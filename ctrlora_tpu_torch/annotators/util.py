"""Shared annotator helpers (counterpart of ``ctrlora_tpu/annotators/util.py``;
reference: annotator/util.py:11-100), numpy and cv2 only.

All stochastic helpers take an explicit np.random.Generator so condition
generation is reproducible (the reference uses module-global random).
``HWC3`` is the port's ``utils/image.HWC3``, which gives JAX's results."""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np

from ctrlora_tpu_torch.utils.image import HWC3  # noqa: F401  (re-exported)


def resize_image(input_image: np.ndarray, resolution: int) -> np.ndarray:
    """Resize short side to `resolution`, rounding dims to multiples of 64."""
    H, W = float(input_image.shape[0]), float(input_image.shape[1])
    k = float(resolution) / min(H, W)
    H = int(np.round(H * k / 64.0)) * 64
    W = int(np.round(W * k / 64.0)) * 64
    return cv2.resize(
        input_image, (W, H),
        interpolation=cv2.INTER_LANCZOS4 if k > 1 else cv2.INTER_AREA,
    )


def nms(x: np.ndarray, t: float, s: float) -> np.ndarray:
    x = cv2.GaussianBlur(x.astype(np.float32), (0, 0), s)
    fs = [
        np.array(f, dtype=np.uint8)
        for f in (
            [[0, 0, 0], [1, 1, 1], [0, 0, 0]],
            [[0, 1, 0], [0, 1, 0], [0, 1, 0]],
            [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
            [[0, 0, 1], [0, 1, 0], [1, 0, 0]],
        )
    ]
    y = np.zeros_like(x)
    for f in fs:
        np.putmask(y, cv2.dilate(x, kernel=f) == x, x)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > t] = 255
    return z


def make_noise_disk(
    H: int, W: int, C: int, F: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    noise = rng.uniform(0, 1, ((H // F) + 2, (W // F) + 2, C))
    noise = cv2.resize(noise, (W + 2 * F, H + 2 * F), interpolation=cv2.INTER_CUBIC)
    noise = noise[F : F + H, F : F + W]
    noise -= noise.min()
    noise /= max(noise.max(), 1e-12)
    if C == 1 and noise.ndim == 2:
        noise = noise[:, :, None]
    return noise


def min_max_norm(x: np.ndarray) -> np.ndarray:
    x = x - x.min()
    return x / max(x.max(), 1e-5)


def safe_step(x: np.ndarray, step: int = 2) -> np.ndarray:
    y = x.astype(np.float32) * float(step + 1)
    return y.astype(np.int32).astype(np.float32) / float(step)


def img2mask(
    img: np.ndarray, H: int, W: int, low: int = 10, high: int = 90,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    assert img.ndim in (2, 3) and img.dtype == np.uint8
    y = img[:, :, int(rng.integers(0, img.shape[2]))] if img.ndim == 3 else img
    y = cv2.resize(y, (W, H), interpolation=cv2.INTER_CUBIC)
    if rng.uniform() < 0.5:
        y = 255 - y
    return y < np.percentile(y, int(rng.integers(low, high)))
