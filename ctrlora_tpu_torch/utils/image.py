"""Image helpers, numpy only: the API's ``HWC3`` (counterpart of
``ctrlora_tpu/annotators/util.py``) and ``center_crop_to_common``
(``ctrlora_tpu/api.py``), and ``write_png`` of the CLIs and the image log
(cv2 where it is installed, else PIL)."""

from __future__ import annotations

import importlib.util
from typing import Tuple

import numpy as np


def HWC3(x: np.ndarray) -> np.ndarray:
    """uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] -> [H, W, 3]: grey is
    repeated, alpha is composited over white."""
    if x.dtype != np.uint8:
        raise ValueError(f"HWC3 takes uint8 images, got {x.dtype}")
    if x.ndim == 2:
        x = x[:, :, None]
    c = x.shape[2]
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x, x, x], axis=2)
    if c != 4:
        raise ValueError(f"HWC3 takes 1, 3 or 4 channels, got {c}")
    color = x[:, :, 0:3].astype(np.float32)
    alpha = x[:, :, 3:4].astype(np.float32) / 255.0
    y = color * alpha + 255.0 * (1.0 - alpha)
    return y.clip(0, 255).astype(np.uint8)


def center_crop_to_common(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Centre-crop two condition images to their common height and width
    (the larger of each pair is cropped)."""
    h, w = a.shape[:2]
    h2, w2 = b.shape[:2]
    if h2 > h:
        b = b[(h2 - h) // 2:(h2 + h) // 2]
    else:
        a = a[(h - h2) // 2:(h + h2) // 2]
    if w2 > w:
        b = b[:, (w2 - w) // 2:(w2 + w) // 2]
    else:
        a = a[:, (w - w2) // 2:(w + w2) // 2]
    return a, b


def png_writer() -> str:
    """The library ``write_png`` uses: 'cv2', else 'PIL'; raises
    ImportError where the host has neither."""
    for name in ("cv2", "PIL"):
        if importlib.util.find_spec(name) is not None:
            return name
    raise ImportError("writing PNG files needs cv2 or PIL; the host has neither")


def write_png(path: str, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] RGB to a PNG file."""
    if png_writer() == "cv2":
        import cv2

        cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        return
    from PIL import Image

    Image.fromarray(rgb).save(path)
