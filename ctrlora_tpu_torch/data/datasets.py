"""The port's numpy copy of ``ctrlora_tpu/data/datasets.py``:
``CustomDataset`` and ``MultiGen20M`` in the reference on-disk layouts
(datasets/custom_dataset.py, datasets/multigen20m.py), with their
randomness drawn from an explicit ``np.random.Generator``, images read with
cv2 where it is installed and PIL otherwise.

Per example: ``jpg`` [H, W, 3] float32 in [-1, 1] (the target image),
``txt`` the prompt ('' with probability drop_rate), ``hint`` [H, W, 3]
float32 in [0, 1] (the condition image), and for MultiGen ``task``, the
'control_<task>' key.

``CTRLORA_NATIVE_DATA=1`` resizes CustomDataset's images with the C++ image
prep (``data.native``: area average down, bilinear up, where cv2 uses
Lanczos up); a failed build of it raises, there is no fallback.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ctrlora_tpu_torch.data import native

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


MULTIGEN_TASK_KEYS = {
    "hed": "control_hed",
    "canny": "control_canny",
    "seg": "control_seg",
    "segbase": "control_seg",
    "depth": "control_depth",
    "normal": "control_normal",
    "openpose": "control_openpose",
    "hedsketch": "control_hedsketch",
    "bbox": "control_bbox",
    "outpainting": "control_outpainting",
    "inpainting": "control_inpainting",
    "blur": "control_blur",
    "grayscale": "control_grayscale",
}


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """uint8 [H, W, 3] RGB, or None where the file cannot be read."""
    if cv2 is not None:
        img = cv2.imread(path)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image  # pragma: no cover

    try:  # pragma: no cover
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:  # pragma: no cover
        return None


def _resize(img: np.ndarray, size: int, up: bool) -> np.ndarray:
    """Square resize: Lanczos up, area down (PIL: Lanczos both ways)."""
    if cv2 is not None:
        interp = cv2.INTER_LANCZOS4 if up else cv2.INTER_AREA
        return cv2.resize(img, (size, size), interpolation=interp)
    from PIL import Image  # pragma: no cover

    return np.asarray(Image.fromarray(img).resize((size, size), Image.LANCZOS))


class CustomDataset:
    """root/{prompt.json, source/, target/}: one JSON line per item with its
    ``source`` and ``target`` paths (relative to root) and its ``prompt``;
    items whose files are missing are skipped."""

    def __init__(self, root: str, drop_rate: float = 0.0, resolution: Optional[int] = None):
        self.root = os.path.expanduser(root)
        self.drop_rate = drop_rate
        self.resolution = resolution
        pj = os.path.join(self.root, "prompt.json")
        if not os.path.isfile(pj):
            raise FileNotFoundError(pj)
        source_files = set(os.listdir(os.path.join(self.root, "source")))
        target_files = set(os.listdir(os.path.join(self.root, "target")))
        self.data: List[dict] = []
        with open(pj) as f:
            for line in f:
                item = json.loads(line)
                if (item["source"].removeprefix("source/") in source_files
                        and item["target"].removeprefix("target/") in target_files):
                    self.data.append(item)

    def __len__(self) -> int:
        return len(self.data)

    def get(self, idx: int, rng: np.random.Generator) -> Dict:
        item = self.data[idx]
        source = imread_rgb(os.path.join(self.root, item["source"]))
        target = imread_rgb(os.path.join(self.root, item["target"]))
        prompt = item["prompt"]
        if rng.random() < self.drop_rate:
            prompt = ""
        if self.resolution is not None and os.environ.get("CTRLORA_NATIVE_DATA"):
            r = self.resolution
            return dict(jpg=native.resize_norm(target, (0, 0, *target.shape[:2]), (r, r),
                                               1 / 127.5, -1.0),
                        txt=prompt,
                        hint=native.resize_norm(source, (0, 0, *source.shape[:2]), (r, r),
                                                1 / 255.0, 0.0))
        if self.resolution is not None:
            source = _resize(source, self.resolution, source.shape[0] < self.resolution)
            target = _resize(target, self.resolution, target.shape[0] < self.resolution)
        return dict(jpg=target.astype(np.float32) / 127.5 - 1.0, txt=prompt,
                    hint=source.astype(np.float32) / 255.0)


class MultiGen20M:
    """One task of MultiGen-20M: a JSON line per item with its ``prompt``,
    its image path ``source`` (under path_meta/images) and its condition
    path ``control_<task>`` (under path_meta/conditions); a paired square
    crop (random or centred) and a resize to ``resolution``
    (datasets/multigen20m.py:59-95)."""

    def __init__(self, path_json: str, path_meta: str, task: str, drop_rate: float = 0.3,
                 random_cropping: bool = True, resolution: int = 512):
        if task not in MULTIGEN_TASK_KEYS:
            raise ValueError(f"unknown multigen task {task!r}")
        self.key = MULTIGEN_TASK_KEYS[task]
        self.task = task
        self.path_meta = path_meta
        self.drop_rate = drop_rate
        self.random_cropping = random_cropping
        self.resolution = resolution
        with open(path_json) as f:
            self.data: List[dict] = [json.loads(line) for line in f]

    def __len__(self) -> int:
        return len(self.data)

    def _paired_crop(self, control: np.ndarray, target: np.ndarray, rng: np.random.Generator):
        """Square-crop the control image (random or centred) and apply the
        same relative crop to the target, then resize both."""
        H, W = control.shape[:2]
        if W >= H:
            crop = H
            l = int(rng.integers(0, W - crop + 1)) if self.random_cropping else (W - crop) // 2
            t0, b0, l0, r0 = 0, H, l, l + crop
        else:
            crop = W
            t = int(rng.integers(0, H - crop + 1)) if self.random_cropping else (H - crop) // 2
            t0, b0, l0, r0 = t, t + crop, 0, W
        rates = (t0 / H, b0 / H, l0 / W, r0 / W)
        Ht, Wt = target.shape[:2]
        tt, bt, lt, rt = (int(rates[0] * Ht), int(rates[1] * Ht), int(rates[2] * Wt),
                          int(rates[3] * Wt))
        r = self.resolution
        return (_resize(control[t0:b0, l0:r0], r, r / min(H, W) > 1),
                _resize(target[tt:bt, lt:rt], r, r / min(Ht, Wt) > 1))

    def get(self, idx: int, rng: np.random.Generator) -> Dict:
        # a sample whose condition, image or prompt is missing is skipped for
        # the next one (reference: multigen20m.py:110-126)
        for _ in range(10000):
            item = self.data[idx]
            src_name = item.get(self.key)
            tgt_name = item.get("source", "")
            tgt_name = tgt_name[2:] if tgt_name.startswith("./") else tgt_name
            source = (imread_rgb(os.path.join(self.path_meta, "conditions", src_name))
                      if src_name else None)
            target = imread_rgb(os.path.join(self.path_meta, "images", tgt_name))
            prompt = item.get("prompt")
            if source is not None and target is not None and prompt is not None:
                break
            idx = (idx + 1) % len(self.data)
        source, target = self._paired_crop(source, target, rng)
        if rng.random() < self.drop_rate:
            prompt = ""
        return dict(jpg=target.astype(np.float32) / 127.5 - 1.0, txt=prompt,
                    hint=source.astype(np.float32) / 255.0, task=self.key)
