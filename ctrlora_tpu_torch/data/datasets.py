"""The port's numpy copy of ``ctrlora_tpu/data/datasets.py``'s
``CustomDataset``: the reference on-disk layout (datasets/custom_dataset.py)
with its randomness drawn from an explicit ``np.random.Generator``, images
read with cv2 where it is installed and PIL otherwise.

Per example: ``jpg`` [H, W, 3] float32 in [-1, 1] (the target image),
``txt`` the prompt ('' with probability drop_rate), ``hint`` [H, W, 3]
float32 in [0, 1] (the condition image).

The JAX package's opt-in C++ transforms (``CTRLORA_NATIVE_DATA=1``) are not
ported yet: with that variable set, a resizing ``get`` raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


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
        if self.resolution is not None:
            if os.environ.get("CTRLORA_NATIVE_DATA"):
                raise NotImplementedError(
                    "CTRLORA_NATIVE_DATA: the native image transforms are not ported yet "
                    "(ROADMAP queue 1 item 6); unset the variable")
            source = _resize(source, self.resolution, source.shape[0] < self.resolution)
            target = _resize(target, self.resolution, target.shape[0] < self.resolution)
        return dict(jpg=target.astype(np.float32) / 127.5 - 1.0, txt=prompt,
                    hint=source.astype(np.float32) / 255.0)
