"""HED edge detector (counterpart of ``ctrlora_tpu/annotators/hed.py``;
reference annotator/hed/__init__.py:37-99, ControlNetHED_Apache2): a
5-block VGG-style net with a 1x1 edge projection after each block; the edge
map is the sigmoid of the mean of the five projections, each resized
bilinearly to the image. ``HEDSketchDetector`` (reference
annotator/hedsketch) thresholds, inverts and blurs HED's map, retrying
until enough pixels are dark.

``ControlNetHED``'s parameter names are the published ControlNetHED.pth's
(``norm``, ``block{b}.convs.{i}``, ``block{b}.projection``), so the file
loads with ``load_state_dict`` as it is.
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.util import HWC3, safe_step

# (in channels, out channels, convs) of blocks 1-5; blocks 2-5 start with a 2x2 max pool
BLOCKS = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))


class DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1)
                                   for i in range(layers))
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, x, down: bool = False):
        if down:
            x = F.max_pool2d(x, 2, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class ControlNetHED(nn.Module):
    """x [B, 3, H, W] on the 0..255 scale -> the five [B, 1, h, w] projections."""

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        for i, (cin, cout, layers) in enumerate(BLOCKS):
            setattr(self, f"block{i + 1}", DoubleConvBlock(cin, cout, layers))

    def forward(self, x):
        h = x - self.norm
        projs = []
        for i in range(len(BLOCKS)):
            h, p = getattr(self, f"block{i + 1}")(h, down=i > 0)
            projs.append(p)
        return projs


class HEDdetector:
    """`state_dict`: ControlNetHED.pth's tensors; default the file in
    `ckpt_dir` (``download.ckpts_dir()``), else torch's seeded init."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights("ControlNetHED.pth", ckpt_dir)
        self.model = nets.build(ControlNetHED, state_dict, "hed", device)

    def __call__(self, input_image: np.ndarray, safe: bool = False) -> np.ndarray:
        assert input_image.ndim == 3
        H, W, _ = input_image.shape
        projs = nets.forward(self.model, input_image[None].astype(np.float32))
        edges = [cv2.resize(p[0, 0].numpy(), (W, H), interpolation=cv2.INTER_LINEAR)
                 for p in projs]
        edge = 1 / (1 + np.exp(-np.mean(np.stack(edges, 2), axis=2).astype(np.float64)))
        if safe:
            edge = safe_step(edge)
        return (edge * 255.0).clip(0, 255).astype(np.uint8)


class HEDSketchDetector:
    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        self.hed = HEDdetector(state_dict, device, ckpt_dir)

    def __call__(self, input_image, safe=False, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        edge = HWC3(self.hed(input_image, safe=safe))
        for cnt in range(6):
            thr = int(rng.integers(110, 160))
            binary = cv2.threshold(edge, thr, 255, cv2.THRESH_BINARY)[1]
            out = cv2.GaussianBlur(cv2.bitwise_not(binary), (3, 3), 0)
            if np.sum(out < 5) > 0.005 * out.shape[0] * out.shape[1] or cnt == 5:
                return out
        return out
