"""PiDiNet edge detector (counterpart of ``ctrlora_tpu/annotators/pidinet.py``;
reference annotator/pidinet: pixel-difference convolutions, the 'carv4'
config at 60 planes, dil 24, sa on).

The pixel-difference convolutions (cd / ad / rd) are kernel transforms, so
``convert_pdc`` turns each into a plain conv kernel when
table5_pidinet.pth is loaded (the reference's own PDCBlock_converted path):

  cd: subtract the kernel's tap sum from the centre tap
  ad: subtract the clockwise-rotated kernel
  rd: scatter the 8 outer taps (+/-) into a 5x5 radial-difference kernel

``PiDiNet`` keeps the file's key names (without DataParallel's 'module.')
and holds the converted kernels: each rd block's depthwise conv is 5x5 with
padding 2. The side outputs are resized to the image bilinearly
(align_corners=False, which is what JAX's ``jax.image.resize`` computes when
it up-samples).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.util import safe_step

CARV4 = ["cd", "ad", "rd", "cv"] * 4
PLANES = 60
DIL = 24
STAGE_BLOCKS = (3, 4, 4, 4)
DILATIONS = (5, 7, 9, 11)

FILE = "table5_pidinet.pth"


def convert_pdc(op: str, w: np.ndarray) -> np.ndarray:
    """A [out, in, 3, 3] pdc kernel -> the plain conv kernel (3x3, or 5x5
    for rd), in numpy float32 as JAX's."""
    w = np.asarray(w, np.float32)
    if op == "cv":
        return w
    if op == "cd":
        out = w.copy()
        out[:, :, 1, 1] -= w.sum(axis=(2, 3))
        return out
    if op == "ad":
        flat = w.reshape(*w.shape[:2], 9)
        perm = [3, 0, 1, 6, 4, 2, 7, 8, 5]
        return (flat - flat[:, :, perm]).reshape(w.shape)
    if op == "rd":
        o, i = w.shape[:2]
        buf = np.zeros((o, i, 25), np.float32)
        flat = w.reshape(o, i, 9)
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, 1:]
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, 1:]
        return buf.reshape(o, i, 5, 5)
    raise ValueError(op)


def block_ops() -> Dict[str, str]:
    """{conv key: pdc op} of the converted kernels: init_block and each
    block's depthwise conv1, in CARV4 order."""
    ops = {"init_block.weight": CARV4[0]}
    idx = 1
    for s, n_blocks in enumerate(STAGE_BLOCKS):
        for b in range(n_blocks):
            ops[f"block{s + 1}_{b + 1}.conv1.weight"] = CARV4[idx]
            idx += 1
    return ops


class PDCBlock(nn.Module):
    def __init__(self, op: str, cin: int, cout: int, stride: int):
        super().__init__()
        k = 5 if op == "rd" else 3
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cin, k, padding=k // 2, groups=cin, bias=False)
        self.conv2 = nn.Conv2d(cin, cout, 1, bias=False)
        if stride > 1:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.stride > 1:
            x = self.shortcut(x)
        return y + x


class CDCM(nn.Module):
    """Compact dilation convolution module."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1)
        for j, d in enumerate(DILATIONS, 1):
            setattr(self, f"conv2_{j}", nn.Conv2d(cout, cout, 3, padding=d, dilation=d,
                                                  bias=False))

    def forward(self, x):
        x = self.conv1(F.relu(x))
        return sum(getattr(self, f"conv2_{j}")(x) for j in range(1, len(DILATIONS) + 1))


class CSAM(nn.Module):
    """Compact spatial attention module."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, 4, 1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class MapReduce(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, 1, 1)

    def forward(self, x):
        return self.conv(x)


class PiDiNet(nn.Module):
    """x [B, 3, H, W] (BGR in 0..1) -> the four side edge maps and the fused
    one, each a sigmoid [B, 1, H, W]."""

    def __init__(self):
        super().__init__()
        chans = (PLANES, 2 * PLANES, 4 * PLANES, 4 * PLANES)
        self.init_block = nn.Conv2d(3, PLANES, 3, padding=1, bias=False)
        idx, cin = 1, PLANES
        for s, n_blocks in enumerate(STAGE_BLOCKS):
            for b in range(n_blocks):
                stride = 2 if b == 0 and s > 0 else 1
                setattr(self, f"block{s + 1}_{b + 1}",
                        PDCBlock(CARV4[idx], cin, chans[s], stride))
                cin = chans[s]
                idx += 1
        self.dilations = nn.ModuleList(CDCM(c, DIL) for c in chans)
        self.attentions = nn.ModuleList(CSAM(DIL) for _ in chans)
        self.conv_reduces = nn.ModuleList(MapReduce(DIL) for _ in chans)
        self.classifier = nn.Conv2d(len(chans), 1, 1)

    def forward(self, x):
        H, W = x.shape[2:]
        h = self.init_block(x)
        feats = []
        for s, n_blocks in enumerate(STAGE_BLOCKS):
            for b in range(n_blocks):
                h = getattr(self, f"block{s + 1}_{b + 1}")(h)
            feats.append(h)
        outs = []
        for i, f in enumerate(feats):
            e = self.conv_reduces[i](self.attentions[i](self.dilations[i](f)))
            outs.append(F.interpolate(e, size=(H, W), mode="bilinear", align_corners=False))
        fused = self.classifier(torch.cat(outs, dim=1))
        return [torch.sigmoid(o) for o in outs + [fused]]


def convert_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """table5_pidinet.pth's tensors ('module.' stripped) -> PiDiNet's: every
    pdc kernel through ``convert_pdc``, the rest as they are."""
    ops = block_ops()
    return {k: torch.from_numpy(convert_pdc(ops[k], v.float().numpy())) if k in ops else v
            for k, v in sd.items()}


class PidiNetDetector:
    """`state_dict`: PiDiNet's (converted) tensors; default table5_pidinet.pth
    in `ckpt_dir` (``download.ckpts_dir()``), its pdc kernels converted,
    else torch's seeded init."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights(FILE, ckpt_dir, strip_module=True)
            if state_dict is not None:
                state_dict = convert_state(state_dict)
        self.model = nets.build(PiDiNet, state_dict, "pidinet", device)

    def __call__(self, input_image: np.ndarray, safe: bool = False) -> np.ndarray:
        assert input_image.ndim == 3
        x = input_image[:, :, ::-1].astype(np.float32) / 255.0  # the reference feeds BGR
        edge = nets.forward(self.model, x[None])[-1][0, 0].numpy()
        if safe:
            edge = safe_step(edge)
        return (edge * 255.0).clip(0, 255).astype(np.uint8)
