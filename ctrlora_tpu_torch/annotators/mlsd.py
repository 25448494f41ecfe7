"""MLSD line-segment detector (counterpart of
``ctrlora_tpu/annotators/mlsd.py``; reference annotator/mlsd, navervision
mlsd's MobileV2_MLSD_Large): a truncated MobileNetV2 on the image plus a
channel of ones, an FPN of A/B/C fusion blocks, and a 9-channel map whose
centre heat and displacements decode into segments.

Inference only: every BatchNorm is folded into a per-channel scale and
shift when the published mlsd_large_512_fp32.pth is loaded
(``fold_batchnorms``, eps 1e-5, as JAX's ``_fold_bn``); the module keeps
the file's key names, its ``FoldedBN`` holding the scale as ``weight``.
Segments are decoded on the host in numpy (``decode_lines``, JAX's
verbatim) and drawn with cv2. The fusion blocks' 2x up-sampling
(``upsample2``) is the reference's own ``F.interpolate(bilinear,
align_corners=True)``; JAX writes
it as a gather at ``jnp.linspace`` positions, which XLA rounds differently
in float32: the two place a sample up to one float32 ulp of (H - 1) apart,
so they differ by that much of a step between neighbours (~3e-5 relative
at 256 rows) and otherwise agree.
"""

from __future__ import annotations

from typing import Dict, Optional

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets


class FoldedBN(nn.Module):
    """A BatchNorm folded to x * weight + bias per channel."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def fold_batchnorms(sd: Dict[str, torch.Tensor], eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Each BatchNorm's (weight, bias, running_mean, running_var) ->
    (scale, shift) under its own weight and bias keys; num_batches_tracked
    goes. The other tensors pass through."""
    out = dict(sd)
    for key in sd:
        if not key.endswith(".running_var"):
            continue
        p = key[:-len(".running_var")]
        w, b, mean, var = (sd[f"{p}.{n}"].float().numpy()
                           for n in ("weight", "bias", "running_mean", "running_var"))
        scale = w / np.sqrt(var + eps)  # numpy's float32 rounding, as JAX's fold
        out[p + ".weight"] = torch.from_numpy(scale)
        out[p + ".bias"] = torch.from_numpy(b - mean * scale)
        for stat in ("running_mean", "running_var", "num_batches_tracked"):
            out.pop(f"{p}.{stat}", None)
    return out


class ConvBNReLU(nn.Sequential):
    """Conv (no bias) + folded BN + ReLU6; a stride-2 conv pads (0, 1, 0, 1)
    as TFLite does instead of symmetrically."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 groups: int = 1):
        padding = 0 if stride == 2 else (kernel_size - 1) // 2
        super().__init__(nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups,
                                   bias=False),
                         FoldedBN(cout), nn.ReLU6())
        self.stride = stride

    def forward(self, x):
        if self.stride == 2:
            x = F.pad(x, (0, 1, 0, 1))
        return super().forward(x)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand: int):
        super().__init__()
        hidden = int(round(inp * expand))
        layers = [ConvBNReLU(inp, hidden, kernel_size=1)] if expand != 1 else []
        layers += [ConvBNReLU(hidden, hidden, stride=stride, groups=hidden),
                   nn.Conv2d(hidden, oup, 1, bias=False), FoldedBN(oup)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and inp == oup

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


# (t, c, n, s) of the truncated MobileNetV2 (reference mbv2_mlsd_large.py:173-181)
MBV2_SETTING = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1)]
FPN_SELECTED = [1, 3, 6, 10, 13]


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        features = [ConvBNReLU(4, 32, stride=2)]
        cin = 32
        for t, c, n, s in MBV2_SETTING:
            for i in range(n):
                features.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        self.features = nn.Sequential(*features)

    def forward(self, x):
        feats = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in FPN_SELECTED:
                feats.append(x)
        return feats


def _conv_bn_relu(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                                   dilation=dilation),
                         FoldedBN(cout), nn.ReLU())


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x with aligned corners, [B, C, H, W] -> [B, C, 2H, 2W]."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=True)


class BlockTypeA(nn.Module):
    def __init__(self, in_c1: int, in_c2: int, out_c1: int, out_c2: int, upscale: bool = True):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_c2, out_c2, 1)
        self.conv2 = _conv_bn_relu(in_c1, out_c1, 1)
        self.upscale = upscale

    def forward(self, a, b):
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            b = upsample2(b)
        return torch.cat((a, b), dim=1)


class BlockTypeB(nn.Module):
    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_c, in_c, 3)
        self.conv2 = _conv_bn_relu(in_c, out_c, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class BlockTypeC(nn.Module):
    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_c, in_c, 3, dilation=5)
        self.conv2 = _conv_bn_relu(in_c, in_c, 3)
        self.conv3 = nn.Conv2d(in_c, out_c, 1)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class MobileV2MLSDLarge(nn.Module):
    """x [B, 4, H, W] (RGB and ones, scaled to [-1, 1]) -> the 9-channel
    map [B, 9, H/2, W/2]: centre logits and two endpoints' displacements."""

    def __init__(self):
        super().__init__()
        self.backbone = MobileNetV2()
        self.block15 = BlockTypeA(64, 96, 64, 64, upscale=False)
        self.block16 = BlockTypeB(128, 64)
        self.block17 = BlockTypeA(32, 64, 64, 64)
        self.block18 = BlockTypeB(128, 64)
        self.block19 = BlockTypeA(24, 64, 64, 64)
        self.block20 = BlockTypeB(128, 64)
        self.block21 = BlockTypeA(16, 64, 64, 64)
        self.block22 = BlockTypeB(128, 64)
        self.block23 = BlockTypeC(64, 16)

    def forward(self, x):
        c1, c2, c3, c4, c5 = self.backbone(x)
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[:, 7:]


def decode_lines(tp_map: np.ndarray, topk: int = 200, ksize: int = 3,
                 score_thr: float = 0.1, dist_thr: float = 20.0) -> np.ndarray:
    """tp_map [H, W, 9] -> line segments [N, 4] (x0, y0, x1, y1) on the
    map's grid (reference utils.py:19-86)."""
    center = tp_map[:, :, 0]
    disp = tp_map[:, :, 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    hmax = cv2.dilate(heat, np.ones((ksize, ksize)))
    heat = np.where(hmax == heat, heat, 0.0)
    flat = heat.reshape(-1)
    idx = np.argpartition(flat, -topk)[-topk:]
    idx = idx[np.argsort(-flat[idx])]
    w = heat.shape[1]
    segs = []
    dist_map = np.sqrt(((disp[:, :, :2] - disp[:, :, 2:]) ** 2).sum(-1))
    for i in idx:
        y, x = divmod(int(i), w)
        if flat[i] > score_thr and dist_map[y, x] > dist_thr:
            dx0, dy0, dx1, dy1 = disp[y, x]
            segs.append([x + dx0, y + dy0, x + dx1, y + dy1])
    return np.asarray(segs, np.float32).reshape(-1, 4)


class MLSDdetector:
    """`state_dict`: mlsd_large_512_fp32.pth's tensors (BatchNorms unfolded,
    as published); default the file in `ckpt_dir`, else torch's seeded
    init."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights("mlsd_large_512_fp32.pth", ckpt_dir)
        self.model = nets.build(MobileV2MLSDLarge,
                                None if state_dict is None else fold_batchnorms(state_dict),
                                "mlsd", device)

    def tp_map(self, input_image: np.ndarray) -> np.ndarray:
        """The network's [H/2, W/2, 9] map of a uint8 RGB image."""
        h, w = input_image.shape[:2]
        feed = np.concatenate([input_image, np.ones((h, w, 1))], axis=-1).astype(np.float32)
        return nets.forward(self.model, feed[None] / 127.5 - 1.0)[0].permute(1, 2, 0).numpy()

    def __call__(self, input_image: np.ndarray, thr_v: float = 0.1,
                 thr_d: float = 0.1) -> np.ndarray:
        """At the input's own resolution (reference mlsd/__init__.py:37)."""
        assert input_image.ndim == 3
        out = np.zeros_like(input_image)
        lines = 2 * decode_lines(self.tp_map(input_image), 200, 3, thr_v, thr_d)  # half-res map
        for x0, y0, x1, y1 in lines.astype(int):
            cv2.line(out, (x0, y0), (x1, y1), (255, 255, 255), 1)
        return out[:, :, 0]
