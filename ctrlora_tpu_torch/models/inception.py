"""FID InceptionV3, pt_inception-2015-12-05 (counterpart of
``ctrlora_tpu/models/inception.py``).

The network torch-fidelity and pytorch-fid wrap: the TF-ported
1008-class InceptionV3 with the three FID quirks, avg_pool2d(3, 1, 1,
count_include_pad=False) in the A, C and E1 mixed blocks, a MAX branch pool
in Mixed_7c, and BatchNorm at eps 1e-3 (folded into a per-channel scale and
bias at load time). The pytorch-fid protocol:

    uint8 RGB -> float/255 -> bilinear resize to 299 (align_corners=False,
    no antialias) -> 2x-1 -> pool3 features [B, 2048] (FID) and fc logits
    [B, 1008] (IS).

Plain cuDNN convolutions in fp32 (JAX's is ``lax.conv`` and
``reduce_window``, no Pallas kernel); ``inception_features`` computes with
TF32 off. Images are NHWC at the API and permuted once inside.

Weights: the standard pt_inception-2015-12-05-6726825d.pth state dict
(torchvision naming) through ``convert_inception``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.utils.precision import fp32_exact


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class BasicConv2d(nn.Module):
    """Conv (no bias) + folded BatchNorm + ReLU: relu(conv(x) * scale +
    bias), as JAX's ``_basic``."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = stride, _pair(padding)
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv2d(x, self.weight, None, self.stride, self.padding)
        return F.relu(y * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1))


def _avgpool_nocip(x):
    """avg_pool2d(3, 1, 1, count_include_pad=False): the FID quirk."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avgpool_nocip(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool_nocip(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
                  else _avgpool_nocip(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class FIDInceptionV3(nn.Module):
    """x [B, 299, 299, 3] in [-1, 1] -> (pool3 [B, 2048], logits [B, 1008])."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)

    @classmethod
    def from_state_dict(cls, state: Dict[str, torch.Tensor], device="cuda") -> "FIDInceptionV3":
        """A model loaded with a port state dict (``convert_inception``), in
        eval mode on `device`."""
        model = cls()
        model.load_state_dict(state, strict=True)
        return model.to(device).eval().requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.float().permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        feats = x.mean((2, 3))  # adaptive avg pool to 1x1
        return feats, self.fc(feats)


def inception_features(model: FIDInceptionV3, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, 299, 299, 3] in [-1, 1] -> (pool3 [B, 2048], logits [B, 1008]),
    in full fp32 (TF32 off for the call)."""
    with fp32_exact(), torch.no_grad():
        return model(x)


def _resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch's bilinear resize (align_corners=False, no antialias) on NHWC,
    written out as JAX's ``_resize_bilinear``
    (``annotators/oneformer/pixel_decoder.py:218``) computes it: the same
    float32 source coordinates and weights, so the two packages agree to
    rounding (F.interpolate's own coordinates differ from both by up to
    4e-6 in a [0, 1] image)."""
    _, h, w, _ = x.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    ys = (torch.arange(oh, dtype=torch.float32, device=x.device) + 0.5) * (h / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=x.device) + 0.5) * (w / ow) - 0.5
    y0, x0 = torch.floor(ys).clamp(0, h - 1), torch.floor(xs).clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[None, :, None, None]
    wx = (xs - x0).clamp(0.0, 1.0)[None, None, :, None]
    y0, y1, x0, x1 = (t.long() for t in (y0, y1, x0, x1))
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def fid_preprocess(images_uint8, device="cuda") -> torch.Tensor:
    """uint8 [B, H, W, 3] (array or tensor) -> [-1, 1] fp32 [B, 299, 299, 3]
    on `device` (pytorch-fid's bilinear align_corners=False resize of the
    [0,1] tensor, without antialias)."""
    x = torch.as_tensor(np.asarray(images_uint8)).to(device).float() / 255.0
    return 2.0 * _resize_bilinear(x, (299, 299)) - 1.0


BRANCHES = {
    "a": ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
          "branch3x3dbl_3", "branch_pool"),
    "b": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
    "c": ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
          "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5",
          "branch_pool"),
    "d": ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
          "branch7x7x3_4"),
    "e": ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"),
}
KINDS = {"Mixed_5b": "a", "Mixed_5c": "a", "Mixed_5d": "a", "Mixed_6a": "b",
         "Mixed_6b": "c", "Mixed_6c": "c", "Mixed_6d": "c", "Mixed_6e": "c",
         "Mixed_7a": "d", "Mixed_7b": "e", "Mixed_7c": "e"}
STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")


def convert_inception(sd: Dict[str, np.ndarray], eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """pt_inception state dict (torchvision names, BN buffers) -> the port's
    folded-BN state dict: scale = gamma / sqrt(var + eps), bias = beta -
    mean * scale, computed in fp32 numpy as JAX's bridge does."""
    sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
          for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def fold(prefix: str) -> None:
        scale = sd[prefix + ".bn.weight"] / np.sqrt(sd[prefix + ".bn.running_var"] + eps)
        bias = sd[prefix + ".bn.bias"] - sd[prefix + ".bn.running_mean"] * scale
        for leaf, value in (("weight", sd[prefix + ".conv.weight"]), ("scale", scale),
                            ("bias", bias)):
            out[f"{prefix}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))

    for stem in STEM:
        fold(stem)
    for mixed, kind in KINDS.items():
        for br in BRANCHES[kind]:
            fold(f"{mixed}.{br}")
    out["fc.weight"] = torch.from_numpy(sd["fc.weight"])
    out["fc.bias"] = torch.from_numpy(sd["fc.bias"])
    return out


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS over fc logits (torch-fidelity convention: softmax, 10 splits)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        if not len(part):
            continue
        marginal = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))).sum(-1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))
