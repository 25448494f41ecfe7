"""UniFormer-S + UPerNet ADE20K segmentation (counterpart of
``ctrlora_tpu/annotators/uniformer.py``; reference annotator/uniformer:
upernet_global_small over the vendored mmseg, the 'seg' condition of
MultiGen-20M).

Backbone (mmseg/models/backbones/uniformer.py): four stages of [3, 4, 8, 3]
blocks at widths [64, 128, 320, 512]; stages 1-2 are convolutional CBlocks
(BatchNorm), stages 3-4 global self-attention SABlocks (LayerNorm eps 1e-6,
head dim 64); each stage starts with a patch-embedding conv and LayerNorm
(eps 1e-5) and ends with a LayerNorm (eps 1e-6). Decode head (uper_head.py):
a pyramid pooling module over stage 4, FPN laterals, the fused bottleneck
and the 150-class conv. Whole-image inference: the logits resized to the
input (bilinear, align_corners=False), argmax and the ADE palette
(annotator/uniformer/__init__.py:24-27).

Inference only: every BatchNorm is folded into a per-channel scale and shift
when upernet_global_small.pth is loaded (``mlsd.fold_batchnorms``, eps 1e-5,
bit-equal to JAX's ``_fold_bn``). The modules keep the file's key names
(``backbone.*``, ``decode_head.*``, the folded scale as each BatchNorm's
``weight``); the file's ``auxiliary_head.*`` (a training-time head) is left
out before the strict load. The widths are this module's constants, read
when a net is built.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.ade_palette import ADE_PALETTE
from ctrlora_tpu_torch.annotators.mlsd import FoldedBN, fold_batchnorms
from ctrlora_tpu_torch.utils.precision import fp32_exact

EMBED_DIMS = (64, 128, 320, 512)
LAYERS = (3, 4, 8, 3)
HEAD_DIM = 64
CHANNELS = 512
POOL_SCALES = (1, 2, 3, 6)
NUM_CLASSES = 150

FILE = "upernet_global_small.pth"
UNUSED = ("auxiliary_head.",)

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] to `size`, align_corners=False (mmseg's
    ``resize``; JAX's ``_resize`` computes the same half-pixel gather)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of [B, C, H, W]."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class CMlp(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, c, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CBlock(nn.Module):
    """Convolutional block: depthwise position conv, then a 5x5 depthwise
    'attention' between 1x1 convs and a conv MLP, each behind a folded BN."""

    def __init__(self, c: int):
        super().__init__()
        self.pos_embed = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self.norm1 = FoldedBN(c)
        self.conv1 = nn.Conv2d(c, c, 1)
        self.attn = nn.Conv2d(c, c, 5, padding=2, groups=c)
        self.conv2 = nn.Conv2d(c, c, 1)
        self.norm2 = FoldedBN(c)
        self.mlp = CMlp(c, 4 * c)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x))))
        return x + self.mlp(self.norm2(x))


class Attention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.heads = c // HEAD_DIM
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x):
        b, s, c = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        w = torch.softmax((q * HEAD_DIM ** -0.5) @ k.transpose(-2, -1), dim=-1)
        return self.proj((w @ v).transpose(1, 2).reshape(b, s, c))


class Mlp(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SABlock(nn.Module):
    """Global self-attention block over the flattened grid."""

    def __init__(self, c: int):
        super().__init__()
        self.pos_embed = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self.norm1 = nn.LayerNorm(c, eps=1e-6)
        self.attn = Attention(c)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)
        self.mlp = Mlp(c, 4 * c)

    def forward(self, x):
        x = x + self.pos_embed(x)
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = t + self.attn(self.norm1(t))
        t = t + self.mlp(self.norm2(t))
        return t.transpose(1, 2).reshape(b, c, h, w)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, patch, stride=patch)
        self.norm = LayerNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


class UniFormer(nn.Module):
    """x [B, 3, H, W] normalized -> the four stages' features."""

    def __init__(self, dims: Sequence[int], layers: Sequence[int]):
        super().__init__()
        for s, (c, n) in enumerate(zip(dims, layers)):
            cin = 3 if s == 0 else dims[s - 1]
            self.add_module(f"patch_embed{s + 1}", PatchEmbed(cin, c, 4 if s == 0 else 2))
            block = CBlock if s < 2 else SABlock
            self.add_module(f"blocks{s + 1}", nn.ModuleList(block(c) for _ in range(n)))
            self.add_module(f"norm{s + 1}", LayerNorm2d(c, eps=1e-6))

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for s in range(4):
            x = getattr(self, f"patch_embed{s + 1}")(x)
            for block in getattr(self, f"blocks{s + 1}"):
                x = block(x)
            outs.append(getattr(self, f"norm{s + 1}")(x))
        return outs


class ConvModule(nn.Module):
    """mmseg's ConvModule: conv (no bias) + folded BN + ReLU."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.bn = FoldedBN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class UPerHead(nn.Module):
    """Four stage features -> class logits at stage 1's resolution."""

    def __init__(self, in_channels: Sequence[int], channels: int):
        super().__init__()
        self.psp_modules = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(scale), ConvModule(in_channels[-1], channels, 1))
            for scale in POOL_SCALES)
        self.bottleneck = ConvModule(in_channels[-1] + len(POOL_SCALES) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(ConvModule(channels, channels, 3)
                                       for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels, channels, 3)
        self.conv_seg = nn.Conv2d(channels, NUM_CLASSES, 1)

    def forward(self, feats):
        x4 = feats[-1]
        psp = [x4] + [resize(ppm(x4), x4.shape[2:]) for ppm in self.psp_modules]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        laterals.append(self.bottleneck(torch.cat(psp, dim=1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(laterals[i], laterals[i - 1].shape[2:])
        fpn = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)] + [laterals[-1]]
        fpn = [fpn[0]] + [resize(f, fpn[0].shape[2:]) for f in fpn[1:]]
        return self.conv_seg(self.fpn_bottleneck(torch.cat(fpn, dim=1)))


class UperNetUniFormer(nn.Module):
    """x [B, 3, H, W] normalized -> logits [B, 150, H/4, W/4]."""

    def __init__(self):
        super().__init__()
        self.backbone = UniFormer(EMBED_DIMS, LAYERS)
        self.decode_head = UPerHead(EMBED_DIMS, CHANNELS)

    def forward(self, x):
        return self.decode_head(self.backbone(x))


class UniformerDetector:
    """`state_dict`: upernet_global_small.pth's tensors (BatchNorms
    unfolded, as published); default the file in `ckpt_dir`. Without it the
    detector raises, as JAX's does: there is no init to fall back on."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights(FILE, ckpt_dir, drop=UNUSED)
        if state_dict is None:
            raise FileNotFoundError(f"UniformerDetector needs {FILE} in the annotator "
                                    f"checkpoint directory ({ckpt_dir or 'ckpts_dir()'})")
        self.model = nets.build(UperNetUniFormer, fold_batchnorms(state_dict), "seg", device)

    def logits(self, img: np.ndarray) -> torch.Tensor:
        """The [1, 150, H, W] logits of a uint8 RGB image: its shorter side
        scaled to 512 for the net (mmseg's ADE test pipeline, no padding),
        the logits resized to the image."""
        H, W = img.shape[:2]
        scale = 512 / min(H, W)
        nh, nw = round(H * scale), round(W * scale)
        r = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        x = (r.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
        t = torch.from_numpy(np.ascontiguousarray(x)).to(nets.device_of(self.model))
        with torch.inference_mode(), fp32_exact():
            return resize(self.model(t[None].permute(0, 3, 1, 2)), (H, W))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        seg = self.logits(img).argmax(dim=1)[0].cpu().numpy()
        return np.asarray(ADE_PALETTE, np.uint8)[seg]
