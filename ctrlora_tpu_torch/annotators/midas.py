"""MiDaS DPT-Large depth estimator (counterpart of
``ctrlora_tpu/annotators/midas.py``; reference annotator/midas: DPTDepthModel
on timm's ViT-L/16 at 384 px with the 'project' readout, hooks at blocks
5/11/17/23, reassemble convs, four RefineNet fusions and the monocular-depth
head). ``MidasDetector`` returns the depth map and the surface normals
derived from its Sobel gradients (reference annotator/midas/__init__.py:27-51).

``DPT``'s parameter names are the published dpt_large_384.pt's
(``pretrained.model.*``, ``pretrained.act_postprocess{1..4}.*``,
``scratch.*``), the ones JAX's ``convert_dpt`` reads; the file's
``pretrained.model.norm`` and ``.head`` (the ViT's final norm and classifier,
which the hooks never reach) are left out before the strict load. The widths
are this module's constants, read when a net is built.

Two places follow the reference where JAX departs from it:

* the 24x24 position grid is resized to the input's grid with
  ``F.interpolate(bilinear, align_corners=False)``, as timm does. JAX's
  ``jax.image.resize`` antialiases when it shrinks, so the two agree to
  rounding for inputs of 384 px and more and differ below;
* the 2x up-sampling of the fusions and the head is MLSD's ``upsample2``,
  ``F.interpolate(bilinear, align_corners=True)``; JAX's gather form places
  a sample up to one float32 ulp of (H - 1) apart (see ``mlsd.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.mlsd import upsample2

# DPT-Large (vitl16_384): the published widths
VIT_DIM = 1024
VIT_LAYERS = 24
VIT_HEADS = 16
HOOKS = (5, 11, 17, 23)
REASSEMBLE = (256, 512, 1024, 1024)
FEATURES = 256
PATCH = 16
POS_GRID = 24  # the position grid of the published file (384 px)

# the published files, in the order the JAX package tries them
FILES = ("dpt_large_384.pt", "dpt_large-midas-2f21e586.pt")
UNUSED = ("pretrained.model.norm.", "pretrained.model.head.")


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv(x).reshape(b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        w = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1), dim=-1)
        return self.proj((w @ v).transpose(1, 2).reshape(b, s, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """timm's pre-norm ViT block (LayerNorm eps 1e-6, exact GELU)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class VisionTransformer(nn.Module):
    def __init__(self, dim: int, layers: int, heads: int, grid: int):
        super().__init__()
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(layers))


def resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[1, 1 + g*g, D] -> [1, 1 + gh*gw, D]: the grid resized bilinearly
    without antialiasing (timm's ``_resize_pos_embed``), the class token kept."""
    tok, grid = pos[:, :1], pos[0, 1:]
    g = int(math.sqrt(grid.shape[0]))
    grid = grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
    return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


class ProjectReadout(nn.Module):
    """The class token appended to every patch token, then Linear + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, x):
        readout = x[:, :1].expand(-1, x.shape[1] - 1, -1)
        return self.project(torch.cat([x[:, 1:], readout], dim=-1))


def act_postprocess(dim: int, width: int, level: int) -> nn.Sequential:
    """The reference's Sequential at its indices: 0 the readout, 1-2 the
    token-to-grid reshape (no parameters; ``DPT.forward`` does it), 3 the
    1x1 conv to `width`, 4 the resampling (x4 / x2 transposed conv, none,
    or a stride-2 conv)."""
    layers = [ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, width, 1)]
    if level == 0:
        layers.append(nn.ConvTranspose2d(width, width, 4, stride=4))
    elif level == 1:
        layers.append(nn.ConvTranspose2d(width, width, 2, stride=2))
    elif level == 3:
        layers.append(nn.Conv2d(width, width, 3, stride=2, padding=1))
    return nn.Sequential(*layers)


class Up2(nn.Module):
    """The head's bilinear 2x with aligned corners (no parameters)."""

    def forward(self, x):
        return upsample2(x)


class ResidualConvUnit(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(c)
        self.resConfUnit2 = ResidualConvUnit(c)
        self.out_conv = nn.Conv2d(c, c, 1)

    def forward(self, x, res: Optional[torch.Tensor] = None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        return self.out_conv(upsample2(self.resConfUnit2(x)))


class DPT(nn.Module):
    """x [B, 3, H, W] (H, W multiples of 32, the image scaled to [-1, 1])
    -> the non-negative inverse depth [B, H, W], at this module's widths
    when it is built."""

    def __init__(self):
        super().__init__()
        self.hooks = tuple(HOOKS)
        self.pretrained = nn.Module()
        self.pretrained.model = VisionTransformer(VIT_DIM, VIT_LAYERS, VIT_HEADS, POS_GRID)
        for lvl, width in enumerate(REASSEMBLE):
            self.pretrained.add_module(f"act_postprocess{lvl + 1}",
                                       act_postprocess(VIT_DIM, width, lvl))
        self.scratch = nn.Module()
        for lvl, width in enumerate(REASSEMBLE):
            self.scratch.add_module(f"layer{lvl + 1}_rn",
                                    nn.Conv2d(width, FEATURES, 3, padding=1, bias=False))
            self.scratch.add_module(f"refinenet{lvl + 1}", FeatureFusionBlock(FEATURES))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(FEATURES, FEATURES // 2, 3, padding=1), Up2(),
            nn.Conv2d(FEATURES // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU())

    def taps(self, x) -> list:
        """The token sequences [B, 1 + gh*gw, D] after the hooked blocks."""
        vit = self.pretrained.model
        gh, gw = x.shape[2] // PATCH, x.shape[3] // PATCH
        h = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        h = torch.cat([vit.cls_token.expand(x.shape[0], -1, -1), h], dim=1)
        h = h + resize_pos_embed(vit.pos_embed, gh, gw)
        taps = []
        for i, block in enumerate(vit.blocks):
            h = block(h)
            if i in self.hooks:
                taps.append(h)
        return taps

    def forward(self, x):
        b, gh, gw = x.shape[0], x.shape[2] // PATCH, x.shape[3] // PATCH
        layers = []
        for lvl, tap in enumerate(self.taps(x)):
            ap = getattr(self.pretrained, f"act_postprocess{lvl + 1}")
            feat = ap[0](tap)
            feat = feat.transpose(1, 2).reshape(b, feat.shape[-1], gh, gw)
            for layer in ap[3:]:
                feat = layer(feat)
            layers.append(getattr(self.scratch, f"layer{lvl + 1}_rn")(feat))
        s = self.scratch
        path = s.refinenet4(layers[3])
        path = s.refinenet3(path, layers[2])
        path = s.refinenet2(path, layers[1])
        path = s.refinenet1(path, layers[0])
        return s.output_conv(path)[:, 0]


class MidasDetector:
    """`state_dict`: dpt_large_384.pt's tensors (else
    dpt_large-midas-2f21e586.pt's); default the file in `ckpt_dir`, else
    torch's seeded init. Returns (depth, normal) as uint8 maps."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = next((sd for f in FILES
                               if (sd := nets.read_weights(f, ckpt_dir, drop=UNUSED))
                               is not None), None)
        self.model = nets.build(DPT, state_dict, "midas", device)

    def depth_map(self, input_image: np.ndarray) -> np.ndarray:
        """The network's float32 inverse depth of a uint8 RGB image, resized
        to multiples of 32 (INTER_AREA) and back (INTER_LINEAR)."""
        H, W = input_image.shape[:2]
        Hp, Wp = (H + 31) // 32 * 32, (W + 31) // 32 * 32
        img = cv2.resize(input_image, (Wp, Hp), interpolation=cv2.INTER_AREA)
        depth = nets.forward(self.model, img[None].astype(np.float32) / 127.5 - 1.0)[0].numpy()
        return cv2.resize(depth, (W, H), interpolation=cv2.INTER_LINEAR)

    def __call__(self, input_image: np.ndarray, a: float = np.pi * 0.2,
                 bg_th: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
        assert input_image.ndim == 3
        depth = self.depth_map(input_image)
        depth_pt = depth - depth.min()
        depth_pt = depth_pt / max(depth_pt.max(), 1e-12)
        depth_image = (depth_pt * 255.0).clip(0, 255).astype(np.uint8)

        gx = cv2.Sobel(depth, cv2.CV_32F, 1, 0, ksize=3)
        gy = cv2.Sobel(depth, cv2.CV_32F, 0, 1, ksize=3)
        z = np.ones_like(gx) * a
        gx[depth_pt < bg_th] = 0
        gy[depth_pt < bg_th] = 0
        normal = np.stack([gx, gy, z], axis=2)
        normal /= np.sum(normal ** 2.0, axis=2, keepdims=True) ** 0.5
        normal_image = (normal * 127.5 + 127.5).clip(0, 255).astype(np.uint8)
        return depth_image, normal_image
