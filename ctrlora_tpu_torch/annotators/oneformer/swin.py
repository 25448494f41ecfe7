"""Swin Transformer backbone of OneFormer (counterpart of
``ctrlora_tpu/annotators/oneformer/swin.py``; reference
annotator/oneformer/oneformer/modeling/backbone/swin.py, D2SwinTransformer).

Patch embedding with right/bottom padding to the patch size; in every stage
fixed windows of ``window_size`` (the map padded right/bottom to whole
windows), each odd block cyclically shifted by half a window with the seam
mask (-100 across the shifted regions); the relative-position bias gathered
from each block's table; patch merging after each stage but the last;
per-output LayerNorms; outputs res2..res5 as [B, C, H, W]. fp32 throughout,
as JAX's. The module keeps the file's key names under ``backbone.``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators.midas import Mlp


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin-L at 384 px with window 12 (the published OneFormer backbones)."""

    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] indices into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=4)
def _index(ws: int) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(ws)).reshape(-1)


def shift_mask(hp: int, wp: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """[nW, N, N] additive mask: -100 between tokens of a window that come
    from different regions of the cyclically shifted map."""
    img = torch.zeros((hp, wp), device=device)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(1, 2).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))

    def forward(self, x, mask=None):
        """x [B*nW, N, C]; mask [nW, N, N] or None."""
        bw, n, c = x.shape
        d = c // self.heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        attn = (q * d ** -0.5) @ k.transpose(-2, -1)
        table = self.relative_position_bias_table
        bias = table[_index(self.ws).to(table.device)].reshape(n, n, self.heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, self.heads, n, n)
                    + mask[None, :, None]).reshape(bw, self.heads, n, n)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float):
        super().__init__()
        self.ws = ws
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, h: int, w: int, shift: int, mask):
        b, l, c = x.shape
        ws = self.ws
        y = self.norm1(x).reshape(b, h, w, c)
        pad_r, pad_b = (ws - w % ws) % ws, (ws - h % ws) % ws
        if pad_r or pad_b:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = y.reshape(b, hp // ws, ws, wp // ws, ws, c).transpose(2, 3).reshape(-1, ws * ws, c)
        y = self.attn(y, mask if shift else None)
        y = y.reshape(b, hp // ws, wp // ws, ws, ws, c).transpose(2, 3).reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ws: int, mlp_ratio: float,
                 downsample: bool):
        super().__init__()
        self.ws = ws
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, ws, mlp_ratio) for _ in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim)

    def forward(self, x, h: int, w: int):
        """Every odd block shifted by ws // 2 (the reference keeps the window
        and the shift whatever the map's size, swin.py:388,414-433)."""
        ws, shift = self.ws, self.ws // 2
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        mask = shift_mask(hp, wp, ws, shift, x.device) if len(self.blocks) > 1 else None
        for j, block in enumerate(self.blocks):
            x = block(x, h, w, shift if j % 2 else 0, mask)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)


class SwinTransformer(nn.Module):
    """x [B, 3, H, W] normalised -> {'res2'..'res5': [B, C_i, H_i, W_i]}."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            BasicLayer(cfg.embed_dim * 2 ** i, cfg.depths[i], cfg.num_heads[i], cfg.window_size,
                       cfg.mlp_ratio, i < n - 1) for i in range(n))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(cfg.embed_dim * 2 ** i))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        ps = self.cfg.patch_size
        h, w = x.shape[2:]
        if w % ps or h % ps:
            x = F.pad(x, (0, (ps - w % ps) % ps, 0, (ps - h % ps) % ps))
        x = self.patch_embed.proj(x)
        b, _, wh, ww = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = {}
        for i, layer in enumerate(self.layers):
            x = layer(x, wh, ww)
            if i in self.cfg.out_indices:
                xo = getattr(self, f"norm{i}")(x)
                outs[f"res{i + 2}"] = xo.transpose(1, 2).reshape(b, -1, wh, ww)
            if hasattr(layer, "downsample"):
                x = layer.downsample(x, wh, ww)
                wh, ww = (wh + 1) // 2, (ww + 1) // 2
        return outs
