"""OneFormer's MSDeformAttn pixel decoder (counterpart of
``ctrlora_tpu/annotators/oneformer/pixel_decoder.py``; reference
oneformer/modeling/pixel_decoder/msdeformattn.py and
ops/modules/ms_deform_attn.py, the pure-PyTorch path).

The res5/res4/res3 maps are projected (1x1 conv + GroupNorm 32), given the
sine position embedding and a level embedding, and refined by six
deformable-attention encoder layers (8 heads, 4 points a level, sampling
with ``F.grid_sample(bilinear, zeros, align_corners=False)``, the
reference's own ``ms_deform_attn_core_pytorch``; JAX writes it as a
four-corner gather); an FPN level adds res2's lateral to the up-sampled 1/8
map, and a 1x1 conv gives the mask features. The module keeps the file's
key names under ``sem_seg_head.pixel_decoder.``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class PixelDecoderConfig:
    conv_dim: int = 256
    mask_dim: int = 256
    nheads: int = 8
    dim_feedforward: int = 1024
    enc_layers: int = 6
    enc_points: int = 4
    # res2..res5 channels (Swin-L); the encoder takes the last three, the
    # FPN lateral res2
    in_channels: Tuple[int, ...] = (192, 384, 768, 1536)


def sine_position_embedding(h: int, w: int, num_pos_feats: int) -> np.ndarray:
    """PositionEmbeddingSine(normalize=True) of an unmasked h x w map ->
    [h, w, 2 * num_pos_feats], in float32 numpy as JAX's
    (position_encoding.py:32-55)."""
    eps, scale = 1e-6, 2 * math.pi
    y = (np.arange(h, dtype=np.float32) + 1.0)[:, None] / (h + eps) * scale
    x = (np.arange(w, dtype=np.float32) + 1.0)[None, :] / (w + eps) * scale
    y, x = np.broadcast_to(y, (h, w)), np.broadcast_to(x, (h, w))
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_pos_feats)
    inter = lambda p: np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([inter(y[:, :, None] / dim_t), inter(x[:, :, None] / dim_t)], axis=-1)


@functools.lru_cache(maxsize=32)
def position_embedding(h: int, w: int, c: int, device: str) -> torch.Tensor:
    """[1, h*w, c] on `device`: ``sine_position_embedding`` with c // 2 features."""
    pe = sine_position_embedding(h, w, c // 2).reshape(1, h * w, c)
    return torch.from_numpy(np.ascontiguousarray(pe, np.float32)).to(device)


def reference_points(shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[sum(h*w), levels, 2] pixel-centre references (valid ratios 1)."""
    pts = []
    for h, w in shapes:
        ry = np.linspace(0.5, h - 0.5, h, dtype=np.float32) / h
        rx = np.linspace(0.5, w - 0.5, w, dtype=np.float32) / w
        gy, gx = np.meshgrid(ry, rx, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, 0)
    return np.broadcast_to(ref[:, None, :], (ref.shape[0], len(shapes), 2)).copy()


class MSDeformAttn(nn.Module):
    def __init__(self, c: int, levels: int, heads: int, points: int):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = nn.Linear(c, heads * levels * points * 2)
        self.attention_weights = nn.Linear(c, heads * levels * points)
        self.value_proj = nn.Linear(c, c)
        self.output_proj = nn.Linear(c, c)

    def forward(self, query, ref, value, shapes):
        """query [B, Lq, C]; ref [B, Lq, L, 2] in [0, 1]; value [B, S, C]."""
        b, lq, c = query.shape
        m, L, p, d = self.heads, self.levels, self.points, c // self.heads
        v = self.value_proj(value).reshape(b, -1, m, d)
        off = self.sampling_offsets(query).reshape(b, lq, m, L, p, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(b, lq, m, L * p), -1)
        attn = attn.reshape(b, lq, m, L, p)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=query.dtype, device=query.device)
        grids = 2 * (ref[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]) - 1
        out = 0
        start = 0
        for lid, (h, w) in enumerate(shapes):
            v_l = v[:, start:start + h * w].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
            g = grids[:, :, :, lid].transpose(1, 2).reshape(b * m, lq, p, 2)
            s = F.grid_sample(v_l, g, mode="bilinear", padding_mode="zeros",
                              align_corners=False)  # [B*M, D, Lq, P]
            a = attn[:, :, :, lid].transpose(1, 2).reshape(b * m, 1, lq, p)
            out = out + (s * a).sum(-1)
            start += h * w
        out = out.reshape(b, m * d, lq).transpose(1, 2)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, c: int, ff: int, levels: int, heads: int, points: int):
        super().__init__()
        self.self_attn = MSDeformAttn(c, levels, heads, points)
        self.norm1 = nn.LayerNorm(c)
        self.linear1 = nn.Linear(c, ff)
        self.linear2 = nn.Linear(ff, c)
        self.norm2 = nn.LayerNorm(c)

    def forward(self, src, pos, ref, shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class ConvNorm(nn.Conv2d):
    """detectron2's Conv2d with a GroupNorm(32) as its ``norm``; no bias."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = nn.GroupNorm(32, cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class MSDeformAttnPixelDecoder(nn.Module):
    """{'res2'..'res5'} -> (mask features [B, mask_dim, H/4, W/4], the
    encoder's maps [1/32, 1/16, 1/8] as [B, C, h, w])."""

    LEVELS = 3

    def __init__(self, cfg: PixelDecoderConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.conv_dim
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cin, c, 1), nn.GroupNorm(32, c))
            for cin in cfg.in_channels[:0:-1])  # res5, res4, res3
        self.transformer = nn.Module()
        self.transformer.level_embed = nn.Parameter(torch.zeros(self.LEVELS, c))
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            EncoderLayer(c, cfg.dim_feedforward, self.LEVELS, cfg.nheads, cfg.enc_points)
            for _ in range(cfg.enc_layers))
        self.mask_features = nn.Conv2d(c, cfg.mask_dim, 1)
        self.adapter_1 = ConvNorm(cfg.in_channels[0], c, 1)
        self.layer_1 = ConvNorm(c, c, 3)

    def forward(self, feats: Dict[str, torch.Tensor]):
        c = self.cfg.conv_dim
        srcs, pos, shapes = [], [], []
        for i, name in enumerate(("res5", "res4", "res3")):
            x = self.input_proj[i](feats[name])
            b, _, h, w = x.shape
            srcs.append(x.flatten(2).transpose(1, 2))
            pos.append(position_embedding(h, w, c, str(x.device))
                       + self.transformer.level_embed[i][None, None])
            shapes.append((h, w))
        src, posx = torch.cat(srcs, 1), torch.cat(pos, 1)
        ref = torch.from_numpy(reference_points(shapes)).to(src.device)[None]
        for layer in self.transformer.encoder.layers:
            src = layer(src, posx, ref, shapes)
        outs: List[torch.Tensor] = []
        start = 0
        for h, w in shapes:
            outs.append(src[:, start:start + h * w].transpose(1, 2).reshape(b, c, h, w))
            start += h * w
        x2 = feats["res2"]
        y = self.adapter_1(x2) + F.interpolate(outs[-1], size=x2.shape[2:], mode="bilinear",
                                               align_corners=False)
        return self.mask_features(F.relu(self.layer_1(y))), outs
