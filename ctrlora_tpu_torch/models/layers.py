"""Core layers of the port: dense and conv layers that compute in their
input's dtype, fp32 norms, the timestep MLP, ResBlock and resampling.

Counterpart of ``ctrlora_tpu/models/layers.py`` for the fused inference tree:
no LoRA banks (``lora_fuse`` folds them before the weights load), submodules
named after the flax scopes so ``convert.params_from_jax`` is a path walk.
Spatial tensors are NCHW-logical in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is the free, contiguous [B, H, W, C] view the
GroupNorm kernel reads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.ops import group_norm as gn_ops
from ctrlora_tpu_torch.schedules import timestep_embedding

CL = torch.channels_last


class Dense(nn.Linear):
    """Linear layer computing in its input's dtype (weights cast on use, a
    no-op once ``lora_fuse.cast_params_for_inference`` has cast them)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv(nn.Conv2d):
    """Conv with torch-symmetric padding (k-1)//2, computing in its input's
    dtype."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True):
        if padding is None:
            padding = (kernel_size - 1) // 2
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class GroupNorm32(nn.Module):
    """GroupNorm in fp32 over NCHW channels-last x, with the SiLU that
    follows most norms fused and an optional row folded in: computes
    GN(x + add_row) for add_row [C]/[1, C]/[B, C] without building the sum
    (kernel A, ``ops/group_norm.py``)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        # real models have C % 32 == 0; tiny test widths take the largest
        # group count that divides C, as the JAX layer does
        self.num_groups = (num_groups if channels % num_groups == 0
                           else math.gcd(channels, num_groups))
        self.eps = eps
        self.silu = silu

    def forward(self, x, add_row: Optional[torch.Tensor] = None):
        x = x.contiguous(memory_format=CL)
        y = gn_ops.group_norm(x.permute(0, 2, 3, 1), self.weight, self.bias,
                              self.num_groups, self.eps, self.silu, add_row)
        return y.permute(0, 3, 1, 2)


class LayerNorm32(nn.Module):
    """LayerNorm in fp32 over the last axis (eps 1e-5), plain."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class TimestepEmbed(nn.Module):
    """Sinusoidal embedding -> Dense -> SiLU -> Dense."""

    def __init__(self, model_channels: int):
        super().__init__()
        self.model_channels = model_channels
        self.dense0 = Dense(model_channels, 4 * model_channels)
        self.dense1 = Dense(4 * model_channels, 4 * model_channels)

    def forward(self, timesteps, dtype):
        emb = timestep_embedding(timesteps, self.model_channels).to(dtype)
        return self.dense1(F.silu(self.dense0(emb)))


class ResBlock(nn.Module):
    """UNet residual block. With ``emb_row`` (the precomputed emb_proj output
    of this block, one row for the whole batch) the row folds into
    out_norm's statistics instead of being added to h."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm32(cin, silu=True)
        self.in_conv = Conv(cin, cout)
        self.emb_proj = Dense(emb_dim, cout)
        self.out_norm = GroupNorm32(cout, silu=True)
        self.out_conv = Conv(cout, cout)
        self.skip = Conv(cin, cout, kernel_size=1) if cin != cout else None

    def forward(self, x, emb=None, emb_row=None):
        h = self.in_conv(self.in_norm(x))
        if emb_row is None:
            emb_row = self.emb_proj(F.silu(emb))
        h = self.out_conv(self.out_norm(h, add_row=emb_row))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 on both sides."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest-neighbour x2 (``jnp.repeat`` twice in JAX) + 3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
