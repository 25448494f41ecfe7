"""Core layers of the port: dense and conv layers that compute in their
input's dtype, fp32 norms, the timestep MLP, ResBlock and resampling.

Counterpart of ``ctrlora_tpu/models/layers.py``. ``Dense`` optionally holds
stacked LoRA adapters (``lora_down`` [n, in, r], ``lora_up`` [n, r, out],
the JAX names and layouts), selected per call by ``lora_idx``: the unfused
tree that training updates. The serving path loads the fused tree instead
(``lora_fuse``), with no LoRA parameters. Submodules are named after the
flax scopes so ``convert.params_from_jax`` is a path walk.
Spatial tensors are NCHW-logical in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is the free, contiguous [B, H, W, C] view the
GroupNorm kernel reads.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import LoRAConfig
from ctrlora_tpu_torch.ops import group_norm as gn_ops
from ctrlora_tpu_torch.schedules import timestep_embedding

CL = torch.channels_last
LoraIdx = Optional[Union[int, torch.Tensor]]


def to_channels_last(module: nn.Module) -> nn.Module:
    """``module.to(memory_format=channels_last)`` for its 4-d weights only
    (a banked zero conv's [n, co, ci, 1, 1] weight has no such format)."""
    for p in module.parameters():
        if p.dim() == 4:
            p.data = p.data.contiguous(memory_format=CL)
    return module


def _take(bank: torch.Tensor, idx: LoraIdx) -> torch.Tensor:
    """One slice of a [n, ...] bank; an out-of-range index selects the
    nearest end (the JAX ``_take``'s mode='clip'). A tensor index is
    gathered on its device (indexing with a 0-d tensor reads its value on
    the host: a wait for the device, which a CUDA graph cannot capture)."""
    if idx is None:
        return bank[0]
    if isinstance(idx, torch.Tensor):
        return bank.index_select(0, idx.reshape(1).clamp(0, bank.shape[0] - 1)).squeeze(0)
    return bank[min(max(int(idx), 0), bank.shape[0] - 1)]


def has_lora(lora: Optional[LoRAConfig]) -> bool:
    return lora is not None and lora.n_loras > 0


def n_banks(lora: Optional[LoRAConfig]) -> int:
    """Bank size of the switchable zero convs and transformer norms."""
    return lora.n_loras if has_lora(lora) and lora.switchable_banks else 0


class Dense(nn.Linear):
    """Linear layer computing in its input's dtype (weights cast on use, a
    no-op once ``lora_fuse.cast_params_for_inference`` has cast them), with
    optional stacked LoRA adapters: y = x W^T + b + (x down[i]) up[i],
    the LoRA term scaled by network_alpha / rank when alpha is set.
    ``lora_down`` starts N(0, 1/rank), ``lora_up`` at zero, as in JAX."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lora: Optional[LoRAConfig] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.lora = lora if has_lora(lora) else None
        if self.lora is not None:
            n, r = lora.n_loras, lora.rank
            self.lora_down = nn.Parameter(torch.randn(n, in_features, r) / r)
            self.lora_up = nn.Parameter(torch.zeros(n, r, out_features))

    def forward(self, x, lora_idx: LoraIdx = None):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.linear(x, self.weight.to(x.dtype), b)
        if self.lora is None:
            return y
        z = (x @ _take(self.lora_down, lora_idx).to(x.dtype)) @ _take(
            self.lora_up, lora_idx).to(x.dtype)
        if self.lora.network_alpha is not None:
            z = z * (self.lora.network_alpha / self.lora.rank)
        return y + z


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


def zero_(layer: nn.Module) -> nn.Module:
    """Zero a layer's weight and bias in place: the JAX package's zeros
    kernel_init (its biases start at zero everywhere)."""
    nn.init.zeros_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def _affine(channels: int, n_banks: int):
    """Norm affine parameters: [C], or an [n_banks, C] switchable bank."""
    shape = (n_banks, channels) if n_banks > 0 else (channels,)
    return nn.Parameter(torch.ones(shape)), nn.Parameter(torch.zeros(shape))


class ZeroConv(Conv):
    """A control tap's 1x1 conv, zero-initialised as JAX's (so a fresh
    control branch adds nothing), `channels` in and `out_channels` (default
    `channels`) out; with ``n_banks`` its weight [n, co, ci, 1, 1] and bias
    [n, co] are a switchable bank selected per call by ``bank_idx`` (the
    JAX ``ZeroConv``)."""

    def __init__(self, channels: int, n_banks: int = 0, out_channels: Optional[int] = None):
        super().__init__(channels, channels if out_channels is None else out_channels,
                         kernel_size=1)
        zero_(self)
        self.n_banks = n_banks
        if n_banks:
            self.weight = nn.Parameter(self.weight.detach()[None].repeat(n_banks, 1, 1, 1, 1))
            self.bias = nn.Parameter(self.bias.detach()[None].repeat(n_banks, 1))

    def forward(self, x, bank_idx: LoraIdx = None):
        if not self.n_banks:
            return super().forward(x)
        b = _take(self.bias, bank_idx).to(x.dtype)
        return self._conv_forward(x, _take(self.weight, bank_idx).to(x.dtype), b)


class GroupNorm32(nn.Module):
    """GroupNorm in fp32 over NCHW channels-last x, with the SiLU that
    follows most norms fused and an optional row folded in: computes
    GN(x + add_row) for add_row [C]/[1, C]/[B, C] without building the sum
    (kernel A or A2, ``ops/group_norm.py``). With ``n_banks`` the affine is
    a switchable [n, C] bank, selected per call by ``bank_idx``."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False, n_banks: int = 0):
        super().__init__()
        self.weight, self.bias = _affine(channels, n_banks)
        self.n_banks = n_banks
        # real models have C % 32 == 0; tiny test widths take the largest
        # group count that divides C, as the JAX layer does
        self.num_groups = (num_groups if channels % num_groups == 0
                           else math.gcd(channels, num_groups))
        self.eps = eps
        self.silu = silu

    def forward(self, x, add_row: Optional[torch.Tensor] = None, bank_idx: LoraIdx = None):
        x = x.contiguous(memory_format=CL)
        w, b = self.weight, self.bias
        if self.n_banks:
            w, b = _take(w, bank_idx), _take(b, bank_idx)
        y = gn_ops.group_norm(x.permute(0, 2, 3, 1), w, b, self.num_groups, self.eps,
                              self.silu, add_row)
        return y.permute(0, 3, 1, 2)


class LayerNorm32(nn.Module):
    """LayerNorm in fp32 over the last axis (eps 1e-5), plain; optionally a
    switchable [n, C] bank as :class:`GroupNorm32`."""

    def __init__(self, channels: int, eps: float = 1e-5, n_banks: int = 0):
        super().__init__()
        self.weight, self.bias = _affine(channels, n_banks)
        self.n_banks = n_banks
        self.eps = eps

    def forward(self, x, bank_idx: LoraIdx = None):
        w, b = self.weight, self.bias
        if self.n_banks:
            w, b = _take(w, bank_idx), _take(b, bank_idx)
        y = F.layer_norm(x.float(), (x.shape[-1],), w, b, self.eps)
        return y.to(x.dtype)


class TimestepEmbed(nn.Module):
    """Sinusoidal embedding -> Dense -> SiLU -> Dense (LoRA sites in the
    control branch)."""

    def __init__(self, model_channels: int, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.model_channels = model_channels
        self.dense0 = Dense(model_channels, 4 * model_channels, lora=lora)
        self.dense1 = Dense(4 * model_channels, 4 * model_channels, lora=lora)

    def forward(self, timesteps, dtype, lora_idx: LoraIdx = None):
        emb = timestep_embedding(timesteps, self.model_channels).to(dtype)
        return self.dense1(F.silu(self.dense0(emb, lora_idx)), lora_idx)


class LabelEmbed(nn.Module):
    """The vector y [B, in] -> Dense -> SiLU -> Dense [B, dim] (SDXL's
    ``label_emb``), added onto the time embedding."""

    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.dense0 = Dense(in_channels, dim)
        self.dense1 = Dense(dim, dim)

    def forward(self, y, dtype):
        return self.dense1(F.silu(self.dense0(y.to(dtype))))


class ResBlock(nn.Module):
    """UNet residual block. The emb_proj row ([B, C] from ``emb``, or the
    precomputed [1, C] ``emb_row`` of the samplers) folds into out_norm's
    statistics instead of being added to h; its gradient flows back through
    the GroupNorm's add_row. emb_proj is a LoRA site in the control branch.
    out_conv starts at zero, as in JAX, so a fresh block is the identity
    (or its skip conv)."""

    def __init__(self, cin: int, cout: int, emb_dim: int, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.in_norm = GroupNorm32(cin, silu=True)
        self.in_conv = Conv(cin, cout)
        self.emb_proj = Dense(emb_dim, cout, lora=lora)
        self.out_norm = GroupNorm32(cout, silu=True)
        self.out_conv = zero_(Conv(cout, cout))
        self.skip = Conv(cin, cout, kernel_size=1) if cin != cout else None

    def forward(self, x, emb=None, emb_row=None, lora_idx: LoraIdx = None):
        h = self.in_conv(self.in_norm(x))
        if emb_row is None:
            emb_row = self.emb_proj(F.silu(emb), lora_idx)
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
