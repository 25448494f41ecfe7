"""Spatial transformer stack of the port: self- and cross-attention, GEGLU
feed-forward (counterpart of ``ctrlora_tpu/models/attention.py``).

Without LoRA, self-attention is ONE projection dot with the concatenated
[to_q | to_k | to_v] weight, whose [B, S, 3*H*D] output the flash kernel
reads directly (kernel B, fused-qkv entry). The concatenation is made once
by ``fuse_projections`` (called from ``lora_fuse.cast_params_for_inference``);
until then it is made per call. The feed-forward hands its ``proj``/``out``
weights to the fused GEGLU kernel (kernel C).

With LoRA (the unfused control tree of training), q, k and v are separate
LoRA ``Dense`` projections and self-attention reads them through the
kernel's BSHD entry; the feed-forward is LoRA ``Dense`` -> split -> exact
GELU gate -> LoRA ``Dense`` with no kernel, as in JAX. With switchable banks
the transformer's norms are [n, C] banks selected by ``lora_idx``.

Two ``CTRLORA_KERNELS`` tokens change the self-attention path without LoRA,
as in the JAX ``CrossAttention``: ``qkvpack=0`` splits the fused projection
into strided [B, S, H, D] views for the BSHD dispatcher (which takes kernel
B6 under ``hpack=2``), and ``fuse_qkv=0`` issues three projections.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import LoRAConfig
from ctrlora_tpu_torch.models.layers import (
    CL, Conv, Dense, GroupNorm32, LayerNorm32, LoraIdx, has_lora, n_banks,
)
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import geglu_ffn as geglu_ops
from ctrlora_tpu_torch.ops import kernel_flags


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, use_flash: bool = True,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.use_flash = heads, dim_head, use_flash
        self.is_self = context_dim is None
        self.lora = has_lora(lora)
        cdim = query_dim if context_dim is None else context_dim
        self.to_q = Dense(query_dim, inner, bias=False, lora=lora)
        self.to_k = Dense(cdim, inner, bias=False, lora=lora)
        self.to_v = Dense(cdim, inner, bias=False, lora=lora)
        self.to_out = Dense(inner, query_dim, lora=lora)
        self.wqkv: Optional[torch.Tensor] = None  # not a parameter: derived

    def fuse_projections(self) -> None:
        """Concatenate the self-attention q|k|v weights once (after the
        weights are final)."""
        if self.is_self and not self.lora:
            self.wqkv = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])

    def forward(self, x, context=None, lora_idx: LoraIdx = None):
        b, s, _ = x.shape
        h, d = self.heads, self.dim_head
        if self.lora:
            ctx = x if context is None else context
            heads4 = lambda t: t.unflatten(-1, (h, d))  # [B, S, H, D] view
            out = fa_ops.dot_product_attention_bshd(
                heads4(self.to_q(x, lora_idx)), heads4(self.to_k(ctx, lora_idx)),
                heads4(self.to_v(ctx, lora_idx)), use_flash=self.use_flash)
            return self.to_out(out, lora_idx)
        if context is None:
            fl = kernel_flags.flags()
            if fl.fuse_qkv is not False:
                w = self.wqkv
                if w is None:
                    w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
                qkv = F.linear(x, w.to(x.dtype))
                if fl.attn_qkv_packed is not False:
                    out = fa_ops.dot_product_attention_bshd_qkv(qkv, h, d,
                                                                use_flash=self.use_flash)
                    return self.to_out(out)
                q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
            else:
                q, k, v = (p(x).unflatten(-1, (h, d)) for p in (self.to_q, self.to_k, self.to_v))
            out = fa_ops.dot_product_attention_bshd(q, k, v, use_flash=self.use_flash)
        else:
            heads4 = lambda t: t.reshape(b, t.shape[1], h, d).transpose(1, 2)
            q = heads4(self.to_q(x))
            k = heads4(self.to_k(context))
            v = heads4(self.to_v(context))
            out = fa_ops.dot_product_attention(q, k, v, use_flash=self.use_flash)
            out = out.transpose(1, 2).reshape(b, s, h * d)
        return self.to_out(out)


class FeedForward(nn.Module):
    """GEGLU feed-forward: proj (C -> 2F), a * gelu(g), out (F -> C)."""

    def __init__(self, dim: int, mult: int = 4, lora: Optional[LoRAConfig] = None):
        super().__init__()
        inner = dim * mult
        self.lora = has_lora(lora)
        self.proj = Dense(dim, 2 * inner, lora=lora)
        self.out = Dense(inner, dim, lora=lora)

    def forward(self, x, lora_idx: LoraIdx = None):
        if self.lora:
            a, gate = self.proj(x, lora_idx).chunk(2, dim=-1)
            return self.out(a * F.gelu(gate), lora_idx)
        args = (x.contiguous(), self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype),
                self.out.weight.to(x.dtype), self.out.bias.to(x.dtype))
        if geglu_ops.geglu_kernel_ok(*args):
            return geglu_ops.geglu_ffn(*args)
        return geglu_ops.geglu_ffn_plain(*args)


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention -> cross-attention -> feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int],
                 use_flash: bool = True, lora: Optional[LoRAConfig] = None):
        super().__init__()
        banks = n_banks(lora)
        self.norm1 = LayerNorm32(dim, n_banks=banks)
        self.attn1 = CrossAttention(dim, heads, dim_head, use_flash=use_flash, lora=lora)
        self.norm2 = LayerNorm32(dim, n_banks=banks)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim,
                                    use_flash=use_flash, lora=lora)
        self.norm3 = LayerNorm32(dim, n_banks=banks)
        self.ff = FeedForward(dim, lora=lora)

    def forward(self, x, context, lora_idx: LoraIdx = None):
        x = x + self.attn1(self.norm1(x, lora_idx), lora_idx=lora_idx)
        x = x + self.attn2(self.norm2(x, lora_idx), context, lora_idx)
        return x + self.ff(self.norm3(x, lora_idx), lora_idx)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, plus
    the input (use_linear=False)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_flash: bool = True,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6, n_banks=n_banks(lora))
        self.proj_in = Conv(channels, inner, kernel_size=1)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, use_flash=use_flash, lora=lora))
        self.proj_out = Conv(inner, channels, kernel_size=1)

    def forward(self, x, context, lora_idx: LoraIdx = None):
        b, c, hh, ww = x.shape
        x_in = x
        x = self.proj_in(self.norm(x, bank_idx=lora_idx)).contiguous(memory_format=CL)
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, inner)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context, lora_idx)
        x = x.reshape(b, hh, ww, inner).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in
