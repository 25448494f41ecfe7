"""Spatial transformer stack of the port: fused-qkv self-attention, plain
cross-attention, GEGLU feed-forward (counterpart of
``ctrlora_tpu/models/attention.py`` on its fused, LoRA-free path).

Self-attention is ONE projection dot with the concatenated [to_q | to_k |
to_v] weight, whose [B, S, 3*H*D] output the flash kernel reads directly
(kernel B). The concatenation is made once by ``fuse_projections`` (called
from ``lora_fuse.cast_params_for_inference``); until then it is made per
call. The feed-forward hands its ``proj``/``out`` weights to the fused GEGLU
kernel (kernel C).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.models.layers import CL, Conv, Dense, GroupNorm32, LayerNorm32
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import geglu_ffn as geglu_ops


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, use_flash: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.use_flash = heads, dim_head, use_flash
        self.is_self = context_dim is None
        cdim = query_dim if context_dim is None else context_dim
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(cdim, inner, bias=False)
        self.to_v = Dense(cdim, inner, bias=False)
        self.to_out = Dense(inner, query_dim)
        self.wqkv: Optional[torch.Tensor] = None  # not a parameter: derived

    def fuse_projections(self) -> None:
        """Concatenate the self-attention q|k|v weights once (after the
        weights are final)."""
        if self.is_self:
            self.wqkv = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])

    def forward(self, x, context=None):
        b, s, _ = x.shape
        h, d = self.heads, self.dim_head
        if context is None:
            w = self.wqkv
            if w is None:
                w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
            qkv = F.linear(x, w.to(x.dtype))
            out = fa_ops.dot_product_attention_bshd_qkv(qkv, h, d, use_flash=self.use_flash)
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

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = Dense(dim, 2 * inner)
        self.out = Dense(inner, dim)

    def forward(self, x):
        args = (x.contiguous(), self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype),
                self.out.weight.to(x.dtype), self.out.bias.to(x.dtype))
        if geglu_ops.geglu_shapes_ok(*args):
            return geglu_ops.geglu_ffn(*args)
        return geglu_ops.geglu_ffn_plain(*args)


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention -> cross-attention -> feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int],
                 use_flash: bool = True):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head, use_flash=use_flash)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim,
                                    use_flash=use_flash)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, plus
    the input (use_linear=False)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_flash: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv(channels, inner, kernel_size=1)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, use_flash=use_flash))
        self.proj_out = Conv(inner, channels, kernel_size=1)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        x_in = x
        x = self.proj_in(self.norm(x)).contiguous(memory_format=CL)
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, inner)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context)
        x = x.reshape(b, hh, ww, inner).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in
