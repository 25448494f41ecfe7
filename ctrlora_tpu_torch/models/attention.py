"""Spatial transformer stack of the port: self- and cross-attention, GEGLU
feed-forward (counterpart of ``ctrlora_tpu/models/attention.py``).

Without LoRA, self-attention is ONE projection dot with the concatenated
[to_q | to_k | to_v] weight, whose [B, S, 3*H*D] output the flash kernel
reads directly (kernel B, fused-qkv entry). The concatenation is made once
by ``fuse_projections`` (called from ``lora_fuse.cast_params_for_inference``);
until then, and again after a ``load_state_dict`` into the site (which
drops the derived weights), it is made per call. The cache is for
inference: the trainers never make it, so their gradients reach the
projections' own weights. The feed-forward hands its ``proj``/``out``
weights to the fused GEGLU kernel (kernel C).

With LoRA (the unfused control tree of training), q, k and v are separate
LoRA ``Dense`` projections and self-attention reads them through the
kernel's BSHD entry; the feed-forward is LoRA ``Dense`` -> split -> exact
GELU gate -> LoRA ``Dense`` with no kernel, as in JAX. With switchable banks
the transformer's norms are [n, C] banks selected by ``lora_idx``.

Without LoRA a cross-attention's k and v are likewise ONE product of the
text context with the concatenated [to_k | to_v] weight (``project_kv``;
``fuse_projections`` caches the weight), split into k and v. The samplers
hoist that product out of their step loops: ``CtrLoraPipeline.xattn_kv_tables``
makes it once per site and the site takes it as ``kv`` (JAX's ``kv``
argument), the same product of the same operands, so the output is the
same. ``kv`` raises on a self-attention, a LoRA or an image-prompt site.

Two ``CTRLORA_KERNELS`` tokens change the self-attention path without LoRA,
as in the JAX ``CrossAttention``: ``qkvpack=0`` splits the fused projection
into strided [B, S, H, D] views for the BSHD dispatcher (which takes kernel
B6 under ``hpack=2``), and ``fuse_qkv=0`` issues three projections.

Under ``parallel.tp.tensor_parallel`` (read at call time) a site whose
heads divide tp computes only this model rank's heads (separate local q, k,
v products, no fused q|k|v entry; a cross-attention without LoRA takes its
local k|v rows in one product, or as ``kv``, a table made under the same
context) and its slice of ``to_out``, with one all-reduce; a feed-forward
computes its slice of the hidden (no kernel C) the same way. A site whose
heads do not divide runs whole through the plain attention, as JAX's XLA
path. Outside the context nothing changes.

With ``ip_tokens`` (the IP-Adapter, reference attention_ip.py:196-289) a
cross-attention's context is [text | image]: the last ``ip_tokens`` rows go
through the bias-free ``to_k_ip`` / ``to_v_ip`` and are attended by the same
queries through the plain attention (JAX runs this 4-token branch outside
Pallas too), added as ``ip_scale`` (an fp32 scalar cast to the output's
dtype, as JAX's) times that output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import LoRAConfig
from ctrlora_tpu_torch.models.layers import (
    CL, Conv, Dense, GroupNorm32, LayerNorm32, LoraIdx, has_lora, n_banks, zero_,
)
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import geglu_ffn as geglu_ops
from ctrlora_tpu_torch.ops import kernel_flags
from ctrlora_tpu_torch.parallel import tp


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default Dense kernel init on an [out, in] weight: a normal of
    variance 1/in truncated at two standard deviations."""
    std = weight.shape[1] ** -0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, use_flash: bool = True,
                 lora: Optional[LoRAConfig] = None, ip_tokens: int = 0):
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
        self.wqkv: Optional[torch.Tensor] = None  # not parameters: derived
        self.wkv: Optional[torch.Tensor] = None
        self.register_load_state_dict_pre_hook(CrossAttention._drop_fused)
        self.ip_tokens = 0 if self.is_self else ip_tokens
        if self.ip_tokens:
            self.to_k_ip = Dense(cdim, inner, bias=False)
            self.to_v_ip = Dense(cdim, inner, bias=False)
            with torch.no_grad():
                lecun_normal_(self.to_k_ip.weight)
                lecun_normal_(self.to_v_ip.weight)
            self.ip_scale = nn.Parameter(torch.ones(()))

    def fuse_projections(self) -> None:
        """Concatenate the self-attention q|k|v weights, or the
        cross-attention k|v weights, once (after the weights are final)."""
        if self.lora:
            return
        if self.is_self:
            self.wqkv = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
        else:
            self.wkv = torch.cat([self.to_k.weight, self.to_v.weight])

    @staticmethod
    def _drop_fused(module, *_) -> None:
        """Before a state dict loads into the site: the concatenated
        weights would go stale, so they go (``fuse_projections`` makes them
        again)."""
        module.wqkv = module.wkv = None

    def kv_cols(self) -> Optional[Tuple[int, int]]:
        """The [lo, hi) of the inner dim that this site's k and v hold under
        tensor parallelism (this rank's heads), None where they are whole."""
        heads = tp.local_range(self.heads)
        return None if heads is None else (heads[0] * self.dim_head, heads[1] * self.dim_head)

    def project_kv(self, context: torch.Tensor, cols: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
        """The cross-attention's k|v [B, Sk, 2*inner] (inner: the columns
        `cols` of each where given) of the text context, in ONE product with
        the concatenated weight, in the context's dtype (JAX's
        ``ctx @ [wk|wv]``). LoRA sites have no such product."""
        if self.is_self or self.lora:
            raise ValueError("project_kv: only a cross-attention without LoRA has a fused "
                             "k|v product")
        w = self.wkv
        if w is None:
            w = torch.cat([self.to_k.weight, self.to_v.weight])
        if cols is not None:
            inner, (lo, hi) = self.heads * self.dim_head, cols
            w = torch.cat([w[lo:hi], w[inner + lo:inner + hi]])
        return F.linear(context, w.to(context.dtype))

    def forward(self, x, context=None, lora_idx: LoraIdx = None,
                kv: Optional[torch.Tensor] = None):
        """`kv`: this site's hoisted k|v, ``project_kv`` of this `context`
        made before the sampler's loop (under tensor parallelism, of this
        rank's columns, as ``kv_cols`` gives them)."""
        b, s, _ = x.shape
        h, d = self.heads, self.dim_head
        if kv is not None and (self.is_self or context is None or self.lora
                               or self.ip_tokens):
            raise ValueError("a hoisted kv applies only to a plain cross-attention: no "
                             "self-attention, LoRA or image-prompt tokens")
        ip_ctx = None
        if self.ip_tokens:  # context = [text tokens | image-prompt tokens]
            n = context.shape[1] - self.ip_tokens
            context, ip_ctx = context[:, :n], context[:, n:]
        # under tensor parallelism: this rank's heads, or (heads % tp != 0)
        # the whole site through the plain attention, as JAX's XLA path
        use_flash = self.use_flash and tp.active() is None
        heads = tp.local_range(h)
        if heads is not None:
            return self._forward_split(x, context, ip_ctx, lora_idx, *heads, kv=kv)
        if self.lora:
            ctx = x if context is None else context
            heads4 = lambda t: t.unflatten(-1, (h, d))  # [B, S, H, D] view
            q = self.to_q(x, lora_idx)
            out = fa_ops.dot_product_attention_bshd(
                heads4(q), heads4(self.to_k(ctx, lora_idx)),
                heads4(self.to_v(ctx, lora_idx)), use_flash=use_flash)
            return self.to_out(self._add_ip(out, q, ip_ctx), lora_idx)
        if context is None:
            fl = kernel_flags.flags()
            if fl.fuse_qkv is not False:
                w = self.wqkv
                if w is None:
                    w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
                qkv = F.linear(x, w.to(x.dtype))
                if fl.attn_qkv_packed is not False:
                    out = fa_ops.dot_product_attention_bshd_qkv(qkv, h, d, use_flash=use_flash)
                    return self.to_out(out)
                q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
            else:
                q, k, v = (p(x).unflatten(-1, (h, d)) for p in (self.to_q, self.to_k, self.to_v))
            out = fa_ops.dot_product_attention_bshd(q, k, v, use_flash=use_flash)
        else:
            heads4 = lambda t: t.reshape(b, t.shape[1], h, d).transpose(1, 2)
            q = self.to_q(x)
            k, v = (self.project_kv(context) if kv is None else kv).chunk(2, dim=-1)
            out = fa_ops.dot_product_attention(heads4(q), heads4(k), heads4(v),
                                               use_flash=use_flash)
            out = self._add_ip(out.transpose(1, 2).reshape(b, s, h * d), q, ip_ctx)
        return self.to_out(out)

    def _forward_split(self, x, context, ip_ctx, lora_idx, h0: int, h1: int, kv=None):
        """The site on this model rank's heads [h0, h1) (``parallel.tp``):
        local q, k, v rows (no fused q|k|v product; a cross-attention
        without LoRA takes its local k|v in one product, or as `kv`),
        attention on the local heads through the BSHD dispatch, a partial
        ``to_out`` over the local columns, one all-reduce over the model
        group, then the bias."""
        d = self.dim_head
        lo, hi = h0 * d, h1 * d
        x = tp.copy_to_model(x)
        ctx = x if context is None else tp.copy_to_model(context)
        (q,) = tp.split_dense(self.to_q, x, [(lo, hi)], lora_idx)
        if context is not None and not self.lora:
            tp.mark_split(self.to_k.weight, self.to_v.weight)
            k, v = (self.project_kv(ctx, (lo, hi)) if kv is None else kv).chunk(2, dim=-1)
        else:
            (k,) = tp.split_dense(self.to_k, ctx, [(lo, hi)], lora_idx)
            (v,) = tp.split_dense(self.to_v, ctx, [(lo, hi)], lora_idx)
        heads4 = lambda t: t.unflatten(-1, (h1 - h0, d))
        out = fa_ops.dot_product_attention_bshd(heads4(q), heads4(k), heads4(v),
                                                use_flash=self.use_flash)
        out = self._add_ip(out, q, None if ip_ctx is None else tp.copy_to_model(ip_ctx),
                           (lo, hi))
        y = tp.reduce_from_model(tp.contract_dense(self.to_out, out, lo, hi, lora_idx))
        return y + self.to_out.bias.to(y.dtype)

    def _add_ip(self, out, q, ip_ctx, cols=None):
        """out [B, S, H*D] plus the image-prompt branch over ip_ctx with the
        queries q [B, S, H*D] (out unchanged without image tokens); `cols`:
        the [lo, hi) of the inner dim that q and out hold under tensor
        parallelism."""
        if ip_ctx is None:
            return out
        b, s, inner = q.shape
        heads4 = lambda t: t.reshape(b, t.shape[1], inner // self.dim_head,
                                     self.dim_head).transpose(1, 2)
        if cols is None:
            k, v = self.to_k_ip(ip_ctx), self.to_v_ip(ip_ctx)
        else:
            (k,), (v,) = (tp.split_dense(p, ip_ctx, [cols]) for p in (self.to_k_ip, self.to_v_ip))
            tp.mark_split(self.ip_scale)
        out_ip = fa_ops.attention_plain(heads4(q), heads4(k), heads4(v))[0]
        out_ip = out_ip.transpose(1, 2).reshape(b, s, -1)
        return out + self.ip_scale.to(out.dtype) * out_ip


class FeedForward(nn.Module):
    """GEGLU feed-forward: proj (C -> 2F), a * gelu(g), out (F -> C)."""

    def __init__(self, dim: int, mult: int = 4, lora: Optional[LoRAConfig] = None):
        super().__init__()
        inner = dim * mult
        self.lora = has_lora(lora)
        self.proj = Dense(dim, 2 * inner, lora=lora)
        self.out = Dense(inner, dim, lora=lora)

    def forward(self, x, lora_idx: LoraIdx = None):
        part = tp.local_range(self.out.in_features)
        if part is not None:  # tensor parallelism: this rank's hidden slice
            lo, hi = part
            f = self.out.in_features
            a, gate = tp.split_dense(self.proj, tp.copy_to_model(x), [(lo, hi), (f + lo, f + hi)],
                                     lora_idx)
            y = tp.reduce_from_model(tp.contract_dense(self.out, a * F.gelu(gate), lo, hi,
                                                       lora_idx))
            return y + self.out.bias.to(y.dtype)
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
                 use_flash: bool = True, lora: Optional[LoRAConfig] = None,
                 ip_tokens: int = 0):
        super().__init__()
        banks = n_banks(lora)
        self.norm1 = LayerNorm32(dim, n_banks=banks)
        self.attn1 = CrossAttention(dim, heads, dim_head, use_flash=use_flash, lora=lora)
        self.norm2 = LayerNorm32(dim, n_banks=banks)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim,
                                    use_flash=use_flash, lora=lora, ip_tokens=ip_tokens)
        self.norm3 = LayerNorm32(dim, n_banks=banks)
        self.ff = FeedForward(dim, lora=lora)

    def forward(self, x, context, lora_idx: LoraIdx = None, kv: Optional[torch.Tensor] = None):
        """`kv`: the cross-attention's hoisted k|v (``CrossAttention.forward``)."""
        x = x + self.attn1(self.norm1(x, lora_idx), lora_idx=lora_idx)
        x = x + self.attn2(self.norm2(x, lora_idx), context, lora_idx, kv=kv)
        return x + self.ff(self.norm3(x, lora_idx), lora_idx)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, plus
    the input; with ``use_linear`` (SDXL) proj_in and proj_out are Linear
    layers on the [B, HW, C] rows instead. proj_out starts at zero, as in
    JAX."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_flash: bool = True,
                 lora: Optional[LoRAConfig] = None, ip_tokens: int = 0,
                 use_linear: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.use_linear = use_linear
        self.norm = GroupNorm32(channels, eps=1e-6, n_banks=n_banks(lora))
        proj = (lambda i, o: Dense(i, o)) if use_linear else (lambda i, o: Conv(i, o, 1))
        self.proj_in = proj(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, use_flash=use_flash, lora=lora,
                ip_tokens=ip_tokens))
        self.proj_out = zero_(proj(inner, channels))

    def forward(self, x, context, lora_idx: LoraIdx = None, kv_rows=None):
        """`kv_rows`: one hoisted cross-attention k|v per block (depth), as
        ``CtrLoraPipeline.xattn_kv_tables`` gives them, or None."""
        b, c, hh, ww = x.shape
        x_in = x
        x = self.norm(x, bank_idx=lora_idx)
        if self.use_linear:  # the channels-last rows are a free [B, HW, C] view
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            x = self.proj_in(x).contiguous(memory_format=CL)
            x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, x.shape[1])
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context, lora_idx,
                                            None if kv_rows is None else kv_rows[i])
        if self.use_linear:
            return self.proj_out(x).reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x_in
        x = x.reshape(b, hh, ww, x.shape[-1]).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in
