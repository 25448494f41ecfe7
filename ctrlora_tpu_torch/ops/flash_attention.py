"""Unmasked softmax attention: CUDA flash-attention forward and plain version.

Kernel B of the port (``csrc/flash_attention.cu``, CUDA C++ for sm_90a). It
replaces the TPU kernels ``ctrlora_tpu/ops/flash_attention.py``
``_fwd_kernel_packed_qkv`` (UNet/ControlNet self-attention read straight
from the fused [B, S, 3*H*D] projection) and ``_fwd_kernel`` (the VAE's
[B, H, S, D] single-head attention). The source note in the .cu file says
what bounds it and how it is built. Two wrappers, one per call site, launch
the same kernel with different strides; each counts its own launches.

Dispatch follows the JAX package (``dot_product_attention`` and
``dot_product_attention_bshd_qkv``): the kernel only where Sk >= 256 and the
sequences tile by 128; cross-attention over 77 text tokens and the 8x8
mid-block self-attention stay plain.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ctrlora_tpu_torch.ops import _build


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, S, D] attention as the JAX ``xla_attention``: fp32 logits and
    softmax, probabilities cast to v's dtype for the PV product. Also
    returns the fp32 natural-log logsumexp [B, H, Sq]. The plain version
    of :func:`flash_attention`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype), v).to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_qkv_plain(qkv: torch.Tensor, heads: int, dim_head: int,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_qkv`: split, then
    :func:`attention_plain`."""
    b, s, _ = qkv.shape
    q, k, v = (t.reshape(b, s, heads, dim_head).transpose(1, 2)
               for t in qkv.split(heads * dim_head, dim=-1))
    out, lse = attention_plain(q, k, v, scale)
    return out.transpose(1, 2).reshape(b, s, heads * dim_head), lse


def _launch(q, k, v, out, lse, b, h, sq, sk, d, qst, kst, vst, ost, scale, what):
    lib = _build.cuda_lib()
    code = lib.ctrlora_flash_fwd(q, k, v, out.data_ptr(), lse.data_ptr(),
                                 b, h, sq, sk, d, *qst, *kst, *vst, *ost,
                                 float(scale), _build.stream_ptr(out.device))
    _build.check(code, what)


def _check_aligned(what: str, ptrs, strides, d: int) -> None:
    if d % 8 or d > 512:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8 and <= 512")
    if any(p % 16 for p in ptrs) or any(s % 8 for s in strides):
        raise ValueError(f"{what}: operands must be 16-byte aligned (pointers "
                         f"{[p % 16 for p in ptrs]}, strides {list(strides)})")


def flash_attention_qkv(qkv: torch.Tensor, heads: int, dim_head: int,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention off the fused projection qkv [B, S, 3*H*D] (q | k | v
    on the last axis). Returns (out [B, S, H*D], lse [B, H, S] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(dim_head)
    b, s, hd3 = qkv.shape
    hd = heads * dim_head
    if hd3 != 3 * hd:
        raise ValueError(f"flash_attention_qkv: width {hd3} != 3*{heads}*{dim_head}")
    if qkv.device.type == "cpu":
        return flash_attention_qkv_plain(qkv, heads, dim_head, scale)
    if qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv: needs a contiguous bf16 CUDA tensor")
    base, esz = qkv.data_ptr(), qkv.element_size()
    _check_aligned("flash_attention_qkv", (base, base + hd * esz, base + 2 * hd * esz),
                   (hd3, dim_head), dim_head)
    out = torch.empty((b, s, hd), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty((b, heads, s), device=qkv.device, dtype=torch.float32)
    qst = (s * hd3, hd3, dim_head)  # (batch, sequence, head) strides
    ost = (s * hd, hd, dim_head)
    _launch(base, base + hd * esz, base + 2 * hd * esz, out, lse, b, heads, s, s,
            dim_head, qst, qst, qst, ost, scale, "flash_attention_qkv")
    flash_attention_qkv.launches += 1
    return out, lse


flash_attention_qkv.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, S, D] attention (any strides with a unit last stride).
    Returns (out [B, H, Sq, D], lse [B, H, Sq] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (q.device.type != "cuda" or any(t.dtype != torch.bfloat16 for t in (q, k, v))
            or any(t.stride(-1) != 1 for t in (q, k, v))):
        raise ValueError("flash_attention: needs bf16 CUDA tensors with unit last stride")
    strides = [t.stride(i) for t in (q, k, v) for i in (0, 2, 1)]
    _check_aligned("flash_attention", [t.data_ptr() for t in (q, k, v)], strides, d)
    out = torch.empty((b, h, sq, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, lse, b, h, sq, sk, d,
            strides[0:3], strides[3:6], strides[6:9],
            (out.stride(0), out.stride(2), out.stride(1)), scale, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def _tiles(s: int) -> bool:
    return s >= 128 and s % 128 == 0


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          use_flash: bool = True) -> torch.Tensor:
    """[B, H, S, D] attention; the kernel when Sk >= 256 and both sequences
    tile, else the plain version (the JAX dispatch rule)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    if use_flash and sk >= 256 and _tiles(sq) and _tiles(sk):
        return flash_attention(q, k, v, scale)[0]
    return attention_plain(q, k, v, scale)[0]


def dot_product_attention_bshd_qkv(qkv, heads: int, dim_head: int,
                                   scale: Optional[float] = None,
                                   use_flash: bool = True) -> torch.Tensor:
    """Self-attention off the fused projection [B, S, 3*H*D] -> [B, S, H*D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(dim_head)
    s = qkv.shape[1]
    if use_flash and s >= 256 and _tiles(s):
        return flash_attention_qkv(qkv, heads, dim_head, scale)[0]
    return flash_attention_qkv_plain(qkv, heads, dim_head, scale)[0]
