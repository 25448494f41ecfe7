"""Unmasked softmax attention: CUDA flash-attention forward and backward,
their plain versions, and the autograd Functions that join them.

Kernel B of the port (``csrc/flash_attention.cu``, wgmma on TMA-loaded
tiles for sm_90a: ``flash_fwd_wgmma`` at D = 8/16/32/40/64/80/128/160,
``flash_fwd_wide`` at D = 512) replaces the TPU forward kernels
``ctrlora_tpu/ops/flash_attention.py`` ``_fwd_kernel_packed_qkv`` (UNet/
ControlNet self-attention read straight from the fused [B, S, 3*H*D]
projection), ``_fwd_kernel_packed`` (separate q, k, v in the projections'
[B, S, H, D] layout: the LoRA control branch) and ``_fwd_kernel`` (the VAE's
[B, H, S, D] single-head attention). The backward kernels
(``csrc/flash_attention_bwd.cu``) replace ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``. Kernel B6 (``csrc/flash_attention_hpack2.cu``, wgmma
on TMA-loaded tiles, :func:`flash_attention_hpack2`, tiled by
:func:`hpack2_plan`) replaces ``_fwd_kernel_hpack2``, the head-pair forward
with the skip-max softmax, which the BSHD dispatcher takes under
``CTRLORA_KERNELS=hpack=2`` where the heads pair and 2*D <= 128. The
source notes in the .cu files say what bounds them and how they are built.
Every other entry launches the same forward kernel with its own strides
(computed from the shapes, not from views), and all share the one pair of
backward kernels; each wrapper counts its own launches. Head dims and
sequence lengths the forward kernel has no instantiation for raise on CUDA
tensors (:func:`forward_tiles`).

Each forward entry is a ``torch.autograd.Function`` saving (q, k, v, out,
lse); its backward computes Delta = rowsum(dO * O) in fp32 and launches the
dQ and dK/dV kernels (on CPU tensors: their plain versions), so a kernel
output carries its gradient like any torch op. :func:`flash_forward_work`, :func:`flash_bwd_dq_work` and
:func:`flash_bwd_dkv_work` count the flops and bytes each function needs.

Dispatch follows the JAX package (``dot_product_attention``,
``dot_product_attention_bshd``, ``dot_product_attention_bshd_qkv``): the
kernel only where Sk >= 256 and the sequences tile by 128; cross-attention
over 77 text tokens and the 8x8 mid-block self-attention stay plain. The
rule (:func:`flash_kernel_ok`) is a pure function of dtypes and shapes: it
also admits only bf16 operands at a head dim the forward kernel has (and,
where a gradient will flow, one the backward kernels have); anything else,
an fp32 VAE for one, takes the plain version. An admitted CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from ctrlora_tpu_torch.ops import _build, kernel_flags, takes_plain

LOG2E = 1.4426950408889634
KERNEL_DTYPES = (torch.bfloat16,)  # the operand dtypes the kernels take
# the backward kernels' instantiations: the finetune sites, and the XS control stream's
BWD_HEAD_DIMS = (8, 16, 32, 40, 80, 160)
BWD_SEQ_MULTIPLE = 128  # Sq and Sk must be multiples of it for the backward kernels
TMA_BOX = 64  # columns of a full TMA box (128 bf16 bytes)


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


def flash_forward_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int = 2) -> tuple:
    """(flops, bytes) of the forward: the two products, 4*B*H*Sq*Sk*D;
    q, k, v read once, out and the fp32 lse written once."""
    return (4 * b * h * sq * sk * d,
            b * h * ((2 * sq + 2 * sk) * d * itemsize + sq * 4))


def flash_bwd_dq_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int = 2) -> tuple:
    """(flops, bytes) of dQ: S = QK^T, dP = dO V^T and dS K, 6*B*H*Sq*Sk*D;
    q, k, v, dO, lse and Delta read once, dQ written once."""
    return (6 * b * h * sq * sk * d,
            b * h * ((3 * sq + 2 * sk) * d * itemsize + 2 * sq * 4))


def flash_bwd_dkv_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int = 2) -> tuple:
    """(flops, bytes) of dK/dV: S, dP, P^T dO and dS^T Q, 8*B*H*Sq*Sk*D;
    q, k, v, dO, lse and Delta read once, dK and dV written once."""
    return (8 * b * h * sq * sk * d,
            b * h * ((2 * sq + 4 * sk) * d * itemsize + 2 * sq * 4))


def _bhsd(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_bshd`: transpose, then
    :func:`attention_plain`."""
    b, s, h, d = q.shape
    out, lse = attention_plain(_bhsd(q), _bhsd(k), _bhsd(v), scale)
    return _bhsd(out).reshape(b, s, h * d), lse


def flash_attention_hpack2_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_hpack2`, in the form of
    the JAX ``_fwd_kernel_hpack2``: q scaled by scale*log2(e) and rounded to
    its dtype, fp32 logits s2, P = exp2(min(s2, 110)) rounded to v's dtype
    with no max subtracted, fp32 PV and row sum, out = PV / max(l, 1e-30)
    and lse = log2(l) / log2(e). q, k, v [B, S, H, D] -> (out [B, S, H*D],
    lse [B, H, S] fp32)."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s2 = torch.matmul(_bhsd(qs).float(), _bhsd(k).float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(s2, max=110.0)).to(v.dtype).float()
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = (torch.matmul(p, _bhsd(v).float()) / l).to(q.dtype)
    return _bhsd(out).reshape(b, s, h * d), torch.log2(l[..., 0]) / LOG2E


def flash_attention_qkv_plain(qkv: torch.Tensor, heads: int, dim_head: int,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_qkv`: split, then
    :func:`attention_plain`."""
    return flash_attention_bshd_plain(*_split_qkv(qkv, heads, dim_head), scale)


# ---------------------------------------------------------------------------
# backward: plain versions and kernel wrappers over [B, H, S, D] views
# ---------------------------------------------------------------------------

def _probs(q, k, lse, scale):
    """P [B, H, Sq, Sk] recomputed in fp32 from the saved logsumexp."""
    return torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                     - lse[..., None])


def flash_attention_bwd_dq_plain(q, k, v, lse, dout, delta, scale: float) -> torch.Tensor:
    """dQ = scale * dS K with dS = P (dO V^T - Delta), in fp32 torch ops
    (the math of the JAX ``_bwd_dq_kernel``); returned in q's dtype."""
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = _probs(q, k, lse, scale) * (dp - delta[..., None])
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, lse, dout, delta, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = scale * dS^T Q and dV = P^T dO, in fp32 torch ops (the math of
    the JAX ``_bwd_dkv_kernel``); returned in k's and v's dtypes."""
    p = _probs(q, k, lse, scale)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in fp32, [B, H, Sq] (a plain op, as in JAX)."""
    return (out.float() * dout.float()).sum(-1)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale: float):
    """The plain version of :func:`flash_attention_bwd` -> (dq, dk, dv)."""
    delta = _delta(out, dout)
    return (flash_attention_bwd_dq_plain(q, k, v, lse, dout, delta, scale),
            *flash_attention_bwd_dkv_plain(q, k, v, lse, dout, delta, scale))


def _strides(ts: Sequence[torch.Tensor]):
    """(batch, sequence, head) strides of [B, H, S, D] views, as int64[]."""
    vals = [t.stride(i) for t in ts for i in (0, 2, 1)]
    return (ctypes.c_longlong * len(vals))(*vals)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The tiling of one backward kernel at one head dim (the Python mirror
    of ``BwdCfg`` in csrc/flash_attention_bwd.cu, which
    ``ctrlora_flash_bwd_config`` reports): a block owns ``rows`` rows (keys
    for dK/dV, queries for dQ) and walks the other sequence in tiles of
    ``tile`` rows through a ring of ``stages``, with two consumer
    warpgroups beside one producer; ``split``: dK and dV on separate
    warpgroups over the same 64 keys."""
    rows: int
    tile: int
    stages: int
    smem_bytes: int
    split: bool

    def grid(self, b: int, h: int, owned: int) -> Tuple[int, int]:
        """(blocks along the owned sequence, batch * heads)."""
        return owned // self.rows, b * h


@functools.lru_cache(maxsize=None)
def flash_bwd_plan(d: int, dkv: bool) -> BwdPlan:
    """The tiling of the dK/dV (``dkv``) or dQ kernel at head dim d. Up to
    D = 80 each warpgroup owns 64 rows and all of their products; at
    D = 160 the dK/dV kernel's two warpgroups share 64 keys, one holding
    dV and one dK (the register budget). Streamed tiles of 64 rows where two
    buffers of S and dP fit the registers beside the accumulators (dK/dV at
    D = 40, dQ up to D = 80), else 32; up to four stages in 200 KB beside
    the owned rows."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward: head dim {d} not in {BWD_HEAD_DIMS}")
    boxes = -(-d // TMA_BOX)
    split = dkv and d > 128
    rows = 64 if split else 128
    tile = 64 if (d <= 40 if dkv else d <= 80) else 32
    owned = 2 * boxes * rows * TMA_BOX * 2
    stage = 2 * boxes * tile * TMA_BOX * 2
    stages = min(4, (200 * 1024 - owned) // stage)
    vec = 2 * tile * 4 if dkv else 0  # the tile's lse and Delta rows
    smem = owned + stages * (stage + vec) + 8 * (1 + 2 * stages) + 1024
    return BwdPlan(rows, tile, stages, smem, split)


def tma_box_widths(d: int) -> Tuple[int, ...]:
    """Columns of the TMA boxes a streamed row of head dim d arrives in: full
    64-column boxes, then a tail box of d % 64 columns."""
    return (TMA_BOX,) * (d // TMA_BOX) + ((d % TMA_BOX,) if d % TMA_BOX else ())


def _check_bwd(what: str, tensors, lse, delta) -> None:
    sq, d = tensors[0].shape[2:]
    sk = tensors[1].shape[2]
    if d not in BWD_HEAD_DIMS or sq % BWD_SEQ_MULTIPLE or sk % BWD_SEQ_MULTIPLE:
        raise ValueError(f"{what}: the backward kernels take D in {BWD_HEAD_DIMS} with Sq, Sk "
                         f"multiples of {BWD_SEQ_MULTIPLE}; got D={d}, Sq={sq}, Sk={sk}")
    if any(t.device.type != "cuda" or t.dtype not in KERNEL_DTYPES or t.stride(-1) != 1
           for t in tensors):
        raise ValueError(f"{what}: needs bf16 CUDA [B, H, S, D] views with unit last stride")
    _check_aligned(what, [t.data_ptr() for t in tensors],
                   [t.stride(i) for t in tensors for i in (0, 1, 2)], d)
    for t in (lse, delta):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: lse and delta must be contiguous, 16-byte aligned "
                             "fp32 [B, H, Sq]")


def flash_attention_bwd_dq(q, k, v, lse, dout, delta, scale: float,
                           dq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ over [B, H, S, D] views (any strides with a unit last stride);
    written into `dq` (a view of the same shape) when given."""
    if takes_plain(q):
        res = flash_attention_bwd_dq_plain(q, k, v, lse, dout, delta, scale)
        return res if dq is None else dq.copy_(res)
    if dq is None:
        dq = torch.empty_like(q)
    _check_bwd("flash_attention_bwd_dq", (q, k, v, dout, dq), lse, delta)
    b, h, sq, d = q.shape
    code = _build.cuda_lib().ctrlora_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[2], d,
        _strides((q, k, v, dout, dq)), float(scale), _build.stream_ptr(q.device))
    _build.check(code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, dout, delta, scale: float,
                            dk: Optional[torch.Tensor] = None,
                            dv: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) over [B, H, S, D] views; written into `dk`/`dv` when given."""
    if takes_plain(q):
        rk, rv = flash_attention_bwd_dkv_plain(q, k, v, lse, dout, delta, scale)
        return (rk if dk is None else dk.copy_(rk)), (rv if dv is None else dv.copy_(rv))
    dk = torch.empty_like(k) if dk is None else dk
    dv = torch.empty_like(v) if dv is None else dv
    _check_bwd("flash_attention_bwd_dkv", (q, k, v, dout, dk, dv), lse, delta)
    b, h, sq, d = q.shape
    code = _build.cuda_lib().ctrlora_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[2], d,
        _strides((q, k, v, dout, dk, dv)), float(scale), _build.stream_ptr(q.device))
    _build.check(code, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float, grads=None):
    """FlashAttention-2 backward over [B, H, S, D] views: Delta as a plain
    fp32 op, then the dQ and dK/dV kernels. `grads` = (dq, dk, dv) views
    to write into (e.g. slices of a fused [B, S, 3*H*D] gradient)."""
    dq, dk, dv = grads if grads is not None else (None, None, None)
    delta = _delta(out, dout).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, lse, dout, delta, scale, dq)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, dout, delta, scale, dk, dv)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# forward kernel entries
# ---------------------------------------------------------------------------

def _check_aligned(what: str, ptrs, strides, d: int) -> None:
    if d % 8 or d > 512:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8 and <= 512")
    if any(p % 16 for p in ptrs) or any(s % 8 for s in strides):
        raise ValueError(f"{what}: operands must be 16-byte aligned (pointers "
                         f"{[p % 16 for p in ptrs]}, strides {list(strides)})")


FORWARD_HEAD_DIMS = (8, 16, 32, 40, 64, 80, 128, 160, 512)  # the forward kernel's instantiations


def forward_tiles(d: int) -> Optional[Tuple[int, int]]:
    """(query rows, keys) that Sq and Sk must be multiples of for the
    forward kernel at head dim d, or None where it has no instantiation:
    D = 40/80/160 (the UNet/ControlNet sites), 8/16/32 (ControlNet-XS's
    control stream), 64, 128 and 512 (the VAE)."""
    if d not in FORWARD_HEAD_DIMS:
        return None
    return (64, 32) if d == 512 else (128, 128)


def _launch_forward(what, ptrs, shape, strides, scale, device) -> torch.Tensor:
    """The forward kernel on raw operands: `ptrs` of q, k, v and out, `shape`
    (B, H, Sq, Sk, D), `strides` the (batch, sequence, head) strides of q,
    k, v and out in elements. Returns lse [B, H, Sq]. The callers compute
    strides from shapes where they can: views cost more host time than the
    kernel takes at the small sites."""
    b, h, sq, sk, d = shape
    tiles = forward_tiles(d)
    if tiles is None or sq % tiles[0] or sk % tiles[1]:
        raise ValueError(f"{what}: the forward kernel takes D in {FORWARD_HEAD_DIMS} with Sq, "
                         f"Sk multiples of 128 (of 64, 32 at D = 512); got D={d}, Sq={sq}, "
                         f"Sk={sk}")
    _check_aligned(what, ptrs[:3], strides[:9], d)
    lse = torch.empty((b, h, sq), device=device, dtype=torch.float32)
    code = _build.cuda_lib().ctrlora_flash_fwd(
        *ptrs, lse.data_ptr(), b, h, sq, sk, d, *strides, float(scale), _build.stream_ptr(device))
    _build.check(code, what)
    return lse


def _check_operands(what: str, ts) -> None:
    if (ts[0].device.type != "cuda"
            or any(t.dtype != torch.bfloat16 or t.stride(-1) != 1 for t in ts)):
        raise ValueError(f"{what}: needs bf16 CUDA tensors with unit last stride")


def _forward(q, k, v, out, scale, what) -> torch.Tensor:
    """The forward kernel over [B, H, S, D] views (any strides with a unit
    last stride), writing `out` (a view of the same shape as q); returns
    lse [B, H, Sq]."""
    _check_operands(what, (q, k, v))
    b, h, sq, d = q.shape
    return _launch_forward(what, [t.data_ptr() for t in (q, k, v, out)],
                           (b, h, sq, k.shape[2], d),
                           [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)], scale,
                           q.device)


def _forward_bshd(q, k, v, scale, what):
    """The forward kernel over [B, S, H, D] views -> (out [B, S, H*D], lse)."""
    _check_operands(what, (q, k, v))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h * d), device=q.device, dtype=q.dtype)
    strides = [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)] + [s * h * d, h * d, d]
    lse = _launch_forward(what, [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()],
                          (b, h, s, k.shape[1], d), strides, scale, q.device)
    return out, lse


def _forward_qkv(qkv, heads, dim_head, scale):
    """The forward kernel off a contiguous [B, S, 3*H*D] projection: q, k and
    v are lane offsets 0, H*D and 2*H*D of each row -> (out [B, S, H*D],
    lse)."""
    what = "flash_attention_qkv"
    _check_operands(what, (qkv,))
    b, s, width = qkv.shape
    hd = heads * dim_head
    out = torch.empty((b, s, hd), device=qkv.device, dtype=qkv.dtype)
    ptr, size = qkv.data_ptr(), qkv.element_size()
    strides = [s * width, width, dim_head] * 3 + [s * hd, hd, dim_head]
    lse = _launch_forward(what, [ptr, ptr + hd * size, ptr + 2 * hd * size, out.data_ptr()],
                          (b, heads, s, s, dim_head), strides, scale, qkv.device)
    return out, lse


def _backward_bshd(q, k, v, out, lse, dout, scale, grads) -> None:
    """The backward over q, k, v [B, S, H, D] views and out, dout
    [B, S, H*D], written into the [B, S, H, D] views `grads`."""
    heads4 = lambda t: _bhsd(t.view(q.shape))
    flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), heads4(out), lse,
                        heads4(dout.contiguous()), scale, grads=tuple(map(_bhsd, grads)))


class _FlashBHSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        if takes_plain(q):
            out, lse = attention_plain(q, k, v, scale)
        else:
            out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
            lse = _forward(q, k, v, out, scale, "flash_attention")
            flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale), None)


class _FlashBSHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        if takes_plain(q):
            out, lse = flash_attention_bshd_plain(q, k, v, scale)
        else:
            out, lse = _forward_bshd(q, k, v, scale, "flash_attention_bshd")
            flash_attention_bshd.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        _backward_bshd(q, k, v, out, lse, dout, ctx.scale, grads)
        return (*grads, None)


class _FlashHpack2(_FlashBSHD):
    """Kernel B6 forward; the backward is the BSHD entry's (the dQ and dK/dV
    kernels from the saved natural-log lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if takes_plain(q):
            out, lse = flash_attention_hpack2_plain(q, k, v, scale)
        else:
            out, lse = _forward_hpack2(q, k, v, scale)
            flash_attention_hpack2.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse


# kernel B6's instantiations: every head dim of FORWARD_HEAD_DIMS with 2*D <= 128
HPACK2_HEAD_DIMS = (8, 16, 32, 40, 64)


@dataclasses.dataclass(frozen=True)
class Hpack2Plan:
    """Kernel B6's tiling at one head dim (the Python mirror of ``Hp2Cfg``
    in csrc/flash_attention_hpack2.cu, which ``ctrlora_flash_hpack2_config``
    reports): ``consumers`` warpgroups a block, each owning ``rows`` query
    rows of one head of the pair (the pair's query tiles dealt out in turn,
    so a block serves both heads); the key tiles of ``keys`` rows of both
    heads stream through a ring of ``stages``; ``smem_bytes`` dynamic shared
    memory. ``threads``: the consumers and a producer warpgroup;
    ``regs``: what a consumer thread holds after the producer hands its
    registers over; ``frag_regs``: the registers of a consumer's fragments
    (S, two P buffers, O, the row sums and q)."""
    consumers: int
    rows: int
    keys: int
    stages: int
    smem_bytes: int
    threads: int
    regs: int
    frag_regs: int

    def as_list(self):
        """The numbers in the order the C entry reports them."""
        return [self.consumers, self.rows, self.keys, self.stages, self.smem_bytes]

    def grid(self, b: int, h: int, sq: int) -> Tuple[int, int]:
        """(blocks along the pair's query tiles, batch * head pairs)."""
        return -(-(2 * sq // self.rows) // self.consumers), b * h // 2


@functools.lru_cache(maxsize=None)
def hpack2_plan(d: int) -> Hpack2Plan:
    """Kernel B6's tiling at head dim d (8, 16, 32, 40 or 64): three consumer
    warpgroups of 64 query rows at 160 registers beside a producer
    warpgroup (four consumers would have ~112 registers and spill); 64-key
    tiles, each stage holding K and V of both heads, four boxes of 128-byte
    rows (a head's D columns and zeros past them); up to six stages in 200
    KB beside a 16-row tile of ones."""
    if d not in HPACK2_HEAD_DIMS:
        raise ValueError(f"flash_attention_hpack2: head dim {d} not in {HPACK2_HEAD_DIMS}")
    consumers, keys, regs = 3, 64, 160
    box = keys * TMA_BOX * 2
    ones = 16 * TMA_BOX * 2
    stages = min(6, (200 * 1024 - ones) // (4 * box))
    smem = stages * 4 * box + ones + 8 * 2 * stages + 1024
    frag = keys // 2 + 2 * (keys // 16) * 4 + d // 2 + 4 + -(-d // 16) * 4
    return Hpack2Plan(consumers, 64, keys, stages, smem, (consumers + 1) * 128, regs, frag)


def _forward_hpack2(q, k, v, scale):
    """Kernel B6 over [B, S, H, D] views -> (out [B, S, H*D], lse)."""
    what = "flash_attention_hpack2"
    b, s, h, d = q.shape
    if (q.device.type != "cuda" or any(t.dtype != torch.bfloat16 for t in (q, k, v))
            or any(t.stride(-1) != 1 for t in (q, k, v))):
        raise ValueError(f"{what}: needs bf16 CUDA tensors with unit last stride")
    if h % 2 or d not in HPACK2_HEAD_DIMS:
        raise ValueError(f"{what}: needs an even head count and D in {HPACK2_HEAD_DIMS}, "
                         f"got H={h} D={d}")
    tiles = forward_tiles(d)
    if s % tiles[0] or k.shape[1] % tiles[1]:
        raise ValueError(f"{what}: needs Sq and Sk multiples of {tiles}; got Sq={s}, "
                         f"Sk={k.shape[1]}")
    out = torch.empty((b, s, h * d), device=q.device, dtype=q.dtype)
    views = [_bhsd(t) for t in (q, k, v, out.view(b, s, h, d))]
    strides = [t.stride(i) for t in views for i in (0, 2, 1)]
    _check_aligned(what, [t.data_ptr() for t in (q, k, v)], strides[:9], d)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    code = _build.cuda_lib().ctrlora_flash_hpack2(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, s, k.shape[1], d, *strides, float(scale), _build.stream_ptr(q.device))
    _build.check(code, what)
    return out, lse


class _FlashQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, dim_head, scale):
        if takes_plain(qkv):
            out, lse = flash_attention_qkv_plain(qkv, heads, dim_head, scale)
        else:
            out, lse = _forward_qkv(qkv, heads, dim_head, scale)
            flash_attention_qkv.launches += 1
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (heads, dim_head, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        qkv, out, lse = ctx.saved_tensors
        heads, dim_head, scale = ctx.args
        dqkv = torch.empty_like(qkv)  # dq | dk | dv written in place, no concat
        _backward_bshd(*_split_qkv(qkv, heads, dim_head), out, lse, dout, scale,
                       _split_qkv(dqkv, heads, dim_head))
        return dqkv, None, None, None


def _split_qkv(qkv, heads, dim_head):
    """[B, S, 3*H*D] -> three [B, S, H, D] views (lane offsets 0/HD/2HD)."""
    return tuple(t.unflatten(-1, (heads, dim_head))
                 for t in qkv.split(heads * dim_head, dim=-1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, S, D] attention (any strides with a unit last stride).
    Returns (out [B, H, Sq, D], lse [B, H, Sq] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashBHSD.apply(q, k, v, scale)


flash_attention.launches = 0


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over q, k, v [B, S, H, D] (the projections' layout; any
    strides with a unit last stride). Returns (out [B, S, H*D], lse [B, H, S]
    fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashBSHD.apply(q, k, v, scale)


flash_attention_bshd.launches = 0


def flash_attention_hpack2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6: attention over q, k, v [B, S, H, D] (any strides with a
    unit last stride, H even, 2*D <= 128) one head pair per block, with the
    skip-max softmax of the JAX ``_fwd_kernel_hpack2``. Returns (out
    [B, S, H*D], lse [B, H, S] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashHpack2.apply(q, k, v, scale)


flash_attention_hpack2.launches = 0


def flash_attention_qkv(qkv: torch.Tensor, heads: int, dim_head: int,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention off the fused projection qkv [B, S, 3*H*D] (q | k | v
    on the last axis). Returns (out [B, S, H*D], lse [B, H, S] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(dim_head)
    hd3 = qkv.shape[-1]
    if hd3 != 3 * heads * dim_head:
        raise ValueError(f"flash_attention_qkv: width {hd3} != 3*{heads}*{dim_head}")
    if qkv.device.type == "cuda" and not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv: needs a contiguous bf16 CUDA tensor")
    return _FlashQKV.apply(qkv, heads, dim_head, scale)


flash_attention_qkv.launches = 0


def _tiles(s: int) -> bool:
    return s >= 128 and s % 128 == 0


def flash_kernel_ok(dtypes, sq: int, sk: int, d: int, grad: bool = False) -> bool:
    """The static dispatch rule of the flash entries: the JAX package's
    shape rule (Sk >= 256, both sequences tiling by 128), bf16 operands
    (`dtypes`), a head dim the forward kernel has, and where a gradient will
    flow (`grad`) one the backward kernels have too. False: the plain
    version."""
    return (all(dt in KERNEL_DTYPES for dt in dtypes) and d in FORWARD_HEAD_DIMS
            and sk >= 256 and _tiles(sq) and _tiles(sk) and (not grad or d in BWD_HEAD_DIMS))


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          use_flash: bool = True) -> torch.Tensor:
    """[B, H, S, D] attention; the kernel where :func:`flash_kernel_ok`,
    else the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    if use_flash and flash_kernel_ok((q.dtype, k.dtype, v.dtype), sq, sk, q.shape[3],
                                     _grad(q, k, v)):
        return flash_attention(q, k, v, scale)[0]
    return attention_plain(q, k, v, scale)[0]


def _hpack_ok(heads: int, dim_head: int) -> bool:
    """The JAX rule for the head-pair kernel: hpack=N with N >= 2, an even
    head count and a pair no wider than 128. B6 is built for every head dim
    of that rule that :func:`flash_kernel_ok` admits (HPACK2_HEAD_DIMS)."""
    return ((kernel_flags.flags().head_pack or 1) > 1 and heads % 2 == 0
            and 2 * dim_head <= 128)


def dot_product_attention_bshd(q, k, v, scale: Optional[float] = None,
                               use_flash: bool = True) -> torch.Tensor:
    """Attention over q, k, v [B, S, H, D] -> [B, Sq, H*D]; same dispatch,
    and kernel B6 instead of the BSHD entry where :func:`_hpack_ok`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    if use_flash and flash_kernel_ok((q.dtype, k.dtype, v.dtype), sq, sk, q.shape[3],
                                     _grad(q, k, v)):
        if _hpack_ok(q.shape[2], q.shape[3]):
            return flash_attention_hpack2(q, k, v, scale)[0]
        return flash_attention_bshd(q, k, v, scale)[0]
    return flash_attention_bshd_plain(q, k, v, scale)[0]


def dot_product_attention_bshd_qkv(qkv, heads: int, dim_head: int,
                                   scale: Optional[float] = None,
                                   use_flash: bool = True) -> torch.Tensor:
    """Self-attention off the fused projection [B, S, 3*H*D] -> [B, S, H*D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(dim_head)
    s = qkv.shape[1]
    if use_flash and flash_kernel_ok((qkv.dtype,), s, s, dim_head, _grad(qkv)):
        return flash_attention_qkv(qkv, heads, dim_head, scale)[0]
    return flash_attention_qkv_plain(qkv, heads, dim_head, scale)[0]
