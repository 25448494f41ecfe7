"""GroupNorm (+SiLU, +add_row) over [B, ..., C] channels-last data.

Kernel A of the port, in Triton. It replaces the TPU kernel pair
``ctrlora_tpu/ops/group_norm.py`` ``_stats_kernel`` + ``_apply_kernel``
(launched from ``fused_group_norm``). Kernel A2 (``csrc/group_norm_onepass.cu``,
CUDA C++, :func:`group_norm_onepass`) replaces the one-pass ``_onepass_kernel``;
:func:`group_norm` routes to it under ``CTRLORA_KERNELS=gn1=1`` where the JAX
admission rule holds (``_onepass_ok``), and to kernel A everywhere else.

What bounds it on the H100: no matrix product, a few flops per element, so
device-memory bandwidth: one read of x for the statistics, one read and one
write to apply them. Design:

* pass 1 (stats, Triton): the TPU kernel carried its channel sums across
  sequential grid steps; Hopper blocks run in no order, so each program
  reduces one (batch, HW-chunk, channel-block) tile and writes its fp32
  partial sums and sums of squares to a [B, chunks, C] scratch. No atomics:
  the summation order is the same on every run.
* epilogue (Triton, one program per (batch, group)): fold the partials
  over chunks, reduce the group's channels, and turn the group moments into
  a per-(batch, channel) affine ``y = x * a + b``. The ``add_row`` algebra of
  the JAX epilogue (plain XLA there) is kept exactly, so GN(x + row) never
  builds x + row. One launch instead of a dozen small torch ops: at ~90
  GroupNorms per DDIM step the launches matter.
* pass 2 (apply, Triton): ``y = x * a + b`` and the optional SiLU in fp32,
  stored in x's dtype.

Channel blocks are masked, so 10 or 20 channels per group (UNet widths)
and 4 (VAE) need no special case, and HW is chunked, so the VAE decoder's
[4, 262144, 128] tensor runs like any other.

:func:`group_norm` is a ``torch.autograd.Function``: kernel forward, and a
backward that recomputes the plain math under autograd (the JAX
``custom_vjp``), with gradients for x, scale, bias and add_row.
"""

import functools
from typing import Optional

import torch

from ctrlora_tpu_torch.ops import _build, kernel_flags

tl = None  # triton.language, bound at the first launch (the kernels' globals)

_BLOCK_R = 64
_BLOCK_C = 64
_CHUNK_ROWS = 512  # rows per stats program


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
                     add_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 GroupNorm of x [B, ..., C] (+ add_row [C]/[1,C]/[B,C]), the math of
    the JAX package's ``_plain_group_norm``."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float()
    if add_row is not None:
        row = add_row.float().reshape(-1, c)
        xf = xf + row.reshape(row.shape[0], *([1] * (x.ndim - 2)), c)
    xg = xf.reshape(b, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    y = xg.reshape(x.shape) * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_work(b: int, hw: int, c: int, itemsize: int = 2,
                    row_rows: int = 0) -> tuple:
    """(flops, bytes) of GroupNorm over x [B, HW, C]: x read once and y
    written once, fp32 scale and bias read once, and `row_rows` added rows
    [n, C] in x's dtype. Its arithmetic is a few operations per element, far
    below the card's ridge, so it is counted as bytes only (flops 0)."""
    return 0, 2 * b * hw * c * itemsize + 2 * c * 4 + row_rows * c * itemsize


@functools.cache
def _kernels():
    global tl
    import triton
    import triton.language as language

    tl = language

    @triton.jit
    def gn_stats(x_ptr, psum_ptr, psq_ptr, HW, C, stride_b, chunk_rows,
                 BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        ch = tl.program_id(1)
        cb = tl.program_id(2)
        n_chunks = tl.num_programs(1)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        s = tl.zeros([BLOCK_C], dtype=tl.float32)
        q = tl.zeros([BLOCK_C], dtype=tl.float32)
        base = x_ptr + b * stride_b
        for r0 in range(0, chunk_rows, BLOCK_R):
            rows = ch * chunk_rows + r0 + tl.arange(0, BLOCK_R)
            m = (rows < HW)[:, None] & cmask[None, :]
            v = tl.load(base + rows.to(tl.int64)[:, None] * C + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            s += tl.sum(v, axis=0)
            q += tl.sum(v * v, axis=0)
        off = (b * n_chunks + ch) * C + cols
        tl.store(psum_ptr + off, s, mask=cmask)
        tl.store(psq_ptr + off, q, mask=cmask)

    @triton.jit
    def gn_apply(x_ptr, y_ptr, a_ptr, bb_ptr, HW, C, stride_b,
                 SILU: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        rb = tl.program_id(1)
        cb = tl.program_id(2)
        rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows < HW)[:, None] & cmask[None, :]
        off = b * stride_b + rows.to(tl.int64)[:, None] * C + cols[None, :]
        v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        a = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bb = tl.load(bb_ptr + b * C + cols, mask=cmask, other=0.0)
        y = v * a[None, :] + bb[None, :]
        if SILU:
            y = y / (1.0 + tl.exp(-y))
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def gn_affine(psum_ptr, psq_ptr, scale_ptr, bias_ptr, row_ptr, a_ptr, bb_ptr,
                  HW, C, n_chunks, cpg, row_stride, eps,
                  HAS_ROW: tl.constexpr, BLOCK: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        grp = tl.program_id(1)
        offs = tl.arange(0, BLOCK)
        cmask = offs < cpg
        ch = grp * cpg + offs
        s = tl.zeros([BLOCK], dtype=tl.float32)
        q = tl.zeros([BLOCK], dtype=tl.float32)
        for i in range(0, n_chunks):
            base = (b * n_chunks + i) * C
            s += tl.load(psum_ptr + base + ch, mask=cmask, other=0.0)
            q += tl.load(psq_ptr + base + ch, mask=cmask, other=0.0)
        if HAS_ROW:  # GN(x + row) from the moments of x
            row = tl.load(row_ptr + b * row_stride + ch, mask=cmask, other=0.0).to(tl.float32)
            q = q + 2.0 * row * s + HW * row * row
            s = s + HW * row
        n = HW * cpg
        mean = tl.sum(s, axis=0) / n
        var = tl.sum(q, axis=0) / n - mean * mean
        inv = 1.0 / tl.sqrt_rn(var + eps)
        a = inv * tl.load(scale_ptr + ch, mask=cmask, other=0.0)
        bb = tl.load(bias_ptr + ch, mask=cmask, other=0.0) - mean * a
        if HAS_ROW:
            bb = bb + row * a
        tl.store(a_ptr + b * C + ch, a, mask=cmask)
        tl.store(bb_ptr + b * C + ch, bb, mask=cmask)

    return gn_stats, gn_affine, gn_apply


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# one-pass admission, the JAX constants under their names (a test may
# monkeypatch _ONEPASS_MIN_ELEMS to 0, as the JAX package's tests do)
_MAX_BLOCK_ELEMS = 1 << 17
_ONEPASS_MAX_BYTES = 3 * 1024 * 1024
_ONEPASS_MIN_ELEMS = 1 << 19
# A2's CTA: 512 threads, one (sample, group) slice staged in shared memory
_ONEPASS_THREADS = 512
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _pick_hw_block(hw: int, c: int) -> Optional[int]:
    for cand in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if cand <= hw and hw % cand == 0 and cand * c <= _MAX_BLOCK_ELEMS:
            return cand
    return None


def _onepass_ok(hw: int, c: int, dtype: torch.dtype, num_groups: int) -> bool:
    """The JAX ``_onepass_ok``: gn1=1, and the [hw, c] sample is large
    enough to gain and small enough (3 MiB) to stay resident."""
    if not kernel_flags.flags().gn_onepass:
        return False
    return (hw * c >= _ONEPASS_MIN_ELEMS
            and hw * c * dtype.itemsize <= _ONEPASS_MAX_BYTES
            and c % num_groups == 0
            and _pick_hw_block(hw, c) is not None)


def _onepass_smem(hw: int, cpg: int, itemsize: int) -> int:
    """A2's dynamic shared memory: per-thread partial sums (two floats per
    element of a pair), the group's per-channel sums and affine, and the
    staged [hw, cpg] slice (the layout of csrc/group_norm_onepass.cu)."""
    vec = 2 if cpg % 2 == 0 else 1
    stats = (4 * cpg + 2) * 4
    return 2 * _ONEPASS_THREADS * vec * 4 + (stats + 15) // 16 * 16 + hw * cpg * itemsize


_ONEPASS_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def group_norm_onepass(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
                       add_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel A2: the one-pass GroupNorm(x + add_row) (+SiLU) of x
    [B, ..., C] contiguous, in one launch that reads x from device memory
    once. Its plain version is :func:`group_norm_plain` (the same function),
    which a CPU tensor takes; on a CUDA tensor the kernel runs or this
    raises. Forward only: :func:`group_norm` gives it its backward."""
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, silu, add_row)
    if x.device.type != "cuda" or x.dtype not in _ONEPASS_DTYPES or not x.is_contiguous():
        raise ValueError("group_norm_onepass: needs a contiguous bf16 or fp32 CUDA tensor")
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    if c % num_groups:
        raise ValueError(f"group_norm_onepass: {c} channels do not split into {num_groups} groups")
    cpg = c // num_groups
    smem = _onepass_smem(hw, cpg, x.element_size())
    if smem > _SMEM_LIMIT or cpg > _ONEPASS_THREADS:
        raise ValueError(f"group_norm_onepass: a [{hw}, {cpg}] group slice needs {smem} bytes "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("group_norm_onepass: scale and bias must be fp32")
    row, row_stride = None, 0
    if add_row is not None:
        row = add_row.float().reshape(-1, c).contiguous()
        if row.shape[0] not in (1, b):
            raise ValueError(f"group_norm_onepass: add_row {tuple(add_row.shape)} is not "
                             f"[C], [1, C] or [B, C]")
        row_stride = 0 if row.shape[0] == 1 else c
    scale, bias = scale.contiguous(), bias.contiguous()  # held until the launch returns
    y = torch.empty_like(x)
    code = _build.cuda_lib().ctrlora_group_norm_onepass(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if row is None else row.data_ptr(), y.data_ptr(), b, hw, c, num_groups,
        row_stride, float(eps), int(silu), _ONEPASS_DTYPES[x.dtype], smem,
        _build.stream_ptr(x.device))
    _build.check(code, "group_norm_onepass")
    group_norm_onepass.launches += 1
    return y


group_norm_onepass.launches = 0


def _forward(x, scale, bias, num_groups, eps, silu, add_row):
    """Kernel A2 where gn1=1 admits the shape; else kernel A on a CUDA
    tensor, the plain version on a CPU tensor."""
    b, c = x.shape[0], x.shape[-1]
    if _onepass_ok(x.numel() // max(b * c, 1), c, x.dtype, num_groups):
        return group_norm_onepass(x, scale, bias, num_groups, eps, silu, add_row)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, silu, add_row)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    import triton

    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous [B, ..., C]")
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"group_norm: {c} channels do not split into {num_groups} groups")
    hw = x.numel() // (b * c)
    chunk = min(_CHUNK_ROWS, _cdiv(hw, _BLOCK_R) * _BLOCK_R)
    n_chunks = _cdiv(hw, chunk)
    n_cb = _cdiv(c, _BLOCK_C)
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("group_norm: scale and bias must be fp32")
    gn_stats, gn_affine, gn_apply = _kernels()
    part = torch.empty((2, b, n_chunks, c), device=x.device, dtype=torch.float32)
    gn_stats[(b, n_chunks, n_cb)](x, part[0], part[1], hw, c, hw * c, chunk,
                                  BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C)
    ab = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    cpg = c // num_groups
    row = None
    if add_row is not None:
        row = add_row.reshape(-1, c)
        if row.shape[0] not in (1, b) or not row.is_contiguous():
            raise ValueError(f"group_norm: add_row {tuple(add_row.shape)} is not [C], [1, C] or [B, C]")
    gn_affine[(b, num_groups)](part[0], part[1], scale, bias, ab if row is None else row,
                               ab[0], ab[1], hw, c, n_chunks, cpg,
                               0 if row is None or row.shape[0] == 1 else c, eps,
                               HAS_ROW=row is not None,
                               BLOCK=triton.next_power_of_2(cpg))
    a, bb = ab[0], ab[1]
    y = torch.empty_like(x)
    gn_apply[(b, _cdiv(hw, _BLOCK_R), n_cb)](x, y, a, bb, hw, c, hw * c,
                                            SILU=silu, BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C)
    group_norm.launches += 1
    return y


class _GroupNorm(torch.autograd.Function):
    """Kernel forward; the backward is the plain math by recompute (autograd
    through :func:`group_norm_plain`), as the JAX ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, x, scale, bias, add_row, num_groups, eps, silu):
        ctx.save_for_backward(x, scale, bias, add_row)
        ctx.args = (num_groups, eps, silu)
        return _forward(x, scale, bias, num_groups, eps, silu, add_row)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            y = group_norm_plain(ins[0], ins[1], ins[2], *ctx.args, add_row=ins[3])
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, gy) if wrt else ())
        return (*(next(got) if n else None for n in need), None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
               add_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(x + add_row) with optional fused SiLU; x [B, ..., C]
    contiguous (channels last), scale/bias [C], add_row [C]/[1, C]/[B, C].
    Returns x's shape and dtype; differentiable in x, scale, bias and
    add_row."""
    return _GroupNorm.apply(x, scale, bias, add_row, num_groups, eps, silu)


group_norm.launches = 0
