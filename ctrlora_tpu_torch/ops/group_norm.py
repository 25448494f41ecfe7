"""GroupNorm (+SiLU, +add_row) over [B, ..., C] channels-last data.

Kernel A of the port (``csrc/group_norm.cu``, CUDA C++ for sm_90a, one
launch per call) replaces the TPU kernel pair ``ctrlora_tpu/ops/group_norm.py``
``_stats_kernel`` + ``_apply_kernel`` (launched from ``fused_group_norm``).
Kernel A2 (:func:`group_norm_onepass`, the same kernel under its own plan,
a second C entry of ``csrc/group_norm.cu``) replaces the one-pass
``_onepass_kernel``; :func:`group_norm` routes to it under
``CTRLORA_KERNELS=gn1=1`` where the JAX admission rule holds
(``_onepass_ok``), and to kernel A everywhere else.

What bounds it on the H100: no matrix product, a few flops per element, so
device-memory bandwidth: x read once and y written once. Kernel A is one
launch of thread-block clusters: a cluster of up to 8 blocks owns one
(sample, slab of whole groups), each block sums its share of the sample's
rows in fp32, the cluster exchanges the per-channel sums through distributed
shared memory and every block folds them in the same order (no atomics, no
scratch tensors), then applies the affine to its rows, kept in shared memory
where they fit (x read once) or read a second time where they do not (the
VAE's 512^2 sites). The ``add_row`` algebra of the JAX epilogue is kept
exactly, so GN(x + row) never builds x + row. :func:`group_norm_plan` is the
Python mirror of the kernel's own choice of cluster, slab and path (the
source note says how it is chosen); the kernel's C entry
``ctrlora_group_norm_config`` reports the same numbers. A2's plan,
:func:`group_norm_onepass_plan`, always stages (x read once) in clusters of
up to 16 blocks (``ctrlora_group_norm_onepass_config`` reports it).

:func:`group_norm` is a ``torch.autograd.Function``: kernel forward, and a
backward that recomputes the plain math under autograd (the JAX
``custom_vjp``), with gradients for x, scale, bias and add_row.
"""

import dataclasses
import functools
from typing import Optional

import torch

from ctrlora_tpu_torch.ops import _build, kernel_flags, takes_plain


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


_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_SM_SMEM = 233472  # an SM's shared memory, of which the system holds
_BLOCK_RESERVE = 1024  # this much for each block

# kernel A's plan (csrc/group_norm.cu gn_plan): 256 threads a block, rows
# streamed in ~16 KB chunks, a ring of 4 chunk buffers on the re-read path,
# clusters of at most 8 blocks
GN_THREADS = 256
GN_VEC_BYTES = 16  # one copy, and one thread's column of a slab
_GN_CHUNK_BYTES = 16384
_GN_RING = 4
GN_MAX_CLUSTER = 8
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' dtype codes (A and A2)


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """Kernel A's launch at one shape (the Python mirror of ``gn_plan`` in
    csrc/group_norm.cu, which ``ctrlora_group_norm_config`` reports): a
    cluster of ``cluster`` blocks owns one (sample, slab); a slab is
    ``groups`` whole groups, ``slab`` channels, and a row has ``slabs`` of
    them; each block owns ``rows`` rows (the last may own fewer), streamed
    in chunks of ``chunk_rows`` rows with 16-byte copies, and
    keeps them in shared memory (``staged``) or reads them again for the
    apply; ``smem`` dynamic shared-memory bytes."""
    cluster: int
    slab: int
    slabs: int
    staged: bool
    smem: int
    chunk_rows: int
    rows: int
    groups: int

    def blocks(self, b: int) -> int:
        """Blocks of the grid at batch b."""
        return b * self.slabs * self.cluster

    def as_list(self):
        """The numbers in the order the C entry reports them."""
        return [self.cluster, self.slab, self.slabs, int(self.staged), self.smem,
                self.chunk_rows, self.rows, self.groups]


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _fixed_bytes(slab: int, gps: int, itemsize: int) -> int:
    """A block's bookkeeping after its rows (csrc/group_norm.cu
    ``fixed_bytes``): per-thread partial sums, the block's channel sums, the
    folded sums, the affine and the group statistics, fp32."""
    return _round16(4 * (2 * GN_THREADS * (GN_VEC_BYTES // itemsize) + 6 * slab + 2 * gps))


def _slab_groups(c: int, groups: int, itemsize: int) -> int:
    """The fewest whole groups (a divisor of `groups`) whose channels make
    >= 128 contiguous bytes of a row, or all of them."""
    cpg = c // groups
    return next((d for d in range(1, groups + 1)
                 if groups % d == 0 and d * cpg * itemsize >= 128), groups)


@functools.lru_cache(maxsize=None)
def group_norm_plan(b: int, hw: int, c: int, groups: int, itemsize: int,
                    sms: int) -> GroupNormPlan:
    """Kernel A's cluster size, slab and path at x [b, hw, c] of `itemsize`
    bytes an element on a card of `sms` multiprocessors. The slab is the
    fewest whole groups (a divisor of `groups`) whose channels make >= 128
    contiguous bytes of a row, or the whole row; slab and row must be whole
    numbers of 16-byte copies. Staged where it can be: the
    smallest cluster of 1, 2, 4, 8 whose grid reaches 15/16 of the SMs (or
    of 8 blocks) and whose block's rows of the slab fit shared memory; else
    the smallest whose grid reaches 15/16 of the SMs, re-reading through a
    ring of chunks; else (the grid cannot fill the card) 8 blocks
    re-reading in chunks twice as large. Raises ValueError where the kernel
    takes no such shape."""
    if b <= 0 or hw <= 0 or groups <= 0 or c % groups or itemsize not in (2, 4):
        raise ValueError(f"group_norm: no plan for [{b}, {hw}, {c}] in {groups} groups, "
                         f"{itemsize}-byte elements")
    cpg = c // groups
    gps = _slab_groups(c, groups, itemsize)
    slab = gps * cpg
    sb, rb = slab * itemsize, c * itemsize
    if sb % GN_VEC_BYTES or rb % GN_VEC_BYTES:
        raise ValueError(f"group_norm: a {sb}-byte slab of a {rb}-byte row is not a whole "
                         f"number of {GN_VEC_BYTES}-byte copies")
    fixed = _fixed_bytes(slab, gps, itemsize)
    target = sms - sms // 16
    slabs = groups // gps
    units = b * slabs
    chunk_rows = max(1, _GN_CHUNK_BYTES // sb)
    plan = functools.partial(GroupNormPlan, slab=slab, slabs=slabs, groups=gps)
    for k in (1, 2, 4, 8):
        rows = -(-hw // k)
        smem = fixed + _round16(rows * sb)
        if (units * k >= target or k == GN_MAX_CLUSTER) and smem <= _SMEM_LIMIT:
            return plan(cluster=k, staged=True, smem=smem, chunk_rows=chunk_rows, rows=rows)
    ring = fixed + _round16(_GN_RING * chunk_rows * sb)
    for k in (1, 2, 4, 8):
        if units * k >= target:
            return plan(cluster=k, staged=False, smem=ring, chunk_rows=chunk_rows,
                        rows=-(-hw // k))
    chunk_rows = max(1, 2 * _GN_CHUNK_BYTES // sb)
    return plan(cluster=GN_MAX_CLUSTER, staged=False,
                smem=fixed + _round16(_GN_RING * chunk_rows * sb), chunk_rows=chunk_rows,
                rows=-(-hw // GN_MAX_CLUSTER))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one-pass admission, the JAX constants under their names (a test may
# monkeypatch _ONEPASS_MIN_ELEMS to 0, as the JAX package's tests do)
_MAX_BLOCK_ELEMS = 1 << 17
_ONEPASS_MAX_BYTES = 3 * 1024 * 1024
_ONEPASS_MIN_ELEMS = 1 << 19
GN_ONEPASS_MAX_CLUSTER = 16  # kernel A2's clusters (a non-portable size)


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


def _onepass_plan_k(b: int, hw: int, c: int, groups: int, itemsize: int, k: int,
                    gps: int) -> Optional[GroupNormPlan]:
    """Kernel A2's plan at cluster size k and a slab of gps groups
    (csrc/group_norm.cu ``onepass_plan_k``): staged, or None where the
    block's rows do not fit its shared memory or one block's threads cannot
    cover the slab's 16-byte columns."""
    slab = gps * (c // groups)
    sb = slab * itemsize
    if sb % GN_VEC_BYTES or c * itemsize % GN_VEC_BYTES or sb // GN_VEC_BYTES > GN_THREADS:
        return None
    rows = -(-hw // k)
    smem = _fixed_bytes(slab, gps, itemsize) + _round16(rows * sb)
    if smem > _SMEM_LIMIT:
        return None
    return GroupNormPlan(cluster=k, slab=slab, slabs=groups // gps, staged=True, smem=smem,
                         chunk_rows=max(1, _GN_CHUNK_BYTES // sb), rows=rows, groups=gps)


@functools.lru_cache(maxsize=None)
def group_norm_onepass_plan(b: int, hw: int, c: int, groups: int, itemsize: int,
                            sms: int) -> GroupNormPlan:
    """Kernel A2's launch at x [b, hw, c] (the Python mirror of
    ``gn_onepass_plan`` in csrc/group_norm.cu, which
    ``ctrlora_group_norm_onepass_config`` reports). Always staged: every
    block keeps its rows of the slab in shared memory, so x is read once.
    The slab is kernel A's; the cluster size is the largest of 1..16 whose
    grid runs in one wave: with two blocks a SM where the rows fit half an
    SM's shared memory, else one, the grid's blocks within that many a SM
    (7/8 of it for clusters of 3 or more blocks, which the GPCs cannot pack
    without gaps). Where no cluster size does, the smallest that stages.
    Raises ValueError for a sample over 3 MiB (the JAX kernel's resident
    limit, ``_ONEPASS_MAX_BYTES``) or where no cluster size stages."""
    if (b <= 0 or hw <= 0 or groups <= 0 or c % groups or itemsize not in (2, 4)
            or hw * c * itemsize > _ONEPASS_MAX_BYTES):
        raise ValueError(f"group_norm_onepass: no plan for [{b}, {hw}, {c}] in {groups} "
                         f"groups, {itemsize}-byte elements (a sample holds at most "
                         f"{_ONEPASS_MAX_BYTES} bytes)")
    gps = _slab_groups(c, groups, itemsize)
    staged = [p for p in (_onepass_plan_k(b, hw, c, groups, itemsize, k, gps)
                          for k in range(1, GN_ONEPASS_MAX_CLUSTER + 1)) if p is not None]
    if not staged:
        raise ValueError(f"group_norm_onepass: a [{hw}, {c}] sample of {itemsize}-byte "
                         f"elements has no staged plan in clusters of up to "
                         f"{GN_ONEPASS_MAX_CLUSTER} blocks of {_SMEM_LIMIT} bytes")
    for per_sm in (2, 1):
        per_block = _SM_SMEM // per_sm - _BLOCK_RESERVE  # at most _SMEM_LIMIT
        one_wave = [p for p in staged if p.smem <= per_block and p.blocks(b) <= (
            per_sm * sms if p.cluster <= 2 else per_sm * sms * 7 // 8)]
        if one_wave:
            return one_wave[-1]
    return staged[0]


def _launch(entry, plan_fn, what, x, scale, bias, num_groups, eps, silu, add_row):
    """Kernel A or A2 (C `entry`, planned by `plan_fn`) on a CUDA x: the
    checks both share, then one launch."""
    b, c = x.shape[0], x.shape[-1]
    if (x.device.type != "cuda" or x.dtype not in _DTYPES or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"{what}: needs a contiguous, 16-byte aligned bf16 or fp32 CUDA "
                         "tensor [B, ..., C]")
    if c % num_groups:
        raise ValueError(f"{what}: {c} channels do not split into {num_groups} groups")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"{what}: scale and bias must be fp32")
    hw, sms = x.numel() // (b * c), _sms(x.device.index)
    plan_fn(b, hw, c, num_groups, x.element_size(), sms)  # raises where the kernel cannot
    row, row_stride = None, 0
    if add_row is not None:
        row = add_row.reshape(-1, c)
        if (row.shape[0] not in (1, b) or not row.is_contiguous()
                or row.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"{what}: add_row {tuple(add_row.shape)} {add_row.dtype} is "
                             "not a contiguous bf16 or fp32 [C], [1, C] or [B, C]")
        row_stride = 0 if row.shape[0] == 1 else c
    scale, bias = scale.contiguous(), bias.contiguous()  # held until the launch returns
    y = torch.empty_like(x)
    code = getattr(_build.cuda_lib(), entry)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), None if row is None else row.data_ptr(),
        y.data_ptr(), b, hw, c, num_groups, row_stride,
        int(row is not None and row.dtype == torch.float32), float(eps), int(silu),
        _DTYPES[x.dtype], sms, _build.stream_ptr(x.device))
    _build.check(code, what)
    return y


def group_norm_onepass(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
                       add_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel A2: the one-pass GroupNorm(x + add_row) (+SiLU) of x
    [B, ..., C] contiguous, in one launch of clusters that keeps every row
    in shared memory and reads x from device memory once. Its plain version
    is :func:`group_norm_plain` (the same function), which a CPU tensor
    takes; on a CUDA tensor the kernel runs or this raises (also where
    :func:`group_norm_onepass_plan` has no staged plan). Forward only:
    :func:`group_norm` gives it its backward."""
    if takes_plain(x):
        return group_norm_plain(x, scale, bias, num_groups, eps, silu, add_row)
    y = _launch("ctrlora_group_norm_onepass", group_norm_onepass_plan, "group_norm_onepass",
                x, scale, bias, num_groups, eps, silu, add_row)
    group_norm_onepass.launches += 1
    return y


group_norm_onepass.launches = 0


def _forward(x, scale, bias, num_groups, eps, silu, add_row):
    """Kernel A2 where gn1=1 admits the shape; else kernel A on a CUDA
    tensor, the plain version on a CPU tensor."""
    b, c = x.shape[0], x.shape[-1]
    if _onepass_ok(x.numel() // max(b * c, 1), c, x.dtype, num_groups):
        return group_norm_onepass(x, scale, bias, num_groups, eps, silu, add_row)
    if takes_plain(x):
        return group_norm_plain(x, scale, bias, num_groups, eps, silu, add_row)
    y = _launch("ctrlora_group_norm", group_norm_plan, "group_norm", x, scale, bias,
                num_groups, eps, silu, add_row)
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
