"""Fused GEGLU feed-forward: CUDA kernels and plain version.

Kernel C of the port (``csrc/geglu_ffn.cu``, CUDA C++ for sm_90a). It
replaces the TPU kernels ``ctrlora_tpu/ops/geglu_ffn.py`` ``_geglu_kernel``
and ``_geglu_kernel_blocked``: ``[a | g] = x W1 + b1``,
``y = (a * gelu_erf(g)) W2 + b2`` without the [rows, 2F] pre-activation ever
reaching device memory. Two launches: ``ctrlora_geglu_up`` writes the gated
``h = a * gelu(g)`` [rows, F] in bf16, ``ctrlora_geglu_down`` computes
``h W2^T + b2``; :func:`geglu_plan` chooses their tiling. The source note in
the .cu file says what bounds them and how they are built.

Weights use ``nn.Linear``'s layout: ``w1`` [2F, C], ``w2`` [C, F].
:func:`geglu_ffn` is a ``torch.autograd.Function``: kernel forward, and a
backward that recomputes :func:`geglu_ffn_plain` under autograd (the JAX
``custom_vjp``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ctrlora_tpu_torch.ops import _build, takes_plain

# the transformer widths the kernels take: SD1.5's, and ControlNet-XS's 0.2x control stream
KERNEL_WIDTHS = (64, 128, 256, 320, 640, 1280)
BM = 128        # rows of a tile of either launch
DOWN_TILES = (160, 128, 64)  # a down tile's output columns: the first that divides C
K_BOX = 64      # columns of one TMA box: the unit of the K loops and of F
H100_SMS = 132
# a tile's fixed cost in the plan's units: F columns (up), K boxes (down)
UP_FIXED, DOWN_FIXED = 32, 4


@dataclasses.dataclass(frozen=True)
class GegluPlan:
    """The tiling of one call. Up: tiles of BM rows by ``bn_up`` columns of
    F (unit u is tile (u // n_up, u % n_up)); down: tiles of BM rows by
    ``bn_down`` output columns, each K range cut into ``split`` parts (unit
    u is part u % split of tile u // split). Each launch runs ``*_grid``
    persistent blocks, block b taking units b, b + grid, ..."""
    bn_up: int
    up_units: int
    up_grid: int
    split: int
    down_tiles: int
    down_units: int
    down_grid: int
    bn_down: int


@functools.lru_cache(maxsize=256)
def geglu_plan(rows: int, c: int, f: int, sms: int = H100_SMS) -> GegluPlan:
    """Tiling for rows x C x F on `sms` SMs that minimises the busiest SM's
    work: its units (ceil(units / sms)) times a unit's work plus a fixed cost
    (filling the ring, the epilogue). Up: 128 columns of F a tile (F % 128 ==
    0) or 64, costed in columns plus UP_FIXED. Down: tiles of the first of
    DOWN_TILES that divides C, and the split of the F / 64 boxes of K (a
    divisor), costed in boxes plus DOWN_FIXED; ties go to the wider tile
    and the smaller split."""
    m = -(-rows // BM)
    busiest = lambda units, work: -(-units // sms) * work
    costs = {bn: busiest(m * (f // bn), bn + UP_FIXED) for bn in (128, 64) if f % bn == 0}
    bn_up = min(costs, key=costs.get)
    bn_down = next((bn for bn in DOWN_TILES if c % bn == 0), None)
    if bn_down is None:
        raise ValueError(f"geglu_plan: no down tile of {DOWN_TILES} divides C = {c}")
    tiles = m * (c // bn_down)
    nk = f // K_BOX
    split = min((s for s in range(1, nk + 1) if nk % s == 0),
                key=lambda s: busiest(tiles * s, nk // s + DOWN_FIXED))
    up_units = m * (f // bn_up)
    return GegluPlan(bn_up, up_units, min(up_units, sms), split, tiles, tiles * split,
                     min(tiles * split, sms), bn_down)


def geglu_ffn_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The JAX ``_reference`` math: projections in x's dtype, exact GELU."""
    h = F.linear(x, w1.to(x.dtype), b1.to(x.dtype))
    a, g = h.chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2.to(x.dtype), b2.to(x.dtype))


def geglu_ffn_work(rows: int, c: int, f: int, itemsize: int = 2,
                   weight_itemsize: int = 2) -> tuple:
    """(flops, bytes) the function needs: both projections (2*rows*C*2F and
    2*rows*F*C); x and the weights and biases read once, y written once."""
    flops = 2 * rows * c * 2 * f + 2 * rows * f * c
    weights = (2 * f * c + 2 * f + c * f + c) * weight_itemsize
    return flops, 2 * rows * c * itemsize + weights


def geglu_shapes_ok(x, w1, b1, w2, b2) -> bool:
    """Static dispatch rule: the kernel serves the SD1.5 widths and
    ControlNet-XS's (KERNEL_WIDTHS) with F a multiple of its 64-wide box;
    other shapes take the plain version."""
    c = x.shape[-1]
    f2 = w1.shape[0]
    return (c in KERNEL_WIDTHS and f2 % 128 == 0 and w1.shape == (f2, c)
            and b1.shape == (f2,) and w2.shape == (c, f2 // 2) and b2.shape == (c,))


def geglu_kernel_ok(x, w1, b1, w2, b2) -> bool:
    """The static dispatch rule of ``FeedForward``, a pure function of
    dtypes and shapes: bf16 operands (the kernels' only type) at the shapes
    :func:`geglu_shapes_ok` admits; anything else takes the plain version."""
    return (all(t.dtype == torch.bfloat16 for t in (x, w1, b1, w2, b2))
            and geglu_shapes_ok(x, w1, b1, w2, b2))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict = {}  # device -> int32 split-K counters, zero between launches


def _split_counters(device, tiles: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < tiles:
        buf = _counters[device] = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                              device=device)
    return buf


def launch_up(x, w1, b1, h, plan: GegluPlan) -> None:
    """h [rows, F] = a * gelu(g) (the first entry point)."""
    c = x.shape[-1]
    code = _build.cuda_lib().ctrlora_geglu_up(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), h.data_ptr(), h.shape[0], c, h.shape[1],
        plan.bn_up, plan.up_grid, _build.stream_ptr(x.device))
    _build.check(code, "geglu_ffn up")


def launch_down(h, w2, b2, out, plan: GegluPlan) -> None:
    """out [rows, C] = h W2^T + b2 (the second entry point), through an fp32
    workspace where the plan splits K."""
    rows, f = h.shape
    c = w2.shape[0]
    ws, split_ptrs = None, (None, None)
    if plan.split > 1:
        ws = torch.empty((plan.split, rows, c), dtype=torch.float32, device=h.device)
        split_ptrs = (ws.data_ptr(), _split_counters(h.device, plan.down_tiles).data_ptr())
    code = _build.cuda_lib().ctrlora_geglu_down(
        h.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), *split_ptrs, rows, c, f,
        plan.split, plan.down_grid, plan.bn_down, _build.stream_ptr(h.device))
    _build.check(code, "geglu_ffn down")


def _forward(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernels on CUDA tensors, the plain version on CPU tensors (``ops.takes_plain``)."""
    if takes_plain(x):
        return geglu_ffn_plain(x, w1, b1, w2, b2)
    args = (x, w1, b1, w2, b2)
    if (x.device.type != "cuda" or any(t.dtype != torch.bfloat16 for t in args)
            or any(not t.is_contiguous() for t in args)):
        raise ValueError("geglu_ffn: needs contiguous bf16 CUDA tensors")
    if not geglu_shapes_ok(*args):
        raise ValueError(f"geglu_ffn: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)) or any(t.data_ptr() % 4 for t in (b1, b2)):
        raise ValueError("geglu_ffn: x and the weights must be 16-byte aligned")
    c = x.shape[-1]
    f = w1.shape[0] // 2
    rows = x.numel() // c
    out = torch.empty_like(x)
    plan = geglu_plan(rows, c, f, _sm_count(x.device.index))
    h = torch.empty((rows, f), dtype=torch.bfloat16, device=x.device)
    launch_up(x, w1, b1, h, plan)
    launch_down(h, w2, b2, out, plan)
    geglu_ffn.launches += 1
    return out


class _GegluFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = geglu_ffn_plain(*ins)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, gy) if wrt else ())
        return tuple(next(got) if n else None for n in need)


def geglu_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused GEGLU FFN over x [..., C]; returns [..., C] in x's dtype. Where
    no gradient can flow (sampling), the forward runs without the autograd
    Function's bookkeeping."""
    args = (x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GegluFFN.apply(*args)
    return _forward(*args)


geglu_ffn.launches = 0
