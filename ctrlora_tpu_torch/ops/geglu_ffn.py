"""Fused GEGLU feed-forward: CUDA kernel and plain version.

Kernel C of the port (``csrc/geglu_ffn.cu``, CUDA C++ for sm_90a). It
replaces the TPU kernels ``ctrlora_tpu/ops/geglu_ffn.py`` ``_geglu_kernel``
and ``_geglu_kernel_blocked``: ``[a | g] = x W1 + b1``,
``y = (a * gelu_erf(g)) W2 + b2`` without the [rows, 2F] pre-activation ever
reaching device memory. The source note in the .cu file says what bounds it
and how it is built.

Weights use ``nn.Linear``'s layout: ``w1`` [2F, C], ``w2`` [C, F].
:func:`geglu_ffn` is a ``torch.autograd.Function``: kernel forward, and a
backward that recomputes :func:`geglu_ffn_plain` under autograd (the JAX
``custom_vjp``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ctrlora_tpu_torch.ops import _build

KERNEL_WIDTHS = (320, 640, 1280)  # the SD1.5 transformer widths the kernel is built for


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
    """Static dispatch rule: the kernel serves the SD1.5 widths with F a
    multiple of its 64-wide chunk; other shapes take the plain version."""
    c = x.shape[-1]
    f2 = w1.shape[0]
    return (c in KERNEL_WIDTHS and f2 % 128 == 0 and w1.shape == (f2, c)
            and b1.shape == (f2,) and w2.shape == (c, f2 // 2) and b2.shape == (c,))


def _forward(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
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
    lib = _build.cuda_lib()
    code = lib.ctrlora_geglu_ffn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                 w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                 rows, c, f, _build.stream_ptr(x.device))
    _build.check(code, "geglu_ffn")
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
    """Fused GEGLU FFN over x [..., C]; returns [..., C] in x's dtype."""
    return _GegluFFN.apply(x, w1, b1, w2, b2)


geglu_ffn.launches = 0
