"""Full-fp32 compute for the evaluation metrics.

PyTorch lets cuDNN convolutions (and, where the caller asks, matmuls) run
fp32 inputs on TF32 tensor cores, which keeps 10 mantissa bits: about 1e-3
relative error in LPIPS, the FID features or a CLIP embedding. The metric
entry points run under ``fp32_exact()``, which turns TF32 off for their
duration and restores the caller's settings on exit, so a sampling run in
the same process keeps its own.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """Matmuls and cuDNN convolutions in full fp32 inside the block; the
    caller's float32 matmul precision and cuDNN TF32 flag come back on exit.
    Usable as a decorator."""
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn
