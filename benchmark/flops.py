"""Analytic FLOP count of one call: a frozen copy of ``fn_flops`` in
``ctrlora_tpu_torch/utils/flops.py`` at commit a86232d, without its check
on the program's kernel wrappers (it counts the benchmark's own plain
reference, which has none).

The call runs eagerly under torch's ``FlopCounterMode``, which counts the
products as they reach aten (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
``convolution`` and, in a backward pass, ``convolution_backward``) at
MAC = 2, elementwise work ignored. On ``meta`` tensors nothing is
computed, so a full-width model counts in seconds.
"""

from __future__ import annotations

from typing import Callable

from torch.utils.flop_counter import FlopCounterMode


def fn_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args, **kwargs)``: its dot and
    convolution products, MAC = 2."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
