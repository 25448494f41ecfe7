"""Analytic FLOP counting of one call (counterpart of
``ctrlora_tpu/utils/flops.py``).

The JAX counter walks a jaxpr and counts its dot_general and
conv_general_dilated FLOPs with the MAC = 2 convention, scan bodies times
their trip count, elementwise work ignored. Here the call runs eagerly
under torch's ``FlopCounterMode``, which counts the same two families as
they reach aten (``mm``, ``addmm``, ``bmm``, ``baddbmm``: every matmul and
Linear lowers to one of them; ``convolution`` and, for a backward pass,
``convolution_backward``) at MAC = 2. A loop counts once per iteration it
runs, as a scan does.

The hand kernels are ctypes launches that no dispatch mode sees, so the
call must run on CPU or meta tensors: there every kernel wrapper computes
its plain version (on meta tensors only during a count,
``ops.meta_takes_plain``), whose products are counted. On the ``meta``
device nothing is computed, so a full-width 50-step sample
counts in seconds with no arithmetic; a call that reads a value back from
a tensor cannot run there and is counted on the CPU. If a kernel launches
during a count, :func:`fn_flops` raises: its work would be missing.
Meta tensors still cost Python dispatch for every op, so
:func:`linear_in_steps` takes a long sampler's count from runs of one and
two steps.
Unlike JAX's TPU bench, whose walker skips ``pallas_call``, the GEGLU
feed-forward's two products are counted (as its plain version's).
"""

from __future__ import annotations

from typing import Callable

from torch.utils.flop_counter import FlopCounterMode

from ctrlora_tpu_torch import ops


def fn_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args, **kwargs)``: its dot and convolution
    products, MAC = 2, elementwise work ignored (JAX ``fn_flops``). The call
    runs, on the CPU or meta tensors it is given (see the module
    docstring); it raises if a hand kernel launched during it. The counting
    mode and the meta tensors' plain route end with the call, whether it
    returns or raises."""
    before = {name: w.launches for name, w in ops.wrappers().items()}
    with ops.meta_takes_plain(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    launched = {name: w.launches - before[name] for name, w in ops.wrappers().items()
                if w.launches != before[name]}
    if launched:
        raise ValueError(f"fn_flops: hand kernels launched during the count ({launched}); "
                         "their work is invisible to it: count on CPU or meta tensors")
    return float(counter.get_total_flops())


def linear_in_steps(count: Callable[[int], float], steps: int) -> float:
    """The count of a `steps`-step sampler workload from `count(1)` and
    `count(2)`: its set-up (text, hint, tables of every step's rows, the
    decode) counts a + c * S and each step the same b, so the workload
    counts count(1) + (steps - 1) * (count(2) - count(1))."""
    one = count(1)
    return one + (steps - 1) * (count(2) - one)
