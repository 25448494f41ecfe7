"""Spans and counters of the port, on the profiler's clock.

A span marks one layer boundary of the main path (names below). Recording
is on while any ``torch.profiler`` records and inside :func:`recording`;
otherwise :func:`span` returns one shared no-op object after reading two
flags, so an unprofiled run allocates nothing and reads no clock. While
recording, a span enters ``torch.profiler.record_function("ctrlora." +
name)``, so under a profiler it lies on the same Kineto timeline as the
device's operations, with a device-side range over the operations launched
inside it; and it adds its host time (``time.perf_counter_ns``) to
in-memory totals by name: calls, host seconds, and self seconds (host
seconds less what its child spans cover). Spans nest on a stack of their
own thread. Memory stays one entry a name; nothing is written to disk.

How an operator reads them::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        sample_batch(pipe, hint, ids, nids, opts, seed)   # or trainer.step_fn(...)
    trace.summary()                          # host seconds by span, counters
    prof.export_chrome_trace("trace.json")   # the ctrlora.* ranges over the device's work

or, without the profiler's cost, ``trace.reset()``, then the work inside
``with trace.recording():``, then ``trace.summary()``.

Spans (child of):
  sample.request (index: the request's number) with sample.text,
      sample.hint, sample.sampler, sample.decode and sample.to_host (the
      clamp, uint8 and copy to the host: the host's wait for the card):
      ``scripts/sample.sample_rows``; a model with a conditioner (SDXL) has
      text.clip_l and text.bigg (its two towers, ``pipeline.
      encode_text_pooled``) inside sample.text, and model.vector (the
      vectors' size embedding and each branch's label_emb, once a request
      where the time embedding is hoisted: ``pipeline.emb_proj_tables``); sample.request with sample.prep,
      sample.sampler and sample.decode: the API's and the style API's
      sampling calls, whose ``timings=`` read them.
  ddim.step, plms.step, dpm.step (index: the step): one a sampler step.
  model.call with model.control and model.unet: ``pipeline.apply_model``.
  train.step (index: the state's step) with train.forward, train.backward
      and train.update (grad norm, AdamW, EMA): ``training/step.py``; a
      step that replays its CUDA graph has train.graph.replay in place of
      train.forward and train.backward, and no span inside it (no Python
      runs there).

Counters (:func:`summary`'s ``counters``):
  kernels.built: builds of the kernel library in this process.
  model.vector.rows: the model-call rows (CFG rows) whose vector
      conditioning went through label_emb in model.vector.
  train.graph.captures, train.graph.replays, train.graph.eager: training
      steps that captured their CUDA graph, replayed one (a capture's own
      step included) and ran eager (``training/step.py``).
  launches: each hand-kernel wrapper's ``.launches`` (``ops.wrappers()``),
      as it stands.
  allocator: {span: {stat: delta}} of ``torch.cuda.memory_stats()``'s
      ``allocation.all.allocated`` (tensor allocations served),
      ``num_device_alloc`` (``cudaMalloc`` calls) and ``num_alloc_retries``,
      read at the entry and exit of sample.request and train.step while
      recording in a process that uses CUDA.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "ctrlora."
ALLOCATOR_SPANS = frozenset(("sample.request", "train.step"))
ALLOCATOR_STATS = ("allocation.all.allocated", "num_device_alloc", "num_alloc_retries")

_lock = threading.Lock()
_local = threading.local()
_recording = 0  # open recording() blocks
_totals: Dict[str, List[int]] = {}  # name -> [calls, host ns, self ns]
_allocator: Dict[str, Dict[str, int]] = {}
_counters: Dict[str, int] = {}


class _Off:
    """What :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _memory() -> Optional[Dict[str, int]]:
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ALLOCATOR_STATS}


class _Span:
    __slots__ = ("name", "index", "_range", "_mem", "_child_ns", "_t0")

    def __init__(self, name: str, index):
        self.name, self.index = name, index

    def __enter__(self) -> "_Span":
        self._range = torch.profiler.record_function(
            PREFIX + self.name, None if self.index is None else str(self.index))
        self._range.__enter__()
        self._mem = _memory() if self.name in ALLOCATOR_SPANS else None
        self._child_ns = 0
        stack = _stack()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child_ns += ns
        mem = _memory() if self._mem is not None else None
        with _lock:
            tot = _totals.setdefault(self.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - self._child_ns
            if mem is not None:
                acc = _allocator.setdefault(self.name, dict.fromkeys(ALLOCATOR_STATS, 0))
                for k in ALLOCATOR_STATS:
                    acc[k] += mem[k] - self._mem[k]
        self._range.__exit__(*exc)
        return False


def span(name: str, index=None):
    """A context manager over one layer boundary: a recorded span while a
    profiler records or inside :func:`recording`, else the shared no-op
    :data:`OFF`. `index` (a step or request number) becomes the range's
    argument in the profiler's trace."""
    if _recording or _profiler._is_profiler_enabled:
        return _Span(name, index)
    return OFF


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans record inside the block, profiler or not."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


@contextlib.contextmanager
def timings_into(out: Optional[dict], **keys: str) -> Iterator[None]:
    """With a dict `out`: record inside the block, then write into `out`,
    for each key, the host seconds that the span it names spent inside the
    block. With None: nothing."""
    if out is None:
        yield
        return

    def host_ns():
        with _lock:
            return {k: _totals.get(n, (0, 0))[1] for k, n in keys.items()}

    before = host_ns()
    with recording():
        yield
    after = host_ns()
    out.update({k: (after[k] - before[k]) / 1e9 for k in keys})


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`, recording or not."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def summary() -> dict:
    """``{"spans": {name: {"calls", "host_s", "self_s"}}, "counters":
    {"kernels.built", "launches": {wrapper: n}, "allocator": {span: {stat:
    delta}}}}`` since the last :func:`reset` (the launches as the wrappers
    hold them)."""
    from ctrlora_tpu_torch import ops

    with _lock:
        spans = {name: {"calls": c, "host_s": ns / 1e9, "self_s": own / 1e9}
                 for name, (c, ns, own) in _totals.items()}
        allocator = {name: dict(acc) for name, acc in _allocator.items()}
        counters = dict(_counters)
    counters.setdefault("kernels.built", 0)
    counters["launches"] = {name: fn.launches for name, fn in ops.wrappers().items()}
    counters["allocator"] = allocator
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear the spans' totals and the counters (not the wrappers' launch
    counts, which their own readers take differences of)."""
    with _lock:
        _totals.clear()
        _allocator.clear()
        _counters.clear()
