"""Spans and the device trace of a ``--trace 1`` run.

:func:`op_spans` wraps the program's operator entry points, as the models
look them up at call time (``fa_ops.<entry>``, ``geglu_ops.<entry>``), in
``torch.profiler.record_function`` ranges named with each call's shapes:
``bench.attn_fwd[b,h,sq,sk,d,itemsize]`` around the three attention
dispatch entries (kernel and plain path alike), ``bench.attn_bwd[...]``
around the flash backward, ``bench.geglu[rows,c,f,itemsize]`` around the
GEGLU feed-forward and its plain version. :func:`method_spans` names coarse
host phases the same way. :func:`profile` runs a callable twice: under a
profiler that records the device's activity alone, with no spans, for the
device's busy and idle time (recording every host operation slows a
host-bound step, and with it the device's pace); then with the spans under
``torch.profiler`` (CPU and CUDA), for the spans, the launches and the
breakdown. It reduces both to what the metric readers take
(:class:`Trace`).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time
from typing import Callable, Dict, Iterator, List, Tuple

import torch

SPAN_PREFIX = "bench."


def _bhsd(q, k):
    return q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], q.element_size()


def _bshd(q, k):
    return q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3], q.element_size()


def _qkv(qkv, heads, dim_head):
    return qkv.shape[0], heads, qkv.shape[1], qkv.shape[1], dim_head, qkv.element_size()


def _geglu(x, w1):
    c = x.shape[-1]
    return x.numel() // c, c, w1.shape[0] // 2, x.element_size()


# (module, entry) -> (span kind, shapes from the call's leading arguments)
OP_ENTRIES = {
    ("ctrlora_tpu_torch.ops.flash_attention", "dot_product_attention"):
        ("attn_fwd", lambda a: _bhsd(a[0], a[1])),
    ("ctrlora_tpu_torch.ops.flash_attention", "dot_product_attention_bshd"):
        ("attn_fwd", lambda a: _bshd(a[0], a[1])),
    ("ctrlora_tpu_torch.ops.flash_attention", "dot_product_attention_bshd_qkv"):
        ("attn_fwd", lambda a: _qkv(a[0], a[1], a[2])),
    ("ctrlora_tpu_torch.ops.flash_attention", "flash_attention_bwd"):
        ("attn_bwd", lambda a: _bhsd(a[0], a[1])),
    ("ctrlora_tpu_torch.ops.geglu_ffn", "geglu_ffn"):
        ("geglu", lambda a: _geglu(a[0], a[1])),
    ("ctrlora_tpu_torch.ops.geglu_ffn", "geglu_ffn_plain"):
        ("geglu", lambda a: _geglu(a[0], a[1])),
}


def span_name(kind: str, shape) -> str:
    return f"{SPAN_PREFIX}{kind}[{','.join(str(int(s)) for s in shape)}]"


def parse_span(name: str) -> Tuple[str, Tuple[int, ...]]:
    """('attn_fwd', (b, h, sq, sk, d, itemsize)) of a span name."""
    kind, _, rest = name[len(SPAN_PREFIX):].partition("[")
    return kind, tuple(int(s) for s in rest.rstrip("]").split(",") if s)


def _wrapped(fn: Callable, kind: str, shape_of: Callable) -> Callable:
    @functools.wraps(fn)
    def span(*args, **kwargs):
        with torch.profiler.record_function(span_name(kind, shape_of(args))):
            return fn(*args, **kwargs)
    return span


@contextlib.contextmanager
def op_spans() -> Iterator[None]:
    """The program's operator entries wrapped in shape-named ranges; the
    originals are back on leaving."""
    saved = []
    try:
        for (mod_name, attr), (kind, shape_of) in OP_ENTRIES.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _wrapped(fn, kind, shape_of))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def method_spans(obj, names: Dict[str, str]) -> Iterator[None]:
    """``obj.<method>`` wrapped in a range ``bench.<label>`` for each
    method -> label of `names`, as an instance attribute; what the instance
    held before is back on leaving."""
    saved = {m: obj.__dict__[m] for m in names if m in obj.__dict__}
    for method, label in names.items():
        fn = getattr(obj, method)

        def span(*args, _fn=fn, _label=SPAN_PREFIX + label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)
        setattr(obj, method, span)
    try:
        yield
    finally:
        for method in names:
            if method in saved:
                setattr(obj, method, saved[method])
            else:
                delattr(obj, method)


class Trace:
    """What the readers take from a profiled piece of work: ``window_s``
    (host clock, synchronised at both ends) and ``busy_s`` (the union of
    device operations' intervals), both of the pass that records the
    device alone; of the pass with the host's operations and the spans,
    ``launches`` (device operations: kernels,
    copies, sets), ``spans`` ({name: (calls, device seconds of the
    operations launched inside)}: the operations that start within the
    device-side interval the profiler records for the range),
    ``op_seconds`` (device seconds by operation name), ``device_ops`` (the
    ten longest) and ``idle_gaps`` (the breakdown)."""

    def __init__(self, window_s: float, busy_s: float, launches: int,
                 spans: Dict[str, Tuple[int, float]], op_seconds: Dict[str, float],
                 idle_gaps: List):
        self.window_s, self.busy_s, self.launches = window_s, busy_s, launches
        self.spans, self.op_seconds, self.idle_gaps = spans, op_seconds, idle_gaps
        self.device_ops = sorted(([n[:120], s] for n, s in op_seconds.items()),
                                 key=lambda x: -x[1])[:10]

    def spans_of(self, kind: str) -> List[Tuple[Tuple[int, ...], int, float]]:
        """[(shape, calls, device seconds)] of the spans of one kind."""
        out = []
        for name, (calls, dev_s) in self.spans.items():
            k, shape = parse_span(name)
            if k == kind:
                out.append((shape, calls, dev_s))
        return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_at(cpu: List, t: float) -> str:
    """The innermost host operation running at time t (us), with the
    outermost benchmark span around it."""
    inner, outer = None, None
    for e in cpu:
        s, f = e.time_range.start, e.time_range.end
        if s <= t < f:
            if inner is None or f - s < inner.time_range.end - inner.time_range.start:
                inner = e
            if e.name.startswith(SPAN_PREFIX) and (
                    outer is None or f - s > outer.time_range.end - outer.time_range.start):
                outer = e
    if inner is None:
        return "host: outside any operation"
    name = inner.name if outer is None or outer is inner else f"{inner.name} in {outer.name}"
    return name[:120]


def _device_ops(events) -> List:
    from torch.autograd import DeviceType

    return sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), key=lambda e: e.time_range.start)


def _profiled(run: Callable[[], None], activities) -> Tuple[float, "torch.profiler.profile"]:
    """(seconds `run` took, synchronised at both ends; the profiler)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    with torch.profiler.profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    return window_s, prof


def _busy_seconds(prof) -> float:
    """The union of the device operations' intervals, read off the raw
    trace (the profiler's own list of events is slow to build)."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    return sum(e - s for s, e in _merge([(e.start_ns(), e.end_ns()) for e in raw
                                         if e.device_type() == DeviceType.CUDA
                                         and not e.is_user_annotation()])) / 1e9


def profile(run: Callable[[], None],
            spans: Callable[[], contextlib.AbstractContextManager] = contextlib.nullcontext
            ) -> Trace:
    """Run `run` with the device recorded alone, then under `spans()` with
    the host recorded too, and reduce the two traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    device_only = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    window_s, prof = _profiled(run, device_only)
    busy_s = _busy_seconds(prof)
    with spans():
        _, prof = _profiled(run, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    # the device-side copy of a user range spans the operations launched inside it
    annotations = [e for e in device if e.is_user_annotation]
    ops = _device_ops(events)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    busy = _merge([(e.time_range.start, e.time_range.end) for e in ops])
    starts = [e.time_range.start for e in ops]
    before = [0.0]
    for e in ops:
        before.append(before[-1] + e.time_range.elapsed_us())
    spans_read: Dict[str, Tuple[int, float]] = {}
    for e in cpu:
        if e.name.startswith(SPAN_PREFIX):
            calls, dev = spans_read.get(e.name, (0, 0.0))
            spans_read[e.name] = (calls + 1, dev)
    for a in annotations:
        if a.name in spans_read:
            lo = bisect.bisect_left(starts, a.time_range.start)
            hi = bisect.bisect_left(starts, a.time_range.end)
            calls, dev = spans_read[a.name]
            spans_read[a.name] = (calls, dev + (before[hi] - before[lo]) / 1e6)
    by_name: Dict[str, float] = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:10]
    idle_gaps = [[_host_at(cpu, start), g / 1e6] for g, start in gaps]
    return Trace(window_s, busy_s, len(ops), spans_read, by_name, idle_gaps)
