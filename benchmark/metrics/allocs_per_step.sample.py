"""Tensor allocations a DDIM step: the caching allocator's
``allocation.all.allocated`` counted over the program's own
``ctrlora.sample.request`` spans (``ctrlora_tpu_torch.utils.trace``), over
the calls of its ``ctrlora.ddim.step`` spans, so the prep and decode
allocations are spread over the steps as ``launches_per_step.sample``
spreads their launches. It counts what a CUDA graph's pool must hold and
what fusing the step's glue removes. The program counts exactly while a
profiler records, so the reading is taken with the profiler running, over
both profiled passes of the traced requests. None where the program has no
such spans or counters."""

UNIT = "allocations/step"
LAYER = "samplers (sampling/ddim.py, sampling/common.py)"
MOVES = "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample":
        return None
    try:
        from ctrlora_tpu_torch.utils import trace
    except ImportError:
        return None
    got = trace.summary()
    step = got["spans"].get("ddim.step")
    request = got["counters"].get("allocator", {}).get("sample.request")
    if not step or not step["calls"] or not request:
        return None
    return request["allocation.all.allocated"] / step["calls"]
