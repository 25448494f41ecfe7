"""Host milliseconds a DDIM step: the host seconds of the program's own
``ctrlora.ddim.step`` spans (``ctrlora_tpu_torch.utils.trace``) over their
calls. The program records its spans exactly while a profiler records, so
the reading is taken with the profiler running, over both profiled passes
of the traced requests (the device alone, then CPU and CUDA); per call, so
the number of passes cancels out. None where the program has no such
spans."""

UNIT = "ms/step"
LAYER = "samplers (sampling/ddim.py, sampling/common.py)"
MOVES = "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample":
        return None
    try:
        from ctrlora_tpu_torch.utils import trace
    except ImportError:
        return None
    step = trace.summary()["spans"].get("ddim.step")
    if not step or not step["calls"]:
        return None
    return 1e3 * step["host_s"] / step["calls"]
