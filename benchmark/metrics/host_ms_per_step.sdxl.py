"""Host milliseconds a DDIM step of SDXL sampling: the host seconds of the
program's own ``ctrlora.ddim.step`` spans over their calls, read as
``host_ms_per_step.sample`` is (both profiled passes, per call). Below the
card's time a step, the card sets the pace. None where the program has no
such spans."""

UNIT = "ms/step"
LAYER = "samplers (sampling/ddim.py, sampling/common.py)"
MOVES = "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample_sdxl":
        return None
    try:
        from ctrlora_tpu_torch.utils import trace
    except ImportError:
        return None
    step = trace.summary()["spans"].get("ddim.step")
    if not step or not step["calls"]:
        return None
    return 1e3 * step["host_s"] / step["calls"]
