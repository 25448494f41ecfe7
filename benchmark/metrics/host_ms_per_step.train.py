"""Host milliseconds a training step: the host seconds of the program's own
``ctrlora.train.step`` spans (``ctrlora_tpu_torch.utils.trace``) over their
calls. The program records its spans exactly while a profiler records, so
the reading is taken with the profiler running, over both profiled passes
of the traced steps (the device alone, then CPU and CUDA); per call, so the
number of passes cancels out. None where the program has no such spans."""

UNIT = "ms/step"
LAYER = "trainer and step (training/trainer.py, training/step.py)"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train":
        return None
    try:
        from ctrlora_tpu_torch.utils import trace
    except ImportError:
        return None
    step = trace.summary()["spans"].get("train.step")
    if not step or not step["calls"]:
        return None
    return 1e3 * step["host_s"] / step["calls"]
