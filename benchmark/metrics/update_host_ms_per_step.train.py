"""Host milliseconds of a training step's update (the gradient norm,
AdamW's step and the EMA): the host seconds of the program's own
``ctrlora.train.update`` spans (``ctrlora_tpu_torch.utils.trace``) over the
calls of its ``ctrlora.train.step`` spans. The program records its spans
exactly while a profiler records, so the reading is taken with the profiler
running, over both profiled passes of the traced steps; per step, so the
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
    spans = trace.summary()["spans"]
    step, update = spans.get("train.step"), spans.get("train.update")
    if not step or not step["calls"] or not update:
        return None
    return 1e3 * update["host_s"] / step["calls"]
