"""Device operations launched a training step in the traced window (every
kernel, copy and set), from the profiler's trace."""

UNIT = "launches/step"
LAYER = "trainer and step (training/trainer.py, training/step.py)"
MOVES = "train_images_per_s"


def read(ctx):
    if not ctx.kind == "train" or not ctx.steps or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.steps
