"""The training window's share of the bf16 peak: the plain reference's
FLOPs of the traced steps (forward and backward, no recomputation,
counted once on meta tensors) over the seconds the same work takes untraced and 989
TFLOP/s."""

from benchmark.readers import peak_share

UNIT, LAYER, MOVES = "%", "model step (pipeline.py, models/)", "train_images_per_s"


def read(ctx):
    if not ctx.kind == "train":
        return None
    return peak_share(ctx)
