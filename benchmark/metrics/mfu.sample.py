"""The sampling window's share of the bf16 peak: the plain reference's
FLOPs of the traced requests (counted once on meta tensors; the LoRA
folded, as served) over the seconds the same work takes untraced and 989 TFLOP/s."""

from benchmark.readers import peak_share

UNIT, LAYER, MOVES = "%", "model step (pipeline.py, models/)", "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample":
        return None
    return peak_share(ctx)
