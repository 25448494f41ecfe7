"""The SDXL sampling window's share of the bf16 peak: the plain SDXL
reference's FLOPs of the traced requests (counted once on meta tensors:
both text towers, the guided model calls with the pixel hint's encoder,
the decode) over the seconds the same work takes untraced and 989
TFLOP/s."""

from benchmark.readers import peak_share

UNIT, LAYER, MOVES = "%", "model step (pipeline.py, models/)", "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample_sdxl":
        return None
    return peak_share(ctx)
