"""Share of its roofline that the flash backward (dQ and dK/dV, kernels B4
and B5) reaches in the traced training window: the least time of each
call's two functions over the device time launched inside the call."""

from benchmark.readers import roofline_share

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "train_images_per_s"


def read(ctx):
    if not ctx.kind == "train":
        return None
    return roofline_share(ctx.trace, "attn_bwd")
