"""Share of its roofline that attention's forward reaches in the traced
sampling window: over every call of the three attention dispatch entries,
the least time each call could take (the larger of its operations at the
bf16 peak and its bytes at the HBM peak, from the shapes it received and
the frozen work count) over the device time of the operations launched
inside them, kernel or plain path alike."""

from benchmark.readers import roofline_share

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample":
        return None
    return roofline_share(ctx.trace, "attn_fwd")
