"""Share of its roofline that the GEGLU feed-forward reaches in the traced
sampling window (kernel C, or its plain version where a shape takes it),
computed as ``attn_fwd_roofline.sample`` is."""

from benchmark.readers import roofline_share

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample":
        return None
    return roofline_share(ctx.trace, "geglu")
