"""Share of its roofline that the GEGLU feed-forward (kernel C, at C = 640
and 1280) reaches in the traced SDXL sampling window, computed as
``geglu_roofline.sample`` is: over every call, the least time its shapes
allow over the device time launched inside its span."""

from benchmark.readers import roofline_share

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample_sdxl":
        return None
    return roofline_share(ctx.trace, "geglu")
