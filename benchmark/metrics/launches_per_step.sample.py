"""Device operations launched a DDIM step in the traced sampling window
(every kernel, copy and set, over the window's steps; the prep and decode
launches included), from the profiler's trace."""

UNIT = "launches/step"
LAYER = "samplers (sampling/ddim.py, sampling/common.py)"
MOVES = "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample" or not ctx.steps or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.steps
