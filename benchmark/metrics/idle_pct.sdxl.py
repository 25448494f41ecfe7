"""Share of the untraced run of the profiled SDXL sampling work in which no
operation ran on the card: its seconds less the device's busy seconds
over the same work, from the pass that records the device alone."""

from benchmark.readers import idle_share

UNIT, LAYER, MOVES = "%", "device (H100)", "sample_images_per_s"


def read(ctx):
    return idle_share(ctx) if ctx.kind == "sample_sdxl" else None
