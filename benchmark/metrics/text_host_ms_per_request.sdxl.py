"""Host milliseconds a request spends in the two text towers: the host
seconds of the program's ``ctrlora.text.clip_l`` and ``ctrlora.text.bigg``
spans (``ctrlora_tpu_torch/utils/trace.py``) over the calls of its
``ctrlora.sample.request`` spans, over both profiled passes. None where the
program has no such spans."""

UNIT = "ms/request"
LAYER = "sample CLI"
MOVES = "sample_images_per_s"


def read(ctx):
    if ctx.kind != "sample_sdxl":
        return None
    try:
        from ctrlora_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()["spans"]
    request = spans.get("sample.request")
    towers = [spans.get(n) for n in ("text.clip_l", "text.bigg")]
    if not request or not request["calls"] or not all(towers):
        return None
    return 1e3 * sum(s["host_s"] for s in towers) / request["calls"]
