"""Share of the traced training steps that replayed the step's CUDA graph:
100 x the calls of the program's ``ctrlora.train.graph.replay`` spans over
the calls of its ``ctrlora.train.step`` spans (``ctrlora_tpu_torch.utils.
trace``), over both profiled passes of the traced steps, as
``host_ms_per_step.train`` reads them. None where the program counts no
``train.graph.*`` steps (a program without the graph) or has no such
spans."""

UNIT = "%"
LAYER = "trainer and step (training/trainer.py, training/step.py)"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train":
        return None
    try:
        from ctrlora_tpu_torch.utils import trace
    except ImportError:
        return None
    summary = trace.summary()
    if not any(k.startswith("train.graph.") for k in summary["counters"]):
        return None
    step = summary["spans"].get("train.step")
    if not step or not step["calls"]:
        return None
    replays = summary["spans"].get("train.graph.replay", {"calls": 0})["calls"]
    return 100.0 * replays / step["calls"]
