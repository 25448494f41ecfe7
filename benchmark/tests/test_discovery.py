"""A configuration, a traffic mix and a per-layer metric dropped into a
directory of their own are found by name, with no existing file edited."""

import json
import os

from benchmark import run
from benchmark.spec import Spec


def test_parts_are_found_by_name(tiny_root):
    metrics = os.path.join(tiny_root, "tb", "metrics")
    os.makedirs(metrics)
    with open(os.path.join(metrics, "tiny_metric.py"), "w") as f:
        f.write("UNIT, LAYER, MOVES = 'x', 'device (H100)', 'setup_s'\n\n"
                "def read(ctx):\n    return 42.0 if ctx.steps else None\n")
    spec = Spec(tiny_root)
    assert spec.config("tiny_sample")["name"] == "tiny_sample"
    assert spec.traffic("tiny_train")["kind"] == "train"
    assert spec.driver("sample").KIND == "sample"
    reader = spec.reader("tiny_metric")
    assert reader.read(run.Context("tiny.sample", "sample", None, {"steps": 3}, 0.0)) == 42.0
    assert reader.read(run.Context("tiny.sample", "sample", None, {}, 0.0)) is None
    assert [m["name"] for m in spec.metrics_of("tiny.sample", trace=False)] == [
        "sample_images_per_s", "setup_s"]


def test_a_tiny_cell_runs_from_its_own_root(tiny_root, capsys):
    assert run.main(["--workload", "tiny.sample", "--seed", str(2 ** 31 + 9), "--seconds", "0",
                     "--trace", "0"], root=tiny_root, device="cpu", chip_check=False) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"sample_images_per_s", "setup_s"}
