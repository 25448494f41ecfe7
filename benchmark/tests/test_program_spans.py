"""The readers of the program's own spans at the tiny size on the CPU: after
a traced piece of work each reads a finite positive number from the
program's totals (the allocator's counts exist only on a card, so there
it reads None), and None in a cell of the other kind."""

import math

import pytest

from benchmark import run
from benchmark.spec import Spec

READERS = {"sample": ("host_ms_per_step.sample", "allocs_per_step.sample"),
           "train": ("host_ms_per_step.train", "update_host_ms_per_step.train")}
CARD_ONLY = {"allocs_per_step.sample"}


@pytest.mark.parametrize("workload,kind", [("tiny.sample", "sample"), ("tiny.train", "train")])
def test_each_reader_reads_its_own_cell(tiny_root, workload, kind):
    from ctrlora_tpu_torch.utils import trace

    spec = Spec(tiny_root)
    w = spec.workload(workload)
    traffic = spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(spec.config(w["config"]), traffic, 2 ** 31 + 5,
                                             "cpu")
    cell.setup()
    trace.reset()
    tr, units = cell.traced()
    ctx = run.Context(workload, kind, tr, units, 0.0)
    for name in READERS[kind]:
        value = spec.reader(name).read(ctx)
        if name in CARD_ONLY:
            assert value is None, name
        else:
            assert value is not None and math.isfinite(value) and value > 0.0, (name, value)
    other_kind = "train" if kind == "sample" else "sample"
    other = run.Context(workload, other_kind, tr, units, 0.0)
    for name in READERS[kind] + READERS[other_kind]:
        assert spec.reader(name).read(other) is None, name
    trace.reset()
