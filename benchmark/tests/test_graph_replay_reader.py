"""The reader of ``graph_replay_pct.train`` on the CPU: 0 over a traced
tiny training cell (off CUDA every step runs eager), 100 where every
recorded step replayed, and None in a sampling cell and where the program
counts no graph steps (as a program without the graph does not)."""

import pytest

from benchmark import run
from benchmark.spec import Spec

NAME = "graph_replay_pct.train"


@pytest.fixture
def reader(tiny_root):
    from ctrlora_tpu_torch.utils import trace

    trace.reset()
    yield Spec(tiny_root).reader(NAME)
    trace.reset()


def test_reads_zero_where_every_step_ran_eager(tiny_root, reader):
    spec = Spec(tiny_root)
    w = spec.workload("tiny.train")
    traffic = spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(spec.config(w["config"]), traffic, 2 ** 31 + 7,
                                             "cpu")
    cell.setup()
    tr, units = cell.traced()
    assert reader.read(run.Context("tiny.train", "train", tr, units, 0.0)) == 0.0
    assert reader.read(run.Context("tiny.train", "sample", tr, units, 0.0)) is None


@pytest.mark.parametrize("counted,want", [(True, 100.0), (False, None)])
def test_reads_the_replayed_share_of_the_steps(reader, counted, want):
    from ctrlora_tpu_torch.utils import trace

    with trace.recording():
        for _ in range(3):
            with trace.span("train.step"):
                with trace.span("train.graph.replay"):
                    pass
    if counted:
        trace.count("train.graph.replays", 3)
    assert reader.read(run.Context("tiny.train", "train", None, {"steps": 3}, 0.0)) == want
