"""The benchmark's spans at the tiny size on the CPU: a traced piece of
work enters every range of the operator entries that the cell's path
reaches, each named with its call's shapes, and the originals are back
afterwards. The flash backward's range is entered from the kernels'
autograd function, which the models take on the card only (bf16, long
sequences); here it is driven directly."""

import importlib

import pytest

from benchmark import trace
from benchmark.spec import Spec


def traced_cell(root, workload):
    spec = Spec(root)
    w = spec.workload(workload)
    traffic = spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(spec.config(w["config"]), traffic, 12, "cpu")
    cell.setup()
    return cell.traced()


@pytest.mark.parametrize("workload,kinds", [("tiny.sample", {"attn_fwd", "geglu"}),
                                            ("tiny.train", {"attn_fwd", "geglu"})])
def test_every_range_is_entered(tiny_root, workload, kinds):
    before = {key: getattr(importlib.import_module(key[0]), key[1]) for key in trace.OP_ENTRIES}
    tr, units = traced_cell(tiny_root, workload)
    entered = {trace.parse_span(name)[0] for name in tr.spans}
    assert kinds <= entered, entered
    for kind in kinds:
        for shape, calls, _ in tr.spans_of(kind):
            assert calls > 0 and all(s > 0 for s in shape)
    assert tr.window_s > 0 and units["untraced_s"] > 0
    assert {key: getattr(importlib.import_module(key[0]), key[1])
            for key in trace.OP_ENTRIES} == before


def test_the_backward_range_is_entered():
    import torch

    from ctrlora_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(1, 2, 8, 4, requires_grad=True) for _ in range(3))

    def step():
        fa.flash_attention(q, k, v, 0.5)[0].sum().backward()

    tr = trace.profile(step, trace.op_spans)
    assert [(shape, calls) for shape, calls, _ in tr.spans_of("attn_bwd")] == [
        ((1, 2, 8, 8, 4, 4), 1)]
    assert q.grad is not None
