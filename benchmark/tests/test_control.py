"""The control of each cell (the reference in the nearest precision below
the configuration's, in the program's place) comes out not correct under
the cell's limits, while the program comes out correct: at the tiny size
on the CPU, and at the cells' own size on a card (``card``)."""

import json

import pytest

from benchmark.spec import Spec
from benchmark.tests.conftest import needs_card

CELLS = [("tiny.sample", "sample.b8.ddim50"), ("tiny.train", "finetune.b16")]


def judged(spec, workload, readings):
    with open(spec.find("limits", workload)) as f:
        limits = json.load(f)
    return {k: readings[k] <= lim for k, lim in limits.items()}


def readings_of(spec, workload, seed, device, units=1):
    w = spec.workload(workload)
    traffic = spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(spec.config(w["config"]), traffic, seed, device)
    cell.setup()
    for i in range(units):
        cell.request(i) if traffic["kind"] == "sample" else cell.step()
    cell.release()
    return cell.check(control=True)


def test_the_controls_rounding_leaves_the_gradient_whole():
    """The float8 control rounds its operands forward only: its training
    gradient is the rounded forward pass's, not zero."""
    import torch

    from benchmark.reference.sd15 import round_e4m3

    gen = torch.Generator().manual_seed(3)
    t = (torch.randn(64, 64, dtype=torch.float64, generator=gen) * 1e-3).requires_grad_(True)
    r = round_e4m3(t)
    assert r.dtype == torch.float32
    assert torch.equal(r.detach(), round_e4m3(t.detach()))
    gap = (r.detach() - t.detach().float()).abs()
    assert 0 < gap.max() <= 2.0 ** -4 * t.detach().abs().max()
    (r * 1e-6).sum().backward()
    assert torch.equal(t.grad, torch.full_like(t, 1e-6, dtype=torch.float32).double())


@pytest.mark.parametrize("tiny,full", CELLS)
def test_control_fails_where_the_program_passes(tiny_root, tiny, full):
    spec = Spec(tiny_root)
    out = readings_of(spec, tiny, 31, "cpu")
    assert all(judged(Spec(), full, out["program"]).values())
    assert not all(judged(Spec(), full, out["control"]).values())


@pytest.mark.card
@pytest.mark.parametrize("workload", [full for _, full in CELLS])
def test_control_fails_at_the_cells_size(workload):
    needs_card()
    spec = Spec()
    for seed in (41, 42, 43):
        out = readings_of(spec, workload, seed, "cuda")
        assert all(judged(spec, workload, out["program"]).values()), out
        assert not all(judged(spec, workload, out["control"]).values()), out
