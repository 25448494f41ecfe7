"""The port's spans and counters (``ctrlora_tpu_torch.utils.trace``) on the
CPU at the tiny size: nothing recorded and one shared no-op object while
no profiler records; under ``torch.profiler`` a sampling request and a
training step record their layer boundaries, nested, with the profiler's
own events holding the same ``ctrlora.*`` ranges; the stack survives an
exception and is per thread; ``reset`` and the counters."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctrlora_tpu_torch import configs, ops
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.scripts.sample import SampleOptions, sample_batch
from ctrlora_tpu_torch.training.trainer import Trainer
from ctrlora_tpu_torch.utils import trace

STEPS = 3
REQUEST = ("sample.text", "sample.hint", "sample.sampler", "sample.decode", "sample.to_host")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small models on a shared host: one torch thread (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_totals():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def request_args():
    pipe = CtrLoraPipeline(configs.tiny_test_config(), "cpu")
    rng = np.random.default_rng(0)
    hint = rng.random((2, 16, 16, 3), dtype=np.float32)
    ids = rng.integers(1, 128, (2, 16))
    opts = SampleOptions(sampler="ddim", steps=STEPS, scale=7.5, eta=0.0, strength=1.0)
    return pipe, hint, ids, np.zeros_like(ids), opts, 0


@pytest.fixture(scope="module")
def profiled_request(request_args):
    """(summary, the profiler's ctrlora.* events) of one profiled request."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sample_batch(*request_args)
    out = trace.summary()
    trace.reset()
    return out, [e for e in prof.events() if e.name.startswith(trace.PREFIX)]


def test_off_records_nothing(request_args):
    assert trace.span("sample.request") is trace.OFF
    assert trace.span("ddim.step", 0) is trace.span("model.call")
    sample_batch(*request_args)
    got = trace.summary()
    assert got["spans"] == {} and got["counters"]["allocator"] == {}


def test_profiled_request_records_each_layer(profiled_request):
    spans = profiled_request[0]["spans"]
    assert spans["sample.request"]["calls"] == 1
    assert all(spans[name]["calls"] == 1 for name in REQUEST)
    # CFG runs on one stacked batch: one model call a step
    assert spans["ddim.step"]["calls"] == spans["model.call"]["calls"] == STEPS
    assert spans["model.control"]["calls"] == spans["model.unet"]["calls"] == STEPS
    host = {name: s["host_s"] for name, s in spans.items()}
    assert sum(host[n] for n in REQUEST) <= host["sample.request"]
    assert host["ddim.step"] <= host["sample.sampler"]
    assert host["model.call"] <= host["ddim.step"]
    assert host["model.control"] + host["model.unet"] <= host["model.call"]


def test_self_seconds_are_never_negative(profiled_request):
    spans = profiled_request[0]["spans"]
    assert spans
    for name, s in spans.items():
        assert 0.0 <= s["self_s"] <= s["host_s"], name
    children = sum(spans[n]["host_s"] for n in REQUEST)
    assert spans["sample.request"]["self_s"] == pytest.approx(
        spans["sample.request"]["host_s"] - children, abs=1e-6)


def test_profiler_events_hold_the_ranges(profiled_request):
    spans, events = profiled_request[0]["spans"], profiled_request[1]
    counts = {}
    for e in events:
        counts[e.name[len(trace.PREFIX):]] = counts.get(e.name[len(trace.PREFIX):], 0) + 1
    assert counts == {name: s["calls"] for name, s in spans.items()}
    # one clock: the steps lie inside the sampler's range, the sampler inside the request's
    by_name = lambda n: [e.time_range for e in events if e.name == trace.PREFIX + n]
    (request,), (sampler,) = by_name("sample.request"), by_name("sample.sampler")
    assert request.start <= sampler.start and sampler.end <= request.end
    steps = by_name("ddim.step")
    assert len(steps) == STEPS
    assert all(sampler.start <= r.start and r.end <= sampler.end for r in steps)


def test_training_step_records_its_phases_in_order(tmp_path):
    gen = torch.Generator().manual_seed(3)
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu", fuse_lora=False)
    tcfg = configs.TrainConfig(trainable="lora", learning_rate=1e-3, use_ema=True)
    trainer = Trainer(pipe, tcfg, str(tmp_path))
    batch = {"jpg": torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1,
             "hint": torch.rand(2, 16, 16, 3, generator=gen),
             "token_ids": torch.randint(1, 128, (2, 16), generator=gen)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.state, _ = trainer.step_fn(trainer.state, batch, gen)
    spans = trace.summary()["spans"]
    phases = ("train.forward", "train.backward", "train.update")
    assert all(spans[n]["calls"] == 1 for n in ("train.step", *phases))
    assert sum(spans[n]["host_s"] for n in phases) <= spans["train.step"]["host_s"]
    assert spans["model.call"]["calls"] == 1
    events = sorted((e for e in prof.events() if e.name.startswith(trace.PREFIX + "train.")),
                    key=lambda e: e.time_range.start)
    assert [e.name[len(trace.PREFIX):] for e in events] == ["train.step", *phases]
    assert all(events[i].time_range.end <= events[i + 1].time_range.start
               for i in range(1, len(events) - 1))


def test_an_exception_leaves_the_stack_empty():
    with trace.recording():
        with pytest.raises(RuntimeError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise RuntimeError("inside")
        assert trace._stack() == []
        with trace.span("after"):
            pass
    spans = trace.summary()["spans"]
    assert {n: s["calls"] for n, s in spans.items()} == {"outer": 1, "inner": 1, "after": 1}
    assert spans["after"]["self_s"] == spans["after"]["host_s"]


def test_spans_nest_per_thread():
    def other():
        with trace.span("other"):
            pass

    with trace.recording():
        with trace.span("main"):
            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    spans = trace.summary()["spans"]
    assert spans["other"]["calls"] == 1
    assert spans["main"]["self_s"] == spans["main"]["host_s"]  # no child on its thread


def test_recording_turns_spans_on_and_off():
    assert trace.span("x") is trace.OFF
    with trace.recording():
        assert trace.span("x") is not trace.OFF
    assert trace.span("x") is trace.OFF


def test_reset_clears_the_totals():
    with trace.recording():
        with trace.span("a", 7):
            pass
    trace.count("kernels.built")
    assert trace.summary()["spans"]["a"]["calls"] == 1
    assert trace.summary()["counters"]["kernels.built"] == 1
    trace.reset()
    got = trace.summary()
    assert got["spans"] == {} and got["counters"]["kernels.built"] == 0


def test_timings_into_reads_the_spans():
    out = {}
    with trace.timings_into(out, a_s="a", b_s="b"):
        with trace.span("a"):
            pass
    assert set(out) == {"a_s", "b_s"} and out["a_s"] > 0.0 and out["b_s"] == 0.0
    with trace.timings_into(None, a_s="a"):
        assert trace.span("a") is trace.OFF


def test_launch_counts_are_the_wrappers():
    launches = trace.summary()["counters"]["launches"]
    assert launches == {name: fn.launches for name, fn in ops.wrappers().items()}
    assert set(launches) == set(ops.wrappers())
