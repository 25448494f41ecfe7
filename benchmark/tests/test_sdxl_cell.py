"""The SDXL sampling cell at the tiny size on the CPU, past the look for a
card: a sound run comes out correct; each planted fault (``label_emb``
skipped, the pooled vector zeroed in the positive half, bigG's context
taken after its final LayerNorm) comes out not correct; the float8 control
fails where the program passes; the new readers read synthetic traces and
the D = 64 census is the calls the program's traced steps make."""

import json
import types

import pytest
import torch

from benchmark import run, work
from benchmark.spec import Spec
from benchmark.tests.tiny_sdxl import write_root

CELL = "tiny.sdxl"
FLASH = "flash_fwd_roofline.sdxl"
# the full cell's D = 64 flash forward a DDIM step (CFG batch 8): 14 self-attentions
# at 64^2 latents (10 heads; 10 in the UNet, 4 in the ControlNet), 90 at 32^2
# (20 heads; 60 in the UNet, 30 in the ControlNet)
FULL_STEP = {(8, 10, 4096, 4096, 64, 2): 14, (8, 20, 1024, 1024, 64, 2): 90}


@pytest.fixture
def sdxl_root(tmp_path):
    return write_root(str(tmp_path))


def result_of(root, capsys, trace=0) -> dict:
    assert run.main(["--workload", CELL, "--seed", str(2 ** 31 + 17), "--seconds", "0",
                     "--trace", str(trace)], root=root, device="cpu", chip_check=False) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(sdxl_root, capsys):
    line = result_of(sdxl_root, capsys)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"clip_rel", "vector_rel", "eps_rel", "pixel_mae"}
    assert set(line["metrics"]) == {"sample_images_per_s", "setup_s"}


def _skip_label_emb(monkeypatch):
    from ctrlora_tpu_torch.models import layers

    monkeypatch.setattr(layers.LabelEmbed, "forward",
                        lambda self, y, dtype: torch.zeros((y.shape[0], self.dense1.out_features),
                                                           dtype=dtype, device=y.device))


def _zero_positive_pooled(monkeypatch):
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

    encode = CtrLoraPipeline.encode_prompts

    def zeroed(self, *a, **k):
        ctx, unc, vec, uvec = encode(self, *a, **k)
        return ctx, unc, torch.cat([torch.zeros_like(vec[:, :-6]), vec[:, -6:]], 1), uvec

    monkeypatch.setattr(CtrLoraPipeline, "encode_prompts", zeroed)


def _context_after_ln_final(monkeypatch):
    from ctrlora_tpu_torch.models.clip import CLIPTextModel

    both = CLIPTextModel.context_and_pooled

    def after(self, ids):
        ctx, pooled = both(self, ids)
        return self.final_layer_norm(ctx).float(), pooled

    monkeypatch.setattr(CLIPTextModel, "context_and_pooled", after)


@pytest.mark.parametrize("fault", [_skip_label_emb, _zero_positive_pooled,
                                   _context_after_ln_final])
def test_a_planted_fault_is_not_correct(sdxl_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    assert result_of(sdxl_root, capsys)["correct"] is False


def test_control_fails_where_the_program_passes(sdxl_root):
    spec = Spec(sdxl_root)
    w = spec.workload(CELL)
    traffic = spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(spec.config(w["config"]), traffic, 31, "cpu")
    cell.setup()
    cell.request(0)
    cell.release()
    out = cell.check(control=True)
    with open(Spec().find("limits", "sdxl_cn.b4.ddim50")) as f:
        limits = json.load(f)
    assert all(out["program"][k] <= lim for k, lim in limits.items()), out
    assert not all(out["control"][k] <= lim for k, lim in limits.items()), out


def test_the_census_is_the_steps_calls(tmp_path):
    """bf16 towers taking the flash entries at 256^2 pixels: 16^2 latents,
    256 tokens at 8-wide heads, which the kernel's rule admits."""
    root = write_root(str(tmp_path), traffic={"resolution": 256, "trace_requests": 1},
                      dtype="bfloat16", use_flash_attention=True)
    spec = Spec(root)
    w = spec.workload(CELL)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(cfg, traffic, 5, "cpu")
    cell.setup()
    tr, units = cell.traced()
    reader = spec.reader(FLASH)
    seen = {shape: calls / units["steps"] for shape, calls, _ in tr.spans_of("attn_fwd")
            if shape[4] == 8 and reader.takes_kernel(True, *shape[2:5])}
    want = reader.census(cfg["model"], traffic, head_dim=8)
    # depth 2 at level 1: the UNet's encoder transformer and its two decoder ones, the
    # ControlNet's encoder one
    assert want and seen == want and sum(want.values()) == 2 * 4


def test_the_full_cell_census():
    spec = Spec()
    w = spec.workload("sdxl_cn.b4.ddim50")
    cfg = spec.config(w["config"])
    assert spec.reader(FLASH).census(cfg["model"], spec.traffic(w["traffic"])) == FULL_STEP


def test_the_frozen_rule_is_the_programs():
    from ctrlora_tpu_torch.ops import flash_attention as fa

    reader = Spec().reader(FLASH)
    bf16 = (torch.bfloat16,) * 3
    for sq in (64, 128, 1024, 4096):
        for sk in (77, 128, 256, 1024, 4096):
            for d in (8, 40, 64, 96, 512):
                assert reader.takes_kernel(True, sq, sk, d) == fa.flash_kernel_ok(bf16, sq, sk, d)


def _ctx(trace, steps=50, requests=1, kind="sample_sdxl", untraced_s=10.0, flops=0.0):
    units = {"requests": requests, "steps": steps, "images": 4, "untraced_s": untraced_s}
    return run.Context("sdxl_cn.b4.ddim50", kind, trace, units, flops)


def test_the_readers_on_a_synthetic_trace():
    spec = Spec()
    per_step = sum(n * work.least_seconds(*work.flash_forward_work(*s))
                   for s, n in FULL_STEP.items())
    fwd = {"void ctrlora::(anonymous namespace)::flash_fwd_wgmma<64>(CUtensorMap_st)": 2.0,
           "void ctrlora::(anonymous namespace)::flash_fwd_wgmma<40>(CUtensorMap_st)": 9.0,
           "void ctrlora::(anonymous namespace)::flash_fwd_wide(CUtensorMap_st)": 7.0}
    geglu = work.least_seconds(*work.geglu_ffn_work(8 * 1024, 1280, 5120))
    tr = types.SimpleNamespace(op_seconds=fwd, busy_s=7.5, spans={
        "bench.geglu[8192,1280,5120,2]": (3, 6 * geglu)})
    tr.spans_of = lambda kind: [((8192, 1280, 5120, 2), 3, 6 * geglu)] if kind == "geglu" else []
    ctx = _ctx(tr, flops=2.0e15)
    assert spec.reader(FLASH).read(ctx) == pytest.approx(100.0 * 50 * per_step / 2.0)
    assert spec.reader("geglu_roofline.sdxl").read(ctx) == pytest.approx(50.0)
    assert spec.reader("idle_pct.sdxl").read(ctx) == pytest.approx(25.0)
    assert spec.reader("mfu.sdxl").read(ctx) == pytest.approx(100 * 2.0e15 / 10.0 / 989e12)
    # no D = 64 kernel: nothing to read; another kind: nothing at all
    tr.op_seconds = {k: v for k, v in fwd.items() if "<64>" not in k}
    assert spec.reader(FLASH).read(ctx) is None
    for name in ("geglu_roofline.sdxl", "idle_pct.sdxl", "mfu.sdxl", "host_ms_per_step.sdxl",
                 "text_host_ms_per_request.sdxl"):
        assert spec.reader(name).read(_ctx(tr, kind="sample")) is None
    # the .sample readers read nothing of this cell's kind
    for m in spec.data["per_layer"]:
        if m["name"].endswith(".sample"):
            assert spec.reader(m["name"]).read(ctx) is None


def test_the_span_readers_read_the_programs_spans():
    from ctrlora_tpu_torch.utils import trace as program_trace

    spec = Spec()
    ctx = _ctx(types.SimpleNamespace())
    program_trace.reset()
    assert spec.reader("text_host_ms_per_request.sdxl").read(ctx) is None
    assert spec.reader("host_ms_per_step.sdxl").read(ctx) is None
    with program_trace.recording():
        for _ in range(2):
            with program_trace.span("sample.request"):
                with program_trace.span("sample.text"):
                    with program_trace.span("text.clip_l"):
                        pass
                    with program_trace.span("text.bigg"):
                        pass
                for i in range(3):
                    with program_trace.span("ddim.step", i):
                        pass
    spans = program_trace.summary()["spans"]
    want = 1e3 * (spans["text.clip_l"]["host_s"] + spans["text.bigg"]["host_s"]) / 2
    assert spec.reader("text_host_ms_per_request.sdxl").read(ctx) == pytest.approx(want)
    assert spec.reader("host_ms_per_step.sdxl").read(ctx) == pytest.approx(
        1e3 * spans["ddim.step"]["host_s"] / 6)
    program_trace.reset()
