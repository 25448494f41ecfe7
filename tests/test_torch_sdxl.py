"""SDXL base 1.0 with its ControlNet in the port, at a tiny size on the CPU,
against the benchmark's plain float32 reference
(``benchmark/reference/sdxl.py``), both on one set of seeded weights
(``benchmark/seeding.py``):

* the UNet and the ControlNet forwards with y;
* bigG's context and pooled vector from one forward against two separate
  reference reads;
* the hoisted per-row time-embedding tables of a DDIM run against the
  un-hoisted model calls;
* the zero negative conditioning of the empty prompt;
* a 3-step ``sample_batch`` trajectory, compared on eps and latents, with
  its spans and counter;

and that an SD1.5 configuration keeps its one-row tables and their unpack
layout, and that the SDXL preset loads from a YAML file.

Tolerances: program and reference compute in float32 on the CPU, in other
orders (the port's hoisted and fused products, its fused GroupNorm); what
is left is float32 rounding, a relative L2 of about 1e-6 a product carried
through at most ~40 layers here, so 1e-4 leaves room; the trajectory's
latents carry three steps of it (1e-4 as well). The hoisted tables make
the same products on the same operands as the un-hoisted calls, but all
steps' rows in one product (its blocking, and so its float32 rounding,
differs from a call's): 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import seeding
from benchmark.reference.sdxl import SDXLReference, guided_eps_xl
from benchmark.reference.diffusion import ddim_coefficients, ddim_ladder
from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import make_emb_row_tables
from ctrlora_tpu_torch.scripts.sample import SampleOptions, sample_batch
from ctrlora_tpu_torch.utils import trace

SIZE = 64  # pixels; the tiny VAE and the hint encoder are /8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def model():
    """(pipeline, reference, model section) on one seed's weights."""
    cfg = configs.load_model_config("tiny_sdxl")
    pipe = CtrLoraPipeline(cfg, "cpu")
    names = ("unet", "control", "vae", "clip", "clip2")
    shapes = {k: {n: tuple(t.shape) for n, t in getattr(pipe, k).state_dict().items()}
              for k in names}
    raw = seeding.seeded_weights(shapes, 2024, "cpu", dict.fromkeys(names, torch.float32))
    for k in names:
        getattr(pipe, k).load_state_dict(raw[k], strict=True)
    pipe.cast_for_inference()
    m = dataclasses.asdict(cfg)
    return pipe, SDXLReference(m, raw), m


def prompt_ids(rows: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(seeding.prompt_ids(rng, rows, 4, 16, length=16))


def empty_ids(rows: int) -> torch.Tensor:
    return torch.from_numpy(seeding.empty_prompt_ids(rows, 16))


def inputs(pipe, rows: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, SIZE // 8, SIZE // 8, 4), generator=gen)
    hint = torch.rand((rows, SIZE, SIZE, 3), generator=gen)
    ctx, unc, vec, uvec = pipe.encode_prompts(prompt_ids(rows, seed), empty_ids(rows),
                                              (SIZE, SIZE))
    return x, hint, ctx, vec


def test_unet_and_controlnet_with_y(model):
    pipe, ref, _ = model
    x, hint, ctx, vec = inputs(pipe, 2, 1)
    t = torch.tensor([999, 421])
    y = ref.vector(vec[:, :-6], (SIZE, SIZE))
    taps = pipe.control(x, t, ctx, hint=hint, y=pipe.embed_vector(vec))
    want = ref.unet.taps(x.permute(0, 3, 1, 2), t, ctx, y, hint.permute(0, 3, 1, 2))
    assert len(taps) == len(want) == 7  # in_conv, 3 ResBlocks, 2 downsamples, the middle
    for got, w in zip(taps, want):
        assert rel(got.permute(0, 3, 1, 2), w) < 1e-4
    out = pipe.apply_model(x, t, ctx, [Conditioning(hint)], vector=vec)
    ref_out = ref.unet.controlled_xl(x.permute(0, 3, 1, 2), t, ctx, y, hint.permute(0, 3, 1, 2))
    assert rel(out.permute(0, 3, 1, 2), ref_out) < 1e-4
    # y reaches the output: another vector moves it
    other = pipe.apply_model(x, t, ctx, [Conditioning(hint)], vector=vec.flip(0))
    assert rel(other, out) > 1e-3


def test_bigg_context_and_pooled_from_one_forward(model):
    pipe, ref, _ = model
    ids = prompt_ids(3, 2)
    ctx, pooled = pipe.clip2.context_and_pooled(ids)
    tower = ref.towers["clip2"]
    assert ctx.shape == (3, 16, 48) and pooled.shape == (3, 40)
    assert rel(ctx, tower.context(ids)) < 1e-5
    assert rel(pooled, tower.pooled(ids)) < 1e-5
    both, pooled2 = pipe.encode_text_pooled(ids)
    want, want_pooled = ref.text(ids)
    assert both.shape == (3, 16, 112)
    assert rel(both, want) < 1e-5 and torch.equal(pooled2, pooled)
    assert rel(pooled2, want_pooled) < 1e-5


def test_hoisted_per_row_tables_match_unhoisted_calls(model):
    pipe, _, _ = model
    x, hint, ctx, vec = inputs(pipe, 2, 3)
    steps = torch.tensor([981, 501, 21], dtype=torch.int32)
    conds = [Conditioning(hint)]
    packed, rows_of = make_emb_row_tables(pipe, conds, steps, vec)
    for i, t in enumerate(steps.tolist()):
        rows = rows_of(packed[i])
        assert all(r.shape[0] == 2 for r in rows["unet"].values())  # one row a model row
        tv = torch.full((2,), t, dtype=torch.int32)
        hoisted = pipe.apply_model(x, tv, ctx, conds, emb_rows=rows)
        plain = pipe.apply_model(x, tv, ctx, conds, vector=vec)
        assert rel(hoisted, plain) < 1e-5
    first = rows_of(packed[0])["unet"]["mid_res0"]
    assert rel(first[0], first[1]) > 1e-3  # the rows differ by their y


def test_zero_negative_conditioning(model):
    pipe, ref, _ = model
    ids = prompt_ids(2, 4)
    nids = torch.cat([empty_ids(1), prompt_ids(1, 5)])  # an empty and a written negative
    ctx, unc, vec, uvec = pipe.encode_prompts(ids, nids, (SIZE, SIZE))
    assert torch.count_nonzero(unc[0]) == 0 and torch.count_nonzero(uvec[0, :-6]) == 0
    assert uvec[0, -6:].tolist() == [SIZE, SIZE, 0, 0, SIZE, SIZE]
    assert torch.count_nonzero(unc[1]) > 0 and torch.count_nonzero(uvec[1, :-6]) > 0
    rctx, runc, ry, ruy = ref.prompts(ids, nids, (SIZE, SIZE))
    assert rel(unc[1], runc[1]) < 1e-5 and torch.count_nonzero(runc[0]) == 0
    assert rel(pipe.embed_vector(uvec), ruy) < 1e-5 and rel(pipe.embed_vector(vec), ry) < 1e-5


def test_three_step_sample_batch_trajectory(model):
    """eps from the program's latents at each step against the eps read off
    its DDIM update, and the reference's own trajectory from the same
    starting noise against the program's latents."""
    pipe, ref, m = model
    b, steps, scale = 2, 3, 5.0
    rng = np.random.default_rng(6)
    hint = rng.random((b, SIZE, SIZE, 3), dtype=np.float32)
    ids, nids = prompt_ids(b, 6).numpy(), empty_ids(b).numpy()
    seen = []
    apply_model = pipe.apply_model

    def kept(x, t, context, conds=None, **kw):
        seen.append(x[:b].clone())
        return apply_model(x, t, context, conds, **kw)

    decode = pipe.decode_first_stage
    pipe.apply_model = kept
    pipe.decode_first_stage = lambda z: (seen.append(z.clone()), decode(z))[1]
    trace.reset()
    try:
        with trace.recording():
            out = sample_batch(pipe, hint, ids, nids, SampleOptions(steps=steps, scale=scale), 11)
    finally:
        del pipe.apply_model, pipe.decode_first_stage
    assert out.shape == (b, SIZE, SIZE, 3) and len(seen) == steps + 1
    got = trace.summary()
    trace.reset()
    assert all(got["spans"][n]["calls"] == 1 for n in ("text.clip_l", "text.bigg", "model.vector"))
    assert got["counters"]["model.vector.rows"] == 2 * b  # the CFG rows
    ts, a_t, a_prev = ddim_ladder(m["diffusion"], steps)
    ctx, unc, y, uy = ref.prompts(torch.from_numpy(ids), torch.from_numpy(nids), (SIZE, SIZE))
    h = torch.from_numpy(hint).permute(0, 3, 1, 2)
    x_ref = seen[0].permute(0, 3, 1, 2).double()
    for k in range(steps):
        c_x, c_e = ddim_coefficients(float(a_t[k]), float(a_prev[k]))
        x, x_next = (seen[j].permute(0, 3, 1, 2).double() for j in (k, k + 1))
        e_prog = (x_next - c_x * x) / c_e
        e_ref = guided_eps_xl(ref.unet, x.float(), int(ts[k]), ctx, unc, y, uy, h, scale, 1.0)
        assert rel(e_prog, e_ref) < 1e-4, k
        e_own = guided_eps_xl(ref.unet, x_ref.float(), int(ts[k]), ctx, unc, y, uy, h, scale,
                              1.0)
        x_ref = c_x * x_ref + c_e * e_own.double()
        assert rel(x_next, x_ref) < 1e-4, k


def test_sd15_keeps_one_row_tables_and_the_unpack_layout():
    """A model without y: the tables stay one row a step shared by the
    batch, packed into one [S, n, Cmax] block that kernel D unpacks into
    [1, C] rows, names sorted, UNet first."""
    cfg = configs.tiny_test_config()
    pipe = CtrLoraPipeline(cfg, "cpu")
    hz = torch.zeros((2, 4, 4, 4))
    packed, rows_of = make_emb_row_tables(pipe, [Conditioning(hz)],
                                          torch.tensor([901, 1], dtype=torch.int32))
    res = [n for n, mod in pipe.unet.named_children() if n.endswith("_res") or "res" in n]
    cres = [n for n, mod in pipe.control.named_children() if "res" in n]
    assert isinstance(packed, torch.Tensor)
    assert packed.shape == (2, len(res) + len(cres), 64)
    rows = rows_of(packed[0])
    assert sorted(rows["unet"]) == sorted(res) and sorted(rows["control"][0]) == sorted(cres)
    assert all(r.shape == (1, pipe.unet.get_submodule(n).emb_proj.out_features)
               for n, r in rows["unet"].items())


def test_preset_loads_from_a_yaml_file(tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = configs.sdxl_controlnet_config()
    path = tmp_path / "sdxl.yaml"
    path.write_text(yaml.safe_dump({"model": dataclasses.asdict(cfg)}))
    assert configs.load_model_config(str(path)) == cfg
    path.write_text("preset: sdxl_controlnet\nunet:\n  dtype: float32\n")
    got = configs.load_model_config(str(path))
    assert got.unet.dtype == "float32" and got.unet.transformer_depth == (1, 2, 10)
    assert (got.unet.heads_at(640), got.unet.heads_at(1280)) == (10, 20)


@pytest.mark.parametrize("edit, error", [
    (lambda c: dataclasses.replace(c, unet=dataclasses.replace(c.unet, context_dim=2047)),
     NotImplementedError),
    (lambda c: dataclasses.replace(c, unet=dataclasses.replace(c.unet, transformer_depth=(1, 2))),
     ValueError),
    (lambda c: dataclasses.replace(c, conditioner=None), NotImplementedError),
    (lambda c: dataclasses.replace(c, control=dataclasses.replace(c.control, variant="lite")),
     NotImplementedError),
])
def test_widths_that_do_not_meet_are_refused(edit, error):
    with pytest.raises(error):
        configs.check_ported(edit(configs.sdxl_controlnet_config()))


def test_parameter_counts_at_published_widths():
    """The full model on the meta device: the widths the published model
    has (counts in millions, as the configuration file states them)."""
    pipe = CtrLoraPipeline(configs.sdxl_controlnet_config(), "meta")
    count = {k: sum(p.numel() for p in getattr(pipe, k).parameters()) / 1e6
             for k in ("unet", "control", "vae", "clip", "clip2")}
    assert 2560 < count["unet"] < 2575 and 1245 < count["control"] < 1260
    assert 694 < count["clip2"] < 696 and 123 < count["clip"] < 124
    assert 83 < count["vae"] < 84
