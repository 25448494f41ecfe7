"""The port's switchable two-LoRA API path against the JAX package on the
CPU, at tiny size in fp32 with inputs from a numpy seed:

* the loader: reference-format checkpoint files (written as
  tests/test_loading.py writes them) load into the port's state dicts equal,
  tensor for tensor, to the JAX ``load_ctrlora`` through
  ``convert.params_from_jax``; ``check_key`` agrees; a LoRA file without
  LoRA keys raises; the port's exporters round-trip through the loader;
* the tokenizer: the same ids as the JAX ``default_tokenizer``, with
  ``regex`` and with the ``re`` fallback;
* the per-condition time-embedding rows: an unfused two-slot tree sampled
  with ``lora_idx=1``, and two conditions with their own fused trees,
  ``lora_weights`` and ``control_scales``: DDIM against JAX from the same
  x_T, rtol 2e-3 / atol 2e-4 (as tests/test_parity.py);
* ``CtrLoRA._sample_images`` and ``sample`` end to end.
"""

import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import lora_fuse as jax_fuse
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig
from ctrlora_tpu.sampling.ddim import ddim_sample as jax_ddim_sample
from ctrlora_tpu.utils import ckpt_torch as jax_bridge
from ctrlora_tpu.utils import loading as jax_loading
from ctrlora_tpu.utils.tokenizer import default_tokenizer as jax_tokenizer

from ctrlora_tpu_torch import configs, convert, lora_fuse
from ctrlora_tpu_torch.api import CtrLoRA
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import loading
from ctrlora_tpu_torch.utils import tokenizer as tok_mod
from ctrlora_tpu_torch.utils.image import HWC3, center_crop_to_common

RTOL, ATOL = 2e-3, 2e-4
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")
RANK = 4


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


def _node(tree, fpath):
    node = tree["params"]
    for p in fpath:
        node = node[p]
    return node


# ---------------------------------------------------------------------------
# reference-format files from random JAX trees (the tests/test_loading.py way)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_ckpts")
    cfg = jax_tiny(n_loras=2, switchable_banks=True)
    params = JaxPipeline(cfg).init(jax.random.PRNGKey(7), image_size=8)
    rng = np.random.default_rng(0)
    rnd = lambda tree: jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
    uparams, vparams, cparams = rnd(params.unet), rnd(params.vae), rnd(params.clip)
    sd = {}
    for prefix, tree, entries in (
            ("model.diffusion_model.", uparams, jax_bridge.unet_entries(cfg.unet)),
            ("first_stage_model.", vparams, jax_bridge.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", cparams,
             jax_bridge.clip_entries(cfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in jax_bridge.export_tree(tree, entries).items()})
    sd_file = tmp / "sd.ckpt"
    torch.save({"state_dict": sd}, sd_file)
    cn = {f"control_model.{k}": torch.from_numpy(v) for k, v in jax_bridge.export_tree(
        rnd(params.control), jax_bridge.controlnet_entries(cfg.control)).items()}
    cn_file = tmp / "basecn.ckpt"
    torch.save(cn, cn_file)
    lora_files = []
    for slot in range(2):
        lsd = {}
        for tpath, fpath in jax_bridge.lora_site_entries(cfg.control):
            kernel = _node(params.control, fpath)["kernel"]
            lsd[f"control_model.{tpath}.lora_layer.down.weight"] = torch.from_numpy(
                rng.standard_normal((RANK, kernel.shape[0])).astype(np.float32))
            lsd[f"control_model.{tpath}.lora_layer.up.weight"] = torch.from_numpy(
                rng.standard_normal((kernel.shape[1], RANK)).astype(np.float32))
        for tpath, fpath in jax_bridge.zero_conv_site_entries(cfg.control):
            c = _node(params.control, fpath)["kernel"].shape
            lsd[f"control_model.{tpath}.weight"] = torch.from_numpy(
                rng.standard_normal((c[-1], c[-2], 1, 1)).astype(np.float32))
            lsd[f"control_model.{tpath}.bias"] = torch.from_numpy(
                rng.standard_normal((c[-1],)).astype(np.float32))
        for tpath, fpath in jax_bridge.norm_site_entries(cfg.control):
            c = _node(params.control, fpath)["scale"].shape[-1]
            for leaf in ("weight", "bias"):
                lsd[f"control_model.{tpath}.{leaf}"] = torch.from_numpy(
                    rng.standard_normal((c,)).astype(np.float32))
        f = tmp / f"lora{slot}.ckpt"
        torch.save(lsd, f)
        lora_files.append(str(f))
    return str(sd_file), str(cn_file), lora_files, tmp


def _port_tiny(**kw):
    return configs.tiny_test_config(n_loras=2, switchable_banks=True, **kw)


def test_loader_matches_jax(ref_files):
    sd_file, cn_file, lora_files, _ = ref_files
    jparams = jax_loading.load_ctrlora(JaxPipeline(jax_tiny(n_loras=2, switchable_banks=True)),
                                       sd_file, cn_file, lora_files)
    states = loading.load_ctrlora(CtrLoraPipeline(_port_tiny(), "cpu", fuse_lora=False), sd_file,
                                  cn_file, lora_files)
    for name in ("unet", "control", "vae", "clip"):
        want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              getattr(jparams, name)))
        got = getattr(states, name)
        assert sorted(got) == sorted(want), name
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, f"{name}: {bad[:5]}"
    # the banks carry each file's slot
    assert not torch.equal(states.control["zero_mid.weight"][0],
                           states.control["zero_mid.weight"][1])


def test_loaded_pipeline_runs_both_slots(ref_files):
    sd_file, cn_file, lora_files, _ = ref_files
    pipe = CtrLoraPipeline(_port_tiny(), "cpu", fuse_lora=False)
    pipe.load_state_dicts(*loading.load_ctrlora(pipe, sd_file, cn_file, lora_files))
    hint, t, ctx = torch.ones(1, 16, 16, 4), torch.tensor([5]), torch.ones(1, 16, 64)
    taps = [pipe.control(hint, t, ctx, lora_idx=i) for i in (0, 1)]
    assert all(torch.isfinite(x).all() for x in taps[0])
    assert not torch.allclose(taps[0][-1], taps[1][-1])


@pytest.mark.parametrize("key", [
    "control_model.time_embed.0.lora_layer.down.weight", "control_model.zero_convs.0.0.weight",
    "control_model.middle_block_out.0.bias", "control_model.input_blocks.1.1.norm.weight",
    "control_model.input_blocks.1.1.transformer_blocks.0.norm2.bias",
    "control_model.input_blocks.1.0.in_layers.0.weight", "control_model.time_embed.0.weight"])
def test_check_key_agrees(key):
    assert loading.check_key(key) == jax_loading.check_key(key)


def test_lora_file_without_lora_keys_raises(ref_files):
    _, _, lora_files, tmp = ref_files
    bogus = tmp / "bogus.ckpt"
    torch.save({"control_model.time_embed.0.weight": torch.zeros(1)}, bogus)
    with pytest.raises(ValueError, match="no LoRA keys"):
        loading.load_ctrlora(CtrLoraPipeline(_port_tiny(), "cpu", fuse_lora=False), None, None,
                             [str(bogus), lora_files[1]])


def test_safetensors_or_clear_error(tmp_path):
    path = str(tmp_path / "x.safetensors")
    try:
        import safetensors.numpy
    except ImportError:
        with pytest.raises(ImportError, match="safetensors"):
            bridge.load_torch_state_dict(path)
        return
    safetensors.numpy.save_file({"a": np.arange(4, dtype=np.float16)}, path)
    got = bridge.load_torch_state_dict(path)
    assert got["a"].dtype == np.float32 and got["a"].tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the API's own files: port modules -> port exporters -> loader
# ---------------------------------------------------------------------------

def _api_cfg():
    """The tiny configuration with the real CLIP vocabulary, so the tokenizer's
    ids embed."""
    cfg = _port_tiny()
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vocab_size=49408))


@pytest.fixture(scope="module")
def api_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api_ckpts")
    cfg = _api_cfg()
    src = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    rng = np.random.default_rng(1)
    for m in src.modules():
        for name, p in m.named_parameters():
            parts = name.split(".")
            is_norm = len(parts) > 1 and "norm" in parts[-2]
            if any(z in name for z in ZERO_INIT):
                std = 0.05
            elif p.ndim >= 2 and not is_norm:
                std = p[0].numel() ** -0.5
            else:
                std = 0.1
            base = 1.0 if is_norm and name.endswith("weight") else 0.0
            p.data.copy_(torch.from_numpy(
                (base + rng.normal(0, std, p.shape)).astype(np.float32)))
    sd = {}
    for prefix, module, entries in (
            ("model.diffusion_model.", src.unet, bridge.unet_entries(cfg.unet)),
            ("first_stage_model.", src.vae, bridge.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", src.clip,
             bridge.clip_entries(cfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in bridge.export_tree(module.state_dict(), entries).items()})
    paths = {"sd": str(tmp / "sd.ckpt"), "cn": str(tmp / "basecn.ckpt"),
             "loras": [str(tmp / f"lora{i}.ckpt") for i in range(2)]}
    torch.save({"state_dict": sd}, paths["sd"])
    cstate = src.control.state_dict()
    torch.save({k: torch.from_numpy(v)
                for k, v in bridge.export_control_base(cstate, cfg.control).items()}, paths["cn"])
    for i, f in enumerate(paths["loras"]):
        torch.save({k: torch.from_numpy(v)
                    for k, v in bridge.export_lora_slot(cstate, cfg.control, i).items()}, f)
    return cfg, src, paths


def test_export_then_load_round_trips(api_files):
    cfg, src, paths = api_files
    states = loading.load_ctrlora(CtrLoraPipeline(cfg, "cpu", fuse_lora=False), paths["sd"],
                                  paths["cn"], paths["loras"])
    for name, module in zip(("unet", "control", "vae", "clip"), src.modules()):
        want = module.state_dict()
        got = getattr(states, name)
        assert sorted(got) == sorted(want)
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, f"{name}: {bad[:5]}"


def test_port_exporters_match_jax(api_files):
    """The port's Base-ControlNet exporter writes what the JAX one writes
    from the same weights (the JAX tree read back from the port's export)."""
    cfg, src, _ = api_files
    cstate = src.control.state_dict()
    jcfg = jax_tiny(n_loras=2, switchable_banks=True)
    ours = bridge.export_control_base(cstate, cfg.control)
    jtree, missing = jax_bridge.convert_tree(ours, jax_bridge.controlnet_entries(jcfg.control),
                                             prefix="control_model.")
    theirs = jax_bridge.export_control_base(jtree, jcfg.control)
    assert not missing and sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


# ---------------------------------------------------------------------------
# tokenizer and image helpers
# ---------------------------------------------------------------------------

PROMPTS = ["", "a photo of a cat", "A Hyper-Detailed, photo-realistic portrait; 8k!!! (best "
           "quality) -- trending on artstation, by greg rutkowski & alphonse mucha?",
           " ".join(["mountains and rivers"] * 40), "it's a dog's life: 3 dogs, 12 cats...",
           "snake_case __init__ 8k 1080p x2 \\ #tags @user"]


@pytest.mark.parametrize("max_length,windows", [(77, 1), (77, 3), (16, 1)])
def test_tokenizer_matches_jax(max_length, windows):
    got = tok_mod.default_tokenizer()(PROMPTS, max_length=max_length, windows=windows)
    want = jax_tokenizer()(PROMPTS, max_length=max_length, windows=windows)
    assert got.dtype == np.int64 and got.shape == (len(PROMPTS), windows * max_length)
    np.testing.assert_array_equal(got, want)


def test_tokenizer_re_fallback_matches_on_ascii():
    """Without ``regex`` (the GPU host) the ``re`` pattern gives the same
    ids on ASCII text."""
    saved = sys.modules.get("regex")
    sys.modules["regex"] = None  # makes `import regex` raise ImportError
    try:
        fallback = importlib.reload(tok_mod)
        assert fallback.re.__name__ == "re"
        got = fallback.CLIPTokenizer()(PROMPTS)
    finally:
        if saved is None:
            del sys.modules["regex"]
        else:
            sys.modules["regex"] = saved
        importlib.reload(tok_mod)
    np.testing.assert_array_equal(got, jax_tokenizer()(PROMPTS))


def test_image_helpers_match_jax():
    from ctrlora_tpu.annotators.util import HWC3 as jax_hwc3
    from ctrlora_tpu.api import center_crop_to_common as jax_crop

    rng = np.random.default_rng(2)
    for shape in ((5, 7), (5, 7, 1), (5, 7, 3), (5, 7, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(HWC3(img), jax_hwc3(img))
    a, b = rng.integers(0, 256, (20, 16, 3), np.uint8), rng.integers(0, 256, (16, 24, 3), np.uint8)
    for x, y in zip(center_crop_to_common(a, b), jax_crop(a, b)):
        np.testing.assert_array_equal(x, y)
    assert center_crop_to_common(a, b)[0].shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# sampling with per-condition trees against JAX
# ---------------------------------------------------------------------------

def _bump(tree, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        ks = jax.tree_util.keystr(path)
        if any(z in ks for z in ZERO_INIT) and ("kernel" in ks or "lora_up" in ks):
            return jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def two_slot():
    jcfg = jax_tiny(n_loras=2, switchable_banks=True)
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init(jax.random.PRNGKey(0), image_size=8)
    params = type(params)(*(_bump(p, 20 + i) for i, p in enumerate(params)))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, size=(1, 16)).astype(np.int32)
    hints = [rng.uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32) for _ in range(2)]
    x_T = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    jctx, junc = jpipe.encode_text_cond_uncond(params, ids, np.zeros_like(ids))
    jhz = [jpipe.encode_first_stage(params, h) for h in hints]
    return jcfg, jpipe, params, ids, hints, x_T, (jctx, junc, jhz)


def _port_pipe(params, fuse_lora):
    pipe = CtrLoraPipeline(_port_tiny(), "cpu", fuse_lora=fuse_lora)
    unfused = convert.params_from_jax(params.control)
    control = (lora_fuse.fuse_control_tree(pipe.control, unfused, 0, pipe.cfg.control.lora)
               if fuse_lora else unfused)
    pipe.load_state_dicts(convert.params_from_jax(params.unet), control,
                          convert.params_from_jax(params.vae), convert.params_from_jax(params.clip))
    pipe.cast_for_inference()
    return pipe, unfused


def _port_text_hints(pipe, ids, hints):
    ctx, unc = pipe.encode_text_cond_uncond(torch.from_numpy(ids),
                                            torch.from_numpy(np.zeros_like(ids)))
    return ctx, unc, [pipe.encode_first_stage(torch.from_numpy(h)) for h in hints]


def test_unfused_slot1_rows_match_jax(two_slot):
    """The hoisted time-embedding rows of an unfused multi-slot tree follow
    the condition's lora_idx (slot 1 here, not slot 0)."""
    jcfg, jpipe, params, ids, hints, x_T, (jctx, junc, jhz) = two_slot
    cfg = JaxDDIMConfig(steps=3, guidance_scale=7.5)
    jz = jax_ddim_sample(jpipe, params, jax.random.PRNGKey(1), jctx, junc,
                         [JaxConditioning(jhz[0], lora_idx=jnp.int32(1))], (1, 8, 8, 4), cfg,
                         x_T=jnp.asarray(x_T))
    pipe, _ = _port_pipe(params, fuse_lora=False)
    ctx, unc, hz = _port_text_hints(pipe, ids, hints)
    _close(hz[0].numpy(), jhz[0])
    z = ddim_sample(pipe, ctx, unc, [Conditioning(hz[0], lora_idx=1)], (1, 8, 8, 4),
                    DDIMConfig(steps=3, guidance_scale=7.5), x_T=torch.from_numpy(x_T))
    _close(z.numpy(), jz)
    z0 = ddim_sample(pipe, ctx, unc, [Conditioning(hz[0], lora_idx=0)], (1, 8, 8, 4),
                     DDIMConfig(steps=3, guidance_scale=7.5), x_T=torch.from_numpy(x_T))
    assert (z0 - z).abs().max() > 1e-3  # the slots really differ


def test_two_fused_conditions_match_jax(two_slot):
    jcfg, jpipe, params, ids, hints, x_T, (jctx, junc, jhz) = two_slot
    n_taps = len(encoder_plan(_port_tiny().control.unet)[0]) + 1
    scales = np.linspace(0.6, 1.3, n_taps).astype(np.float32)
    weights = (1.0, 0.7)
    jfused = [jax_fuse.fuse_control_tree(params.control, i, jcfg.control.lora) for i in (0, 1)]
    jconds = [JaxConditioning(jhz[i], lora_idx=jnp.int32(i), weight=weights[i],
                              control_params=jfused[i]) for i in (0, 1)]
    jz = jax_ddim_sample(jpipe, params, jax.random.PRNGKey(1), jctx, junc, jconds, (1, 8, 8, 4),
                         JaxDDIMConfig(steps=3, guidance_scale=7.5),
                         control_scales=jnp.asarray(scales), x_T=jnp.asarray(x_T))

    pipe, unfused = _port_pipe(params, fuse_lora=True)
    second = pipe.new_control()
    second.load_state_dict(lora_fuse.fuse_control_tree(second, unfused, 1, pipe.cfg.control.lora))
    lora_fuse.cast_params_for_inference(second, torch.float32)
    ctx, unc, hz = _port_text_hints(pipe, ids, hints)
    conds = [Conditioning(hz[i], lora_idx=i, weight=weights[i], control=c)
             for i, c in enumerate((pipe.control, second))]
    z = ddim_sample(pipe, ctx, unc, conds, (1, 8, 8, 4), DDIMConfig(steps=3, guidance_scale=7.5),
                    x_T=torch.from_numpy(x_T), control_scales=scales.tolist())
    _close(z.numpy(), jz)


# ---------------------------------------------------------------------------
# the API end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def api(api_files):
    cfg, _, paths = api_files
    ct = CtrLoRA(num_loras=2, cfg=cfg, device="cpu")
    ct.create_model(paths["sd"], paths["cn"], paths["loras"])
    return ct


def test_api_sample_images(api):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2)]
    args = ("a photo of a house", "blurry", 2, 3, 7.5, (1.0, 0.8))
    out = api._sample_images(images, *args, seed=0)
    assert out.shape == (2, 16, 16, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, api._sample_images(images, *args, seed=0))
    assert not np.array_equal(out, api._sample_images(images, *args, seed=1))
    swapped = api._sample_images(images, *args[:-1], (0.0, 1.0), seed=0)
    assert not np.array_equal(out, swapped)


def test_api_timings_are_filled(api):
    """`timings=` reads the call's phases off its spans, and leaves the
    spans off after the call."""
    from ctrlora_tpu_torch.utils import trace

    images = [np.full((16, 16, 3), 128, np.uint8)] * 2
    timings = {}
    out = api._sample_images(images, "a house", "", 1, 2, 7.5, (1.0, 1.0), seed=0,
                             timings=timings)
    assert out.shape == (1, 16, 16, 3)
    assert set(timings) == {"prep_s", "ddim_s", "decode_s"}
    assert all(v > 0.0 for v in timings.values()), timings
    assert trace.span("sample.request") is trace.OFF


def test_api_sample_crops_and_returns_pil(api):
    from PIL import Image

    rng = np.random.default_rng(4)
    grey = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    wide = rng.integers(0, 256, (16, 24, 4), dtype=np.uint8)
    out = api.sample((grey, wide), "a cat", num_samples=1, ddim_steps=2)
    assert len(out) == 1 and isinstance(out[0], Image.Image) and out[0].size == (16, 16)
    with pytest.raises(ValueError, match="Expected 2 images"):
        api.sample((grey,), "a cat")


def test_api_create_model_checks(api_files):
    cfg, _, paths = api_files
    ct = CtrLoRA(num_loras=2, cfg=cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        ct.create_model(paths["sd"], paths["cn"], [paths["loras"][0], "missing.ckpt"])
    with pytest.raises(ValueError, match="expected 2 lora files"):
        ct.create_model(paths["sd"], paths["cn"], paths["loras"][:1])
    with pytest.raises(RuntimeError, match="create_model"):
        ct._sample_images([np.zeros((16, 16, 3), np.uint8)] * 2, "", "", 1, 1, 7.5,
                          (1.0, 1.0), 0)


def test_api_unfused_matches_fused(api, api_files):
    """fuse=False (one unfused tree, lora_idx per condition) samples what the
    per-LoRA fused trees sample."""
    cfg, _, paths = api_files
    ct = CtrLoRA(num_loras=2, cfg=cfg, fuse=False, device="cpu")
    ct.create_model(paths["sd"], paths["cn"], paths["loras"])
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2)]
    args = (images, "a boat", "", 1, 2, 7.5, (1.0, 0.6), 0)
    _close(ct._sample_float(*args).numpy(), api._sample_float(*args).numpy())
