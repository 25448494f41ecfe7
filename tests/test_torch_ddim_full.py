"""The port's DDIM family against the JAX package on the CPU, at the tiny
test configuration in fp32 with inputs from a numpy seed:

* the DDIM tables at eta > 0 (sigmas) and the 'quad' ladder, and the
  v-parameterization helpers (tolerance 1e-6);
* ``ddim_sample`` at eta > 0 and temperature < 1 with JAX's own draws,
  rebuilt from its key splits and passed in; guess mode with decayed
  control scales; a per-step ``ucg_schedule``; mask/x0 inpainting; a
  v-parameterized model;
* ``ddim_encode``, ``ddim_stochastic_encode`` and ``ddim_decode_from``;
* ``CtrLoRA._sample_float(eta=, guess_mode=)`` from reference-format files
  written from the same weights.

Slices are held to rtol 2e-3 / atol 2e-4, as tests/test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import lora_fuse as jax_fuse
from ctrlora_tpu import schedules as jax_sched
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling import ddim as jax_ddim

from ctrlora_tpu_torch import configs, convert, lora_fuse, schedules
from ctrlora_tpu_torch.api import CtrLoRA
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling import ddim
from ctrlora_tpu_torch.utils import ckpt_torch as bridge

RTOL, ATOL = 2e-3, 2e-4
TABLE_TOL = 1e-6
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")
B, LAT = 2, (2, 8, 8, 4)
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test run shares the host's cores between several test processes:
    one torch thread keeps these small-model tests from oversubscribing
    them (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def _random_params(jpipe, seed):
    """The JAX pipeline's parameters drawn with numpy: the init's shapes
    (``jax.eval_shape``, no compile) filled as a trained model's could be:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), small biases, and
    the layers a fresh model zero-initialises (and lora_up) N(0, 0.05^2), so
    every branch carries signal."""
    shapes = jax.eval_shape(lambda k: jpipe.init(k, image_size=8), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        ks, name, shape = jax.tree_util.keystr(path), path[-1].key, leaf.shape
        if name == "scale":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "bias":
            x = 0.02 * rng.normal(size=shape)
        elif name in ("token_embedding", "position_embedding"):
            x = 0.02 * rng.normal(size=shape)
        elif name == "lora_up" or any(z in ks for z in ZERO_INIT):
            x = 0.05 * rng.normal(size=shape)
        elif name == "lora_down":
            x = rng.normal(size=shape) * shape[-2] ** -0.5
        else:  # kernel [..., in, out]; a banked one has a leading slot axis
            fan_in = int(np.prod(shape[1 if len(shape) == 5 else 0:-1]))
            x = rng.normal(size=shape) * fan_in ** -0.5
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _with_vocab(cfg):
    """The real CLIP vocabulary, so the tokenizer's ids embed (API test)."""
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vocab_size=49408))


def _v(cfg, beta_schedule="linear"):
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, parameterization="v", beta_schedule=beta_schedule))


def _port_pipe(pcfg, params):
    pipe = CtrLoraPipeline(pcfg, device="cpu")
    fused = lora_fuse.fuse_control_tree(pipe.control, convert.params_from_jax(params.control),
                                        0, pcfg.control.lora)
    pipe.load_state_dicts(convert.params_from_jax(params.unet), fused,
                          convert.params_from_jax(params.vae),
                          convert.params_from_jax(params.clip))
    pipe.cast_for_inference()
    return pipe


@pytest.fixture(scope="module")
def env():
    """One JAX pipeline (random weights, no init compile), its fused tree, the port pipeline on
    the same weights, and encoded text and hints for a batch of 2."""
    jcfg = _with_vocab(jax_tiny(n_loras=1, switchable_banks=True))
    jpipe = JaxPipeline(jcfg)
    params = _random_params(jpipe, 10)
    jfused = jax_fuse.fuse_control_tree(params.control, 0, jcfg.control.lora)
    pcfg = _with_vocab(configs.tiny_test_config(n_loras=1, switchable_banks=True))
    ppipe = _port_pipe(pcfg, params)

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 49408, size=(B, 16)).astype(np.int32)
    hint = rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32)
    x_T = rng.normal(size=LAT).astype(np.float32)
    jctx, junc = jpipe.encode_text_cond_uncond(params, ids, np.zeros_like(ids))
    jhz = jpipe.encode_first_stage(params, hint)
    ctx, unc = ppipe.encode_text_cond_uncond(torch.from_numpy(ids),
                                             torch.from_numpy(np.zeros_like(ids)))
    hz = ppipe.encode_first_stage(torch.from_numpy(hint))
    _close(hz.numpy(), jhz)
    return dict(jcfg=jcfg, pcfg=pcfg, jpipe=jpipe, params=params, jfused=jfused, ppipe=ppipe,
                jctx=jctx, junc=junc, jhz=jhz, ctx=ctx, unc=unc, hz=hz, x_T=x_T, rng=rng)


def _jconds(e):
    return [JaxConditioning(e["jhz"], control_params=e["jfused"])]


def _conds(e):
    return [Conditioning(e["hz"])]


def _jax_draws(key, steps, shape):
    """JAX ddim_sample's draws: split(key) -> (rng, init); then per step
    split(rng, 3) -> (rng, noise_rng, mask_rng)."""
    rng, _ = jax.random.split(key)
    noise, mask_noise = [], []
    for _ in range(steps):
        rng, n_rng, m_rng = jax.random.split(rng, 3)
        noise.append(np.asarray(jax.random.normal(n_rng, shape, jnp.float32)))
        mask_noise.append(np.asarray(jax.random.normal(m_rng, shape, jnp.float32)))
    return torch.from_numpy(np.stack(noise)), torch.from_numpy(np.stack(mask_noise))


def _n_taps(e):
    return len(encoder_plan(e["pcfg"].control.unet)[0]) + 1


# ---------------------------------------------------------------------------
# tables and helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("steps,discr", [(4, "uniform"), (20, "uniform"), (50, "uniform"),
                                         (7, "quad"), (50, "quad")])
def test_ddim_tables_match_jax(eta, steps, discr):
    a = jax_sched.make_ddim_schedule(jax_sched.make_schedule(), steps, eta=eta,
                                     discr_method=discr)
    b = schedules.make_ddim_schedule(schedules.make_schedule(), steps, eta=eta,
                                     discr_method=discr)
    np.testing.assert_array_equal(a.timesteps, b.timesteps)
    for f in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        _close(getattr(b, f), getattr(a, f), rtol=TABLE_TOL, atol=TABLE_TOL)
    assert (np.max(b.sigmas) > 0) == (eta > 0)


def test_ddim_tables_at_eta0_unchanged_for_existing_callers():
    """The eta-0 tables are the same bits as the JAX package's (the main
    path's numbers do not move), and a sub-ladder slices every table."""
    a = jax_sched.make_ddim_schedule(jax_sched.make_schedule(), 50)
    b = schedules.make_ddim_schedule(schedules.make_schedule(), 50)
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    sub = b[:10]
    assert sub.num_steps == 10 and np.array_equal(sub.alphas, b.alphas[:10])


def test_v_helpers_match_jax():
    rng = np.random.default_rng(1)
    js, ps = jax_sched.make_schedule(), schedules.make_schedule()
    x, noise, v = (rng.normal(size=LAT).astype(np.float32) for _ in range(3))
    t = np.array([3, 977], np.int32)
    tx = lambda a: torch.from_numpy(a)
    _close(schedules.get_v(ps, tx(x), tx(noise), tx(t)).numpy(),
           jax_sched.get_v(js, x, noise, t), rtol=TABLE_TOL, atol=TABLE_TOL)
    _close(schedules.predict_eps_from_z_and_v(ps, tx(x), tx(t), tx(v)).numpy(),
           jax_sched.predict_eps_from_z_and_v(js, x, t, v), rtol=TABLE_TOL, atol=TABLE_TOL)
    _close(schedules.predict_start_from_z_and_v(ps, tx(x), tx(t), tx(v)).numpy(),
           jax_sched.predict_start_from_z_and_v(js, x, t, v), rtol=TABLE_TOL, atol=TABLE_TOL)


def test_ddim_config_fields():
    fields = {f.name for f in dataclasses.fields(ddim.DDIMConfig)}
    assert fields == {"steps", "eta", "guidance_scale", "temperature", "guess_mode",
                      "ucg_schedule"}
    assert fields < {f.name for f in dataclasses.fields(jax_ddim.DDIMConfig)}


# ---------------------------------------------------------------------------
# ddim_sample
# ---------------------------------------------------------------------------

def test_ddim_eta_temperature_matches_jax(env):
    e = env
    cfg_kw = dict(steps=STEPS, guidance_scale=7.5, eta=0.5, temperature=0.8)
    key = jax.random.PRNGKey(3)
    jz = jax_ddim.ddim_sample(e["jpipe"], e["params"], key, e["jctx"], e["junc"], _jconds(e),
                              LAT, jax_ddim.DDIMConfig(**cfg_kw), x_T=jnp.asarray(e["x_T"]))
    noise, _ = _jax_draws(key, STEPS, LAT)
    z = ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
                         ddim.DDIMConfig(**cfg_kw), x_T=torch.from_numpy(e["x_T"]), noise=noise)
    _close(z.numpy(), jz)
    z0 = ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
                          ddim.DDIMConfig(steps=STEPS), x_T=torch.from_numpy(e["x_T"]))
    assert (z - z0).abs().max() > 1e-3  # the noise really enters


def test_ddim_draws_come_from_the_generator_after_x_T(env):
    """Without `noise` the S draws come from `generator` in one call after
    x_T: the same generator state gives the same sample."""
    e = env
    cfg = ddim.DDIMConfig(steps=STEPS, eta=0.7)
    run = lambda g: ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT, cfg,
                                     generator=g)
    gen = torch.Generator().manual_seed(5)
    x_T = torch.randn(LAT, generator=gen)
    noise = torch.randn((STEPS, *LAT), generator=gen)
    want = ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT, cfg, x_T=x_T,
                            noise=noise)
    torch.testing.assert_close(run(torch.Generator().manual_seed(5)), want, rtol=0, atol=0)


def test_guess_mode_matches_jax(env):
    """Guess mode: the uncond half without control, with the gradio app's
    decayed scales strength * 0.825**(taps-1-i)."""
    e = env
    n = _n_taps(e)
    scales = [1.2 * 0.825 ** float(n - 1 - i) for i in range(n)]
    jcfg = jax_ddim.DDIMConfig(steps=STEPS, guidance_scale=7.5, guess_mode=True)
    jz = jax_ddim.ddim_sample(e["jpipe"], e["params"], jax.random.PRNGKey(1), e["jctx"],
                              e["junc"], _jconds(e), LAT, jcfg,
                              control_scales=jnp.asarray(scales, jnp.float32),
                              x_T=jnp.asarray(e["x_T"]))
    run = lambda guess: ddim.ddim_sample(
        e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
        ddim.DDIMConfig(steps=STEPS, guidance_scale=7.5, guess_mode=guess),
        x_T=torch.from_numpy(e["x_T"]), control_scales=scales)
    z = run(True)
    _close(z.numpy(), jz)
    assert (z - run(False)).abs().max() > 1e-3


def test_ucg_schedule_matches_jax(env):
    e = env
    ucg = (9.0, 6.5, 3.0, 1.5)
    jz = jax_ddim.ddim_sample(e["jpipe"], e["params"], jax.random.PRNGKey(1), e["jctx"],
                              e["junc"], _jconds(e), LAT,
                              jax_ddim.DDIMConfig(steps=STEPS, ucg_schedule=ucg),
                              x_T=jnp.asarray(e["x_T"]))
    z = ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
                         ddim.DDIMConfig(steps=STEPS, ucg_schedule=ucg),
                         x_T=torch.from_numpy(e["x_T"]))
    _close(z.numpy(), jz)
    with pytest.raises(ValueError, match="ucg_schedule"):
        ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
                         ddim.DDIMConfig(steps=STEPS, ucg_schedule=ucg[:2]),
                         x_T=torch.from_numpy(e["x_T"]))


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_mask_x0_inpainting_matches_jax(env, eta):
    e = env
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=LAT).astype(np.float32)
    mask = np.zeros(LAT, np.float32)
    mask[:, :, :4] = 1.0  # keep the left half
    key = jax.random.PRNGKey(4)
    jz = jax_ddim.ddim_sample(e["jpipe"], e["params"], key, e["jctx"], e["junc"], _jconds(e),
                              LAT, jax_ddim.DDIMConfig(steps=STEPS, eta=eta),
                              x_T=jnp.asarray(e["x_T"]), mask=jnp.asarray(mask),
                              x0=jnp.asarray(x0))
    noise, mask_noise = _jax_draws(key, STEPS, LAT)
    z = ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
                         ddim.DDIMConfig(steps=STEPS, eta=eta), x_T=torch.from_numpy(e["x_T"]),
                         mask=torch.from_numpy(mask), x0=torch.from_numpy(x0),
                         noise=noise if eta else None, mask_noise=mask_noise)
    _close(z.numpy(), jz)


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine"])
def test_v_parameterization_matches_jax(env, beta_schedule):
    e = env
    jpipe = JaxPipeline(_v(e["jcfg"], beta_schedule))
    ppipe = _port_pipe(_v(e["pcfg"], beta_schedule), e["params"])
    key = jax.random.PRNGKey(6)
    jz = jax_ddim.ddim_sample(jpipe, e["params"], key, e["jctx"], e["junc"], _jconds(e), LAT,
                              jax_ddim.DDIMConfig(steps=STEPS, eta=0.4),
                              x_T=jnp.asarray(e["x_T"]))
    noise, _ = _jax_draws(key, STEPS, LAT)
    z = ddim.ddim_sample(ppipe, e["ctx"], e["unc"], _conds(e), LAT,
                         ddim.DDIMConfig(steps=STEPS, eta=0.4), x_T=torch.from_numpy(e["x_T"]),
                         noise=noise)
    _close(z.numpy(), jz)
    eps = ddim.ddim_sample(e["ppipe"], e["ctx"], e["unc"], _conds(e), LAT,
                           ddim.DDIMConfig(steps=STEPS, eta=0.4),
                           x_T=torch.from_numpy(e["x_T"]), noise=noise)
    assert (z - eps).abs().max() > 1e-3  # the model output is read as v


# ---------------------------------------------------------------------------
# encode / img2img
# ---------------------------------------------------------------------------

def test_ddim_encode_matches_jax(env):
    e = env
    x0 = np.random.default_rng(8).normal(size=LAT).astype(np.float32)
    jx = jax_ddim.ddim_encode(e["jpipe"], e["params"], jnp.asarray(x0), 3, e["jctx"],
                              e["junc"], _jconds(e), steps=STEPS, guidance_scale=3.0)
    x = ddim.ddim_encode(e["ppipe"], torch.from_numpy(x0), 3, e["ctx"], e["unc"], _conds(e),
                         steps=STEPS, guidance_scale=3.0)
    _close(x.numpy(), jx)


def test_ddim_stochastic_encode_matches_jax(env):
    e = env
    x0 = np.random.default_rng(9).normal(size=LAT).astype(np.float32)
    key = jax.random.PRNGKey(11)
    for t_index in (np.array([1, 3], np.int32), 2):
        jx = jax_ddim.ddim_stochastic_encode(e["jpipe"], jnp.asarray(x0),
                                             jnp.asarray(t_index), key, STEPS)
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, LAT, jnp.float32)))
        x = ddim.ddim_stochastic_encode(e["ppipe"], torch.from_numpy(x0), t_index, STEPS,
                                        noise=noise)
        _close(x.numpy(), jx, rtol=TABLE_TOL, atol=TABLE_TOL)


def test_ddim_decode_from_matches_jax(env):
    """img2img: x0 noised to step 3 of a 4-step ladder, then decoded from
    there at eta 0.5."""
    e = env
    x0 = np.random.default_rng(10).normal(size=LAT).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jcfg = jax_ddim.DDIMConfig(steps=STEPS, eta=0.5)
    jxt = jax_ddim.ddim_stochastic_encode(e["jpipe"], jnp.asarray(x0), jnp.int32(2), key,
                                          STEPS)
    jz = jax_ddim.ddim_decode_from(e["jpipe"], e["params"], jxt, 3, e["jctx"], e["junc"],
                                   _jconds(e), jcfg, key)
    noise, _ = _jax_draws(key, 3, LAT)
    xt = ddim.ddim_stochastic_encode(
        e["ppipe"], torch.from_numpy(x0), 2, STEPS,
        noise=torch.from_numpy(np.asarray(jax.random.normal(key, LAT, jnp.float32))))
    z = ddim.ddim_decode_from(e["ppipe"], xt, 3, e["ctx"], e["unc"], _conds(e),
                              ddim.DDIMConfig(steps=STEPS, eta=0.5), noise=noise)
    _close(z.numpy(), jz)


# ---------------------------------------------------------------------------
# the API: eta and guess mode from reference-format files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def api(env, tmp_path_factory):
    """Reference-format files written from the JAX weights (through the
    port's exporters), loaded by ``CtrLoRA.create_model``."""
    tmp = tmp_path_factory.mktemp("ddim_api")
    pcfg, params = env["pcfg"], env["params"]
    states = {k: convert.params_from_jax(getattr(params, k))
              for k in ("unet", "control", "vae", "clip")}
    sd = {}
    for prefix, name, entries in (
            ("model.diffusion_model.", "unet", bridge.unet_entries(pcfg.unet)),
            ("first_stage_model.", "vae", bridge.vae_entries(pcfg.vae)),
            ("cond_stage_model.transformer.text_model.", "clip",
             bridge.clip_entries(pcfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in bridge.export_tree(states[name], entries).items()})
    paths = {"sd": str(tmp / "sd.ckpt"), "cn": str(tmp / "basecn.ckpt"),
             "lora": str(tmp / "lora0.ckpt")}
    torch.save({"state_dict": sd}, paths["sd"])
    as_torch = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    torch.save(as_torch(bridge.export_control_base(states["control"], pcfg.control)),
               paths["cn"])
    torch.save(as_torch(bridge.export_lora_slot(states["control"], pcfg.control, 0)),
               paths["lora"])
    ct = CtrLoRA(num_loras=1, cfg=pcfg, device="cpu")
    ct.create_model(paths["sd"], paths["cn"], [paths["lora"]])
    return ct


def test_api_guess_mode_matches_jax(env, api):
    """``_sample_float(guess_mode=True)`` with the decayed scales against
    JAX's ddim_sample on the same weights, prompt ids, hint and x_T."""
    e = env
    img = np.random.default_rng(13).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    n = _n_taps(e)
    scales = [0.9 * 0.825 ** float(n - 1 - i) for i in range(n)]
    args = ([img], "a red house", "blurry", B, STEPS, 7.5, (1.0,), 21)
    got = api._sample_float(*args, guess_mode=True, control_scales=scales)

    jp, params = e["jpipe"], e["params"]
    ids, nids = (api.token_ids(p, B).numpy() for p in ("a red house", "blurry"))
    jctx, junc = jp.encode_text_cond_uncond(params, ids, nids)
    jhz = jp.encode_first_stage(params, np.repeat(img[None].astype(np.float32) / 255.0, B, 0))
    x_T = torch.randn(LAT, generator=torch.Generator().manual_seed(21))
    jz = jax_ddim.ddim_sample(
        jp, params, jax.random.PRNGKey(0), jctx, junc,
        [JaxConditioning(jhz, lora_idx=jnp.int32(0), weight=jnp.float32(1.0),
                         control_params=e["jfused"])], LAT,
        jax_ddim.DDIMConfig(steps=STEPS, guidance_scale=7.5, guess_mode=True),
        control_scales=jnp.asarray(scales, jnp.float32), x_T=jnp.asarray(x_T.numpy()))
    _close(got.numpy(), jp.decode_first_stage(params, jz))
    plain = api._sample_float(*args, control_scales=scales)
    assert (got - plain).abs().max() > 1e-3


def test_api_eta_draws_follow_the_seed(env, api):
    """``_sample_images(eta=...)``: x_T and then the S eta draws come from
    one CPU generator seeded with `seed`; the same seed gives the same
    image, eta changes it."""
    e = env
    img = np.random.default_rng(14).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    args = ([img], "a boat", "", B, STEPS, 7.5, (1.0,), 3)
    out = api._sample_images(*args, eta=0.6)
    assert out.shape == (B, 16, 16, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, api._sample_images(*args, eta=0.6))
    assert not np.array_equal(out, api._sample_images(*args))

    pipe = api.pipe
    gen = torch.Generator().manual_seed(3)
    x_T = torch.randn(LAT, generator=gen)
    noise = torch.randn((STEPS, *LAT), generator=gen)
    ctx, unc = pipe.encode_text_cond_uncond(api.token_ids("a boat", B), api.token_ids("", B))
    conds = api.conditions([img], B, (1.0,))
    z = ddim.ddim_sample(pipe, ctx, unc, conds, LAT, ddim.DDIMConfig(steps=STEPS, eta=0.6),
                         x_T=x_T, noise=noise)
    want = torch.clamp(pipe.decode_first_stage(z) * 127.5 + 127.5, 0, 255).to(torch.uint8)
    np.testing.assert_array_equal(out, want.numpy())
