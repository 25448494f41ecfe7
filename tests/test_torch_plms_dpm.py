"""The port's PLMS and DPM-Solver samplers against the JAX package on the
CPU, at the tiny test configuration in fp32 with inputs from a numpy seed:

* the host-side tables, exactly: ``order_schedule`` and
  ``singlestep_orders`` over a grid of steps x orders, the singlestep block
  coefficients (1e-12 relative; float64 on both sides);
* dynamic thresholding on its own (rtol 2e-3 / atol 2e-4);
* ``plms_sample`` (with guess mode and decayed scales), the multistep
  ``dpm_solver_sample`` at orders 1-3 for both algorithms, with
  thresholding, and ``dpm_solver_singlestep_sample`` at orders 1-3, eps and
  v models: the final latents within rtol 2e-3 / atol 2e-4 of JAX's from
  the same x_T.

The JAX samplers run under ``jax.jit`` (one compile each).
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
from ctrlora_tpu.sampling import dpm_solver as jax_dpm
from ctrlora_tpu.sampling import plms as jax_plms
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig

from ctrlora_tpu_torch import configs, convert, lora_fuse
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling import dpm_solver, plms
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig

RTOL, ATOL = 2e-3, 2e-4
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")
B, LAT = 2, (2, 8, 8, 4)


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
    jcfg = jax_tiny(n_loras=1, switchable_banks=True)
    jpipe = JaxPipeline(jcfg)
    params = _random_params(jpipe, 20)
    pcfg = configs.tiny_test_config(n_loras=1, switchable_banks=True)
    ppipe = _port_pipe(pcfg, params)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 128, size=(B, 16)).astype(np.int32)
    hint = rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32)
    jctx, junc = jpipe.encode_text_cond_uncond(params, ids, np.zeros_like(ids))
    ctx, unc = ppipe.encode_text_cond_uncond(torch.from_numpy(ids),
                                             torch.from_numpy(np.zeros_like(ids)))
    return dict(jcfg=jcfg, pcfg=pcfg, jpipe=jpipe, params=params, ppipe=ppipe,
                jfused=jax_fuse.fuse_control_tree(params.control, 0, jcfg.control.lora),
                jctx=jctx, junc=junc, jhz=jpipe.encode_first_stage(params, hint),
                ctx=ctx, unc=unc, hz=ppipe.encode_first_stage(torch.from_numpy(hint)),
                x_T=rng.normal(size=LAT).astype(np.float32))


def _both(e, jax_fn, port_fn, cfg_kw, v=False, scales=None, beta_schedule="linear", **kw):
    """The JAX sampler (jitted) and the port's on the same inputs (a v
    model under `beta_schedule` where `v`); returns (port latents, JAX
    latents)."""
    jpipe = JaxPipeline(_v(e["jcfg"], beta_schedule)) if v else e["jpipe"]
    ppipe = _port_pipe(_v(e["pcfg"], beta_schedule), e["params"]) if v else e["ppipe"]
    jscales = None if scales is None else jnp.asarray(scales, jnp.float32)

    @jax.jit
    def run(params, jfused, ctx, unc, hz, x_T):
        return jax_fn(jpipe, params, jax.random.PRNGKey(0), ctx, unc,
                      [JaxConditioning(hz, control_params=jfused)], LAT,
                      JaxDDIMConfig(**cfg_kw), control_scales=jscales, x_T=x_T, **kw)

    jz = run(e["params"], e["jfused"], e["jctx"], e["junc"], e["jhz"], jnp.asarray(e["x_T"]))
    z = port_fn(ppipe, e["ctx"], e["unc"], [Conditioning(e["hz"])], LAT, DDIMConfig(**cfg_kw),
                x_T=torch.from_numpy(e["x_T"]), control_scales=scales, **kw)
    assert z.shape == LAT and torch.isfinite(z).all()
    return z, np.asarray(jz)


# ---------------------------------------------------------------------------
# host-side tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lower_order_final", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("steps", [1, 2, 3, 5, 8, 14, 15, 20, 50])
def test_order_schedule_matches_jax(steps, order, lower_order_final):
    np.testing.assert_array_equal(
        dpm_solver.order_schedule(steps, order, lower_order_final),
        jax_dpm.order_schedule(steps, order, lower_order_final))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("steps", [1, 2, 3, 4, 5, 6, 7, 10, 20, 25])
def test_singlestep_orders_match_jax(steps, order):
    got = dpm_solver.singlestep_orders(steps, order)
    assert got == jax_dpm.singlestep_orders(steps, order) and sum(got) == steps


@pytest.mark.parametrize("data_pred", [True, False])
@pytest.mark.parametrize("o", [1, 2, 3])
def test_singlestep_block_coeffs_match_jax(o, data_pred):
    ac = np.asarray(jax_sched.make_schedule().alphas_cumprod, np.float64)
    alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
    lam = np.log(alpha) - np.log(sigma)
    for s_idx, t_idx in ((999, 749), (500, 333), (120, 0)):
        got = dpm_solver._singlestep_block_coeffs(lam, alpha, sigma, s_idx, t_idx, o, data_pred)
        want = jax_dpm._singlestep_block_coeffs(lam, alpha, sigma, s_idx, t_idx, o, data_pred)
        assert list(got[0]) == list(want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-12, atol=0)


def test_dynamic_threshold_matches_jax():
    x0 = np.random.default_rng(2).normal(0, 2.0, size=LAT).astype(np.float32)
    for ratio, max_val in ((0.995, 1.0), (0.9, 0.5), (0.5, 5.0)):
        _close(dpm_solver._dynamic_threshold(torch.from_numpy(x0), ratio, max_val).numpy(),
               jax_dpm._dynamic_threshold(jnp.asarray(x0), ratio, max_val))


def test_bad_arguments_raise(env):
    e = env
    args = (e["ppipe"], e["ctx"], e["unc"], [Conditioning(e["hz"])], LAT)
    with pytest.raises(ValueError, match="eta"):
        plms.plms_sample(*args, DDIMConfig(steps=3, eta=0.5), x_T=torch.zeros(LAT))
    with pytest.raises(ValueError, match="eps parameterization"):
        plms.plms_sample(_port_pipe(_v(e["pcfg"]), e["params"]), *args[1:],
                         DDIMConfig(steps=3), x_T=torch.zeros(LAT))
    with pytest.raises(ValueError, match="order"):
        dpm_solver.dpm_solver_sample(*args, DDIMConfig(steps=3), order=4)
    with pytest.raises(ValueError, match="algorithm"):
        dpm_solver.dpm_solver_singlestep_sample(*args, DDIMConfig(steps=3), algorithm="x")


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

def test_plms_guess_mode_matches_jax(env):
    """PLMS (order 1 with its extra evaluation at t_next, then orders 2-4)
    in guess mode with decayed control scales."""
    e = env
    n = len(encoder_plan(e["pcfg"].control.unet)[0]) + 1
    scales = [0.825 ** float(n - 1 - i) for i in range(n)]
    z, jz = _both(e, jax_plms.plms_sample, plms.plms_sample,
                  dict(steps=5, guidance_scale=7.5, guess_mode=True), scales=scales)
    _close(z.numpy(), jz)


@pytest.mark.parametrize("algorithm", ["dpmsolver++", "dpmsolver"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_dpm_multistep_matches_jax(env, order, algorithm):
    z, jz = _both(env, jax_dpm.dpm_solver_sample, dpm_solver.dpm_solver_sample,
                  dict(steps=5, guidance_scale=7.5), order=order, algorithm=algorithm)
    _close(z.numpy(), jz)


def test_dpm_multistep_thresholding_matches_jax(env):
    e = env
    kw = dict(order=2, algorithm="dpmsolver++", thresholding=True,
              dynamic_thresholding_ratio=0.9, thresholding_max_val=0.5)
    z, jz = _both(e, jax_dpm.dpm_solver_sample, dpm_solver.dpm_solver_sample,
                  dict(steps=5, guidance_scale=7.5), **kw)
    _close(z.numpy(), jz)
    plain = dpm_solver.dpm_solver_sample(e["ppipe"], e["ctx"], e["unc"], [Conditioning(e["hz"])],
                                         LAT, DDIMConfig(steps=5), x_T=torch.from_numpy(e["x_T"]),
                                         order=2)
    assert (z - plain).abs().max() > 1e-3  # the threshold really clips


@pytest.mark.parametrize("order", [1, 2, 3])
def test_dpm_singlestep_matches_jax(env, order):
    """4 evaluations: blocks [1, 1, 1, 1], [2, 2] and [3, 1] (a lower-order
    tail after a full block)."""
    z, jz = _both(env, jax_dpm.dpm_solver_singlestep_sample,
                  dpm_solver.dpm_solver_singlestep_sample, dict(steps=4, guidance_scale=7.5),
                  order=order, algorithm="dpmsolver++" if order != 2 else "dpmsolver")
    _close(z.numpy(), jz)


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine"])
@pytest.mark.parametrize("method,order", [("multistep", 3), ("singlestep", 2)])
def test_dpm_v_parameterization_matches_jax(env, method, order, beta_schedule):
    jax_fn, port_fn = ((jax_dpm.dpm_solver_sample, dpm_solver.dpm_solver_sample)
                       if method == "multistep" else
                       (jax_dpm.dpm_solver_singlestep_sample,
                        dpm_solver.dpm_solver_singlestep_sample))
    z, jz = _both(env, jax_fn, port_fn, dict(steps=4, guidance_scale=7.5), v=True,
                  order=order, beta_schedule=beta_schedule)
    _close(z.numpy(), jz)
