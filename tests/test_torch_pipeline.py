"""The port's controlled-sampling slice end to end against the JAX package at
tiny size: text and hint encoding, LoRA fusion, 3 DDIM steps at CFG 7.5
from the same x_T, decoding. fp32 on the CPU; tolerance rtol=2e-3,
atol=2e-4 as tests/test_parity.py.
"""

import inspect

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

from ctrlora_tpu_torch import configs, convert, lora_fuse, schedules
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample

RTOL, ATOL = 2e-3, 2e-4
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")


def _bump(tree, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        ks = jax.tree_util.keystr(path)
        if any(z in ks for z in ZERO_INIT) and ("kernel" in ks or "lora_up" in ks):
            return jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def both():
    jcfg = jax_tiny(n_loras=1, switchable_banks=True)
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init(jax.random.PRNGKey(0), image_size=8)
    params = type(params)(*(_bump(p, 10 + i) for i, p in enumerate(params)))

    pcfg = configs.tiny_test_config(n_loras=1, switchable_banks=True)
    ppipe = CtrLoraPipeline(pcfg, device="cpu")
    fused = lora_fuse.fuse_control_tree(ppipe.control, convert.params_from_jax(params.control),
                                        0, pcfg.control.lora)
    ppipe.load_state_dicts(convert.params_from_jax(params.unet), fused,
                           convert.params_from_jax(params.vae),
                           convert.params_from_jax(params.clip))
    ppipe.cast_for_inference()
    return jcfg, jpipe, params, ppipe


def test_schedules_match():
    from ctrlora_tpu import schedules as js

    a, b = js.make_schedule(), schedules.make_schedule()
    np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
    da, db = js.make_ddim_schedule(a, 50), schedules.make_ddim_schedule(b, 50)
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas"):
        np.testing.assert_array_equal(getattr(da, f), getattr(db, f))
    t = np.array([1, 500, 981], np.int32)
    _close(schedules.timestep_embedding(torch.from_numpy(t), 320).numpy(),
           js.timestep_embedding(jnp.asarray(t), 320))


def test_ddim_slice_matches_jax(both):
    jcfg, jpipe, params, ppipe = both
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, size=(1, 16)).astype(np.int32)
    uids = np.zeros_like(ids)
    hint = rng.uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    x_T = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)

    # JAX reference: the fused-LoRA path, as bench.py drives it
    jctx, junc = jpipe.encode_text_cond_uncond(params, ids, uids)
    jhz = jpipe.encode_first_stage(params, hint)
    jfused = jax_fuse.fuse_control_tree(params.control, 0, jcfg.control.lora)
    jz = jax_ddim_sample(jpipe, params, jax.random.PRNGKey(1), jctx, junc,
                         [JaxConditioning(jhz, control_params=jfused)], (1, 8, 8, 4),
                         JaxDDIMConfig(steps=3, guidance_scale=7.5), x_T=jnp.asarray(x_T))
    jimg = jpipe.decode_first_stage(params, jz)

    ctx, unc = ppipe.encode_text_cond_uncond(torch.from_numpy(ids), torch.from_numpy(uids))
    _close(ctx.numpy(), jctx)
    hz = ppipe.encode_first_stage(torch.from_numpy(hint))
    _close(hz.numpy(), jhz)
    z = ddim_sample(ppipe, ctx, unc, [Conditioning(hz)], (1, 8, 8, 4),
                    DDIMConfig(steps=3, guidance_scale=7.5), x_T=torch.from_numpy(x_T))
    assert z.shape == (1, 8, 8, 4) and torch.isfinite(z).all()
    _close(z.numpy(), jz)
    img = ppipe.decode_first_stage(z)
    assert img.shape == (1, 16, 16, 3)
    _close(img.numpy(), jimg)
    # the control branch really contributes: without it the sample differs
    z0 = ddim_sample(ppipe, ctx, unc, None, (1, 8, 8, 4),
                     DDIMConfig(steps=3, guidance_scale=7.5), x_T=torch.from_numpy(x_T))
    assert (z0 - z).abs().max() > 1e-3


def test_pipeline_defaults_to_the_card_and_cpu_is_explicit(both):
    """The entry point runs on the card unless the caller asks for the CPU;
    a pipeline built with device="cpu" keeps every weight there and still
    encodes the hint as the JAX package does."""
    default = inspect.signature(CtrLoraPipeline.__init__).parameters["device"].default
    assert default == "cuda"
    _, jpipe, params, ppipe = both
    assert ppipe.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for m in ppipe.modules() for p in m.parameters())
    hint = np.random.default_rng(3).uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    _close(ppipe.encode_first_stage(torch.from_numpy(hint)).numpy(),
           jpipe.encode_first_stage(params, hint))
