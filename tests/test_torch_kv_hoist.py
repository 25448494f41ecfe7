"""The hoisted cross-attention k|v of the port (``CtrLoraPipeline.
xattn_kv_tables``, ``CrossAttention``'s ``kv``, made once by every sampler's
guided model call) against its own in-loop projection and against the JAX
package, on the CPU
at the tiny configuration in fp32 with seeded weights (the JAX counterpart:
tests/test_kv_hoist.py).

  * the tables are the in-loop product: ``apply_model`` given them is bit
    for bit the call without them, and within rtol 2e-3 / atol 2e-4 of
    JAX's ``apply_model(..., kv_rows=...)``, the tables themselves of
    JAX's;
  * a runtime-LoRA control condition gets None and the UNet still hoists;
  * a 3-step CFG ``ddim_sample`` (which hoists) is bit for bit the one
    with the products in the loop, and matches JAX's with
    ``hoist_xattn_kv=True``; PLMS and DPM-Solver hoist too, bit for bit;
  * ControlNet-XS, ControlNet-Lite and a UNet with image tokens have no
    tables, in both packages;
  * ``kv`` handed to a self-attention, a LoRA or an image-prompt site
    raises.

One JAX pipeline with numpy-seeded weights (``tests/torch_ranks.jax_side``:
no init is compiled); the JAX calls run eagerly, its sampler's scan once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import lora_fuse as jax_fuse
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling import ddim as jax_ddim

from ctrlora_tpu_torch import configs, lora_fuse
from ctrlora_tpu_torch.configs import LoRAConfig
from ctrlora_tpu_torch.models.attention import CrossAttention
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import make_guided_eps_fn
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.sampling.dpm_solver import dpm_solver_sample
from ctrlora_tpu_torch.sampling.plms import plms_sample
from tests import torch_ranks as ranks

RTOL, ATOL = 2e-3, 2e-4
B, LAT = 2, (2, 8, 8, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def env():
    jpipe, params, states = ranks.jax_side(seed=40)
    jcfg = jpipe.cfg
    fused = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu")
    fused.load_state_dicts(
        states[0], lora_fuse.fuse_control_tree(fused.control, states[1], 0,
                                               fused.cfg.control.lora), *states[2:])
    fused.cast_for_inference()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2 * B, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2 * B, 16, 64)).astype(np.float32)
    hz = rng.normal(size=(2 * B, 8, 8, 4)).astype(np.float32)
    return dict(jpipe=jpipe, params=params, fused=fused, unfused=ranks.train_pipeline(states),
                jfused=jax_fuse.fuse_control_tree(params.control, 0, jcfg.control.lora),
                x=x, ctx=ctx, hz=hz, t=np.full((2 * B,), 421, np.int32),
                x_T=rng.normal(size=LAT).astype(np.float32),
                ids=rng.integers(1, 128, size=(B, 16)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_apply_model_with_tables_is_the_in_loop_call_and_matches_jax(env):
    e, pipe = env, env["fused"]
    ctx, conds = _t(e["ctx"]), [Conditioning(_t(e["hz"]))]
    tables = pipe.xattn_kv_tables(ctx, conds)
    assert all(len(v) == 1 and v[0].shape == (2 * B, 16, 128) for v in tables["unet"].values())
    assert pipe.unet.mid_attn.block_0.attn2.wkv is not None  # cached by cast_for_inference
    args = (_t(e["x"]), _t(e["t"]).long(), ctx, conds)
    with torch.no_grad():
        ref = pipe.apply_model(*args)
        out = pipe.apply_model(*args, kv_rows=tables)
    assert torch.equal(out, ref)

    jconds = [JaxConditioning(jnp.asarray(e["hz"]), control_params=e["jfused"])]
    jtables = e["jpipe"].xattn_kv_tables(e["params"], jnp.asarray(e["ctx"]), jconds)
    assert set(tables["unet"]) == set(jtables["unet"]) and tables["unet"]
    assert set(tables["control"][0]) == set(jtables["control"][0]) and tables["control"][0]
    for name, rows in tables["unet"].items():
        _close(rows[0], jtables["unet"][name][0])
    for name, rows in tables["control"][0].items():
        _close(rows[0], jtables["control"][0][name][0])
    jout = e["jpipe"].apply_model(e["params"], jnp.asarray(e["x"]), jnp.asarray(e["t"]),
                                  jnp.asarray(e["ctx"]), jconds, kv_rows=jtables)
    _close(out, jout)


def test_runtime_lora_condition_keeps_its_projections_in_the_loop(env):
    """The unfused control tree carries LoRA on attn2's k and v: its entry
    is None, the UNet's still hoists (JAX tests/test_kv_hoist.py:50)."""
    e, pipe = env, env["unfused"]
    ctx, conds = _t(e["ctx"]), [Conditioning(_t(e["hz"]), lora_idx=0)]
    tables = pipe.xattn_kv_tables(ctx, conds)
    assert tables["unet"] and tables["control"] == (None,)
    args = (_t(e["x"]), _t(e["t"]).long(), ctx, conds)
    with torch.no_grad():
        ref = pipe.apply_model(*args)
        out = pipe.apply_model(*args, kv_rows=tables)
    assert torch.equal(out, ref)

    jconds = [JaxConditioning(jnp.asarray(e["hz"]), lora_idx=jnp.int32(0))]
    jtables = e["jpipe"].xattn_kv_tables(e["params"], jnp.asarray(e["ctx"]), jconds)
    assert jtables["control"] == (None,)
    jout = e["jpipe"].apply_model(e["params"], jnp.asarray(e["x"]), jnp.asarray(e["t"]),
                                  jnp.asarray(e["ctx"]), jconds, kv_rows=jtables)
    _close(out, jout)


def test_ddim_with_hoisting_is_bit_equal_and_matches_jax(env):
    e, pipe = env, env["fused"]
    ids = _t(e["ids"])
    ctx, unc = pipe.encode_text_cond_uncond(ids, torch.zeros_like(ids))
    conds = [Conditioning(_t(e["hz"][:B]))]

    run = lambda: ddim_sample(pipe, ctx, unc, conds, LAT, DDIMConfig(steps=3), x_T=_t(e["x_T"]))
    on = run()
    with ranks.kv_in_loop(pipe):
        off = run()
    assert on.shape == LAT and torch.isfinite(on).all()
    assert torch.equal(on, off)

    jp, params = e["jpipe"], e["params"]
    jctx, junc = jp.encode_text_cond_uncond(params, e["ids"], np.zeros_like(e["ids"]))
    jz = jax_ddim.ddim_sample(
        jp, params, jax.random.PRNGKey(0), jctx, junc,
        [JaxConditioning(jnp.asarray(e["hz"][:B]), control_params=e["jfused"])], LAT,
        jax_ddim.DDIMConfig(steps=3, hoist_xattn_kv=True), x_T=jnp.asarray(e["x_T"]))
    _close(on, jz)


@pytest.mark.parametrize("sampler", ["plms", "dpm_solver"])
def test_every_sampler_hoists_bit_for_bit(env, sampler):
    """The guided model call of every sampler makes the tables (once, from
    the CFG-stacked context); PLMS and DPM-Solver with them are bit for bit
    the runs with the products in the loop."""
    e, pipe = env, env["fused"]
    ids = _t(e["ids"])
    ctx, unc = pipe.encode_text_cond_uncond(ids, torch.zeros_like(ids))
    conds = [Conditioning(_t(e["hz"][:B]))]
    eps = make_guided_eps_fn(pipe, ctx, unc, conds, 7.5)
    assert eps.kv_tables is not None and eps.kv_tables["control"][0]
    assert all(rows[0].shape[0] == 2 * B for rows in eps.kv_tables["unet"].values())
    sample = {"plms": plms_sample, "dpm_solver": dpm_solver_sample}[sampler]
    run = lambda: sample(pipe, ctx, unc, conds, LAT, DDIMConfig(steps=3), x_T=_t(e["x_T"]))
    on = run()
    with ranks.kv_in_loop(pipe):
        off = run()
    assert on.shape == LAT and torch.isfinite(on).all()
    assert torch.equal(on, off)


def _variant(kind):
    cfg = configs.tiny_test_config(hint_mode="image" if kind != "ip_tokens" else "latent")
    if kind == "ip_tokens":
        return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, ip_tokens=4))
    ctrl = (dict(variant="xs", control_model_ratio=0.5) if kind == "xs"
            else dict(variant="lite"))
    return dataclasses.replace(cfg, control=dataclasses.replace(cfg.control, **ctrl))


@pytest.mark.parametrize("kind", ["xs", "lite", "ip_tokens"])
def test_variants_without_hoistable_sites_have_no_tables(kind):
    pipe = CtrLoraPipeline(_variant(kind), "cpu")
    ctx = torch.zeros((1, 16, 64))
    assert pipe.xattn_kv_tables(ctx, []) is None
    jcfg = jax_tiny(hint_mode="image" if kind != "ip_tokens" else "latent")
    if kind == "ip_tokens":
        jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, ip_tokens=4))
    else:
        ctrl = (dict(variant="xs", control_model_ratio=0.5) if kind == "xs"
                else dict(variant="lite"))
        jcfg = dataclasses.replace(jcfg, control=dataclasses.replace(jcfg.control, **ctrl))
    # JAX decides from the configuration before it reads a parameter
    assert JaxPipeline(jcfg).xattn_kv_tables(None, jnp.zeros((1, 16, 64)), None) is None


@pytest.mark.parametrize("site", ["self", "lora", "ip_tokens"])
def test_kv_on_a_site_without_the_fused_product_raises(site):
    kw = {"self": {}, "lora": dict(context_dim=64, lora=LoRAConfig(n_loras=1, rank=4)),
          "ip_tokens": dict(context_dim=64, ip_tokens=4)}[site]
    attn = CrossAttention(32, 2, 16, **kw)
    x, kv = torch.zeros((1, 4, 32)), torch.zeros((1, 16, 64))
    context = None if site == "self" else torch.zeros((1, 16 + 4 * (site == "ip_tokens"), 64))
    with pytest.raises(ValueError, match="plain cross-attention"):
        attn(x, context, kv=kv)
    if site != "ip_tokens":
        with pytest.raises(ValueError, match=r"fused k\|v product"):
            attn.project_kv(torch.zeros((1, 16, 32 if site == "self" else 64)))
