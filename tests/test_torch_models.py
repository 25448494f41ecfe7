"""Parity of the PyTorch port's model modules with the JAX package.

The same seeded weights (through ``convert.params_from_jax``) and inputs (numpy)
go through both; fp32 on the CPU. Tolerance rtol=2e-3, atol=2e-4, as
tests/test_parity.py: the two frameworks sum convolutions and matmuls in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import lora_fuse as jax_fuse
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models import attention as jax_attention
from ctrlora_tpu.models import layers as jax_layers
from ctrlora_tpu.models.unet import ControlNet as JaxControlNet
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline

from ctrlora_tpu_torch import configs, convert, lora_fuse
from ctrlora_tpu_torch.models import attention, clip, layers, unet, vae

RTOL, ATOL = 2e-3, 2e-4
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")


def _bump(tree, seed):
    """Zero-init kernels (and lora_up) -> small random values, so every
    branch carries signal, as a trained checkpoint does."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        ks = jax.tree_util.keystr(path)
        if any(z in ks for z in ZERO_INIT) and ("kernel" in ks or "lora_up" in ks):
            return jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


def _np(t):
    return t.detach().cpu().float().numpy()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jax_tiny(n_loras=1, switchable_banks=True)
    pipe = JaxPipeline(cfg)
    params = pipe.init(jax.random.PRNGKey(0), image_size=8)
    params = type(params)(*(_bump(p, i) for i, p in enumerate(params)))
    return cfg, pipe, params


def _load(module, tree):
    module.load_state_dict(convert.params_from_jax(tree), strict=True)
    return module.eval()


def test_group_norm_and_resblock_with_emb_row():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    row = rng.normal(size=(1, 64)).astype(np.float32)
    blk = jax_layers.ResBlock(out_channels=64)
    emb = jnp.zeros((2, 128))
    p = _bump(blk.init(jax.random.PRNGKey(2), jnp.asarray(x), emb), 3)
    p = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), p)
    ref = blk.apply(p, jnp.asarray(x), None, None, jnp.asarray(row))
    mod = _load(layers.ResBlock(32, 64, 128), p)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = mod(xt, emb_row=torch.from_numpy(row)).permute(0, 2, 3, 1)
    _close(_np(out), ref)
    # the unhoisted path: emb through emb_proj inside the block
    e = rng.normal(size=(2, 128)).astype(np.float32)
    ref2 = blk.apply(p, jnp.asarray(x), jnp.asarray(e))
    out2 = mod(xt, emb=torch.from_numpy(e)).permute(0, 2, 3, 1)
    _close(_np(out2), ref2)


def test_spatial_transformer():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, 48)).astype(np.float32)
    st = jax_attention.SpatialTransformer(heads=2, dim_head=16, context_dim=48,
                                          use_flash=False)
    p = _bump(st.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(ctx)), 6)
    ref = st.apply(p, jnp.asarray(x), jnp.asarray(ctx))
    mod = _load(attention.SpatialTransformer(32, 2, 16, context_dim=48, use_flash=False), p)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = mod(xt, torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    _close(_np(out), ref)


def test_unet_with_control(jax_model):
    cfg, pipe, params = jax_model
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 900], np.int32)
    ctx = rng.normal(size=(2, 16, 64)).astype(np.float32)
    taps = [rng.normal(0, 0.1, size=(2, 8 // s, 8 // s, c)).astype(np.float32)
            for s, c in ((1, 32), (1, 32), (2, 32), (2, 64), (2, 64))]
    ref = pipe.unet.apply(params.unet, x, t, ctx, control=[jnp.asarray(a) for a in taps])
    mod = _load(unet.UNet(configs.tiny_test_config().unet), params.unet)
    out = mod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
              control=[torch.from_numpy(a) for a in taps])
    assert out.shape == (2, 8, 8, 4)
    _close(_np(out), ref)


def test_controlnet_fused_matches_jax_fused(jax_model):
    """Port lora_fuse on the converted unfused tree == JAX fuse, then both
    fused ControlNets agree."""
    cfg, pipe, params = jax_model
    rng = np.random.default_rng(8)
    hint = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([500, 3], np.int32)
    ctx = rng.normal(size=(2, 16, 64)).astype(np.float32)
    jfused = jax_fuse.fuse_control_tree(params.control, 0, cfg.control.lora)
    jmod = JaxControlNet(jax_fuse.fused_control_config(cfg.control))
    ref = jmod.apply(jfused, hint, t, ctx)

    pcfg = configs.tiny_test_config(n_loras=1, switchable_banks=True)
    mod = unet.ControlNet(lora_fuse.fused_control_config(pcfg.control)).eval()
    fused = lora_fuse.fuse_control_tree(mod, convert.params_from_jax(params.control), 0,
                                        pcfg.control.lora)
    jflat = convert.params_from_jax(jfused)
    assert set(fused) == set(jflat)
    for k in jflat:
        _close(_np(fused[k]), _np(jflat[k]))
    mod.load_state_dict(fused, strict=True)
    out = mod(torch.from_numpy(hint), torch.from_numpy(t), torch.from_numpy(ctx))
    assert len(out) == len(ref) == 5
    for a, b in zip(out, ref):
        _close(_np(a), b)


def test_vae_encode_decode(jax_model):
    cfg, pipe, params = jax_model
    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    from ctrlora_tpu.models.vae import AutoencoderKL as JaxVAE

    mean, logvar = pipe.vae.apply(params.vae, img, method=JaxVAE.encode)
    dec = pipe.vae.apply(params.vae, z, method=JaxVAE.decode)
    mod = _load(vae.AutoencoderKL(configs.tiny_test_config().vae), params.vae)
    pm, plv = mod.encode(torch.from_numpy(img))
    _close(_np(pm), mean)
    _close(_np(plv), logvar)
    pd = mod.decode(torch.from_numpy(z))
    assert pd.shape == (1, 16, 16, 3)
    _close(_np(pd), dec)


def test_clip_text_model(jax_model):
    cfg, pipe, params = jax_model
    ids = np.random.default_rng(10).integers(0, 200, size=(2, 16)).astype(np.int32)
    ref = pipe.clip.apply(params.clip, ids)  # ids >= vocab clamp in both
    mod = _load(clip.CLIPTextModel(configs.tiny_test_config().clip), params.clip)
    _close(_np(mod(torch.from_numpy(ids))), ref)
