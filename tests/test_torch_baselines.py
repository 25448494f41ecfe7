"""The ControlNet baselines of the port against the JAX package on the CPU:
the vanilla image-hint ControlNet (``cldm_v15``'s branch) and
ControlNet-Lite, at the tiny test configuration with ``hint_mode='image'``
in fp32, weights through ``convert.params_from_jax``, inputs from a numpy
seed, within rtol 2e-3 / atol 2e-4 (the frameworks sum convolutions in
different orders):

* ``HintBlock`` and every control tap of each variant;
* the UNet with encoder-side taps and with ``only_mid_control``;
* ``apply_model`` of each variant, and of the vanilla variant with
  ``global_average_pooling`` and ``only_mid_control``;
* a 2-step ``ddim_sample`` of each variant from JAX's starting noise (Lite
  builds no row table and so launches no row unpack);
* a train step's loss and trainable gradients against ``jax.grad`` of the
  JAX ``loss_for_batch``, and the trainable count against JAX's mask.

The tiny VAE downsamples by 2 and the hint encoder by 8, so the pixel hint
is 4x the target image's size, as in the JAX package's own baseline tests.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import configs as jax_configs
from ctrlora_tpu.configs import TrainConfig as JaxTrainConfig
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models.unet import HintBlock as JaxHintBlock
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig
from ctrlora_tpu.sampling.ddim import ddim_sample as jax_ddim_sample
from ctrlora_tpu.training import step as jstep
from ctrlora_tpu.training import train_state as jts

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling import common as sampling_common
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.style import style_config
from ctrlora_tpu_torch.training import step as pstep
from ctrlora_tpu_torch.training import train_state as pts
from tests.test_torch_plms_dpm import _random_params
from tests.torch_fresh import seed_zeroed_layers_

RTOL, ATOL = 2e-3, 2e-4
B, LAT, HINT = 2, 8, 64  # latent 8x8 (tiny VAE: /2), pixel hint 64x64 (hint encoder: /8)
VARIANTS = ("controlnet", "lite")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test run shares the host's cores between
    several test processes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def _variant(cfg, variant, **diffusion):
    return dataclasses.replace(
        cfg, control=dataclasses.replace(cfg.control, variant=variant),
        diffusion=dataclasses.replace(cfg.diffusion, **diffusion))


def jax_config(variant, **diffusion):
    return _variant(jax_tiny(hint_mode="image"), variant, **diffusion)


def port_config(variant, **diffusion):
    return _variant(configs.tiny_test_config(hint_mode="image"), variant, **diffusion)


def port_pipeline(pcfg, params, **kw):
    pipe = CtrLoraPipeline(pcfg, "cpu", **kw)
    pipe.load_state_dicts(*(convert.params_from_jax(p) for p in params))
    return pipe


def _env(variant):
    jpipe = JaxPipeline(jax_config(variant))
    params = _random_params(jpipe, 30 + VARIANTS.index(variant))
    rng = np.random.default_rng(1)
    inputs = {"x": rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
              "hint": rng.uniform(0, 1, (B, HINT, HINT, 3)).astype(np.float32),
              "ctx": rng.standard_normal((B, 16, 64)).astype(np.float32),
              "t": np.array([17, 901], np.int32)}
    return {"variant": variant, "jpipe": jpipe, "params": params, "inputs": inputs,
            "ppipe": port_pipeline(port_config(variant), params)}


@pytest.fixture(scope="module")
def envs():
    """Each variant's JAX pipeline, random weights, port pipeline and inputs."""
    return {v: _env(v) for v in VARIANTS}


@pytest.fixture(params=VARIANTS)
def env(request, envs):
    return envs[request.param]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _shared_fields(port, ref, path=""):
    """Every field both dataclass trees have, as (path, port value, JAX value)."""
    out = []
    for f in dataclasses.fields(port):
        if not hasattr(ref, f.name):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            out += _shared_fields(a, b, f"{path}{f.name}.")
        else:
            out.append((path + f.name, a, b))
    return out


@pytest.mark.parametrize("name", ["cldm_v15", "cnlite_sd15"])
def test_baseline_presets_match_jax(name):
    """The port's presets equal JAX's, field for field where both have the
    field (the port leaves out the fields of what it does not port)."""
    fields = _shared_fields(configs.load_model_config(name), jax_configs.load_model_config(name))
    assert len(fields) > 60
    assert [(p, a) for p, a, b in fields if a != b] == []
    ctl = configs.load_model_config(name).control
    assert (ctl.hint_mode, ctl.variant) == ("image", "lite" if "lite" in name else "controlnet")


def test_xs_preset_names_its_roadmap_item():
    """ControlNet-XS (ROADMAP item 10b) is ported: its preset is JAX's, field
    for field, and its pipeline holds the XS UNet and no control module.
    The style config's image tokens (item 9) are ported too: its file reads
    as the port's ``style_config()``."""
    fields = _shared_fields(configs.load_model_config("cnxs_sd15"),
                            jax_configs.load_model_config("cnxs_sd15"))
    assert len(fields) > 60 and [(p, a) for p, a, b in fields if a != b] == []
    pipe = CtrLoraPipeline(_variant(configs.tiny_test_config(hint_mode="image"), "xs"), "cpu")
    assert type(pipe.unet).__name__ == "XSUNet" and pipe.control is None
    assert configs.load_model_config(
        "configs/inference/ctrlora_style_sd15_rank128_1lora.yaml") == style_config()


def test_hint_block_matches_jax(env):
    params, hint = env["params"], env["inputs"]["hint"]
    want = JaxHintBlock(32).apply({"params": params.control["params"]["hint_block"]},
                                  jnp.asarray(hint))
    got = env["ppipe"].control.hint_block(_t(hint), torch.float32).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (B, LAT, LAT, 32)
    _close(got.detach().numpy(), want)


def test_control_taps_match_jax(env):
    i, params = env["inputs"], env["params"]
    args = (jnp.asarray(i["x"]), jnp.asarray(i["t"]), jnp.asarray(i["ctx"]))
    want = env["jpipe"].control.apply(params.control, *args, hint=jnp.asarray(i["hint"]))
    got = env["ppipe"].control(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), hint=_t(i["hint"]))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)


@pytest.mark.parametrize("mode", ["encoder", "only_mid"])
def test_unet_control_modes_match_jax(envs, mode):
    """The UNet alone, with random taps: encoder-side injection (Lite's)
    and the middle tap only."""
    env = envs["controlnet"]
    i, params = env["inputs"], env["params"]
    rng = np.random.default_rng(2)
    chans = [(8, 32), (8, 32), (4, 32), (4, 64), (4, 64)]
    taps = [rng.standard_normal((B, s, s, c)).astype(np.float32) for s, c in chans]
    kw = ({"control_mode": "encoder"} if mode == "encoder" else {"only_mid_control": True})
    want = env["jpipe"].unet.apply(params.unet, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
                                   jnp.asarray(i["ctx"]), control=[jnp.asarray(c) for c in taps],
                                   **kw)
    got = env["ppipe"].unet(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), control=[_t(c) for c in taps],
                            **kw)
    _close(got.detach().numpy(), want)
    plain = env["ppipe"].unet(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), control=[_t(c) for c in taps])
    assert (got - plain).abs().max() > 1e-3  # the mode changes the output


@pytest.mark.parametrize("variant,options", [
    ("controlnet", {}), ("lite", {}),
    ("controlnet", {"global_average_pooling": True, "only_mid_control": True})],
    ids=["controlnet", "lite", "controlnet-gap_only_mid"])
def test_apply_model_matches_jax(envs, variant, options):
    env = envs[variant]
    i, params = env["inputs"], env["params"]
    jpipe = JaxPipeline(jax_config(variant, **options))
    ppipe = port_pipeline(port_config(variant, **options), params) if options \
        else env["ppipe"]
    want = jpipe.apply_model(params, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
                             jnp.asarray(i["ctx"]), [JaxConditioning(jnp.asarray(i["hint"]))])
    got = ppipe.apply_model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), [Conditioning(_t(i["hint"]))])
    _close(got.numpy(), want)


def test_ddim_sample_matches_jax(env):
    """2 DDIM steps at CFG 7.5 from JAX's starting noise; the vanilla
    ControlNet builds its row tables (one unpack a step), Lite none."""
    i, params, variant = env["inputs"], env["params"], env["variant"]
    unc = np.zeros_like(i["ctx"])
    x_T = np.random.default_rng(3).standard_normal((B, LAT, LAT, 4)).astype(np.float32)
    run = jax.jit(lambda p, c, u, h, x: jax_ddim_sample(
        env["jpipe"], p, jax.random.PRNGKey(0), c, u, [JaxConditioning(h)], (B, LAT, LAT, 4),
        JaxDDIMConfig(steps=2, guidance_scale=7.5), x_T=x))
    want = run(params, *(jnp.asarray(a) for a in (i["ctx"], unc, i["hint"], x_T)))
    unpack = mock.MagicMock(wraps=sampling_common.unpack_ops.unpack_rows)
    with mock.patch.object(sampling_common.unpack_ops, "unpack_rows", unpack):
        got = ddim_sample(env["ppipe"], _t(i["ctx"]), _t(unc), [Conditioning(_t(i["hint"]))],
                          (B, LAT, LAT, 4), DDIMConfig(steps=2, guidance_scale=7.5),
                          x_T=_t(x_T))
    _close(got.numpy(), want)
    assert unpack.call_count == (2 if variant == "controlnet" else 0)
    tables = env["ppipe"].emb_proj_tables(torch.tensor([1, 2]), [Conditioning(_t(i["hint"]))])
    assert (tables is None) == (variant == "lite")


def test_train_step_matches_jax(env):
    """trainable='all': the loss of one batch and every control gradient
    against jax.grad, with JAX's draws (z noise, t, diffusion noise; an
    image hint takes no posterior draw). Lite's unused time_embed gets no
    gradient in the port (the reference's AdamW skips it) and zeros in
    JAX."""
    params, jpipe = env["params"], env["jpipe"]
    rng = np.random.default_rng(4)
    batch = {"jpg": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, (B, HINT, HINT, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, (B, 16)).astype(np.int32)}
    key = jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_for_batch(jpipe, p, jbatch, key), has_aux=True))(params)
    _, z_rng, t_rng = jax.random.split(key, 3)
    t_rng, n_rng = jax.random.split(t_rng)
    shape = (B, LAT, LAT, 4)
    draws = {"z_eps": jax.random.normal(z_rng, shape), "t": jax.random.randint(t_rng, (B,), 0, 1000),
             "noise": jax.random.normal(n_rng, shape)}
    draws = {k: _t(v) for k, v in draws.items()}

    pipe = port_pipeline(port_config(env["variant"]), params, fuse_lora=False)
    tcfg = configs.TrainConfig(trainable="all")
    mask = pts.trainable_mask(pipe, tcfg)
    pts.make_optimizer(pipe, tcfg, mask)
    jmask = jts.trainable_mask(params, JaxTrainConfig(trainable="all"))
    assert pts.count_trainable(pipe, mask) == jts.count_trainable(params, jmask)
    assert all(mask["control"].values()) and not any(mask["unet"].values())
    loss, _ = pstep.loss_for_batch(pipe, {k: _t(v) for k, v in batch.items()}, draws=draws)
    _close(loss.item(), float(jloss))
    loss.backward()
    ref = convert.params_from_jax(jgrads.control)
    unused = []
    for name, p in pipe.control.named_parameters():
        if p.grad is None:
            unused.append(name)
            np.testing.assert_array_equal(ref[name].numpy(), 0)
        else:
            _close(p.grad.numpy(), ref[name].numpy())
    assert unused == ([] if env["variant"] == "controlnet" else
                      [n for n, _ in pipe.control.time_embed.named_parameters(prefix="time_embed")])
    assert all(p.grad is None for p in pipe.unet.parameters())


@pytest.mark.parametrize("variant", VARIANTS)
def test_fresh_control_branch_adds_nothing(variant):
    """As in JAX, whose zero convs and hint-encoder output conv start at
    zero: a fresh branch's taps are all zero, so a fresh model is the
    plain UNet, and each zero conv still gets a gradient once the UNet's
    zeroed layers carry weights (a fresh UNet outputs 0, as JAX's)."""
    torch.manual_seed(0)
    pipe = CtrLoraPipeline(port_config(variant), "cpu", fuse_lora=False)
    x, t = torch.randn(B, LAT, LAT, 4), torch.tensor([3, 500])
    ctx, hint = torch.randn(B, 16, 64), torch.rand(B, HINT, HINT, 3)
    assert not pipe.control.hint_block.conv_out.weight.any()
    with torch.no_grad():
        taps = pipe.control(x, t, ctx, hint=hint)
        assert all(not tap.any() for tap in taps)
        torch.testing.assert_close(pipe.apply_model(x, t, ctx, [Conditioning(hint)]),
                                   pipe.unet(x, t, ctx), rtol=0, atol=0)
    seed_zeroed_layers_(pipe.unet)
    tcfg = configs.TrainConfig(trainable="all")
    pts.make_optimizer(pipe, tcfg, pts.trainable_mask(pipe, tcfg))
    pipe.apply_model(x, t, ctx, [Conditioning(hint)]).square().mean().backward()
    assert all(p.grad.any() for n, p in pipe.control.named_parameters()
               if n.startswith("zero_") and n.endswith("weight"))


def test_latent_cached_batch_raises_for_image_hint(env):
    moments = torch.zeros(B, LAT, LAT, 8)
    with pytest.raises(ValueError, match="hint_mode='latent'"):
        pstep.loss_for_batch(env["ppipe"], {"jpg_moments": moments, "hint_moments": moments,
                                            "token_ids": torch.ones(B, 16, dtype=torch.long)})
