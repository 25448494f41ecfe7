"""The port's style / IP-Adapter slice against the JAX package on the CPU,
fp32 at the tiny test configuration with two image-prompt tokens, inputs
from a numpy seed, rtol 2e-3 / atol 2e-4 unless a test says otherwise:

* ``ImageProjModel``, ``CLIPVisionModel`` (each package's
  ``convert_clip_vision`` on one HF-named dict), ``clip_image_preprocess``
  (1e-6), ``ip_attn_sites`` / ``IP_SCALE_TARGETS`` and the UNet's checkpoint
  table with the image-prompt keys, at SD1.5 and tiny width;
* ``load_ip_adapter_into`` run numerically: one seeded ip-adapter dict
  loaded by both packages, then the UNet + ControlNet evaluation with text
  and image tokens (the check the JAX package's own tests make through
  ``eval_shape`` only);
* ``pipeline.apply_model`` with ``ip_context`` (the control branch reads the
  text only), 2-step guided DDIM with ``ip_context`` and
  ``uncond_ip_context`` from a given x_T, and ``ddim_decode_from``;
* the open_clip text bridge and the negative-content text tower
  (``layer="projected"``) from tiny files;
* a tiny ``StyleCtrLoRA`` end to end from files the test writes (SD, Base
  ControlNet, LoRA, both IP-Adapter file forms, the vision tower): loaded
  tensors equal to the files', ``embed_style`` against JAX's vision tower
  and image projection, txt2img and img2img images;
* a fresh image-prompt branch (``ip_scale`` 1, lecun-normal projections)
  and the port's refusals of a missing, unexpected or mis-sized
  ``ip_context``.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import lora_fuse as jax_fuse
from ctrlora_tpu.configs import CLIPTextConfig as JaxCLIPTextConfig
from ctrlora_tpu.configs import UNetConfig as JaxUNetConfig
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models import ip_adapter as jax_ip
from ctrlora_tpu.models import openclip as jax_openclip
from ctrlora_tpu.models.clip import CLIPTextModel as JaxCLIPTextModel
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig
from ctrlora_tpu.sampling.ddim import ddim_decode_from as jax_ddim_decode_from
from ctrlora_tpu.sampling.ddim import ddim_sample as jax_ddim_sample
from ctrlora_tpu.utils import ckpt_torch as jax_bridge

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.models import ip_adapter, openclip
from ctrlora_tpu_torch.models.clip import CLIPTextModel
from ctrlora_tpu_torch.models.unet import UNet
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_decode_from, ddim_sample
from ctrlora_tpu_torch.style import StyleCtrLoRA, style_config
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from tests.test_torch_plms_dpm import _port_pipe, _random_params
from tests.torch_configs import jax_tree

RTOL, ATOL = 2e-3, 2e-4
IP = 2  # image-prompt tokens of the tiny configuration
B, LAT = 2, (2, 8, 8, 4)
IP_SCALE = 0.7
# the tiny vision tower: image 28, patch 14, width 32, 2 layers
VISION = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=2, projection_dim=16, hidden_act="gelu")
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")


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


def _with_ip(cfg, n=IP):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, ip_tokens=n))


def _site_widths(cfg):
    """Each attn2 site's inner width, in ``ip_attn_sites`` order (the port's
    module tree says it)."""
    unet = UNet(cfg)
    return [unet.get_submodule(".".join(s)).to_q.out_features
            for s in ip_adapter.ip_attn_sites(cfg)]


def _seeded_ip_sd(rng, cfg, scale=0.1):
    """A seeded ip-adapter sub-dict: '{2j+1}.to_{k,v}_ip.weight' [inner,
    context_dim] for site j, the reference's layout."""
    sd = {}
    for j, inner in enumerate(_site_widths(cfg)):
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"{2 * j + 1}.{name}.weight"] = (
                scale * rng.standard_normal((inner, cfg.context_dim))).astype(np.float32)
    return sd


def _proj_sd(rng, dim, tokens, embeds):
    return {"proj.weight": (rng.standard_normal((tokens * dim, embeds)) * embeds ** -0.5
                            ).astype(np.float32),
            "proj.bias": (0.02 * rng.standard_normal(tokens * dim)).astype(np.float32),
            "norm.weight": (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
            "norm.bias": (0.02 * rng.standard_normal(dim)).astype(np.float32)}


def _hf_vision_sd(rng, v):
    """A seeded HF CLIPVisionModelWithProjection state dict for config `v`."""
    d, f, pre = v["hidden_size"], v["intermediate_size"], "vision_model."
    n = lambda *shape, std=None: (rng.standard_normal(shape) * (
        std if std is not None else shape[-1] ** -0.5)).astype(np.float32)
    sd = {pre + "embeddings.class_embedding": n(d, std=0.02),
          pre + "embeddings.position_embedding.weight":
              n((v["image_size"] // v["patch_size"]) ** 2 + 1, d, std=0.02),
          pre + "embeddings.patch_embedding.weight": n(d, 3, v["patch_size"], v["patch_size"],
                                                       std=(3 * v["patch_size"] ** 2) ** -0.5),
          "visual_projection.weight": n(v["projection_dim"], d)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{pre}{ln}.weight"] = 1 + n(d, std=0.1)
        sd[f"{pre}{ln}.bias"] = n(d, std=0.02)
    for i in range(v["num_layers"]):
        src = f"{pre}encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{src}self_attn.{name}.weight"] = n(d, d)
            sd[f"{src}self_attn.{name}.bias"] = n(d, std=0.02)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{src}{ln}.weight"] = 1 + n(d, std=0.1)
            sd[f"{src}{ln}.bias"] = n(d, std=0.02)
        sd[f"{src}mlp.fc1.weight"], sd[f"{src}mlp.fc1.bias"] = n(f, d), n(f, std=0.02)
        sd[f"{src}mlp.fc2.weight"], sd[f"{src}mlp.fc2.bias"] = n(d, f), n(d, std=0.02)
    return sd


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------

def test_image_proj_matches_jax():
    rng = np.random.default_rng(0)
    sd = _proj_sd(rng, 64, IP, 16)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    want = jax_ip.ImageProjModel(cross_attention_dim=64, clip_extra_context_tokens=IP).apply(
        _jax_tree(jax_ip.convert_image_proj(sd)), jnp.asarray(x))
    model = ip_adapter.ImageProjModel(64, IP, 16)
    model.load_state_dict(ip_adapter.convert_image_proj(sd), strict=True)
    got = model(torch.from_numpy(x))
    assert tuple(got.shape) == (3, IP, 64)
    _close(got.detach(), want)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_vision_matches_jax(act):
    v = dict(VISION, hidden_act=act)
    sd = _hf_vision_sd(np.random.default_rng(1), v)
    px = np.random.default_rng(2).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = jax_ip.CLIPVisionModel(jax_ip.CLIPVisionConfig(**v)).apply(
        _jax_tree(jax_ip.convert_clip_vision(sd, jax_ip.CLIPVisionConfig(**v))), jnp.asarray(px))
    cfg = ip_adapter.CLIPVisionConfig(**v)
    model = ip_adapter.CLIPVisionModel(cfg)
    model.load_state_dict(ip_adapter.convert_clip_vision(sd, cfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(px))
    assert tuple(got.shape) == (2, 16)
    _close(got, want)


def test_vision_defaults_are_vit_h():
    assert (dataclasses.asdict(ip_adapter.CLIPVisionConfig())
            == dataclasses.asdict(jax_ip.CLIPVisionConfig()))
    model = ip_adapter.CLIPVisionModel(ip_adapter.CLIPVisionConfig(**VISION))
    assert tuple(model.position_embedding.shape) == (5, 32)
    assert model.patch_embedding.bias is None and model.visual_projection.bias is None


@pytest.mark.parametrize("hw", [(37, 53), (53, 37)])
def test_clip_image_preprocess_matches_jax(hw):
    img = np.random.default_rng(3).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = ip_adapter.clip_image_preprocess(img[None])
    assert got.shape == (1, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_ip.clip_image_preprocess(img[None]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", ["sd15", "tiny"])
def test_ip_sites_and_entries_match_jax(width):
    pcfg = configs.UNetConfig() if width == "sd15" else configs.tiny_test_config().unet
    jcfg = JaxUNetConfig() if width == "sd15" else jax_tiny().unet
    sites = ip_adapter.ip_attn_sites(pcfg)
    assert sites == jax_ip.ip_attn_sites(jcfg)
    assert len(sites) == (16 if width == "sd15" else 4)
    assert ip_adapter.IP_SCALE_TARGETS == jax_ip.IP_SCALE_TARGETS
    for ip in (False, True):
        assert bridge.unet_entries(pcfg, ip=ip) == jax_bridge.unet_entries(jcfg, ip=ip)


def test_params_from_jax_keeps_a_scalar_leaf():
    sd = convert.params_from_jax({"params": {"attn2": {"ip_scale": np.float32(0.7),
                                                       "to_k_ip": {"kernel": np.ones((3, 2))}}}})
    assert tuple(sd["attn2.ip_scale"].shape) == () and float(sd["attn2.ip_scale"]) == \
        pytest.approx(0.7)
    assert tuple(sd["attn2.to_k_ip.weight"].shape) == (2, 3)


# ---------------------------------------------------------------------------
# the model path against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    jcfg = _with_ip(jax_tiny(n_loras=1, switchable_banks=True))
    jpipe = JaxPipeline(jcfg)
    params = _random_params(jpipe, 30)
    params = params._replace(unet=jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.full_like(x, 0.8) if p[-1].key == "ip_scale" else x, params.unet))
    pcfg = _with_ip(configs.tiny_test_config(n_loras=1, switchable_banks=True))
    ppipe = _port_pipe(pcfg, params)
    jfused = jax_fuse.fuse_control_tree(params.control, 0, jcfg.control.lora)
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 128, size=(B, 16)).astype(np.int32)
    hint = rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32)
    jctx, junc = jpipe.encode_text_cond_uncond(params, ids, np.zeros_like(ids))
    inputs = dict(ctx=np.asarray(jctx), unc=np.asarray(junc),
                  hz=np.asarray(jpipe.encode_first_stage(params, hint)),
                  x=rng.normal(size=LAT).astype(np.float32),
                  ip=rng.normal(size=(B, IP, 64)).astype(np.float32),
                  uip=rng.normal(size=(B, IP, 64)).astype(np.float32))

    @jax.jit
    def j_apply(params, x, t, ctx, hz, ip):
        return jpipe.apply_model(params, x, t, ctx, [JaxConditioning(hz, control_params=jfused)],
                                 ip_context=ip)

    return dict(jcfg=jcfg, pcfg=pcfg, jpipe=jpipe, params=params, ppipe=ppipe, jfused=jfused,
                i=inputs, j_apply=j_apply)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _apply_both(e, params, ppipe, t=500):
    i = e["i"]
    tv = np.full((B,), t, np.int32)
    want = e["j_apply"](params, i["x"], tv, i["ctx"], i["hz"], i["ip"])
    with torch.no_grad():
        got = ppipe.apply_model(_t(i["x"]), _t(tv), _t(i["ctx"]), [Conditioning(_t(i["hz"]))],
                                ip_context=_t(i["ip"]))
    return got, np.asarray(want)


def test_apply_model_with_ip_context_matches_jax(env):
    """The UNet reads [text | image] tokens; the control branch the text."""
    ppipe = env["ppipe"]
    with mock.patch.object(ppipe, "apply_control", wraps=ppipe.apply_control) as spy:
        got, want = _apply_both(env, env["params"], ppipe)
    assert tuple(spy.call_args.args[2].shape) == (B, 16, 64)
    assert got.shape == LAT and torch.isfinite(got).all()
    _close(got, want)
    # the image tokens matter
    with torch.no_grad():
        other = ppipe.apply_model(_t(env["i"]["x"]), torch.full((B,), 500), _t(env["i"]["ctx"]),
                                  [Conditioning(_t(env["i"]["hz"]))],
                                  ip_context=_t(env["i"]["uip"]))
    assert (other - got).norm() / got.norm() > 1e-3


@pytest.mark.parametrize("target", ["all", "style_blocks"])
def test_load_ip_adapter_into_runs_as_jax(env, target):
    """One seeded ip-adapter dict through each package's
    ``load_ip_adapter_into`` at ip_scale 0.7: equal trees, and the same
    UNet + ControlNet evaluation on text and image tokens (tiny has no
    out_3/4/5 sites, so 'style_blocks' zeroes every scale)."""
    pcfg = env["pcfg"]
    ip_sd = _seeded_ip_sd(np.random.default_rng(5), pcfg.unet)
    tree = jax_bridge.tree_to_mutable(env["params"].unet)
    jax_ip.load_ip_adapter_into(tree, ip_sd, env["jcfg"].unet, IP_SCALE, target)
    params = env["params"]._replace(unet=_jax_tree(tree))
    ppipe = _port_pipe(pcfg, env["params"])
    assert ip_adapter.load_ip_adapter_into(ppipe.unet, ip_sd, pcfg.unet, IP_SCALE,
                                           target) is ppipe.unet
    want_sd = convert.params_from_jax(tree)
    got_sd = ppipe.unet.state_dict()
    ip_keys = [k for k in want_sd if "_ip" in k or "ip_scale" in k]
    assert len(ip_keys) == 3 * len(ip_adapter.ip_attn_sites(pcfg.unet))
    for k in ip_keys:
        assert torch.equal(got_sd[k], want_sd[k]), k
    scales = {float(got_sd[k]) for k in ip_keys if k.endswith("ip_scale")}
    assert scales == ({float(np.float32(IP_SCALE))} if target == "all" else {0.0})
    got, want = _apply_both(env, params, ppipe)
    _close(got, want)


def test_load_into_cast_unet_keeps_its_dtypes():
    """Into a UNet cast for inference: the projections are written in place
    in bf16, ip_scale stays an fp32 scalar and is used in bf16 as JAX's
    (0.7 -> 0.69921875)."""
    cfg = _with_ip(configs.tiny_test_config()).unet
    unet = UNet(cfg)
    from ctrlora_tpu_torch.lora_fuse import cast_params_for_inference

    cast_params_for_inference(unet, torch.bfloat16)
    attn = unet.get_submodule(".".join(ip_adapter.ip_attn_sites(cfg)[0]))
    ptr = attn.to_k_ip.weight.data_ptr()
    ip_adapter.load_ip_adapter_into(unet, _seeded_ip_sd(np.random.default_rng(6), cfg), cfg,
                                    IP_SCALE)
    assert attn.to_k_ip.weight.dtype == torch.bfloat16 and attn.to_k_ip.weight.data_ptr() == ptr
    assert attn.ip_scale.dtype == torch.float32 and attn.ip_scale.dim() == 0
    assert attn.ip_scale.to(torch.bfloat16).item() == 0.69921875


@pytest.fixture(scope="module")
def jax_ddim(env):
    """JAX's three guided runs, jitted once: ddim_sample with and without
    uncond_ip_context, and ddim_decode_from (4-step ladder from rung 2)."""
    jpipe, i = env["jpipe"], env["i"]

    @jax.jit
    def run(params, ctx, unc, hz, x, ip, uip):
        conds = [JaxConditioning(hz, control_params=env["jfused"])]
        key = jax.random.PRNGKey(0)
        cfg = JaxDDIMConfig(steps=2, guidance_scale=4.0)
        a = jax_ddim_sample(jpipe, params, key, ctx, unc, conds, LAT, cfg, x_T=x,
                            ip_context=ip, uncond_ip_context=uip)
        b = jax_ddim_sample(jpipe, params, key, ctx, unc, conds, LAT, cfg, x_T=x, ip_context=ip)
        c = jax_ddim_decode_from(jpipe, params, x, 2, ctx, unc, conds,
                                 JaxDDIMConfig(steps=4, guidance_scale=4.0), key,
                                 ip_context=ip, uncond_ip_context=uip)
        return a, b, c

    out = run(env["params"], i["ctx"], i["unc"], i["hz"], i["x"], i["ip"], i["uip"])
    return dict(zip(("uncond_ip", "cond_ip_reused", "decode_from"), map(np.asarray, out)))


@pytest.mark.parametrize("case", ["uncond_ip", "cond_ip_reused", "decode_from"])
def test_guided_ddim_with_ip_context_matches_jax(env, jax_ddim, case):
    i, ppipe = env["i"], env["ppipe"]
    ctx, unc, x = _t(i["ctx"]), _t(i["unc"]), _t(i["x"])
    conds = [Conditioning(_t(i["hz"]))]
    uip = None if case == "cond_ip_reused" else _t(i["uip"])
    if case == "decode_from":
        z = ddim_decode_from(ppipe, x, 2, ctx, unc, conds, DDIMConfig(steps=4, guidance_scale=4.0),
                             ip_context=_t(i["ip"]), uncond_ip_context=uip)
    else:
        z = ddim_sample(ppipe, ctx, unc, conds, LAT, DDIMConfig(steps=2, guidance_scale=4.0),
                        x_T=x, ip_context=_t(i["ip"]), uncond_ip_context=uip)
    assert z.shape == LAT and torch.isfinite(z).all()
    _close(z, jax_ddim[case])
    if case == "cond_ip_reused":  # the uncond half's own tokens change the result
        a = jax_ddim["uncond_ip"]
        assert np.linalg.norm(a - z.numpy()) / np.linalg.norm(a) > 1e-3


# ---------------------------------------------------------------------------
# the text towers
# ---------------------------------------------------------------------------

TEXT = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, max_length=16,
            hidden_act="gelu")


def test_openclip_text_matches_jax():
    assert (dataclasses.asdict(openclip.openclip_vith_text_config())
            == dataclasses.asdict(jax_openclip.openclip_vith_text_config()))
    rng = np.random.default_rng(7)
    d, f, n = 32, 64, lambda *s, std=0.1: (std * rng.standard_normal(s)).astype(np.float32)
    sd = {"token_embedding.weight": n(64, d, std=0.02), "positional_embedding": n(16, d, std=0.02),
          "ln_final.weight": 1 + n(d), "ln_final.bias": n(d, std=0.02)}
    for i in range(2):
        t = f"transformer.resblocks.{i}."
        sd.update({t + "attn.in_proj_weight": n(3 * d, d, std=d ** -0.5),
                   t + "attn.in_proj_bias": n(3 * d, std=0.02),
                   t + "attn.out_proj.weight": n(d, d, std=d ** -0.5),
                   t + "attn.out_proj.bias": n(d, std=0.02),
                   t + "ln_1.weight": 1 + n(d), t + "ln_1.bias": n(d, std=0.02),
                   t + "ln_2.weight": 1 + n(d), t + "ln_2.bias": n(d, std=0.02),
                   t + "mlp.c_fc.weight": n(f, d, std=d ** -0.5), t + "mlp.c_fc.bias": n(f),
                   t + "mlp.c_proj.weight": n(d, f, std=f ** -0.5), t + "mlp.c_proj.bias": n(d)})
    ids = rng.integers(1, 64, (2, 16)).astype(np.int32)
    jcfg = JaxCLIPTextConfig(vocab_size=64, layer="penultimate", **TEXT)
    want = JaxCLIPTextModel(jcfg).apply(jax_openclip.convert_openclip_text(sd, jcfg),
                                        jnp.asarray(ids))
    pcfg = configs.CLIPTextConfig(vocab_size=64, layer="penultimate", **TEXT)
    model = CLIPTextModel(pcfg)
    model.load_state_dict(openclip.convert_openclip_text(sd, pcfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 16, 32)
    _close(got, want)


def _seeded_(module, rng):
    """N(0, 1/fan_in) weights, norm scales near 1, small biases and
    embeddings, and N(0, 0.05) in the layers a fresh model zero-initialises,
    drawn in the modules' parameter order."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            parts = name.split(".")
            is_norm = len(parts) > 1 and "norm" in parts[-2]
            if any(z in name for z in ZERO_INIT):
                std = 0.05
            elif p.ndim >= 2 and not is_norm and "embedding" not in name:
                std = p[0].numel() ** -0.5
            else:
                std = 0.02 if "embedding" in name else 0.1
            base = 1.0 if is_norm and name.endswith("weight") else 0.0
            p.copy_(torch.from_numpy(np.asarray(base + rng.normal(0, std, p.shape), np.float32)))


# ---------------------------------------------------------------------------
# StyleCtrLoRA end to end from files
# ---------------------------------------------------------------------------

def _style_cfg():
    cfg = _with_ip(configs.tiny_test_config(n_loras=1, switchable_banks=True))
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vocab_size=49408))


@pytest.fixture(scope="module")
def style_files(tmp_path_factory):
    """Tiny reference-format files from seeded port modules: SD (no
    image-prompt keys), Base ControlNet, one LoRA, the IP-Adapter file in the
    nested published form and in the flat form, the HF vision tower and the
    negative-content text tower (``text_model.*`` + ``text_projection``)."""
    tmp = tmp_path_factory.mktemp("style_ckpts")
    cfg = _style_cfg()
    rng = np.random.default_rng(8)
    src = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    for m in src.modules():
        _seeded_(m, rng)
    sd = {}
    for prefix, module, entries in (
            ("model.diffusion_model.", src.unet, bridge.unet_entries(cfg.unet)),
            ("first_stage_model.", src.vae, bridge.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", src.clip,
             bridge.clip_entries(cfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in bridge.export_tree(module.state_dict(), entries).items()})
    paths = {k: str(tmp / f"{k}.ckpt") for k in ("sd", "cn", "lora", "ip_nested", "ip_flat",
                                                   "vision", "text")}
    torch.save({"state_dict": sd}, paths["sd"])
    cstate = src.control.state_dict()
    torch.save({k: torch.from_numpy(v) for k, v in
                bridge.export_control_base(cstate, cfg.control).items()}, paths["cn"])
    torch.save({k: torch.from_numpy(v) for k, v in
                bridge.export_lora_slot(cstate, cfg.control, 0).items()}, paths["lora"])
    ip_sd = {k: torch.from_numpy(v) for k, v in _seeded_ip_sd(rng, cfg.unet).items()}
    proj_sd = {k: torch.from_numpy(v) for k, v in _proj_sd(rng, 64, IP, 16).items()}
    torch.save({"image_proj": proj_sd, "ip_adapter": ip_sd}, paths["ip_nested"])
    torch.save({**{f"ip_adapter.{k}": v for k, v in ip_sd.items()},
                **{f"image_proj.{k}": v for k, v in proj_sd.items()}}, paths["ip_flat"])
    vision_sd = _hf_vision_sd(rng, VISION)
    torch.save({k: torch.from_numpy(v) for k, v in vision_sd.items()}, paths["vision"])
    tcfg = configs.CLIPTextConfig(layer="projected", projection_dim=16, **TEXT)
    tower = CLIPTextModel(tcfg)
    _seeded_(tower, rng)
    text_sd = {f"text_model.{k}": torch.from_numpy(v) for k, v in
               bridge.export_tree(tower.state_dict(), bridge.clip_entries(tcfg)).items()}
    text_sd["text_projection.weight"] = tower.text_projection.weight.detach().clone()
    torch.save(text_sd, paths["text"])
    return dict(cfg=cfg, tcfg=tcfg, paths=paths, ip_sd=ip_sd, proj_sd=proj_sd,
                vision_sd=vision_sd, text_sd=text_sd)


def _style_model(files, form="nested"):
    st = StyleCtrLoRA(cfg=files["cfg"], vision_cfg=ip_adapter.CLIPVisionConfig(**VISION),
                      neg_text_cfg=files["tcfg"], bf16=False, device="cpu")
    p = files["paths"]
    st.create_model(p["sd"], p["cn"], [p["lora"]])
    st.load_ip_adapter(p[f"ip_{form}"], ip_scale=IP_SCALE, target="all",
                       image_encoder_ckpt=p["vision"])
    return st


@pytest.fixture(scope="module")
def style_model(style_files):
    return _style_model(style_files)


@pytest.mark.parametrize("form", ["nested", "flat"])
def test_style_model_loads_the_files(style_files, form):
    st = _style_model(style_files, form)
    cfg = style_files["cfg"]
    for j, site in enumerate(ip_adapter.ip_attn_sites(cfg.unet)):
        attn = st.pipe.unet.get_submodule(".".join(site))
        for name in ("to_k_ip", "to_v_ip"):
            assert torch.equal(getattr(attn, name).weight,
                               style_files["ip_sd"][f"{2 * j + 1}.{name}.weight"])
        assert attn.ip_scale.item() == pytest.approx(IP_SCALE)
    for k, v in style_files["proj_sd"].items():
        assert torch.equal(st.image_proj.state_dict()[k], v), k
    vstate = st.vision.state_dict()
    assert len(vstate) == len(style_files["vision_sd"])
    assert torch.equal(vstate["layer_1.fc1.weight"], torch.from_numpy(
        style_files["vision_sd"]["vision_model.encoder.layers.1.mlp.fc1.weight"]))


def test_fresh_style_unet_has_full_ip_scale(style_files):
    """A fresh port UNet with image tokens starts as JAX's: ip_scale 1 at
    every site and lecun-normal (not zero) image-prompt projections, so the
    SD file's missing image-prompt keys keep these values."""
    cfg = style_files["cfg"]
    st = StyleCtrLoRA(cfg=cfg, bf16=False, device="cpu")
    for site in ip_adapter.ip_attn_sites(cfg.unet):
        attn = st.pipe.unet.get_submodule(".".join(site))
        assert attn.ip_scale.item() == 1.0 and attn.ip_scale.dtype == torch.float32
        w = attn.to_k_ip.weight
        assert w.abs().max() <= 2 * w.shape[1] ** -0.5 / 0.87962566103423978 + 1e-6
        assert 0.5 < float(w.std() * w.shape[1] ** 0.5) < 1.5
    st.create_model(*(style_files["paths"][k] for k in ("sd", "cn")), [style_files["paths"]["lora"]])
    assert torch.equal(st.embed_style_tokens_zero(2), torch.zeros(2, IP, 64))


def test_embed_style_matches_jax(style_files, style_model):
    img = np.random.default_rng(9).integers(0, 256, (40, 30, 3), dtype=np.uint8)
    jv = jax_ip.CLIPVisionConfig(**VISION)
    px = jax_ip.clip_image_preprocess(img[None], size=28)
    embeds = jax_ip.CLIPVisionModel(jv).apply(
        _jax_tree(jax_ip.convert_clip_vision(style_files["vision_sd"], jv)), jnp.asarray(px))
    proj = jax_ip.ImageProjModel(cross_attention_dim=64, clip_extra_context_tokens=IP)
    ptree = _jax_tree(jax_ip.convert_image_proj(
        {k: v.numpy() for k, v in style_files["proj_sd"].items()}))
    got = style_model.embed_style(img)
    assert tuple(got.shape) == (1, IP, 64)
    _close(got, proj.apply(ptree, embeds))
    neg = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 16)).astype(np.float32))
    _close(style_model.embed_style(img, neg, 0.5), proj.apply(ptree, embeds - 0.5 * neg.numpy()))
    _close(style_model.embed_style_tokens_zero(2), proj.apply(ptree, jnp.zeros((2, 16))))


def test_neg_content_tower_matches_jax(style_files, style_model):
    """The projected text tower from HF ``text_model.*`` keys and
    ``text_projection.weight``, as JAX's ``embed_neg_content`` builds it
    (at the tiny width of the file)."""
    text_sd = {k: v.numpy() for k, v in style_files["text_sd"].items()}
    jcfg = JaxCLIPTextConfig(layer="projected", projection_dim=16, **TEXT)
    tree, _ = jax_bridge.convert_tree(text_sd, jax_bridge.clip_entries(jcfg),
                                      prefix="text_model.", strict=False)
    tree["params"]["text_projection"] = {"kernel": text_sd["text_projection.weight"].T}
    from ctrlora_tpu.utils.tokenizer import default_tokenizer as jax_tokenizer

    ids = jnp.asarray(jax_tokenizer()(["a photo of a house"], max_length=16))
    want = JaxCLIPTextModel(jcfg).apply(_jax_tree(tree), ids) * 0.5
    got = style_model.embed_neg_content("a photo of a house", style_files["paths"]["text"], 0.5)
    assert tuple(got.shape) == (1, 16)
    _close(got, want)


@pytest.mark.parametrize("mode", ["txt2img", "img2img"])
def test_sample_with_style_gives_images(style_model, mode):
    rng = np.random.default_rng(11)
    hint = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    content = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) if mode == "img2img" else None
    tokens = style_model.embed_style(rng.integers(0, 256, (30, 30, 3), dtype=np.uint8))
    imgs = style_model.sample_with_style((hint,), tokens, "a house", "blurry", num_samples=2,
                                         ddim_steps=3, scale=7.5, lora_weights=(1.0,), seed=3,
                                         img2img_image=content, img2img_strength=0.7)
    arrs = [np.asarray(im) for im in imgs]
    assert len(arrs) == 2 and all(a.shape == (16, 16, 3) and a.dtype == np.uint8 for a in arrs)
    again = style_model._sample_style_float((hint,), tokens, "a house", "blurry", 2, 3, 7.5,
                                            (1.0,), 3, content, 0.7)
    assert torch.isfinite(again).all()
    np.testing.assert_array_equal(
        torch.clamp(again * 127.5 + 127.5, 0, 255).to(torch.uint8).numpy(), np.stack(arrs))


@pytest.mark.parametrize("mode", ["txt2img", "img2img"])
def test_style_timings_are_filled(style_model, mode):
    rng = np.random.default_rng(12)
    hint = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    content = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) if mode == "img2img" else None
    tokens = style_model.embed_style(rng.integers(0, 256, (30, 30, 3), dtype=np.uint8))
    timings = {}
    style_model._sample_style_float((hint,), tokens, "a house", "", 1, 2, 7.5, (1.0,), 3,
                                    content, 0.7, timings=timings)
    assert set(timings) == {"prep_s", "ddim_s", "decode_s"}
    assert all(v > 0.0 for v in timings.values()), timings


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["missing", "wrong_count", "unexpected", "xs"])
def test_ip_context_refusals(env, case):
    """JAX would take the last text tokens for image tokens where a UNet with
    image tokens gets none (or too few), and ignores ip_context on the XS
    path; the port raises."""
    x, t, ctx = torch.zeros(LAT), torch.full((B,), 5), torch.zeros(B, 16, 64)
    ip = torch.zeros(B, IP, 64)
    if case in ("missing", "wrong_count"):
        pipe, kw = env["ppipe"], ({} if case == "missing" else {"ip_context": ip[:, :1]})
    elif case == "unexpected":
        pipe, kw = CtrLoraPipeline(configs.tiny_test_config(), "cpu"), {"ip_context": ip}
    else:
        cfg = configs.tiny_test_config(hint_mode="image")
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, variant="xs", control_model_ratio=0.5))
        pipe, kw = CtrLoraPipeline(cfg, "cpu"), {"ip_context": ip}
    with pytest.raises(ValueError, match="ip_context"):
        pipe.apply_model(x, t, ctx, None, **kw)


def test_style_config_is_jax_style_config():
    from ctrlora_tpu.style import style_config as jax_style_config

    got, want = style_config(1, 128, 4), jax_style_config(1, 128, 4)
    assert jax_tree(got) == dataclasses.asdict(want)
    assert got.unet.ip_tokens == 4 and got.control.unet.ip_tokens == 0
    with pytest.raises(ValueError, match="ip_tokens"):
        StyleCtrLoRA(cfg=configs.tiny_test_config(n_loras=1), device="cpu")
