"""ControlNet-XS of the port against the JAX package on the CPU, in fp32 at
tiny size (``BASE`` as in tests/test_xs.py, control ratio 0.5), weights
through ``convert.params_from_jax``, inputs from a numpy seed, within rtol
2e-3 / atol 2e-4 (the frameworks sum convolutions in different orders).
The zero convs, the hint encoder's and the UNet's zero-initialised layers
get random weights first, so that every path carries signal:

* ``XSUNet`` against JAX ``XSUNet`` in each guiding / infusion2control
  mode and with ``learn_embedding``; its ``no_control`` forward against
  JAX's and against the plain port UNet on the base weights;
* a fresh port UNet (and XS UNet) outputs exactly 0, as JAX's does;
* ``xs_entries`` against JAX's; an XS control file round trip;
* a 2-step DDIM sample through the pipeline against JAX's;
* one train step's loss and trainable gradients against ``jax.grad`` under
  JAX's XS mask (the base stream gets none); JAX's own ``loss_for_batch``
  drops the hint for XS (its pipeline has no control module), so the
  reference loss is JAX ``p_losses`` with the hint's condition;
* ``train_cn --variant xs`` on a tiny run, and a resumed run bit-equal to
  a straight one, from ``--config`` given as a YAML file;
* an XS pipeline raising on ``control_batch_mask`` and the like.
"""

import dataclasses
import json
import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.configs import TrainConfig as JaxTrainConfig
from ctrlora_tpu.configs import UNetConfig as JaxUNetConfig
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models.unet import UNet as JaxUNet
from ctrlora_tpu.models.xs import XSUNet as JaxXSUNet
from ctrlora_tpu.models.xs import xs_entries as jax_xs_entries
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig
from ctrlora_tpu.sampling.ddim import ddim_sample as jax_ddim_sample
from ctrlora_tpu.training import train_state as jts
from ctrlora_tpu.training.losses import p_losses as jax_p_losses

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.models.unet import UNet
from ctrlora_tpu_torch.models.xs import XSUNet
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.scripts import train_cn
from ctrlora_tpu_torch.training import step as pstep
from ctrlora_tpu_torch.training import train_state as pts
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import loading
from tests.test_torch_plms_dpm import _random_params
from tests.torch_fresh import seeded_training_pipelines

RTOL, ATOL = 2e-3, 2e-4
RATIO = 0.5
BASE = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_heads=2, context_dim=48, dtype="float32",
            use_checkpoint=False, use_flash_attention=False)
B, LAT, HINT = 2, 8, 64  # tiny pipeline: latent 8x8 (VAE /2), pixel hint 64x64 (/8)
MODES = [("encoder_double", "cat", False), ("encoder", "add", False), ("full", "cat", False),
         ("encoder_double", "cat", True), ("full", "add", False), ("encoder_double", None, False)]
FORWARD_MODES = MODES[:5]  # the last differs from the first by no infusion alone


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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed, lat=LAT, ctx_len=7, ctx_dim=48):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, lat, lat, 4)).astype(np.float32),
            "hint": rng.uniform(0, 1, (B, 8 * lat, 8 * lat, 3)).astype(np.float32),
            "ctx": rng.standard_normal((B, ctx_len, ctx_dim)).astype(np.float32),
            "t": np.array([321, 17], np.int32)}


def _module_params(init, seed):
    """Numpy-drawn parameters of one flax module (``_random_params`` over an
    object whose ``init`` is the module's)."""
    return _random_params(types.SimpleNamespace(init=lambda k, image_size=8: init(k)), seed)


def _xs_pair(mode, seed):
    guiding, infusion, learn = mode
    kw = dict(control_model_ratio=RATIO, infusion2control=infusion, guiding=guiding,
              learn_embedding=learn)
    jmodel = JaxXSUNet(JaxUNetConfig(**BASE), hint_channels=3, **kw)
    i = _inputs(seed)
    params = _module_params(lambda k: jmodel.init(
        k, jnp.asarray(i["x"]), jnp.asarray(i["t"]), jnp.asarray(i["ctx"]),
        hint=jnp.asarray(i["hint"])), seed)
    model = XSUNet(configs.UNetConfig(**BASE), hint_channels=3, **kw).eval()
    model.load_state_dict(convert.params_from_jax(params), strict=True)
    return jmodel, params, model, i


@pytest.mark.parametrize("mode", FORWARD_MODES,
                         ids=["-".join(map(str, m)) for m in FORWARD_MODES])
def test_xs_unet_matches_jax(mode):
    jmodel, params, model, i = _xs_pair(mode, 10 + MODES.index(mode))
    want = jmodel.apply(params, jnp.asarray(i["x"]), jnp.asarray(i["t"]), jnp.asarray(i["ctx"]),
                        hint=jnp.asarray(i["hint"]))
    with torch.no_grad():
        got = model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), hint=_t(i["hint"]))
        plain = model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), no_control=True)
    assert tuple(got.shape) == (B, LAT, LAT, 4)
    _close(got.numpy(), want)
    assert (got - plain).abs().max() > 1e-3  # the control stream changes the output


def test_xs_head_pair_route_matches_default_flags(monkeypatch):
    """The XS UNet (``BASE`` with its flash sites on, control ratio 0.5) at a
    32x32 latent, so its attention runs at S = 256 where the kernel rule
    admits it, under hpack=2 and qkvpack=0 against the default flags. With
    fp32 admitted the wrappers run their plain versions on these CPU
    tensors: the flagged run takes B6's entry at the control stream's and
    the base stream's head dims, the default run the fused-qkv entry, and
    the two agree within rtol 2e-3 / atol 2e-4. A slip in the views the
    B6 route passes (head split, strides) would show here."""
    from ctrlora_tpu_torch.ops import flash_attention as fa_ops
    from ctrlora_tpu_torch.ops import kernel_flags

    cfg = configs.UNetConfig(**{**BASE, "use_flash_attention": True})
    torch.manual_seed(3)
    model = XSUNet(cfg, hint_channels=3, control_model_ratio=RATIO).eval()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.any():  # the zero convs and zero-initialised layers carry signal
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    i = _inputs(12, lat=32)
    dims = {"flash_attention_hpack2": [], "flash_attention_qkv": [], "flash_attention_bshd": []}
    for name in dims:
        real = getattr(fa_ops, name)
        monkeypatch.setattr(fa_ops, name, lambda *a, _n=name, _r=real, **k: dims[_n].append(
            a[0].shape[-1] if a[0].ndim == 4 else a[2]) or _r(*a, **k))
    monkeypatch.setattr(fa_ops, "KERNEL_DTYPES", (torch.float32,))
    run = lambda: model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), hint=_t(i["hint"]))
    with torch.no_grad():
        base = run()
        assert dims["flash_attention_qkv"] and not dims["flash_attention_hpack2"]
        dims["flash_attention_qkv"].clear()
        with kernel_flags.override(head_pack=2, attn_qkv_packed=False):
            flagged = run()
    assert not dims["flash_attention_qkv"] and not dims["flash_attention_bshd"]
    # the control stream's heads are half the base stream's width
    assert set(dims["flash_attention_hpack2"]) == {16, 32}
    _close(flagged.numpy(), base.numpy())
    assert (flagged - base).abs().max() > 0  # two routes, two sums


def test_xs_no_control_is_the_plain_unet():
    jmodel, params, model, i = _xs_pair(MODES[0], 20)
    args = (jnp.asarray(i["x"]), jnp.asarray(i["t"]), jnp.asarray(i["ctx"]))
    want = jmodel.apply(params, *args, no_control=True)
    with torch.no_grad():
        got = model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]), no_control=True)
        no_hint = model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]))
        unet = UNet(configs.UNetConfig(**BASE)).eval()
        base = {k: v for k, v in model.state_dict().items() if k in unet.state_dict()}
        unet.load_state_dict(base, strict=True)
        plain = unet(_t(i["x"]), _t(i["t"]), _t(i["ctx"]))
    _close(got.numpy(), want)
    assert torch.equal(got, no_hint) and torch.equal(got, plain)


def test_fresh_unet_outputs_zero_as_jax():
    """JAX zero-initialises conv_out, every ResBlock's out_conv and every
    transformer's proj_out: a fresh UNet outputs exactly 0; so does the
    port's, and a fresh XS UNet."""
    i = _inputs(21)
    args = (jnp.asarray(i["x"]), jnp.asarray(i["t"]), jnp.asarray(i["ctx"]))
    jax_out = jax.jit(JaxUNet(JaxUNetConfig(**BASE)).init_with_output)(
        jax.random.PRNGKey(0), *args)[0]
    torch.manual_seed(0)
    with torch.no_grad():
        out = UNet(configs.UNetConfig(**BASE))(_t(i["x"]), _t(i["t"]), _t(i["ctx"]))
        xs_out = XSUNet(configs.UNetConfig(**BASE), control_model_ratio=RATIO)(
            _t(i["x"]), _t(i["t"]), _t(i["ctx"]), hint=_t(i["hint"]))
    assert not np.asarray(jax_out).any()
    assert not out.any() and not xs_out.any()


@pytest.mark.parametrize("mode", MODES, ids=["-".join(map(str, m)) for m in MODES])
def test_xs_entries_match_jax(mode):
    guiding, infusion, learn = mode
    kw = dict(ratio=RATIO, infusion2control=infusion, guiding=guiding, learn_embedding=learn)
    got = bridge.xs_entries(configs.UNetConfig(**BASE), **kw)
    want = jax_xs_entries(JaxUNetConfig(**BASE), **kw)
    if infusion is None:  # JAX lists enc_zero_in convs that its module does not have
        want = [e for e in want if not e[0].startswith("enc_zero_convs_in.")]
    assert sorted(got) == sorted((t, tuple(f), k) for t, f, k in want)
    # every parameter of the XS UNet has exactly one entry
    model = XSUNet(configs.UNetConfig(**BASE), control_model_ratio=RATIO,
                   infusion2control=infusion, guiding=guiding, learn_embedding=learn)
    assert sorted(convert.port_key(f) for _, f, _ in got) == sorted(model.state_dict())


# ---------------------------------------------------------------------------
# the pipeline: DDIM, the train step, the control file, the CLI
# ---------------------------------------------------------------------------

def _xs_config(cfg):
    return dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, variant="xs", control_model_ratio=RATIO))


@pytest.fixture(scope="module")
def env():
    jpipe = JaxPipeline(_xs_config(jax_tiny(hint_mode="image")))
    params = _random_params(jpipe, 30)
    assert params.control is None
    pipe = CtrLoraPipeline(_xs_config(configs.tiny_test_config(hint_mode="image")), "cpu")
    pipe.load_state_dicts(*(convert.params_from_jax(p) if p is not None else {}
                            for p in params))
    return {"jpipe": jpipe, "params": params, "pipe": pipe, "inputs": _inputs(31, ctx_len=16,
                                                                              ctx_dim=64)}


def test_xs_apply_model_and_ddim_match_jax(env):
    i, params, jpipe, pipe = env["inputs"], env["params"], env["jpipe"], env["pipe"]
    want = jpipe.apply_model(params, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
                             jnp.asarray(i["ctx"]), [JaxConditioning(jnp.asarray(i["hint"]))])
    with torch.no_grad():
        got = pipe.apply_model(_t(i["x"]), _t(i["t"]), _t(i["ctx"]),
                               [Conditioning(_t(i["hint"]))])
    _close(got.numpy(), want)
    assert pipe.emb_proj_tables(torch.tensor([1, 2]), [Conditioning(_t(i["hint"]))]) is None
    unc = np.zeros_like(i["ctx"])
    x_T = np.random.default_rng(3).standard_normal((B, LAT, LAT, 4)).astype(np.float32)
    run = jax.jit(lambda p, c, u, h, x: jax_ddim_sample(
        jpipe, p, jax.random.PRNGKey(0), c, u, [JaxConditioning(h)], (B, LAT, LAT, 4),
        JaxDDIMConfig(steps=2, guidance_scale=7.5), x_T=x))
    want = run(params, *(jnp.asarray(a) for a in (i["ctx"], unc, i["hint"], x_T)))
    got = ddim_sample(pipe, _t(i["ctx"]), _t(unc), [Conditioning(_t(i["hint"]))],
                      (B, LAT, LAT, 4), DDIMConfig(steps=2, guidance_scale=7.5), x_T=_t(x_T))
    _close(got.numpy(), want)


def test_xs_pipeline_refuses_what_jax_ignores(env):
    i, pipe = env["inputs"], env["pipe"]
    args = (_t(i["x"]), _t(i["t"]), _t(i["ctx"]))
    cond = Conditioning(_t(i["hint"]))
    with pytest.raises(ValueError, match="control_batch_mask"):
        pipe.apply_model(*args, [cond], control_batch_mask=torch.ones(B))
    with pytest.raises(ValueError, match="control_scales"):
        pipe.apply_model(*args, [cond], control_scales=[0.5] * 5)
    with pytest.raises(ValueError, match="one condition"):
        pipe.apply_model(*args, [cond, cond])
    with pytest.raises(ValueError, match="one condition"):
        pipe.apply_model(*args, [dataclasses.replace(cond, weight=0.5)])
    with pytest.raises(ValueError, match="no separate control module"):
        pipe.new_control()
    with torch.no_grad():  # ones are what JAX computes
        ones = pipe.apply_model(*args, [cond], control_scales=[1.0] * 5)
        assert torch.equal(ones, pipe.apply_model(*args, [cond]))


def test_xs_train_step_matches_jax(env):
    """The loss of one batch and every trainable gradient against jax.grad
    of the JAX model's loss with the hint's condition, with JAX's draws;
    the trainable set is JAX's XS mask, and the base stream gets no
    gradient."""
    params, jpipe = env["params"], env["jpipe"]
    rng = np.random.default_rng(4)
    batch = {"jpg": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, (B, HINT, HINT, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, (B, 16)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, z_rng, t_rng = jax.random.split(jax.random.PRNGKey(6), 3)

    def jloss(p):
        z = jax.lax.stop_gradient(jpipe.encode_first_stage(p, jb["jpg"], rng=z_rng))
        ctx = jax.lax.stop_gradient(jpipe.encode_text_tokens(p, jb["token_ids"]))
        return jax_p_losses(jpipe, p, t_rng, z, ctx, [JaxConditioning(jb["hint"])])

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    t_key, n_key = jax.random.split(t_rng)
    shape = (B, LAT, LAT, 4)
    draws = {"z_eps": jax.random.normal(z_rng, shape),
             "t": jax.random.randint(t_key, (B,), 0, 1000),
             "noise": jax.random.normal(n_key, shape)}

    pipe = CtrLoraPipeline(_xs_config(configs.tiny_test_config(hint_mode="image")), "cpu",
                           fuse_lora=False)
    pipe.load_state_dicts(*(convert.params_from_jax(p) if p is not None else {}
                            for p in params))
    tcfg = configs.TrainConfig(trainable="all")
    mask = pts.trainable_mask(pipe, tcfg)
    pts.make_optimizer(pipe, tcfg, mask)
    jmask = convert.params_from_jax(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32),
        jts.trainable_mask(params, JaxTrainConfig(trainable="all"), xs=True).unet, params.unet))
    assert mask["unet"] == {k: bool(v.all()) for k, v in jmask.items()}
    assert "control" not in mask and any(mask["unet"].values())
    assert not any(v for k, v in mask["unet"].items() if k.startswith(("in_", "out_", "mid_res")))
    loss, _ = pstep.loss_for_batch(pipe, {k: _t(v) for k, v in batch.items()},
                                   draws={k: _t(v) for k, v in draws.items()})
    _close(loss.item(), float(jl))
    loss.backward()
    ref = convert.params_from_jax(jgrads.unet)
    for name, p in pipe.unet.named_parameters():
        if mask["unet"][name]:
            _close(p.grad.numpy(), ref[name].numpy())
        else:
            assert p.grad is None, name
    assert max(float(p.grad.abs().max()) for n, p in pipe.unet.named_parameters()
               if n.startswith("ctrl_in_1_res")) > 0


def test_xs_control_file_round_trip(env, tmp_path):
    """An XS control file (TwoStreamControlNet's keys at its root) fills
    every control-stream weight of the XS UNet and leaves the base stream."""
    cfg, pipe = env["pipe"].cfg, env["pipe"]
    table = bridge.xs_control_entries(cfg)
    written = bridge.export_tree(pipe.unet.state_dict(), table)
    assert "input_hint_block.14.weight" in written and "enc_zero_convs_out.0.0.weight" in written
    assert not any(k.startswith("base.") for k in written)
    path = str(tmp_path / "xs.ckpt")
    torch.save({k: torch.from_numpy(v) for k, v in written.items()}, path)
    torch.manual_seed(5)
    fresh = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    states = loading.load_ctrlora(fresh, None, path, basecn_skip="lora")
    assert states.control == {}
    for k, v in states.unet.items():
        src = pipe.unet.state_dict()[k] if k.split(".")[0].startswith(
            pts.XS_TRAINABLE_PREFIXES) else fresh.unet.state_dict()[k]
        assert torch.equal(v, src), k


RES = 64  # the CLI's image size (the hint encoder needs a multiple of 8)


def _cli_config():
    """The tiny XS model whose VAE has four levels (latent /8), as a YAML
    file's `preset:` + overrides would give it."""
    cfg = _xs_config(configs.tiny_test_config(hint_mode="image"))
    return dataclasses.replace(cfg, vae=dataclasses.replace(cfg.vae, ch_mult=(1, 1, 2, 2)))


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("xs_cli")
    (root / "source").mkdir()
    (root / "target").mkdir()
    rng = np.random.default_rng(0)
    with open(root / "prompt.json", "w") as f:
        for i in range(4):
            for sub in ("source", "target"):
                cv2.imwrite(str(root / sub / f"{i}.png"),
                            rng.integers(0, 256, (72, 72 + 8 * (i % 2), 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"a picture {i}"}) + "\n")
    yaml_path = root / "cnxs_tiny.yaml"
    yaml_path.write_text(
        "preset: tiny\nmodel:\n  control:\n    hint_mode: image\n    variant: xs\n"
        f"    control_model_ratio: {RATIO}\n  vae:\n    ch_mult:\n    - 1\n    - 1\n    - 2\n"
        "    - 2\n")
    assert configs.load_model_config(str(yaml_path)) == _cli_config()
    with pytest.MonkeyPatch.context() as mp, seeded_training_pipelines():
        mp.setattr(train_cn, "RESOLUTION", RES)
        flags = lambda name, steps, *extra: [
            "--variant", "xs", "--config", str(yaml_path), "--device", "cpu", "--dataroot",
            str(root), "--bs", "2", "--max_steps", str(steps), "--log_every", "1",
            "--ckpt_logger_freq", "2", "--img_logger_freq", "4", "--use_ema",
            "--num_workers", "2", "-n", str(root / name), *extra]
        straight = train_cn.main(flags("straight", 4))
        first = train_cn.main(flags("first", 2))
        resumed = train_cn.main(flags("resumed", 4, "--resume",
                                      os.path.join(first.workdir, "ckpt_00000002.pt")))
    return {"straight": straight, "resumed": resumed}


def test_train_cn_xs_cli(cli_env):
    run = cli_env["straight"]
    with open(os.path.join(run.workdir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    train = [ln for ln in lines if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1, 2, 3, 4]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0 for ln in train)
    trainer = run.trainer
    assert trainer.pipe.is_xs and set(trainer.mask) == {"unet", "vae", "clip"}
    png = cv2.imread(os.path.join(run.workdir, "image_log", "step_00000004.png"))
    assert png.shape == (48 + 3 * RES, 2 * RES, 3)
    # the base stream is frozen: the loaded one, bit for bit
    from ctrlora_tpu_torch.scripts import train_common as common

    with seeded_training_pipelines():
        seeded = common.load_training_pipeline(_cli_config(), "cpu", None, None, 42)
    changed = [n for n, p in trainer.pipe.unet.named_parameters()
               if not torch.equal(p, seeded.unet.state_dict()[n])]
    assert changed and all(n.split(".")[0].startswith(pts.XS_TRAINABLE_PREFIXES)
                           for n in changed)


def test_train_cn_xs_resume_is_bit_equal_to_straight(cli_env):
    a, b = cli_env["straight"].trainer.state, cli_env["resumed"].trainer.state
    assert b.step == 4 and b.ema.updates == 4
    for k, p in a.trainable.items():
        assert torch.equal(p, b.trainable[k]), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
