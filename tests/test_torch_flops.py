"""The port's FLOP counter (``ctrlora_tpu_torch/utils/flops.py``) against
the JAX package's (``ctrlora_tpu/utils/flops.py``), on the CPU at the tiny
configuration:

  * one UNet + ControlNet evaluation, a 3-step CFG DDIM sample (k|v in the
    loop and hoisted, as the samplers make it) and a VAE decode count the
    same FLOPs in both
    packages (integers, held to rel 1e-12). JAX traces under
    ``kernel_flags.override(use_flash=False, geglu_ffn=False)``, as its
    bench counts, so that no product hides in a ``pallas_call``;
  * each hand kernel's plain version, on meta tensors at the main path's
    shape from tests/test_torch_work.py, counts the FLOPs its ``*_work``
    function reckons for the kernel's roofline;
  * a count on meta tensors equals the eager CPU count: the whole sampling
    workload (CLIP pair, VAE encode, DDIM, decode) and a training step's
    forward and backward with rematerialised blocks; and the sampling
    workload's count taken from its one- and two-step runs
    (``linear_in_steps``) equals its direct count;
  * a hand-kernel launch during a count raises, and a count that raises
    leaves no counting mode and no plain route for meta tensors behind.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ctrlora_tpu import lora_fuse as jax_fuse
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.ops import kernel_flags as jax_flags
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling import ddim as jax_ddim
from ctrlora_tpu.utils.flops import fn_flops as jax_fn_flops

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.ops import flash_attention as fa
from ctrlora_tpu_torch.ops import geglu_ffn as geglu
from ctrlora_tpu_torch.ops import group_norm as gn
from ctrlora_tpu_torch.ops import unpack_rows as unpack
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.training import train_state
from ctrlora_tpu_torch.training.step import loss_for_batch
from ctrlora_tpu_torch.utils.flops import fn_flops, linear_in_steps
from tests.torch_ranks import kv_in_loop

B, LAT = 2, (2, 8, 8, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    assert a > 0 and a == pytest.approx(b, rel=1e-12, abs=0)


def _jax_count(fn, *args):
    with jax_flags.override(use_flash=False, geglu_ffn=False):
        return jax_fn_flops(fn, *args)


@pytest.fixture(scope="module")
def env():
    """The tiny one-LoRA pipelines of both packages (weights do not move a
    count: JAX's are zeros of the init's shapes, the port's its own init)."""
    jpipe = JaxPipeline(jax_tiny(n_loras=1))
    shapes = jax.eval_shape(lambda k: jpipe.init(k, image_size=8), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu")
    pipe.cast_for_inference()
    rng = np.random.default_rng(6)
    arr = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(jpipe=jpipe, params=params, pipe=pipe,
                jfused=jax_fuse.fuse_control_tree(params.control, 0, jpipe.cfg.control.lora),
                x=arr(2 * B, 8, 8, 4), ctx=arr(2 * B, 16, 64), unc=arr(B, 16, 64),
                hz=arr(2 * B, 8, 8, 4), x_T=arr(*LAT))


def test_unet_controlnet_evaluation_counts_as_jax(env):
    e = env
    t = np.full((2 * B,), 500, np.int32)
    jconds = [JaxConditioning(jnp.asarray(e["hz"]), control_params=e["jfused"])]
    want = _jax_count(lambda: e["jpipe"].apply_model(e["params"], jnp.asarray(e["x"]),
                                                      jnp.asarray(t), jnp.asarray(e["ctx"]),
                                                      jconds))
    got = fn_flops(e["pipe"].apply_model, torch.from_numpy(e["x"]), torch.from_numpy(t).long(),
                   torch.from_numpy(e["ctx"]), [Conditioning(torch.from_numpy(e["hz"]))])
    _same(got, want)


@pytest.mark.parametrize("hoist", [False, True])
def test_ddim_sample_counts_as_jax(env, hoist):
    e = env
    ctx, unc, hz = (e[k][:B] for k in ("ctx", "unc", "hz"))
    want = _jax_count(lambda: jax_ddim.ddim_sample(
        e["jpipe"], e["params"], jax.random.PRNGKey(0), jnp.asarray(ctx), jnp.asarray(unc),
        [JaxConditioning(jnp.asarray(hz), control_params=e["jfused"])], LAT,
        jax_ddim.DDIMConfig(steps=3, hoist_xattn_kv=hoist), x_T=jnp.asarray(e["x_T"])))
    with contextlib.nullcontext() if hoist else kv_in_loop(e["pipe"]):
        got = fn_flops(lambda: ddim_sample(
            e["pipe"], torch.from_numpy(ctx), torch.from_numpy(unc),
            [Conditioning(torch.from_numpy(hz))], LAT, DDIMConfig(steps=3),
            x_T=torch.from_numpy(e["x_T"])))
    _same(got, want)


def test_vae_decode_counts_as_jax(env):
    e = env
    z = e["x_T"]
    want = _jax_count(lambda: e["jpipe"].decode_first_stage(e["params"], jnp.asarray(z)))
    got = fn_flops(e["pipe"].decode_first_stage, torch.from_numpy(z))
    _same(got, want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# kernel -> (the wrapper's call on meta tensors, its work's flops), at the
# main path's shapes of tests/test_torch_work.py
KERNEL_CALLS = {
    "flash_attention_qkv": (lambda: fa.flash_attention_qkv(_meta(8, 4096, 3 * 320), 8, 40),
                            fa.flash_forward_work(8, 8, 4096, 4096, 40)),
    "flash_attention": (lambda: fa.flash_attention(*(_meta(4, 1, 4096, 512),) * 3),
                        fa.flash_forward_work(4, 1, 4096, 4096, 512)),
    "flash_attention_bshd": (lambda: fa.flash_attention_bshd(*(_meta(4, 4096, 8, 40),) * 3),
                             fa.flash_forward_work(4, 8, 4096, 4096, 40)),
    "flash_attention_hpack2": (
        lambda: fa.flash_attention_hpack2(*(_meta(8, 4096, 8, 40),) * 3),
        fa.flash_forward_work(8, 8, 4096, 4096, 40)),
    "flash_attention_bwd_dq": (
        lambda: fa.flash_attention_bwd_dq(*(_meta(4, 8, 4096, 40),) * 3,
                                          _meta(4, 8, 4096, dtype=torch.float32),
                                          _meta(4, 8, 4096, 40),
                                          _meta(4, 8, 4096, dtype=torch.float32), 0.158),
        fa.flash_bwd_dq_work(4, 8, 4096, 4096, 40)),
    "flash_attention_bwd_dkv": (
        lambda: fa.flash_attention_bwd_dkv(*(_meta(4, 8, 4096, 40),) * 3,
                                           _meta(4, 8, 4096, dtype=torch.float32),
                                           _meta(4, 8, 4096, 40),
                                           _meta(4, 8, 4096, dtype=torch.float32), 0.158),
        fa.flash_bwd_dkv_work(4, 8, 4096, 4096, 40)),
    "geglu_ffn": (lambda: geglu.geglu_ffn(_meta(8 * 4096, 320), _meta(2560, 320), _meta(2560),
                                          _meta(320, 1280), _meta(320)),
                  geglu.geglu_ffn_work(8 * 4096, 320, 1280)),
    "group_norm": (lambda: gn.group_norm(_meta(8, 64, 64, 320),
                                         *(_meta(320, dtype=torch.float32),) * 2,
                                         silu=True, add_row=_meta(1, 320)),
                   gn.group_norm_work(8, 4096, 320, row_rows=1)),
    "group_norm_onepass": (lambda: gn.group_norm_onepass(
        _meta(8, 64, 64, 320), *(_meta(320, dtype=torch.float32),) * 2, silu=True,
        add_row=_meta(8, 320)), gn.group_norm_work(8, 4096, 320, row_rows=8)),
    "unpack_rows": (lambda: unpack.unpack_rows(_meta(32, 1280), [1280] * 32),
                    unpack.unpack_rows_work([1280] * 32)),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_kernel_plain_version_counts_its_work(name):
    """The whole-step count takes each kernel as its plain version: that
    version's products are the work the kernel's roofline (bound_ms) is
    reckoned from, so the two agree."""
    call, (flops, _) = KERNEL_CALLS[name]
    assert fn_flops(call) == flops


def _workload(pipe, dev, ids, hint, x_T, hoist=True, steps=3):
    ctx, unc = pipe.encode_text_cond_uncond(ids.to(dev), torch.zeros_like(ids).to(dev))
    hz = pipe.encode_first_stage(hint.to(dev))
    with contextlib.nullcontext() if hoist else kv_in_loop(pipe):
        z = ddim_sample(pipe, ctx, unc, [Conditioning(hz)], tuple(x_T.shape),
                        DDIMConfig(steps=steps), x_T=x_T.to(dev))
    return pipe.decode_first_stage(z)


@pytest.mark.parametrize("hoist", [False, True])
def test_meta_count_equals_the_eager_count_of_the_sampling_workload(env, hoist):
    """Phase 4's workload (CLIP pair, VAE encode of the hint, CFG DDIM,
    decode) at tiny size: the meta device reads nothing back, so the
    full-width count on the card takes no arithmetic."""
    ids = torch.from_numpy(np.random.default_rng(7).integers(1, 128, (B, 16)))
    hint, x_T = torch.rand(B, 16, 16, 3) * 2 - 1, torch.from_numpy(env["x_T"])
    eager = fn_flops(_workload, env["pipe"], "cpu", ids, hint, x_T, hoist)
    meta_pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "meta")
    meta_pipe.cast_for_inference()
    _same(fn_flops(_workload, meta_pipe, "meta", ids, hint, x_T, hoist), eager)
    # chip_smoke.py's phase 4 counts its 50 steps from runs of one and two
    count = lambda steps: fn_flops(_workload, meta_pipe, "meta", ids, hint, x_T, hoist, steps)
    _same(linear_in_steps(count, 3), eager)
    _same(linear_in_steps(count, 5), count(5))


def test_meta_count_equals_the_eager_count_of_a_training_step():
    """A LoRA finetune step's forward and backward (trainable LoRA, frozen
    UNet, rematerialised blocks, convolution backwards among them)."""
    cfg = configs.tiny_test_config(n_loras=1)
    unet = dataclasses.replace(cfg.unet, use_checkpoint=True)
    cfg = dataclasses.replace(cfg, unet=unet,
                              control=dataclasses.replace(cfg.control, unet=unet))
    rng = np.random.default_rng(8)
    batch = {"jpg": rng.uniform(-1, 1, (B, 16, 16, 3)), "hint": rng.uniform(0, 1, (B, 16, 16, 3)),
             "token_ids": rng.integers(1, 128, (B, 16))}
    draws = {"z_eps": rng.normal(size=LAT), "hint_eps": rng.normal(size=LAT),
             "t": rng.integers(0, 1000, (B,)), "noise": rng.normal(size=LAT)}

    def count(dev):
        pipe = CtrLoraPipeline(cfg, dev, fuse_lora=False)
        train_state.make_optimizer(pipe, configs.TrainConfig(trainable="lora"),
                                   train_state.trainable_mask(
                                       pipe, configs.TrainConfig(trainable="lora")))
        to = lambda v: torch.from_numpy(v).to(dev, torch.float32 if v.dtype == float else None)
        b, d = ({k: to(v) for k, v in x.items()} for x in (batch, draws))
        return fn_flops(lambda: loss_for_batch(pipe, b, draws=d)[0].backward())

    _same(count("meta"), count("cpu"))


def test_a_launch_during_the_count_raises_and_a_raising_count_leaves_no_mode():
    """Also the meta tensors' plain route: a wrapper given a meta tensor
    raises outside a count, after a count that raised too."""
    def launches():
        gn.group_norm.launches += 1  # what a launch on a CUDA tensor records

    before = gn.group_norm.launches
    with pytest.raises(ValueError, match="hand kernels launched"):
        fn_flops(launches)
    gn.group_norm.launches = before
    assert _get_current_dispatch_mode() is None

    def fails():
        torch.ones(2, 3) @ torch.ones(3, 4)
        raise RuntimeError("inside the count")

    x = _meta(2, 8, 8, 64, dtype=torch.float32)
    norm = lambda: gn.group_norm(x, *(_meta(64, dtype=torch.float32),) * 2, 32)
    with pytest.raises(RuntimeError, match="inside the count"):
        fn_flops(lambda: (norm(), fails()))
    assert _get_current_dispatch_mode() is None
    with pytest.raises(ValueError, match="CUDA"):
        norm()
    assert fn_flops(lambda: torch.ones(2, 3) @ torch.ones(3, 4)) == 2 * 2 * 3 * 4
