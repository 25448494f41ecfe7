"""The static dispatch rules of the port's kernel entries on the CPU.

``flash_kernel_ok`` (the flash entries) and ``geglu_kernel_ok``
(``FeedForward``) are pure functions of dtypes and shapes: the kernels take
bf16 only, the flash forward only the head dims it has instantiations for
(and, where a gradient will flow, those of the backward too). Anything else
takes the plain version, as the JAX package sends fp32 through XLA: an fp32
VAE and an fp32 feed-forward at an SD1.5 width still match the JAX package
(fp32 on the CPU, rtol 2e-3 / atol 2e-4 as tests/test_torch_models.py) and
never reach a kernel wrapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.configs import VAEConfig as JaxVAEConfig
from ctrlora_tpu.models import attention as jax_attention
from ctrlora_tpu.models.vae import AutoencoderKL as JaxVAE

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.models import attention, vae
from ctrlora_tpu_torch.ops import flash_attention as fa
from ctrlora_tpu_torch.ops import geglu_ffn as geglu

RTOL, ATOL = 2e-3, 2e-4
BF16, FP32, FP16 = torch.bfloat16, torch.float32, torch.float16

# (S, D) of the SD1.5 attention sites: UNet/ControlNet self-attention at
# 64^2, 32^2, 16^2 latents, the VAE's mid-block at 512^2
SD15_SITES = [(4096, 40), (1024, 80), (256, 160), (4096, 512)]


@pytest.mark.parametrize("s, d", SD15_SITES)
def test_flash_rule_admits_bf16_at_the_sd15_sites(s, d):
    assert fa.flash_kernel_ok((BF16,) * 3, s, s, d)
    assert fa.flash_kernel_ok((BF16,), s, s, d)


@pytest.mark.parametrize("s, d", SD15_SITES)
@pytest.mark.parametrize("dtype", [FP32, FP16])
def test_flash_rule_sends_other_dtypes_to_plain(s, d, dtype):
    assert not fa.flash_kernel_ok((dtype,) * 3, s, s, d)
    assert not fa.flash_kernel_ok((BF16, dtype, BF16), s, s, d)  # one operand is enough


@pytest.mark.parametrize("d", [4, 12, 24, 48, 96, 256])
def test_flash_rule_sends_other_head_dims_to_plain(d):
    assert d not in fa.FORWARD_HEAD_DIMS
    assert not fa.flash_kernel_ok((BF16,) * 3, 4096, 4096, d)


@pytest.mark.parametrize("s, d", [(4096, 8), (1024, 16), (256, 32)])
def test_flash_rule_admits_the_xs_head_dims(s, d):
    """ControlNet-XS's control stream (8 heads of 8/16/32 at 64^2, 32^2 and
    16^2) takes the kernels forward and backward, as JAX's rule (no
    head-dim condition) takes its Pallas kernels; its 8^2 site stays plain."""
    assert fa.flash_kernel_ok((BF16,) * 3, s, s, d, grad=True)
    assert not fa.flash_kernel_ok((BF16,) * 3, 64, 64, d)


@pytest.mark.parametrize("sq, sk, admitted", [
    (4096, 77, False),   # cross-attention over the text tokens
    (64, 64, False),     # the 8x8 mid-block self-attention
    (128, 128, False),   # Sk < 256
    (256, 256, True),
    (4096, 320, False),  # Sk does not tile by 128
    (384, 4096, True),
])
def test_flash_rule_keeps_the_jax_shape_rule(sq, sk, admitted):
    assert fa.flash_kernel_ok((BF16,) * 3, sq, sk, 40) is admitted


@pytest.mark.parametrize("d", fa.FORWARD_HEAD_DIMS)
def test_flash_rule_with_a_gradient_needs_a_backward_kernel(d):
    """A kernel forward's gradient goes through the backward kernels, so
    where one will flow the rule admits only their head dims."""
    assert fa.flash_kernel_ok((BF16,) * 3, 1024, 1024, d)
    assert fa.flash_kernel_ok((BF16,) * 3, 1024, 1024, d, grad=True) is (d in fa.BWD_HEAD_DIMS)


def _operands(c, dtype, f2=None):
    f2 = 8 * c if f2 is None else f2
    return (torch.zeros(2, 4, c, dtype=dtype), torch.zeros(f2, c, dtype=dtype),
            torch.zeros(f2, dtype=dtype), torch.zeros(c, f2 // 2, dtype=dtype),
            torch.zeros(c, dtype=dtype))


@pytest.mark.parametrize("c", geglu.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype, admitted", [(BF16, True), (FP32, False), (FP16, False)])
def test_geglu_rule_admits_bf16_at_the_sd15_widths(c, dtype, admitted):
    ops = _operands(c, dtype)
    assert geglu.geglu_shapes_ok(*ops)  # the shapes alone would admit
    assert geglu.geglu_kernel_ok(*ops) is admitted


def test_geglu_rule_needs_every_operand_in_bf16():
    ops = list(_operands(320, BF16))
    ops[2] = ops[2].float()  # an fp32 bias
    assert not geglu.geglu_kernel_ok(*ops)
    assert not geglu.geglu_kernel_ok(*_operands(768, BF16))  # not an SD1.5 width


def _no_kernel(*_a, **_k):
    raise AssertionError("a kernel wrapper was called for fp32 operands")


def test_fp32_vae_decode_takes_plain_attention_and_matches_jax(monkeypatch):
    """A two-level fp32 VAE whose mid-block attention is a shape the kernel
    takes (S = 16*16 = 256, D = 64) decodes through the plain attention and
    matches the JAX package."""
    for name in ("flash_attention", "flash_attention_bshd", "flash_attention_qkv"):
        monkeypatch.setattr(fa, name, _no_kernel)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype="float32")
    assert fa.flash_kernel_ok((BF16,) * 3, 256, 256, 64)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    jvae = JaxVAE(JaxVAEConfig(**kw))
    params = jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    ref = jvae.apply(params, jnp.asarray(z), method=JaxVAE.decode)
    mod = vae.AutoencoderKL(configs.VAEConfig(**kw))
    mod.load_state_dict(convert.params_from_jax(params), strict=True)
    out = mod.eval().decode(torch.from_numpy(z))
    assert out.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c", [320, 64])
def test_fp32_feed_forward_takes_plain_and_matches_jax(c, monkeypatch):
    """FeedForward at an SD1.5 width (the kernel's shapes) and at the tiny
    configuration's, in fp32: the plain GEGLU, equal to the JAX module."""
    monkeypatch.setattr(geglu, "geglu_ffn", _no_kernel)
    rng = np.random.default_rng(c)
    x = rng.normal(size=(2, 8, c)).astype(np.float32)
    jff = jax_attention.FeedForward(dim=c)
    params = jff.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    ref = jff.apply(params, jnp.asarray(x))
    mod = attention.FeedForward(c)
    mod.load_state_dict(convert.params_from_jax(params), strict=True)
    out = mod.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
