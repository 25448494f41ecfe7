"""The port's kernel flags and the two kernels they switch on, against the
JAX package on the CPU (fp32, inputs from a numpy seed):

* ``CTRLORA_KERNELS`` parsing of the four tokens the port honours equals
  the JAX package's; every other token warns; ``override`` nests.
* Kernel A2's plain version against the JAX ``_onepass_kernel`` (interpret
  mode, the size gate patched out as tests/test_group_norm.py does), and
  the dispatch: ``group_norm`` picks ``group_norm_onepass`` exactly where
  the JAX ``_onepass_ok`` does.
* Kernel B6's plain version against the JAX ``_fwd_kernel_hpack2`` (it runs
  in interpret mode here; a spy shows that the JAX side took it), and the
  dispatch of ``CrossAttention`` under qkvpack / fuse_qkv / hpack.

Tolerance rtol 1e-4 / atol 1e-5: the same fp32 math summed in another order.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.ops import flash_attention as jfa
from ctrlora_tpu.ops import group_norm as jgn
from ctrlora_tpu.ops import kernel_flags as jflags

from ctrlora_tpu_torch.models.attention import CrossAttention
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import group_norm as gn_ops
from ctrlora_tpu_torch.ops import kernel_flags

RTOL, ATOL = 1e-4, 1e-5
FIELDS = ("gn_onepass", "head_pack", "attn_qkv_packed", "fuse_qkv")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "gn1=1", "gn1=0", "hpack=2", "hpack=4", "qkvpack=0", "qkvpack=1", "fuse_qkv=0",
    "gn1=1,hpack=2,qkvpack=0", " gn1=1 , fuse_qkv=1 "])
def test_flags_parse_as_jax(spec, monkeypatch):
    monkeypatch.setenv("CTRLORA_KERNELS", spec)
    ours, theirs = kernel_flags.flags(), jflags.flags()
    assert {f: getattr(ours, f) for f in FIELDS} == {f: getattr(theirs, f) for f in FIELDS}


@pytest.mark.parametrize("tok", ["noflash", "bq=256", "gn1=2", "hpack=x", "hpack=0", "bogus"])
def test_other_tokens_warn(tok, monkeypatch):
    monkeypatch.setenv("CTRLORA_KERNELS", f"gn1=1,{tok}")
    with pytest.warns(UserWarning, match="CTRLORA_KERNELS"):
        fl = kernel_flags._parse(f"gn1=1,{tok}")
    assert fl.gn_onepass is True and fl.head_pack is None


def test_override_nests_and_restores():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        base = kernel_flags.flags()
    with kernel_flags.override(gn_onepass=True):
        with kernel_flags.override(head_pack=2, attn_qkv_packed=False):
            fl = kernel_flags.flags()
            assert (fl.gn_onepass, fl.head_pack, fl.attn_qkv_packed) == (True, 2, False)
        fl = kernel_flags.flags()
        assert (fl.gn_onepass, fl.head_pack, fl.attn_qkv_packed) == (True, None, None)
    assert kernel_flags.flags() == base
    with pytest.raises(TypeError, match="unknown kernel flag"):
        kernel_flags.set_flags(safemax=True)
    kernel_flags.set_flags(head_pack=2)
    assert kernel_flags.flags().head_pack == 2
    kernel_flags.clear_flags()
    assert kernel_flags.flags() == base


# ---------------------------------------------------------------------------
# kernel A2: the one-pass GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,row,silu", [
    ((2, 8, 8, 64), None, False), ((2, 8, 8, 64), (1, 64), True),
    ((2, 8, 8, 64), (2, 64), True), ((1, 64, 64), (64,), False)])
def test_onepass_plain_matches_jax_kernel(shape, row, silu, monkeypatch):
    monkeypatch.setattr(jgn, "_ONEPASS_MIN_ELEMS", 0)
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    scale = rng.normal(1, 0.1, (c,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (c,)).astype(np.float32)
    add = None if row is None else rng.normal(0, 1, row).astype(np.float32)
    hw = int(np.prod(shape[1:-1]))
    with jflags.override(gn_onepass=True):
        assert jgn._onepass_ok(hw, c, jnp.float32, 32)
        want = jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                    1e-5, silu, interpret=True,
                                    add_row=None if add is None else jnp.asarray(add))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = gn_ops.group_norm_onepass(t(x), t(scale), t(bias), 32, 1e-5, silu, t(add))
    _close(got.numpy(), want)


@pytest.mark.parametrize("hw,c,dtype", [
    (64 * 64, 320, "bfloat16"), (32 * 32, 640, "bfloat16"), (32 * 32, 960, "bfloat16"),
    (32 * 32, 1280, "bfloat16"), (16 * 16, 2560, "bfloat16"), (16 * 16, 1920, "bfloat16"),
    (32 * 32, 1920, "bfloat16"), (64 * 64, 512, "bfloat16"), (64 * 64, 640, "bfloat16"),
    (512 * 512, 128, "bfloat16"), (16 * 16, 1280, "bfloat16"), (8 * 8, 1280, "bfloat16"),
    (64 * 64, 320, "float32"), (32 * 32, 640, "float32")])
def test_onepass_admission_as_jax(hw, c, dtype):
    """The admitted shapes: the five of the sampling path (64x64x320, 32x32
    at 640/960/1280, and the UNet decoder's 16x16x2560 in_norms), and none
    of the 64x64x640, 32x32x1920, VAE, other 16x16 or 8x8 sites; fp32
    doubles the bytes."""
    for on in (None, True, False):
        with kernel_flags.override(gn_onepass=on), jflags.override(gn_onepass=on):
            assert (gn_ops._onepass_ok(hw, c, getattr(torch, dtype), 32)
                    == jgn._onepass_ok(hw, c, getattr(jnp, dtype), 32))


def test_group_norm_dispatches_to_onepass(monkeypatch):
    """Under gn1=1 ``group_norm`` hands admitted shapes to kernel A2 (here:
    its plain version, on a CPU tensor), forward and backward; the rest,
    and everything without the flag, to kernel A."""
    calls = []
    real = gn_ops.group_norm_onepass
    monkeypatch.setattr(gn_ops, "group_norm_onepass",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(gn_ops, "_ONEPASS_MIN_ELEMS", 2048)
    rng = np.random.default_rng(4)
    small = torch.from_numpy(rng.normal(size=(2, 4, 4, 64)).astype(np.float32))
    big = torch.from_numpy(rng.normal(size=(2, 8, 8, 64)).astype(np.float32)).requires_grad_()
    scale, bias = torch.ones(64), torch.zeros(64)
    gn_ops.group_norm(big, scale, bias, 32)
    assert calls == []
    with kernel_flags.override(gn_onepass=True):
        y = gn_ops.group_norm(big, scale, bias, 32, 1e-5, True, torch.ones(1, 64))
        gn_ops.group_norm(small, scale, bias, 32)
    assert calls == [big.shape]
    y.sum().backward()
    want = gn_ops.group_norm_plain(big.detach(), scale, bias, 32, 1e-5, True, torch.ones(1, 64))
    _close(y.detach().numpy(), want.numpy())
    assert big.grad is not None and torch.isfinite(big.grad).all()


# ---------------------------------------------------------------------------
# kernel B6: the head-pair flash forward
# ---------------------------------------------------------------------------

def test_hpack2_plain_matches_jax_kernel(monkeypatch):
    taken = []
    real = jfa._fwd_kernel_hpack2
    monkeypatch.setattr(jfa, "_fwd_kernel_hpack2",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 256, 4, 40
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    with jflags.override(head_pack=2):
        jout, jlse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                        bshd=True)
    assert taken, "the JAX side did not take _fwd_kernel_hpack2"
    out, lse = fa_ops.flash_attention_hpack2(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert out.shape == (b, s, h * d) and lse.shape == (b, h, s)
    _close(out.numpy(), np.asarray(jout).reshape(b, s, h * d))
    _close(lse.numpy(), jlse)
    # the skip-max form agrees with exact softmax for in-range logits
    ref, rlse = fa_ops.flash_attention_bshd_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                                  scale)
    _close(out.numpy(), ref.numpy())
    _close(lse.numpy(), rlse.numpy())


def test_hpack2_plain_clamps_and_floors():
    """Logits beyond the clamp stay finite (exp2(110) does not overflow) and
    the result is still the softmax of the clamped logits."""
    q = torch.full((1, 4, 2, 8), 40.0)
    k = torch.full((1, 4, 2, 8), 40.0)
    v = torch.arange(64, dtype=torch.float32).reshape(1, 4, 2, 8)
    out, lse = fa_ops.flash_attention_hpack2_plain(q, k, v)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _close(out.reshape(1, 4, 2, 8).numpy(), v.mean(1, keepdim=True).expand(1, 4, 2, 8).numpy())


def _attention(heads, dim_head, seq):
    torch.manual_seed(0)
    attn = CrossAttention(heads * dim_head, heads, dim_head).eval()
    attn.fuse_projections()
    x = torch.randn(1, seq, heads * dim_head)
    return attn, x


@pytest.mark.parametrize("spec,heads,dim_head,want", [
    ({}, 2, 40, "qkv"),
    ({"attn_qkv_packed": False}, 2, 40, "bshd"),
    ({"attn_qkv_packed": False, "head_pack": 2}, 2, 40, "hpack2"),
    ({"attn_qkv_packed": False, "head_pack": 2}, 3, 40, "bshd"),
    ({"attn_qkv_packed": False, "head_pack": 2}, 2, 80, "bshd"),
    ({"fuse_qkv": False, "head_pack": 2}, 2, 40, "hpack2"),
    ({"head_pack": 2}, 2, 40, "qkv")])
def test_cross_attention_dispatch(spec, heads, dim_head, want, monkeypatch):
    """Self-attention at S=256 under the flags takes the wrapper the JAX
    rules take (qkvpack and fuse_qkv in ``CrossAttention``, then hpack
    where the heads pair and 2*D <= 128), and all give one result. The
    kernels take bf16 only, so fp32 takes no wrapper; with fp32 admitted
    (the wrappers run their plain versions on CPU tensors) the routes show."""
    taken = []
    for name in ("flash_attention_qkv", "flash_attention_bshd", "flash_attention_hpack2"):
        real = getattr(fa_ops, name)
        monkeypatch.setattr(fa_ops, name,
                            lambda *a, _n=name, _r=real, **k: taken.append(_n) or _r(*a, **k))
    attn, x = _attention(heads, dim_head, 256)
    with kernel_flags.override(**spec):
        plain = attn(x)
    assert taken == []
    monkeypatch.setattr(fa_ops, "KERNEL_DTYPES", (torch.float32,))
    base = attn(x)
    _close(base.detach().numpy(), plain.detach().numpy())
    taken.clear()
    jfield = {"head_pack": 2} if spec.get("head_pack") else {}
    with kernel_flags.override(**spec), jflags.override(**jfield):
        out = attn(x)
        jhpack = ((jflags.flags().head_pack or 1) > 1 and heads % 2 == 0
                  and 2 * dim_head <= 128)
    assert taken == [f"flash_attention_{want}"]
    assert (want == "hpack2") == (jhpack and spec.get("attn_qkv_packed", spec.get("fuse_qkv"))
                                  is False)
    _close(out.detach().numpy(), base.detach().numpy())


def test_fuse_qkv_off_keeps_projection_weights():
    """``fuse_projections`` keeps to_q/to_k/to_v, so fuse_qkv=0 still has
    its three weights after the fused one is made."""
    attn, x = _attention(2, 16, 64)
    assert attn.wqkv is not None
    with kernel_flags.override(fuse_qkv=False):
        out = attn(x)
    _close(out.detach().numpy(), attn(x).detach().numpy())
