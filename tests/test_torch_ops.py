"""Parity of the port's kernel modules (their plain versions, which the
wrappers take on CPU tensors) with the JAX package's Pallas kernels, run as
the JAX tests run them off-TPU: in interpret mode.

Inputs come from numpy; fp32 throughout. Tolerance rtol=1e-4, atol=1e-5:
the same math summed in another order (the JAX GEGLU's A&S erf differs
from torch.erf by at most 1.5e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.ops import flash_attention as jfa
from ctrlora_tpu.ops import geglu_ffn as jgeglu
from ctrlora_tpu.ops.group_norm import fused_group_norm
from ctrlora_tpu.ops.kernel_flags import override
from ctrlora_tpu.ops.unpack_rows import pack_row_tables as jpack
from ctrlora_tpu.ops.unpack_rows import unpack_rows as junpack

from ctrlora_tpu_torch.ops import flash_attention as fa
from ctrlora_tpu_torch.ops import geglu_ffn as geglu
from ctrlora_tpu_torch.ops import group_norm as gn
from ctrlora_tpu_torch.ops import unpack_rows as ur

RTOL, ATOL = 1e-4, 1e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


T = torch.from_numpy


@pytest.mark.parametrize("c,eps,silu,row", [
    (320, 1e-5, True, None),       # cpg 10, UNet ResBlock norm
    (320, 1e-5, True, "c"),        # add_row [C]
    (320, 1e-5, True, "1c"),       # add_row [1, C]
    (640, 1e-6, False, "bc"),      # cpg 20, add_row [B, C], transformer eps
    (128, 1e-6, True, None),       # cpg 4, VAE
    (128, 1e-6, False, "1c"),
    (64, 1e-5, True, "bc"),        # cpg 2: ControlNet-XS's control stream at 64^2
    (384, 1e-5, True, None),       # cpg 12: its `cat` infusion's 64 + 320
    (1536, 1e-5, True, None),      # cpg 48: 256 + 1280
])
def test_group_norm_matches_pallas(c, eps, silu, row):
    rng = np.random.default_rng(c + int(silu))
    x = rng.normal(1.0, 2.0, size=(2, 4, 8, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=(c,)).astype(np.float32)
    add = {None: None, "c": (c,), "1c": (1, c), "bc": (2, c)}[row]
    add = None if add is None else rng.normal(size=add).astype(np.float32)
    ref = fused_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, eps,
                           silu, interpret=True,
                           add_row=None if add is None else jnp.asarray(add))
    out = gn.group_norm(T(x), T(scale), T(bias), 32, eps, silu,
                        None if add is None else T(add))
    _close(out.numpy(), ref)
    assert gn.group_norm.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("d", [40, 80, 160, 8, 16, 32])  # UNet; ControlNet-XS's control stream
def test_flash_qkv_matches_pallas(d):
    b, s, h = 1, 256, 2
    rng = np.random.default_rng(d)
    qkv = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
    ref_out, ref_lse = jfa._flash_forward_qkv(jnp.asarray(qkv), h, d, d ** -0.5)
    out, lse = fa.flash_attention_qkv(T(qkv), h, d)
    _close(out.numpy(), ref_out)
    _close(lse.numpy(), ref_lse)
    # the module-level dispatch (Sk >= 256 -> flash entry) gives the same output
    disp = fa.dot_product_attention_bshd_qkv(T(qkv), h, d)
    _close(disp.numpy(), ref_out)


def test_flash_bhsd_matches_pallas_vae_geometry():
    b, h, s, d = 1, 1, 256, 512
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3))
    ref_out, ref_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          d ** -0.5)
    out, lse = fa.flash_attention(T(q), T(k), T(v))
    _close(out.numpy(), ref_out)
    _close(lse.numpy(), ref_lse)
    _close(fa.dot_product_attention(T(q), T(k), T(v)).numpy(),
           jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def test_attention_small_sk_stays_plain():
    """Cross-attention over 77 tokens: the JAX XLA path and the port's
    plain path (both skip flash below Sk=256)."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 2, 64, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 77, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 77, 16)).astype(np.float32)
    ref = jfa.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(fa.dot_product_attention(T(q), T(k), T(v)).numpy(), ref)


def _geglu_inputs(rows, c, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, size=(2, rows // 2, c)).astype(np.float32)
    w1 = rng.normal(0, 0.05, size=(c, 2 * f)).astype(np.float32)
    b1 = rng.normal(0, 0.05, size=(2 * f,)).astype(np.float32)
    w2 = rng.normal(0, 0.05, size=(f, c)).astype(np.float32)
    b2 = rng.normal(0, 0.05, size=(c,)).astype(np.float32)
    return x, w1, b1, w2, b2


def _port_geglu(x, w1, b1, w2, b2):
    # Linear layout: w1 [2F, C], w2 [C, F]
    return geglu.geglu_ffn(T(x), T(np.ascontiguousarray(w1.T)), T(b1),
                           T(np.ascontiguousarray(w2.T)), T(b2)).numpy()


def test_geglu_matches_pallas_resident():
    x, w1, b1, w2, b2 = _geglu_inputs(256, 64, 256, 1)
    with override(geglu_ffn=True):
        ref = jgeglu.geglu_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    _close(_port_geglu(x, w1, b1, w2, b2), ref)


@pytest.mark.parametrize("c", [128, 256])  # ControlNet-XS's 32^2 and 16^2 widths (F = 4C)
def test_geglu_matches_pallas_xs_widths(c):
    x, w1, b1, w2, b2 = _geglu_inputs(128, c, 4 * c, c)
    with override(geglu_ffn=True):
        ref = jgeglu.geglu_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    _close(_port_geglu(x, w1, b1, w2, b2), ref)


def test_geglu_matches_pallas_blocked():
    x, w1, b1, w2, b2 = _geglu_inputs(256, 128, 512, 2)
    ref = jgeglu._forward_blocked(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), 128, 256)
    _close(_port_geglu(x, w1, b1, w2, b2), ref)
    assert geglu.geglu_ffn.launches == 0


def test_unpack_rows_and_pack_match_pallas():
    rng = np.random.default_rng(3)
    tables = {f"r{i}": rng.normal(size=(3, c)).astype(np.float32)
              for i, c in enumerate((320, 640, 1280, 320, 1280))}
    jtab, jnames, jsizes = jpack({k: jnp.asarray(v) for k, v in tables.items()})
    ptab, pnames, psizes = ur.pack_row_tables({k: T(v) for k, v in tables.items()})
    assert (pnames, psizes) == (jnames, jsizes)
    np.testing.assert_array_equal(ptab.numpy(), np.asarray(jtab))
    ref = junpack(jtab[1], jsizes, interpret=True)
    rows = ur.unpack_rows(ptab[1], psizes)
    assert [r.shape for r in rows] == [tuple(r.shape) for r in ref]
    for a, b in zip(rows, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ur.unpack_rows.launches == 0
