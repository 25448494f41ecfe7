"""Gradients of the port's kernel modules against the JAX package: the
flash-attention BSHD forward and the backward kernels' math (Pallas in
interpret mode, as the JAX tests run them off-TPU), and the autograd
Functions of every training-path kernel against ``jax.grad``/``jax.vjp`` of
the JAX ``custom_vjp``s.

Inputs come from numpy; fp32 on the CPU, where each wrapper takes its
kernel's plain version, so these tests go through the same autograd
Functions as the GPU path. Tolerances: forward rtol 1e-4 / atol 1e-5 (the
same math summed in another order); attention gradients rtol 1e-3 / atol
5e-5, as tests/test_flash_attention.py; GroupNorm and GEGLU gradients rtol
1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.ops import flash_attention as jfa
from ctrlora_tpu.ops import geglu_ffn as jgeglu
from ctrlora_tpu.ops import group_norm as jgn

from ctrlora_tpu_torch.ops import flash_attention as fa
from ctrlora_tpu_torch.ops import geglu_ffn as geglu
from ctrlora_tpu_torch.ops import group_norm as gn

T = torch.from_numpy
B, S, H = 1, 256, 2


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def _qkv(d, seed, layout="bshd"):
    rng = np.random.default_rng(seed)
    shape = (B, S, H, d) if layout == "bshd" else (B, H, S, d)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_bshd_forward_matches_pallas(d):
    q, k, v, _ = _qkv(d, d)
    ref_out, ref_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          d ** -0.5, bshd=True)
    out, lse = fa.flash_attention_bshd(T(q), T(k), T(v))
    assert out.shape == (B, S, H * d)
    _close(out.numpy(), np.asarray(ref_out).reshape(B, S, H * d), 1e-4, 1e-5)
    _close(lse.numpy(), ref_lse, 1e-4, 1e-5)
    disp = fa.dot_product_attention_bshd(T(q), T(k), T(v))
    _close(disp.numpy(), np.asarray(ref_out).reshape(B, S, H * d), 1e-4, 1e-5)
    assert fa.flash_attention_bshd.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("d", [40, 80, 160, 8, 16, 32])  # UNet; ControlNet-XS's control stream
def test_flash_backward_math_matches_pallas(d):
    q, k, v, g = _qkv(d, 10 + d, layout="bhsd")
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, d ** -0.5)
    ref = jfa._flash_backward(d ** -0.5, (jq, jk, jv, out, lse), jg)
    got = fa.flash_attention_bwd_plain(T(q), T(k), T(v), T(np.asarray(out)),
                                       T(np.asarray(lse)), T(g), d ** -0.5)
    for a, b in zip(got, ref):
        _close(a.numpy(), b, 1e-3, 5e-5)
    # the wrappers (plain on CPU) split the same math into dQ and dK/dV
    wrapped = fa.flash_attention_bwd(T(q), T(k), T(v), T(np.asarray(out)),
                                     T(np.asarray(lse)), T(g), d ** -0.5)
    for a, b in zip(wrapped, got):
        torch.testing.assert_close(a, b)
    assert fa.flash_attention_bwd_dq.launches == fa.flash_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("d", [40, 160])
def test_flash_bshd_function_grads_match_jax(d):
    q, k, v, g = _qkv(d, 20 + d)
    jg = jnp.asarray(g)

    def jloss(q, k, v):
        return jnp.sum(jfa._flash_attention_bshd(q, k, v, d ** -0.5) * jg)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (T(a).requires_grad_() for a in (q, k, v))
    out, _ = fa.flash_attention_bshd(tq, tk, tv)
    out.backward(T(g).reshape(B, S, H * d))
    for t, r in zip((tq, tk, tv), ref):
        _close(t.grad.numpy(), r, 1e-3, 5e-5)


@pytest.mark.parametrize("d", [40, 160])
def test_flash_qkv_function_grads_match_jax(d):
    rng = np.random.default_rng(30 + d)
    qkv = rng.normal(size=(B, S, 3 * H * d)).astype(np.float32)
    g = rng.normal(size=(B, S, H * d)).astype(np.float32)
    jg = jnp.asarray(g)

    def jloss(x):
        return jnp.sum(jfa._flash_attention_qkv(x, H, d, d ** -0.5) * jg)

    ref = jax.grad(jloss)(jnp.asarray(qkv))
    t = T(qkv).requires_grad_()
    out, _ = fa.flash_attention_qkv(t, H, d)
    out.backward(T(g))
    _close(t.grad.numpy(), ref, 1e-3, 5e-5)


def test_flash_bhsd_function_grads_match_plain_autograd():
    q, k, v, g = (T(a) for a in _qkv(40, 40, layout="bhsd"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves)[0].backward(g)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.attention_plain(*plain)[0].backward(g)
    for a, b in zip(leaves, plain):
        _close(a.grad.numpy(), b.grad.numpy(), 1e-3, 5e-5)


@pytest.mark.parametrize("c,silu,row", [
    (320, True, "bc"),   # ResBlock out_norm with the per-example emb row
    (320, True, None),
    (640, False, "1c"),
])
def test_group_norm_grads_match_jax_vjp(c, silu, row):
    rng = np.random.default_rng(c + int(silu))
    x = rng.normal(1.0, 2.0, size=(2, 4, 8, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=(c,)).astype(np.float32)
    add = None if row is None else rng.normal(size=(2, c) if row == "bc" else (1, c)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, scale, bias)] + ([] if add is None else [jnp.asarray(add)])
    eps = 1e-5
    fn = lambda *a: jgn.group_norm(a[0], a[1], a[2], a[3] if len(a) > 3 else None, 32, eps, silu)
    ref_y, vjp = jax.vjp(fn, *jargs)
    ref = vjp(jnp.asarray(g))
    targs = [T(a).requires_grad_() for a in (x, scale, bias)] + (
        [] if add is None else [T(add).requires_grad_()])
    y = gn.group_norm(targs[0], targs[1], targs[2], 32, eps, silu,
                      targs[3] if add is not None else None)
    _close(y.detach().numpy(), ref_y, 1e-4, 1e-5)
    y.backward(T(g))
    for t, r in zip(targs, ref):
        _close(t.grad.numpy(), r, 1e-4, 1e-5)


def test_geglu_grads_match_jax_vjp():
    rng = np.random.default_rng(7)
    c, f = 64, 256
    x = rng.normal(0, 0.5, size=(2, 64, c)).astype(np.float32)
    w1 = rng.normal(0, 0.05, size=(c, 2 * f)).astype(np.float32)
    b1 = rng.normal(0, 0.05, size=(2 * f,)).astype(np.float32)
    w2 = rng.normal(0, 0.05, size=(f, c)).astype(np.float32)
    b2 = rng.normal(0, 0.05, size=(c,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    ref_y, vjp = jax.vjp(jgeglu.geglu_ffn, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    rx, rw1, rb1, rw2, rb2 = vjp(jnp.asarray(g))
    # Linear layout: w1 [2F, C], w2 [C, F]
    targs = [T(a).requires_grad_() for a in (x, np.ascontiguousarray(w1.T), b1,
                                              np.ascontiguousarray(w2.T), b2)]
    y = geglu.geglu_ffn(*targs)
    _close(y.detach().numpy(), ref_y, 1e-4, 1e-5)
    y.backward(T(g))
    for got, want in zip((targs[0].grad, targs[1].grad.T, targs[2].grad, targs[3].grad.T,
                          targs[4].grad), (rx, rw1, rb1, rw2, rb2)):
        _close(got.numpy(), want, 1e-4, 1e-5)
    assert geglu.geglu_ffn.launches == 0
