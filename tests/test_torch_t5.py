"""The port's frozen T5 encoder against the JAX package's on the CPU: a
tiny T5Config (2 layers, d_model 64, 4 heads) with seeded HF-named
weights through both packages' convert_t5, the last hidden state within
rtol 1e-4 / atol 1e-5; the relative-position buckets equal; the JAX tree
carried into the port's state dict; FrozenT5Embedder's encode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctrlora_tpu.models import t5 as jt5
from ctrlora_tpu_torch import convert
from ctrlora_tpu_torch.models import t5 as tt5

KW = dict(vocab_size=100, d_model=64, d_kv=16, d_ff=96, num_layers=2, num_heads=4,
          relative_attention_num_buckets=8, relative_attention_max_distance=20)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Six pytest processes share the host's cores: one torch thread each
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_state(cfg, seed=0):
    """An HF T5EncoderModel state dict of seeded weights (norm weights
    around 1)."""
    rng = np.random.default_rng(seed)
    inner = cfg.num_heads * cfg.d_kv
    shapes = {"shared.weight": (cfg.vocab_size, cfg.d_model),
              "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
                  (cfg.relative_attention_num_buckets, cfg.num_heads)}
    for i in range(cfg.num_layers):
        hf = f"encoder.block.{i}.layer"
        for nm in ("q", "k", "v"):
            shapes[f"{hf}.0.SelfAttention.{nm}.weight"] = (inner, cfg.d_model)
        shapes[f"{hf}.0.SelfAttention.o.weight"] = (cfg.d_model, inner)
        shapes[f"{hf}.1.DenseReluDense.wi_0.weight"] = (cfg.d_ff, cfg.d_model)
        shapes[f"{hf}.1.DenseReluDense.wi_1.weight"] = (cfg.d_ff, cfg.d_model)
        shapes[f"{hf}.1.DenseReluDense.wo.weight"] = (cfg.d_model, cfg.d_ff)
    sd = {k: rng.normal(0, 0.15, s).astype(np.float32) for k, s in shapes.items()}
    sd["shared.weight"] *= 6
    for k in ["encoder.final_layer_norm.weight"] + [
            f"encoder.block.{i}.layer.{j}.layer_norm.weight"
            for i in range(cfg.num_layers) for j in (0, 1)]:
        sd[k] = rng.normal(1, 0.1, cfg.d_model).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def t5():
    cfg_j, cfg_t = jt5.T5Config(**KW), tt5.T5Config(**KW)
    sd = hf_state(cfg_t)
    model = tt5.T5TextModel(cfg_t)
    model.load_state_dict(tt5.convert_t5(sd, cfg_t), strict=True)
    return cfg_j, cfg_t, sd, model.eval()


@pytest.mark.parametrize("seq", [11, 77])
def test_t5_last_hidden_state_matches_jax(t5, seq):
    cfg_j, _, sd, model = t5
    ids = np.random.default_rng(seq).integers(0, KW["vocab_size"], (2, seq))
    want = np.asarray(jt5.T5TextModel(cfg_j).apply(jt5.convert_t5(sd, cfg_j), jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, seq, KW["d_model"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seq", [1, 13, 77, 200])
def test_position_bias_table_equals_jax(seq):
    for kw in (KW, {}):
        np.testing.assert_array_equal(tt5.position_bias_table(seq, tt5.T5Config(**kw)),
                                      jt5.position_bias_table(seq, jt5.T5Config(**kw)))


def test_t5_tree_carries_and_entries_match_jax(t5):
    """JAX's convert_t5 tree through params_from_jax equals the port's
    convert_t5 bit for bit, and both read the same HF names."""
    cfg_j, cfg_t, sd, _ = t5
    assert set(tt5.t5_entries(cfg_t)) == set(jt5.t5_entries(cfg_j))
    carried = convert.params_from_jax(jt5.convert_t5(sd, cfg_j))
    own = tt5.convert_t5(sd, cfg_t)
    assert set(carried) == set(own)
    for k in own:
        assert torch.equal(carried[k], own[k]), k


def test_frozen_t5_embedder_encode(t5):
    _, cfg_t, sd, model = t5
    ids = np.random.default_rng(3).integers(0, KW["vocab_size"], (2, 9))
    emb = tt5.FrozenT5Embedder(cfg_t, tt5.convert_t5(sd, cfg_t), device="cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(ids))
    assert torch.equal(emb.encode(ids), want)
    assert torch.equal(emb.encode(torch.from_numpy(ids)), want)
    with pytest.raises(RuntimeError, match="tokenizer"):
        emb.encode(["a photo of a cat"])
    tok = tt5.FrozenT5Embedder(cfg_t, tt5.convert_t5(sd, cfg_t), device="cpu",
                               tokenize=lambda texts: ids[:len(texts)])
    assert torch.equal(tok.encode(["a", "b"]), want)
