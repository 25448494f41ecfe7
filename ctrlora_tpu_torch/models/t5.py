"""Frozen T5 text encoder (counterpart of ``ctrlora_tpu/models/t5.py``;
reference ldm/modules/encoders/modules.py:58-86, FrozenT5Embedder on
google/t5-v1_1-large).

No ctrlora config builds this encoder: it is the vendored SD codebase's
other conditioning option. T5 v1.1 encoder: a shared token embedding,
pre-RMSNorm blocks of (self-attention with a bucketed relative position
bias, gated-GELU feed-forward), a final RMSNorm. No layer has a bias, and
attention is NOT 1/sqrt(d)-scaled (T5 folds the scale into its
initialisation). The position bias comes from block 0's table and every
layer shares it. Plain ``F.linear`` and matmul attention in fp32 (JAX's is
einsums, no Pallas kernel).

Weights load from the HF ``T5EncoderModel`` state-dict names
(``t5_entries``); both are torch, so every layout is kept. Tokenization
(SentencePiece) is not vendored: ``FrozenT5Embedder.encode`` takes token
ids, or text with a ``tokenize`` callable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024  # t5-v1_1-large
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 77  # the reference pads/truncates to 77


class RMSNorm(nn.Module):
    """T5LayerNorm: no mean subtraction, no bias; the statistics in fp32,
    cast back to the input's dtype before the weight."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def _relative_position_bucket(rel_pos: np.ndarray, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional bucketing (HF T5Attention._relative_position_bucket)."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def position_bias_table(seq_len: int, cfg: T5Config) -> np.ndarray:
    """[seq, seq] int bucket ids for the relative_attention_bias lookup."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    return _relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                     cfg.relative_attention_max_distance)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(self, x, position_bias):
        b, s, _ = x.shape
        split = lambda t: t.reshape(b, s, self.heads, self.d_kv).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))  # q NOT scaled
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + position_bias
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, s, self.heads * self.d_kv)
        return self.o(out)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5Attention(cfg)
        self.ln_ff = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, position_bias):
        x = x + self.attn(self.ln_attn(x), position_bias)
        h = self.ln_ff(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h)


class T5TextModel(nn.Module):
    """input_ids [B, S] -> last hidden state [B, S, d_model] (the reference
    returns outputs.last_hidden_state, modules.py:83)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.randn(cfg.vocab_size, cfg.d_model))
        self.relative_attention_bias = nn.Parameter(
            torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads) * 0.02)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", T5Block(cfg))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        x = self.token_embedding[input_ids.long()]
        buckets = torch.from_numpy(position_bias_table(s, self.cfg)).to(x.device)
        # [S, S, H] -> [1, H, S, S], shared by every layer
        bias = self.relative_attention_bias[buckets].permute(2, 0, 1)[None].float()
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, bias)
        return self.final_layer_norm(x)


def t5_entries(cfg: T5Config) -> Dict[str, str]:
    """{HF T5EncoderModel state-dict name: the port's T5TextModel key}."""
    e = {"shared.weight": "token_embedding",
         "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
             "relative_attention_bias",
         "encoder.final_layer_norm.weight": "final_layer_norm.weight"}
    for i in range(cfg.num_layers):
        hf, ours = f"encoder.block.{i}.layer", f"block_{i}"
        for nm in ("q", "k", "v", "o"):
            e[f"{hf}.0.SelfAttention.{nm}.weight"] = f"{ours}.attn.{nm}.weight"
        e[f"{hf}.0.layer_norm.weight"] = f"{ours}.ln_attn.weight"
        for nm in ("wi_0", "wi_1", "wo"):
            e[f"{hf}.1.DenseReluDense.{nm}.weight"] = f"{ours}.{nm}.weight"
        e[f"{hf}.1.layer_norm.weight"] = f"{ours}.ln_ff.weight"
    return e


def convert_t5(sd: Mapping[str, np.ndarray], cfg: T5Config) -> Dict[str, torch.Tensor]:
    """HF T5EncoderModel state dict -> the port's T5TextModel state dict,
    fp32."""
    out = {}
    for hf_name, key in t5_entries(cfg).items():
        v = sd[hf_name]
        out[key] = (v.detach().to("cpu", torch.float32) if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v, np.float32)))
    return out


class FrozenT5Embedder:
    """The reference's FrozenT5Embedder (modules.py:58-86): a T5TextModel
    in eval mode on `device`, loaded from a port state dict when one is
    given."""

    def __init__(self, cfg: T5Config = T5Config(), state_dict=None,
                 tokenize: Optional[Callable] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = T5TextModel(cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.tokenize = tokenize

    def encode(self, ids_or_text) -> torch.Tensor:
        if isinstance(ids_or_text, (list, tuple)) and ids_or_text and isinstance(
                ids_or_text[0], str):
            if self.tokenize is None:
                raise RuntimeError("T5 SentencePiece tokenizer unavailable on this host; "
                                   "pass token ids or a `tokenize` callable")
            ids_or_text = self.tokenize(ids_or_text)
        ids = (ids_or_text if isinstance(ids_or_text, torch.Tensor)
               else torch.as_tensor(np.asarray(ids_or_text)))
        with torch.no_grad():
            return self.model(ids.to(self.device))
