"""CLIP ViT-L/14 text encoder (counterpart of ``ctrlora_tpu/models/clip.py``;
reference ldm/modules/encoders/modules.py:88-131). fp32 and plain: no TPU
kernel runs here.

``CLIPTextConfig.layer`` picks the output: 'last' (final_layer_norm of the
last hidden state), 'penultimate' (the same one layer early), 'hidden' (the
raw state entering layer ``layer_idx``, clip-skip), 'pooled' (the 'last'
row at the EOT token, the largest id of the row) or 'projected' (pooled @
``text_projection``). ``context_and_pooled`` gives a tower's output and
its projected pooled vector from one forward (SDXL's OpenCLIP bigG tower:
``CLIPTextModel(cfg, pooled=True)``). ``encode_windowed`` is the
reference's 3x77-token "clip hack" (cldm/hack.py:32-68).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import CLIPTextConfig
from ctrlora_tpu_torch.models.layers import Dense, LayerNorm32


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj = Dense(d, d), Dense(d, d)
        self.v_proj, self.out_proj = Dense(d, d), Dense(d, d)

    def forward(self, x, mask):
        b, s, d = x.shape
        hd = d // self.heads
        split = lambda t: t.reshape(b, s, self.heads, hd).transpose(1, 2)
        q = split(self.q_proj(x)) * (hd ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + mask
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(b, s, d))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.quick = cfg.hidden_act == "quick_gelu"
        self.layer_norm1 = LayerNorm32(cfg.hidden_size)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        h = self.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick else F.gelu(h)
        return x + self.fc2(h)


LAYERS = ("last", "penultimate", "hidden", "pooled", "projected")


class CLIPTextModel(nn.Module):
    """`pooled`: the tower also gives its projected pooled vector
    (``context_and_pooled``), so it holds ``text_projection`` whatever its
    ``layer``."""

    def __init__(self, cfg: CLIPTextConfig, pooled: bool = False):
        super().__init__()
        if cfg.layer not in LAYERS:
            raise ValueError(f"unknown layer {cfg.layer!r}; one of {LAYERS}")
        if cfg.layer == "hidden" and cfg.layer_idx is None:
            raise ValueError("layer='hidden' requires layer_idx")
        if (cfg.layer == "projected" or pooled) and not cfg.projection_dim:
            raise ValueError("a projected pooled vector needs projection_dim")
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_layer_norm = LayerNorm32(cfg.hidden_size)
        if cfg.layer == "projected" or pooled:
            self.text_projection = Dense(cfg.hidden_size, cfg.projection_dim, bias=False)

    def _embed(self, input_ids: torch.Tensor):
        """(the token and position embeddings, the causal mask)."""
        cfg = self.cfg
        s = input_ids.shape[1]
        ids = input_ids.long().clamp(0, cfg.vocab_size - 1)  # out-of-vocab ids clamp
        x = (self.token_embedding[ids] + self.position_embedding[None, :s]).to(cfg.compute_dtype)
        return x, torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]

    def _hidden_stop(self) -> int:
        """The layer whose input 'hidden' returns."""
        cfg = self.cfg
        stop = cfg.num_layers + cfg.layer_idx if cfg.layer_idx < 0 else cfg.layer_idx
        if not 0 <= stop < cfg.num_layers:
            raise ValueError(f"layer_idx {cfg.layer_idx} is outside the "
                             f"{cfg.num_layers} layers")
        return stop

    def _pooled(self, final: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """The rows of `final` [B, S, hidden] at each row's EOT token."""
        return final[torch.arange(final.shape[0], device=final.device),
                     input_ids.long().argmax(dim=-1)]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, S] -> [B, S, hidden] fp32 ('last', 'penultimate',
        'hidden'), [B, hidden] ('pooled') or [B, projection_dim]
        ('projected')."""
        cfg = self.cfg
        x, mask = self._embed(input_ids)
        if cfg.layer == "hidden":
            for i in range(self._hidden_stop()):
                x = getattr(self, f"layer_{i}")(x, mask)
            return x.float()
        for i in range(cfg.num_layers - (cfg.layer == "penultimate")):
            x = getattr(self, f"layer_{i}")(x, mask)
        final = self.final_layer_norm(x).float()
        if cfg.layer in ("last", "penultimate"):
            return final
        pooled = self._pooled(final, input_ids)
        return pooled if cfg.layer == "pooled" else self.text_projection(pooled)

    def context_and_pooled(self, input_ids: torch.Tensor):
        """(the 'hidden' context [B, S, hidden] fp32, the projected pooled
        vector [B, projection_dim] fp32) of one forward: the layers up to
        ``layer_idx`` give the context, the rest of them, final_layer_norm
        at each row's EOT token and ``text_projection`` the pooled vector."""
        cfg = self.cfg
        if cfg.layer != "hidden" or not hasattr(self, "text_projection"):
            raise ValueError("context_and_pooled needs layer='hidden' and a tower built "
                             "with pooled=True")
        x, mask = self._embed(input_ids)
        stop = self._hidden_stop()
        for i in range(cfg.num_layers):
            if i == stop:
                context = x.float()
            x = getattr(self, f"layer_{i}")(x, mask)
        pooled = self._pooled(self.final_layer_norm(x).float(), input_ids)
        return context, self.text_projection(pooled)


def encode_windowed(model: CLIPTextModel, input_ids: torch.Tensor,
                    window: int = 77) -> torch.Tensor:
    """Encode each `window`-token slice of input_ids [B, n*window] and
    concatenate the outputs on the sequence axis: [B, n*window, hidden]."""
    s = input_ids.shape[1]
    if s % window:
        raise ValueError(f"windowed encoding expects a multiple of {window} tokens, got {s}")
    return torch.cat([model(input_ids[:, i:i + window]) for i in range(0, s, window)], dim=1)
