"""CLIP ViT-L/14 text encoder, layer 'last' (counterpart of
``ctrlora_tpu/models/clip.py``). fp32 and plain: no TPU kernel runs here.
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


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.layer != "last":
            raise ValueError("the port's CLIP implements layer='last' only")
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_layer_norm = LayerNorm32(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, S] -> final_layer_norm(hidden) [B, S, hidden] fp32."""
        cfg = self.cfg
        s = input_ids.shape[1]
        ids = input_ids.long().clamp(0, cfg.vocab_size - 1)  # out-of-vocab ids clamp
        x = (self.token_embedding[ids] + self.position_embedding[None, :s]).to(cfg.compute_dtype)
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.final_layer_norm(x).float()
