"""OneFormer's transformer decoder, inference path (counterpart of
``ctrlora_tpu/annotators/oneformer/decoder.py``; reference
oneformer/modeling/transformer_decoder/oneformer_transformer_decoder.py and
transformer.py, the DETR class transformer; the text tower is
training-only, oneformer_model.py:266-270).

The task token (``task_mlp`` over the raw token ids, then the decoder norm)
seeds the Q-1 queries of a two-layer post-norm DETR decoder over the mask
features (its memory is their sine position embedding and its key position
their 1x1 projection: the reference passes the two in that swapped order,
decoder.py:434-437); with the task token they make the Q queries of nine
masked layers cycling over the pixel decoder's three maps. Each layer runs
cross-attention under the previous prediction's mask (sigmoid < 0.5
blocked, rows blocked everywhere unblocked), self-attention and the FFN,
each post-norm; each prediction gives class logits [B, Q, K+1] and masks
[B, Q, H/4, W/4]. The module keeps the file's key names under
``sem_seg_head.predictor.`` (the task MLP's under ``task_mlp.``); attention
is plain matmuls and a softmax, as JAX's. The published configs project no
input (conv_dim = hidden_dim), so there is no ``input_proj``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators.oneformer.pixel_decoder import position_embedding


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    hidden_dim: int = 256
    num_queries: int = 150
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9  # DEC_LAYERS - 1
    class_dec_layers: int = 2
    num_classes: int = 133
    task_seq_len: int = 77


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (``in_proj_weight`` [3C, C],
    ``in_proj_bias``, ``out_proj``), batch first, an additive mask."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        b, sq, c = q.shape
        d = c // self.heads
        w, bias = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        heads = lambda x, i: F.linear(x, w[i], bias[i]).reshape(b, -1, self.heads, d).transpose(1, 2)
        logits = (heads(q, 0) * d ** -0.5) @ heads(k, 1).transpose(-2, -1)
        if mask is not None:
            logits = logits + mask
        o = (torch.softmax(logits, dim=-1) @ heads(v, 2)).transpose(1, 2).reshape(b, sq, c)
        return self.out_proj(o)


class MLP(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int, n: int):
        super().__init__()
        dims = [cin] + [hidden] * (n - 1) + [cout]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DetrDecoderLayer(nn.Module):
    def __init__(self, c: int, heads: int, ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(c, heads)
        self.multihead_attn = MultiheadAttention(c, heads)
        self.linear1 = nn.Linear(c, ff)
        self.linear2 = nn.Linear(ff, c)
        self.norm1 = nn.LayerNorm(c)
        self.norm2 = nn.LayerNorm(c)
        self.norm3 = nn.LayerNorm(c)

    def forward(self, tgt, memory, pos, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class ClassTransformer(nn.Module):
    """The DETR transformer with no encoder layers (every published config)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        c = cfg.hidden_dim
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(DetrDecoderLayer(c, cfg.nheads, cfg.dim_feedforward)
                                            for _ in range(cfg.class_dec_layers))
        self.decoder.norm = nn.LayerNorm(c)

    def forward(self, src, pos, query_embed, task_token):
        """src, pos [B, S, C]; query_embed [Q-1, C]; task_token [B, 1, C]."""
        qe = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = task_token.expand(-1, qe.shape[1], -1)
        for layer in self.decoder.layers:
            tgt = layer(tgt, src, pos, qe)
        return self.decoder.norm(tgt)


class SelfAttentionLayer(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(c, heads)
        self.norm = nn.LayerNorm(c)

    def forward(self, x, query_pos):
        q = x + query_pos
        return self.norm(x + self.self_attn(q, q, x))


class CrossAttentionLayer(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(c, heads)
        self.norm = nn.LayerNorm(c)

    def forward(self, x, memory, pos, query_pos, mask):
        return self.norm(x + self.multihead_attn(x + query_pos, memory + pos, memory, mask))


class FFNLayer(nn.Module):
    def __init__(self, c: int, ff: int):
        super().__init__()
        self.linear1 = nn.Linear(c, ff)
        self.linear2 = nn.Linear(ff, c)
        self.norm = nn.LayerNorm(c)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class OneFormerDecoder(nn.Module):
    """(the task MLP's output, [1/32, 1/16, 1/8] maps, the mask features)
    -> (class logits [B, Q, K+1], masks [B, Q, H/4, W/4])."""

    LEVELS = 3

    def __init__(self, cfg: DecoderConfig, mask_dim: int):
        super().__init__()
        self.cfg = cfg
        c, L = cfg.hidden_dim, cfg.dec_layers
        self.class_transformer = ClassTransformer(cfg)
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(c, cfg.nheads) for _ in range(L))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(c, cfg.nheads) for _ in range(L))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(c, cfg.dim_feedforward) for _ in range(L))
        self.decoder_norm = nn.LayerNorm(c)
        self.query_embed = nn.Embedding(cfg.num_queries, c)
        self.level_embed = nn.Embedding(self.LEVELS, c)
        self.class_input_proj = nn.Conv2d(mask_dim, c, 1)
        self.class_embed = nn.Linear(c, cfg.num_classes + 1)
        self.mask_embed = MLP(c, c, mask_dim, 3)

    def predict(self, output, mask_features, target_hw: Tuple[int, int]):
        """(class logits, masks, the attention mask [B, 1, Q, h*w] at
        `target_hw`) of the queries `output` [B, Q, C]."""
        x = self.decoder_norm(output)
        masks = torch.einsum("bqc,bchw->bqhw", self.mask_embed(x), mask_features)
        small = F.interpolate(masks, size=target_hw, mode="bilinear", align_corners=False)
        blocked = torch.sigmoid(small.flatten(2)) < 0.5
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        attn_mask = torch.zeros(blocked.shape, dtype=masks.dtype, device=masks.device)
        attn_mask = attn_mask.masked_fill(blocked, float("-inf"))[:, None]
        return self.class_embed(x), masks, attn_mask

    def queries(self, task: torch.Tensor, features: Sequence[torch.Tensor],
                mask_features: torch.Tensor):
        """(the masked layers' memories [B, h*w, C] with their position
        embeddings and sizes, the first queries [B, Q, C]: the class
        transformer's Q-1 and the normalised task token)."""
        c = self.cfg.hidden_dim
        b = mask_features.shape[0]
        src, pos, sizes = [], [], []
        for i, x in enumerate(features):
            h, w = x.shape[2:]
            sizes.append((h, w))
            pos.append(position_embedding(h, w, c, str(x.device)))
            src.append(x.flatten(2).transpose(1, 2) + self.level_embed.weight[i][None, None])
        task = self.decoder_norm(task[:, None, :])
        mh, mw = mask_features.shape[2:]
        mf_pe = position_embedding(mh, mw, c, str(mask_features.device)).expand(b, -1, -1)
        mf_proj = self.class_input_proj(mask_features).flatten(2).transpose(1, 2)
        out = self.class_transformer(mf_pe, mf_proj, self.query_embed.weight[:-1], task)
        return src, pos, sizes, torch.cat([out, task], dim=1)

    def layer(self, i: int, output, src, pos, attn_mask):
        """Masked layer i on the queries `output`: cross-attention to level
        i % 3 under `attn_mask`, self-attention, FFN."""
        li, query_pos = i % self.LEVELS, self.query_embed.weight[None]
        output = self.transformer_cross_attention_layers[i](
            output, src[li], pos[li], query_pos, attn_mask)
        output = self.transformer_self_attention_layers[i](output, query_pos)
        return self.transformer_ffn_layers[i](output)

    def forward(self, task: torch.Tensor, features: Sequence[torch.Tensor],
                mask_features: torch.Tensor):
        src, pos, sizes, output = self.queries(task, features, mask_features)
        cls, masks, attn_mask = self.predict(output, mask_features, sizes[0])
        for i in range(self.cfg.dec_layers):
            output = self.layer(i, output, src, pos, attn_mask)
            cls, masks, attn_mask = self.predict(output, mask_features,
                                                 sizes[(i + 1) % self.LEVELS])
        return cls, masks
