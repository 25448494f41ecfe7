"""OpenCLIP text-tower bridge of the port (counterpart of
``ctrlora_tpu/models/openclip.py``; reference
ldm/modules/encoders/modules.py:134-186, FrozenOpenCLIPEmbedder on laion
ViT-H-14, layer='penultimate').

The ViT-H tower is kept, as in JAX, for parity with the reference's
codebase; no config instantiates it. The tower is the port's
``CLIPTextModel`` with gelu and the 'penultimate' layer (23 of 24 blocks,
then ln_final); only the checkpoint's names differ: open_clip packs q/k/v
into ``attn.in_proj_weight`` and names its blocks
``transformer.resblocks.N``. The ViT-bigG tower is SDXL's second text
tower (``configs.sdxl_controlnet_config``'s ``conditioner.clip2``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ctrlora_tpu_torch.configs import CLIPTextConfig


def openclip_vith_text_config(layer: str = "penultimate") -> CLIPTextConfig:
    """The laion/ViT-H-14 text tower (the reference's default)."""
    return CLIPTextConfig(vocab_size=49408, hidden_size=1024, intermediate_size=4096,
                          num_layers=24, num_heads=16, max_length=77, layer=layer,
                          hidden_act="gelu")


def openclip_bigg_text_config() -> CLIPTextConfig:
    """The laion/ViT-bigG-14 text tower as SDXL reads it: the state
    entering its last layer (no ln_final) as the context, and its
    ``text_projection`` [1280, 1280] for the pooled vector."""
    return CLIPTextConfig(vocab_size=49408, hidden_size=1280, intermediate_size=5120,
                          num_layers=32, num_heads=20, max_length=77, layer="hidden",
                          layer_idx=-1, hidden_act="gelu", projection_dim=1280)


def convert_openclip_text(sd: Mapping[str, np.ndarray], cfg: CLIPTextConfig
                          ) -> Dict[str, torch.Tensor]:
    """An open_clip text-tower state dict -> the port's CLIPTextModel state
    dict, fp32; ``in_proj_weight`` [3d, d] (rows q | k | v) split into
    q_proj, k_proj and v_proj."""
    t = lambda k: torch.from_numpy(np.array(sd[k], np.float32))
    out = {"token_embedding": t("token_embedding.weight"),
           "position_embedding": t("positional_embedding"),
           "final_layer_norm.weight": t("ln_final.weight"),
           "final_layer_norm.bias": t("ln_final.bias")}
    for i in range(cfg.num_layers):
        src, dst = f"transformer.resblocks.{i}.", f"layer_{i}."
        for leaf, qkv in (("weight", t(src + "attn.in_proj_weight")),
                          ("bias", t(src + "attn.in_proj_bias"))):
            for name, part in zip(("q_proj", "k_proj", "v_proj"), qkv.chunk(3)):
                out[f"{dst}self_attn.{name}.{leaf}"] = part.contiguous()
            for name, theirs in (("self_attn.out_proj", "attn.out_proj"),
                                 ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                                 ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
                out[f"{dst}{name}.{leaf}"] = t(f"{src}{theirs}.{leaf}")
    return out
