"""LoRA fusion and the inference cast (counterpart of
``ctrlora_tpu/lora_fuse.py``).

``W_fused = W + scale * (down[slot] @ up[slot])^T`` folds one adapter into
every LoRA site's Linear weight, and the slot's zero-conv and norm banks are
selected, so the sampler's control branch runs with no LoRA ops at all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn

from ctrlora_tpu_torch.configs import ControlNetConfig, LoRAConfig
from ctrlora_tpu_torch.models.layers import GroupNorm32, LayerNorm32


def fused_control_config(cfg: ControlNetConfig) -> ControlNetConfig:
    """Config of the fused tree: no LoRA params, no banks."""
    return dataclasses.replace(cfg, lora=LoRAConfig(n_loras=0))


def fuse_control_tree(control: nn.Module, state: Mapping[str, torch.Tensor], slot: int,
                      lora: LoRAConfig, lora_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Fold adapter `slot` of an unfused control state dict (as
    ``convert.params_from_jax`` gives it: ``<site>.lora_down`` [n, in, r],
    ``<site>.lora_up`` [n, r, out], banked leaves with a leading [n] axis)
    into a state dict that loads into `control`, a fused-config ControlNet,
    with ``strict=True``. `control` only supplies the target shapes."""
    alpha = (lora.network_alpha / lora.rank) if lora.network_alpha else 1.0
    scale = lora_scale * alpha
    target = control.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith((".lora_down", ".lora_up")):
            continue
        site = key.rsplit(".", 1)[0]
        if key.endswith(".weight") and f"{site}.lora_down" in state:
            down = state[f"{site}.lora_down"][slot].float()
            up = state[f"{site}.lora_up"][slot].float()
            value = (value.float() + scale * (down @ up).T).to(value.dtype)
        elif lora.switchable_banks and value.ndim == target[key].ndim + 1:
            value = value[slot]
        out[key] = value
    return out


def cast_params_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast Dense and Conv weights and biases to the compute dtype once;
    norm affines stay fp32 (they are applied in fp32). Then derive the
    fused projection weights (``CrossAttention.fuse_projections``)."""
    for m in module.modules():
        if isinstance(m, (GroupNorm32, LayerNorm32)):
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    for m in module.modules():
        if hasattr(m, "fuse_projections"):
            m.fuse_projections()
    return module
