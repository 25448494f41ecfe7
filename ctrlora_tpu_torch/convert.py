"""Weight bridge: JAX/flax parameter trees -> the port's state dicts.

The port's submodules carry the flax scope names, so a parameter's path is
the same in both packages and only the leaf's layout changes:

* Dense ``kernel`` [in, out]          -> ``weight`` [out, in]
* Conv ``kernel`` HWIO                -> ``weight`` OIHW
* banked ZeroConv ``kernel`` [n,1,1,ci,co] -> ``weight`` [n, co, ci, 1, 1]
* GroupNorm / LayerNorm ``scale``     -> ``weight`` (banked [n, C] kept)
* ``bias``, ``lora_down`` [n, in, r], ``lora_up`` [n, r, out], the CLIP
  embeddings and the 0-d ``ip_scale`` keep their layout.

A tree without LoRA or banks (a fused control tree, the UNet, VAE and CLIP)
loads straight into the port's modules with ``load_state_dict(strict=True)``;
an unfused control tree goes through ``lora_fuse.fuse_control_tree`` first.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight"}


def port_key(path: Sequence[str]) -> str:
    """The port's state-dict key of a flax parameter path, e.g.
    ('in_1_res', 'emb_proj', 'kernel') -> 'in_1_res.emb_proj.weight'."""
    return ".".join((*path[:-1], _LEAF_NAMES.get(path[-1], path[-1])))


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return "weight", value.transpose(0, 4, 3, 1, 2)
        raise ValueError(f"kernel of rank {value.ndim}")
    return _LEAF_NAMES.get(name, name), value


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy-convertible arrays (a flax ``{'params': ...}``
    subtree or its content) -> flat state dict of contiguous torch tensors."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping[str, Any]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}.", value)
                continue
            name, arr = _leaf(key, np.asarray(value))
            # reshape: ascontiguousarray makes a 0-d leaf (ip_scale) 1-d
            out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))

    walk("", tree)
    return out
