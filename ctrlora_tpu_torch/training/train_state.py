"""Trainable-parameter masks, the optimizer and the train state
(counterpart of ``ctrlora_tpu/training/train_state.py``).

The reference's trainable-set rules (cldm/cldm_ctrlora_finetune.py:84-108,
cldm_ctrlora_pretrain.py:174-182, cldm/cldm.py:419-426), as predicates over
the dotted parameter names, which carry the flax scope names:

  * trainable='all'  - every control-branch parameter (pretrain)
  * trainable='lora' - LoRA matrices + zero convs (if zero_trainable) +
                       transformer norms (if norm_trainable)
  * trainable='full' - every control parameter except LoRA

With sd_locked=False the UNet decoder (out_* blocks, norm_out, conv_out)
trains too. ControlNet-XS (the pipeline's XS UNet, no control module)
trains every parameter whose top-level name starts with ``ctrl_``,
``enc_zero_``, ``dec_zero_``, ``mid_zero_`` or ``hint_block``, whatever the
mode, and never its base stream (JAX ``unet_trainable(xs=True)``). Frozen
parameters get ``requires_grad_(False)`` and AdamW never sees them, as in
the reference; so no gradient is computed for them, while the gradient
still flows through their activations (the XS base stream's too).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.models.xs import XS_TRAINABLE_PREFIXES
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.training.ema import EmaState

# transformer norms are the modules literally named norm/norm1/norm2/norm3
# (ResBlock norms are in_norm/out_norm and never match)
_NORM_NAMES = {"norm", "norm1", "norm2", "norm3"}

Mask = Dict[str, Dict[str, bool]]  # {branch: {parameter name: trains}}


def control_trainable(name: str, cfg: TrainConfig) -> bool:
    names = name.split(".")
    is_lora = any(n in ("lora_down", "lora_up") for n in names)
    if cfg.trainable == "all":
        return True
    if cfg.trainable == "full":
        return not is_lora
    if cfg.trainable == "lora":
        return (is_lora or (cfg.zero_trainable and any(n.startswith("zero_") for n in names))
                or (cfg.norm_trainable and any(n in _NORM_NAMES for n in names)))
    raise ValueError(f"unknown trainable mode {cfg.trainable!r}")


def unet_trainable(name: str, cfg: TrainConfig) -> bool:
    if cfg.sd_locked:
        return False
    top = name.split(".")[0]
    return top.startswith("out_") or top in ("norm_out", "conv_out")


def xs_trainable(name: str, cfg: TrainConfig) -> bool:
    return name.split(".")[0].startswith(XS_TRAINABLE_PREFIXES)


def branches(pipe: CtrLoraPipeline) -> Dict[str, nn.Module]:
    """The pipeline's modules by branch name (no 'control' for XS)."""
    out = {"unet": pipe.unet, "control": pipe.control, "vae": pipe.vae, "clip": pipe.clip}
    return {k: m for k, m in out.items() if m is not None}


def trainable_mask(pipe: CtrLoraPipeline, cfg: TrainConfig) -> Mask:
    """{branch: {parameter name: True where it trains}}; VAE and CLIP are
    always frozen."""
    rules = {"unet": xs_trainable if pipe.is_xs else unet_trainable,
             "control": control_trainable}
    return {branch: {name: branch in rules and rules[branch](name, cfg)
                     for name, _ in module.named_parameters()}
            for branch, module in branches(pipe).items()}


def trainable_parameters(pipe: CtrLoraPipeline, mask: Mask) -> Dict[str, nn.Parameter]:
    """{'branch.name': parameter} of the trainable set, in module order."""
    return {f"{branch}.{name}": p
            for branch, module in branches(pipe).items()
            for name, p in module.named_parameters() if mask[branch][name]}


def count_trainable(pipe: CtrLoraPipeline, mask: Mask) -> int:
    return sum(p.numel() for p in trainable_parameters(pipe, mask).values())


def make_optimizer(pipe: CtrLoraPipeline, cfg: TrainConfig, mask: Mask, mesh=None):
    """Freeze everything outside the mask (``requires_grad_(False)``) and
    return AdamW over the trainable parameters only (torch's defaults:
    betas 0.9/0.999, eps 1e-8, weight decay 1e-2; decoupled decay). With
    ``cfg.shard_opt_state`` over a `mesh` in a process group, the AdamW
    state is sharded over the data ranks (``parallel.mesh.ShardedOptimizer``);
    without a group it stays whole (one rank keeps all of it)."""
    for branch, module in branches(pipe).items():
        for name, p in module.named_parameters():
            p.requires_grad_(mask[branch][name])
    params: List[nn.Parameter] = list(trainable_parameters(pipe, mask).values())
    adamw = lambda ps: torch.optim.AdamW(ps, lr=cfg.learning_rate,
                                         betas=(cfg.adam_b1, cfg.adam_b2),
                                         eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    if cfg.shard_opt_state and mesh is not None and mesh.distributed:
        from ctrlora_tpu_torch.parallel.mesh import ShardedOptimizer

        return ShardedOptimizer(params, mesh, adamw)
    return adamw(params)


@dataclasses.dataclass
class TrainState:
    """The step count, the modules (their parameters are the train state),
    the optimizer holding the AdamW moments, the trainable parameters by
    'branch.name', and their EMA shadow when ``use_ema`` is set."""

    step: int
    modules: Dict[str, nn.Module]
    optimizer: torch.optim.Optimizer
    trainable: Dict[str, nn.Parameter] = dataclasses.field(default_factory=dict)
    ema: Optional[EmaState] = None
