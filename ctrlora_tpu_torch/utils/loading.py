"""Checkpoint composition of the port: SD + Base ControlNet + per-slot
LoRAs -> the four state dicts (counterpart of ``ctrlora_tpu/utils/loading.py``).

The reference's three-stage partial load:
  1. the SD checkpoint fills the UNet, VAE and CLIP;
  2. the Base-ControlNet checkpoint fills the control branch's base weights,
     skipping the LoRA, zero-conv and norm keys (``check_key``); for
     ControlNet-XS, a control file in TwoStreamControlNet's layout
     (``ckpt_torch.xs_control_entries``) fills the XS UNet's control stream,
     zero convs and hint encoder;
  3. LoRA checkpoint i fills bank slot i: its LoRA matrices, and its zero
     convs and transformer norms (switchable banks).

The result is in the port's state-dict layout (``convert.params_from_jax``):
fp32 CPU tensors, the control dict unfused with its [n] banks, ready for
``lora_fuse.fuse_control_tree`` or for an unfused pipeline.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch import convert
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline, build_control
from ctrlora_tpu_torch.utils import ckpt_torch as bridge

StateDict = Dict[str, torch.Tensor]


class States(NamedTuple):
    unet: StateDict
    control: StateDict
    vae: StateDict
    clip: StateDict


def check_key(k: str) -> bool:
    """Keys that belong to a LoRA slot (the reference api.py's rule)."""
    return "lora_layer" in k or "zero_convs" in k or "middle_block_out" in k or "norm" in k


def _merge(dst: StateDict, tree: dict) -> None:
    """Copy a flax-layout tree into a port state dict, through
    ``convert.params_from_jax``; raises on a key or shape the module lacks."""
    if not tree:
        return
    for key, value in convert.params_from_jax(tree).items():
        if key not in dst:
            raise KeyError(f"checkpoint maps to {key!r}, which the module does not have")
        if dst[key].shape != value.shape:
            raise ValueError(f"shape mismatch for {key}: {tuple(dst[key].shape)} vs "
                             f"{tuple(value.shape)}")
        dst[key] = value.float()


def load_sd_into(cfg, states: States, sd: Dict[str, np.ndarray]) -> None:
    """The SD file's UNet, VAE and CLIP keys; each key the file lacks keeps
    the state's value (an SD file has no image-prompt keys: those come from
    the IP-Adapter file)."""
    ip = cfg.unet.ip_tokens > 0
    for dst, entries, prefix in (
            (states.unet, bridge.unet_entries(cfg.unet, ip=ip), "model.diffusion_model."),
            (states.vae, bridge.vae_entries(cfg.vae), "first_stage_model."),
            (states.clip, bridge.clip_entries(cfg.clip), "cond_stage_model.transformer.text_model.")):
        tree, _ = bridge.convert_tree(sd, entries, prefix=prefix, strict=False)
        _merge(dst, tree)


def load_basecn_into(cfg, states: States, sd: Dict[str, np.ndarray], skip: str = "slots") -> None:
    """skip='slots': the inference rule, without LoRA, zero convs and norms
    (they come from the LoRA files); skip='lora': the finetune-init rule,
    everything but the LoRA keys."""
    pfx = "control_model."
    if skip == "slots":
        keep = lambda k: not check_key(k)
    elif skip == "lora":
        keep = lambda k: "lora" not in k
    else:
        raise ValueError(f"skip must be 'slots' or 'lora', got {skip!r}")
    if cfg.control.variant == "xs":  # the control keys of the XS tree, into the XS UNet
        sd = {k: v for k, v in sd.items() if keep(k)}
        tree, _ = bridge.convert_tree(sd, bridge.xs_control_entries(cfg), strict=False)
        _merge(states.unet, tree)
        return
    sd = {k: v for k, v in sd.items() if k.startswith(pfx) and keep(k[len(pfx):])}
    tree, _ = bridge.convert_tree(sd, bridge.control_entries(cfg.control), prefix=pfx,
                                  strict=False)
    _merge(states.control, tree)


def load_lora_slot_into(cfg, states: States, sd: Dict[str, np.ndarray], slot: int,
                        task: Optional[str] = None) -> int:
    """One LoRA file into bank slot `slot`; returns the number of keys used."""
    sd = {k: v for k, v in sd.items() if k.startswith("control_model.")}
    style = "dict" if any(".loras_dict." in k for k in sd) else "module"
    used = bridge.load_lora_bank(sd, cfg.control, states.control, slot, key_style=style,
                                 task=task)
    used += bridge.load_switchable_bank(sd, cfg.control, states.control, slot)
    return len(used)


def _cpu_state(module: torch.nn.Module) -> StateDict:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in module.state_dict().items()}


def load_ctrlora(pipe: CtrLoraPipeline, sd_file: Optional[str] = None,
                 basecn_file: Optional[str] = None, lora_files: Sequence[str] = (),
                 tasks: Optional[Sequence[str]] = None, basecn_skip: str = "slots") -> States:
    """The four state dicts from reference checkpoint files. A stage given as
    None keeps the modules' own initialisation: the pipeline's UNet, VAE and
    CLIP, and its control tree unless that is a fused LoRA tree, which is
    replaced by a freshly initialised unfused one of the same variant
    (``build_control(fuse_lora=False)``). The result lives on the CPU."""
    cfg = pipe.cfg
    control = pipe.control
    if pipe.fuse_lora and cfg.control.lora.n_loras > 0:
        with pipe.device:  # initialised where the pipeline lives (fast on a card)
            control = build_control(cfg.control, fuse_lora=False)
    states = States(_cpu_state(pipe.unet), {} if control is None else _cpu_state(control),
                    _cpu_state(pipe.vae), _cpu_state(pipe.clip))
    if sd_file:
        load_sd_into(cfg, states, bridge.load_torch_state_dict(sd_file))
    if basecn_file:
        load_basecn_into(cfg, states, bridge.load_torch_state_dict(basecn_file),
                         skip=basecn_skip)
    for i, lf in enumerate(lora_files):
        n = load_lora_slot_into(cfg, states, bridge.load_torch_state_dict(lf), i,
                                task=tasks[i] if tasks else None)
        if n == 0:
            raise ValueError(f"no LoRA keys found in {lf}")
    return states
