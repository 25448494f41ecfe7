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
``lora_fuse.fuse_control_tree`` or for an unfused pipeline. The SD and
Base-ControlNet files map onto it key by key (``ckpt_torch.port_entries``:
the file's tensor, widened to fp32 once), and only the keys no file fills
are copied from the modules.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

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


def _merge(dst: StateDict, values: Dict[str, torch.Tensor]) -> None:
    """Copy port-layout tensors ({port key: tensor}, as
    ``ckpt_torch.port_entries`` gives them) into a port state dict as new
    fp32 CPU tensors; raises on a key or shape the module lacks."""
    for key, value in values.items():
        if key not in dst:
            raise KeyError(f"checkpoint maps to {key!r}, which the module does not have")
        if dst[key].shape != value.shape:
            raise ValueError(f"shape mismatch for {key}: {tuple(dst[key].shape)} vs "
                             f"{tuple(value.shape)}")
        dst[key] = value.to("cpu", torch.float32, copy=True,
                            memory_format=torch.contiguous_format)


def load_sd_into(cfg, states: States, sd: Dict[str, torch.Tensor]) -> None:
    """The SD file's UNet, VAE and CLIP keys (tensors, as
    ``ckpt_torch.load_torch_tensors`` reads them); each key the file lacks
    keeps the state's value (an SD file has no image-prompt keys: those
    come from the IP-Adapter file)."""
    ip = cfg.unet.ip_tokens > 0
    for dst, entries, prefix in (
            (states.unet, bridge.unet_entries(cfg.unet, ip=ip), "model.diffusion_model."),
            (states.vae, bridge.vae_entries(cfg.vae), "first_stage_model."),
            (states.clip, bridge.clip_entries(cfg.clip), "cond_stage_model.transformer.text_model.")):
        _merge(dst, bridge.port_entries(sd, entries, prefix=prefix))


def load_basecn_into(cfg, states: States, sd: Dict[str, torch.Tensor],
                     skip: str = "slots") -> None:
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
        _merge(states.unet, bridge.port_entries(sd, bridge.xs_control_entries(cfg)))
        return
    sd = {k: v for k, v in sd.items() if k.startswith(pfx) and keep(k[len(pfx):])}
    _merge(states.control, bridge.port_entries(sd, bridge.control_entries(cfg.control),
                                               prefix=pfx))


def load_lora_slot_into(cfg, states: States, sd: Dict[str, np.ndarray], slot: int,
                        task: Optional[str] = None) -> int:
    """One LoRA file into bank slot `slot`; returns the number of keys used."""
    sd = {k: v for k, v in sd.items() if k.startswith("control_model.")}
    style = "dict" if any(".loras_dict." in k for k in sd) else "module"
    used = bridge.load_lora_bank(sd, cfg.control, states.control, slot, key_style=style,
                                 task=task)
    used += bridge.load_switchable_bank(sd, cfg.control, states.control, slot)
    return len(used)


def _materialize(state: StateDict, own: StateDict) -> None:
    """Every value of `state` still one of the module's own tensors (`own`,
    its state dict) becomes an fp32 CPU copy of it."""
    for key, value in state.items():
        if value is own.get(key):
            state[key] = value.to("cpu", torch.float32, copy=True)


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
    # the modules' own tensors, not copied: only those no file replaces are
    # copied (``_materialize``)
    own = States(pipe.unet.state_dict(), {} if control is None else control.state_dict(),
                 pipe.vae.state_dict(), pipe.clip.state_dict())
    states = States(*(dict(s) for s in own))
    if sd_file:
        load_sd_into(cfg, states, bridge.load_torch_tensors(sd_file))
    if basecn_file:
        load_basecn_into(cfg, states, bridge.load_torch_tensors(basecn_file),
                         skip=basecn_skip)
    for state, mine in zip(states, own):  # the LoRA files write into the banks in place
        _materialize(state, mine)
    for i, lf in enumerate(lora_files):
        n = load_lora_slot_into(cfg, states, bridge.load_torch_state_dict(lf), i,
                                task=tasks[i] if tasks else None)
        if n == 0:
            raise ValueError(f"no LoRA keys found in {lf}")
    return states
