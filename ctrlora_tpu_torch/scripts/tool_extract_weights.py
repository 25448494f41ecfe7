"""Extract control or LoRA weights from a trained checkpoint (counterpart of
``scripts/tool_extract_weights.py``; reference scripts/tool_extract_weights.py),
in the reference's torch formats:

  -t control              -> control_model.* base weights (no LoRA)
  -t lora [--slot i]      -> LoRA slot i + its zero convs + norms (module keys)
  -t lora --from_base     -> one LoRA file per task / slot into a directory

  python -m ctrlora_tpu_torch.scripts.tool_extract_weights -t lora \\
      --ckpt runs/my_lora --save_path lora.ckpt [--config tiny.yaml]

--ckpt is a torch .ckpt holding reference or exported keys (the LoRA banks
read per slot, with --tasks naming the pretrain file's slots), or a
directory written by the port's ``Trainer`` (its newest ``ckpt_*.pt``:
its trainable control weights over the config's fresh control tree; the
JAX package reads an orbax TrainState directory there). The config is
--config (a preset name or YAML file), else ``ctrlora_pretrain_config``
with --from_base and ``ctrlora_finetune_config`` without. No network
runs: the control tree is built on the CPU, under seed 0 where the
checkpoint leaves a weight out.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ctrlora_tpu_torch.configs import (
    ModelConfig, ctrlora_finetune_config, ctrlora_pretrain_config, load_model_config,
)
from ctrlora_tpu_torch.scripts.tool_make_control_init import fresh_control_state
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils.loading import States, _merge, load_lora_slot_into

StateDict = Dict[str, torch.Tensor]


def model_config(args) -> ModelConfig:
    if args.config:
        return load_model_config(args.config)
    if args.from_base:
        return ctrlora_pretrain_config(lora_rank=args.lora_rank)
    return ctrlora_finetune_config(lora_rank=args.lora_rank)


def trainer_checkpoint(directory: str) -> str:
    """The newest ``ckpt_*.pt`` a Trainer wrote into `directory`."""
    found = sorted(glob.glob(os.path.join(directory, "ckpt_*.pt")))
    if not found:
        raise FileNotFoundError(f"{directory} holds no ckpt_*.pt of a Trainer")
    return found[-1]


def load_control_tree(args) -> Tuple[StateDict, ModelConfig]:
    """(the unfused control state dict, the model config)."""
    cfg = model_config(args)
    state = fresh_control_state(cfg.control)
    if os.path.isdir(args.ckpt):
        ckpt = torch.load(trainer_checkpoint(args.ckpt), map_location="cpu", weights_only=True)
        for key, value in ckpt["trainable"].items():
            if key.startswith("control."):
                state[key[len("control."):]].copy_(value)
        return state, cfg
    sd = bridge.load_torch_tensors(args.ckpt)
    _merge(state, bridge.port_entries(sd, bridge.controlnet_entries(cfg.control),
                                      prefix="control_model."))
    for slot, task in enumerate(cfg.tasks or [None]):
        load_lora_slot_into(cfg, States({}, state, {}, {}), sd, slot, task=task)
    return state, cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-t", "--type", required=True, choices=["control", "lora"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--from_base", action="store_true")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--slot", type=int, default=0)
    p.add_argument("--tasks", type=str, nargs="+", default=None,
                   help="slot->task names for --from_base output files; overrides the "
                        "config's tasks (pass the same list given to "
                        "train_ctrlora_pretrain --tasks)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """Writes the file(s) and returns {path: what was written there}."""
    args = build_parser().parse_args(argv)
    control, cfg = load_control_tree(args)
    written = {}

    def save(d, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({k: torch.from_numpy(v) for k, v in d.items()}, path)
        written[path] = d
        print(f"Extracted weights saved to {path}")

    if args.type == "control":
        save(bridge.export_control_base(control, cfg.control), args.save_path)
    elif args.from_base:
        os.makedirs(args.save_path, exist_ok=True)
        n = cfg.control.lora.n_loras
        tasks = args.tasks or cfg.tasks or [f"slot{i}" for i in range(n)]
        if len(tasks) != n:
            raise ValueError(f"{len(tasks)} task names for {n} LoRA slots")
        for slot, task in enumerate(tasks):
            save(bridge.export_lora_slot(control, cfg.control, slot=slot),
                 os.path.join(args.save_path, f"{task}.ckpt"))
    else:
        save(bridge.export_lora_slot(control, cfg.control, slot=args.slot), args.save_path)
    print("Done.")
    return written


if __name__ == "__main__":
    main()
