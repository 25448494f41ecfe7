"""Initialise a ControlNet from the SD UNet's encoder (counterpart of
``scripts/tool_make_control_init.py``; reference
scripts/tool_make_control_init.py): every ``control_model.<name>`` that the
SD checkpoint has as ``model.diffusion_model.<name>`` is copied from it; the
layers the UNet lacks keep a fresh initialisation (the zero convs start at
zero, the hint block of --hint_mode image at torch's init under seed 0)
and are listed. Writes a fp32 torch checkpoint of ``control_model.*`` keys
that the trainers' --cn_ckpt reads.

  python -m ctrlora_tpu_torch.scripts.tool_make_control_init \\
      --sd_ckpt sd15.ckpt --output_path control_init.ckpt [--hint_mode image]

No network runs: the fresh ControlNet is built on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ctrlora_tpu_torch.configs import ControlNetConfig, LoRAConfig
from ctrlora_tpu_torch.pipeline import build_control
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils.loading import _merge

INIT_SEED = 0


def fresh_control_state(cfg: ControlNetConfig) -> Dict[str, torch.Tensor]:
    """An unfused control module of `cfg`, built on the CPU under seed
    INIT_SEED: its state dict."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INIT_SEED)
        control = build_control(cfg, fuse_lora=False)
    return control.state_dict()


def make_control_init(sd: Dict[str, np.ndarray], cfg: ControlNetConfig
                      ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """(control_model.* arrays, the control keys the SD file does not have);
    `sd` holds numpy arrays or tensors."""
    state = fresh_control_state(cfg)
    _merge(state, bridge.port_entries(sd, bridge.unet_entries(cfg.unet, decoder=False),
                                      prefix="model.diffusion_model."))
    out = bridge.export_tree(state, bridge.controlnet_entries(cfg), prefix="control_model.")
    new = [t for t, _, _ in bridge.controlnet_entries(cfg)
           if "model.diffusion_model." + t not in sd]
    return out, new


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sd_ckpt", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--hint_mode", choices=["latent", "image"], default="latent")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Writes --output_path and returns what it wrote."""
    args = build_parser().parse_args(argv)
    cfg = ControlNetConfig(hint_mode=args.hint_mode, lora=LoRAConfig(n_loras=0))
    out, new = make_control_init(bridge.load_torch_tensors(args.sd_ckpt), cfg)
    for k in new:
        print(f"These weights are newly added: control_model.{k}")
    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)), exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in out.items()}, args.output_path)
    print("Done.")
    return out


if __name__ == "__main__":
    main()
