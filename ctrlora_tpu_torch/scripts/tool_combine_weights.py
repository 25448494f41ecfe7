"""Combine SD + Base ControlNet + LoRA into one torch checkpoint
(counterpart of ``scripts/tool_combine_weights.py``; reference
scripts/tool_combine_weights.py): a plain dict union, SD's ``model_ema.*``
keys left out, plus a zero ``logvar`` [1000] buffer, written in fp32.

  python -m ctrlora_tpu_torch.scripts.tool_combine_weights --lora_ckpt l.ckpt \\
      --save_path combined.ckpt [--sd_ckpt sd.ckpt --base_ckpt basecn.ckpt]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from ctrlora_tpu_torch.utils.ckpt_torch import load_torch_state_dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sd_ckpt", default="./ckpts/sd15/v1-5-pruned.ckpt")
    p.add_argument("--base_ckpt", default="./ckpts/ctrlora-basecn/ctrlora_sd15_basecn700k.ckpt")
    p.add_argument("--lora_ckpt", required=True)
    p.add_argument("--save_path", required=True)
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """Writes --save_path and returns what it wrote."""
    args = build_parser().parse_args(argv)
    ckpt = {k: v for k, v in load_torch_state_dict(args.sd_ckpt).items()
            if not k.startswith("model_ema.")}
    ckpt.update(load_torch_state_dict(args.base_ckpt))
    ckpt.update(load_torch_state_dict(args.lora_ckpt))
    out = {k: torch.from_numpy(v) for k, v in ckpt.items()}
    out["logvar"] = torch.zeros(1000)
    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    torch.save(out, args.save_path)
    print(f"Saved combined weights to [{args.save_path}]")
    return out


if __name__ == "__main__":
    main()
