"""Base ControlNet + per-task LoRA pretraining on MultiGen-20M with the
PyTorch port (counterpart of ``scripts/train_ctrlora_pretrain.py``;
reference: scripts/train_ctrlora_pretrain.py).

Every batch carries ONE task (``MultiTaskSchedule``); its index selects the
task's LoRA bank, and the whole control branch trains (trainable='all').

  python -m ctrlora_tpu_torch.scripts.train_ctrlora_pretrain \\
      --json_dir data/multigen/json_files --meta_dir data/multigen \\
      --tasks hed canny seg depth normal openpose hedsketch bbox outpainting \\
      --sd_ckpt ckpts/v1-5-pruned.ckpt --cn_ckpt ckpts/control_init.ckpt --bs 4

The flags are the JAX script's, with --config taking a preset name or a
YAML file, plus --device (default cuda, no fallback to the CPU) and
--log_every. --tasks sets the number of LoRA banks and ``cfg.tasks``
(bank i trains on task i). ``main`` is ``parse_args``, ``build_datasets``
(one MultiGen20M per task from ``aesthetics_plus_all_group_<task>_all.json``)
and ``train`` (the run on dataset objects).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

from ctrlora_tpu_torch.configs import (
    MULTIGEN_TASKS, ModelConfig, ctrlora_pretrain_config, load_model_config,
)
from ctrlora_tpu_torch.data.datasets import MultiGen20M
from ctrlora_tpu_torch.data.scheduler import MultiTaskSchedule
from ctrlora_tpu_torch.scripts import train_common as common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--json_dir", type=str, required=True)
    p.add_argument("--meta_dir", type=str, required=True)
    p.add_argument("--tasks", nargs="+", default=list(MULTIGEN_TASKS))
    p.add_argument("--config", type=str, default=None,
                   help="preset name or YAML file (default: ctrlora_pretrain)")
    common.add_common_flags(p, bs=4, max_steps=700_000, log_freq=10_000, num_workers=16)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def model_config(args: argparse.Namespace) -> ModelConfig:
    """The preset, with --tasks as the source of the bank -> task mapping."""
    if not args.config:
        return ctrlora_pretrain_config(tasks=args.tasks, lora_rank=args.lora_rank)
    cfg = load_model_config(args.config)
    lora = dataclasses.replace(cfg.control.lora, n_loras=len(args.tasks))
    return dataclasses.replace(cfg, control=dataclasses.replace(cfg.control, lora=lora),
                               tasks=tuple(args.tasks))


def build_datasets(args: argparse.Namespace) -> list:
    return [MultiGen20M(os.path.join(args.json_dir, f"aesthetics_plus_all_group_{t}_all.json"),
                        args.meta_dir, t, drop_rate=args.drop_rate, resolution=args.resolution)
            for t in args.tasks]


def train(args: argparse.Namespace, datasets: Sequence) -> common.TrainRun:
    """The run on `datasets`, one per task in --tasks order (anything with
    ``__len__`` and ``get(idx, rng)``)."""
    if len(datasets) != len(args.tasks):
        raise ValueError(f"{len(datasets)} datasets for {len(args.tasks)} tasks")
    device = common.check_args(args)
    cfg = model_config(args)
    pipe, load_s = common.timed(lambda: common.load_training_pipeline(
        cfg, device, args.sd_ckpt, args.cn_ckpt, args.seed), device)
    schedule = MultiTaskSchedule(sizes=tuple(len(d) for d in datasets),
                                 batch_size=common.global_batch(args), seed=args.seed)
    return common.run(args, pipe, common.train_config(args, "all"), datasets, schedule,
                      {"load": load_s})


def main(argv: Optional[Sequence[str]] = None) -> common.TrainRun:
    args = parse_args(argv)
    return train(args, build_datasets(args))


if __name__ == "__main__":
    main()
