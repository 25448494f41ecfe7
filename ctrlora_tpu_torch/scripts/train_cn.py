"""Baseline trainers with the PyTorch port: the vanilla image-hint
ControlNet, ControlNet-Lite and ControlNet-XS (counterpart of
``scripts/train_cn.py``; reference: scripts/train_cn.py, train_cnlite.py,
train_cnxs.py). The trainer of the CtrLoRA CLIs, with the pixel hint as the
condition and every control parameter trainable (trainable='all'); the UNet
(XS: its base stream) stays frozen.

  python -m ctrlora_tpu_torch.scripts.train_cn --variant controlnet \\
      --dataroot data/mycondition --sd_ckpt ckpts/v1-5-pruned.ckpt \\
      --cn_ckpt ckpts/control_sd15_init.ckpt --bs 4 --gradacc 2 -n cn_mycondition
  python -m ctrlora_tpu_torch.scripts.train_cn --variant lite ...
  python -m ctrlora_tpu_torch.scripts.train_cn --variant xs \\
      --config configs/cnxs_sd15.yaml ...

The flags are the JAX script's, with --config taking a preset name or a
YAML file (``configs.load_model_config``), plus --device (default cuda; the
script never falls back to the CPU, ask for it with --device cpu) and
--log_every. --multigen20m reads
``<dataroot>/json_files/aesthetics_plus_all_group_<task>_all.json``;
--subset N trains on the first N examples. --cn_ckpt fills every control
key but LoRA ones (XS: a file in TwoStreamControlNet's layout); what no
file gives keeps the initialisation seeded with --seed. Images are resized
to 512^2 (``RESOLUTION``), as the reference trains the baselines. Under
torchrun, --tp and --shard_opt_state split the run over the ranks
(``train_common``). ``main`` is ``parse_args``, ``build_datasets``
(the files) and ``train`` (the run on dataset objects).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ctrlora_tpu_torch.configs import (
    ModelConfig, cnlite_config, cnxs_config, load_model_config, sd15_config,
)
from ctrlora_tpu_torch.data.datasets import CustomDataset, MultiGen20M
from ctrlora_tpu_torch.data.scheduler import SingleTaskSchedule
from ctrlora_tpu_torch.scripts import train_common as common

RESOLUTION = 512  # the image size of the baselines' training data
PRESETS = {"controlnet": sd15_config, "lite": cnlite_config, "xs": cnxs_config}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", choices=["controlnet", "lite", "xs"], default="controlnet")
    p.add_argument("--dataroot", type=str, required=True)
    p.add_argument("--multigen20m", action="store_true")
    p.add_argument("--task", type=str, default=None)
    p.add_argument("--subset", type=int, default=0, help="train on the first N examples")
    p.add_argument("--config", type=str, default=None,
                   help="preset name or YAML file (default: the variant's preset, "
                        "cldm_v15, cnlite_sd15 or cnxs_sd15)")
    common.add_common_flags(p, bs=1, max_steps=100_000, log_freq=1000, num_workers=16,
                            baseline=True)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.multigen20m and not args.task:
        raise SystemExit("--multigen20m requires --task")
    return args


def model_config(args: argparse.Namespace) -> ModelConfig:
    return load_model_config(args.config) if args.config else PRESETS[args.variant]()


def build_datasets(args: argparse.Namespace) -> list:
    """The one dataset the flags name, read from its files."""
    if args.multigen20m:
        return [MultiGen20M(os.path.join(args.dataroot, "json_files",
                                         f"aesthetics_plus_all_group_{args.task}_all.json"),
                            args.dataroot, args.task, drop_rate=args.drop_rate,
                            resolution=RESOLUTION)]
    return [CustomDataset(args.dataroot, drop_rate=args.drop_rate, resolution=RESOLUTION)]


def train(args: argparse.Namespace, datasets: Sequence) -> common.TrainRun:
    """The run on `datasets` (one dataset: anything with ``__len__`` and
    ``get(idx, rng)``)."""
    device = common.check_args(args)
    cfg = model_config(args)
    pipe, load_s = common.timed(lambda: common.load_training_pipeline(
        cfg, device, args.sd_ckpt, args.cn_ckpt, args.seed), device)
    (ds,) = datasets
    size = min(len(ds), args.subset) if args.subset > 0 else len(ds)
    schedule = SingleTaskSchedule(size=size, batch_size=common.global_batch(args),
                                  seed=args.seed)
    return common.run(args, pipe, common.train_config(args, "all"), [ds], schedule,
                      {"load": load_s})


def main(argv: Optional[Sequence[str]] = None) -> common.TrainRun:
    args = parse_args(argv)
    return train(args, build_datasets(args))


if __name__ == "__main__":
    main()
