"""Novel-condition LoRA finetune with the PyTorch port (counterpart of
``scripts/train_ctrlora_finetune.py``; reference:
scripts/train_ctrlora_finetune.py).

  python -m ctrlora_tpu_torch.scripts.train_ctrlora_finetune \\
      --dataroot data/mycondition --sd_ckpt ckpts/v1-5-pruned.ckpt \\
      --cn_ckpt ckpts/ctrlora_sd15_basecn700k.ckpt \\
      --lora_rank 128 --bs 1 --max_steps 1000 --name mycondition

  # one MultiGen-20M task:
  python -m ctrlora_tpu_torch.scripts.train_ctrlora_finetune \\
      --multigen_json path/to/task.json --multigen_meta path/to/meta --task hed ...

The flags are the JAX script's, with --config taking a preset name or a
YAML file, plus --device (default cuda; the script never falls back to the CPU,
ask for it with --device cpu) and --log_every. --resume takes a
``ckpt_*.pt`` of an earlier run and the loader resumes at its step;
--cache_latents encodes a --dataroot dataset's VAE posterior moments once
and trains from them. Under torchrun, --tp and --shard_opt_state split
the run over the ranks (``train_common``). ``main`` is ``parse_args``,
``build_datasets`` (the files) and
``train`` (the run on dataset objects).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ctrlora_tpu_torch.configs import ctrlora_finetune_config, load_model_config
from ctrlora_tpu_torch.data.datasets import CustomDataset, MultiGen20M
from ctrlora_tpu_torch.data.scheduler import SingleTaskSchedule
from ctrlora_tpu_torch.scripts import train_common as common
from ctrlora_tpu_torch.training.latent_cache import LatentCachedDataset, precompute_moments


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataroot", type=str, help="CustomDataset root")
    p.add_argument("--multigen_json", type=str)
    p.add_argument("--multigen_meta", type=str)
    p.add_argument("--task", type=str, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="preset name or YAML file (default: ctrlora_finetune)")
    p.add_argument("--ft_with_lora", action="store_true", default=True)
    p.add_argument("--no_lora", dest="ft_with_lora", action="store_false")
    p.add_argument("--norm_trainable", action="store_true", default=True)
    p.add_argument("--cache_latents", action="store_true",
                   help="encode the dataset's VAE posterior moments once and train from "
                        "the cache (--dataroot only: MultiGen's random crop defeats it)")
    common.add_common_flags(p, bs=1, max_steps=100_000, log_freq=1000, num_workers=8)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.cache_latents and not args.dataroot:
        raise SystemExit("--cache_latents requires --dataroot "
                         "(MultiGen's random crop defeats the cache)")
    if not args.dataroot and not (args.multigen_json and args.multigen_meta and args.task):
        raise SystemExit("give --dataroot, or --multigen_json, --multigen_meta and --task")
    return args


def build_datasets(args: argparse.Namespace) -> list:
    """The one dataset the flags name, read from its files."""
    if args.dataroot:
        return [CustomDataset(args.dataroot, drop_rate=args.drop_rate,
                              resolution=args.resolution)]
    return [MultiGen20M(args.multigen_json, args.multigen_meta, args.task,
                        drop_rate=args.drop_rate, resolution=args.resolution)]


def train(args: argparse.Namespace, datasets: Sequence) -> common.TrainRun:
    """The run on `datasets` (one dataset: a CustomDataset for
    --cache_latents, or anything with ``__len__`` and ``get(idx, rng)``)."""
    device = common.check_args(args)
    cfg = (load_model_config(args.config) if args.config else
           ctrlora_finetune_config(lora_rank=args.lora_rank, ft_with_lora=args.ft_with_lora))
    pipe, load_s = common.timed(lambda: common.load_training_pipeline(
        cfg, device, args.sd_ckpt, args.cn_ckpt, args.seed), device)
    seconds = {"load": load_s}
    (ds,) = datasets
    if args.cache_latents:
        (jm, hm), seconds["precompute"] = common.timed(lambda: precompute_moments(pipe, ds),
                                                       device)
        ds = LatentCachedDataset(ds, jm, hm)
    tcfg = common.train_config(args, "lora" if args.ft_with_lora else "full",
                               norm_trainable=args.norm_trainable)
    schedule = SingleTaskSchedule(size=len(ds), batch_size=common.global_batch(args),
                                  seed=args.seed)
    return common.run(args, pipe, tcfg, [ds], schedule, seconds)


def main(argv: Optional[Sequence[str]] = None) -> common.TrainRun:
    args = parse_args(argv)
    return train(args, build_datasets(args))


if __name__ == "__main__":
    main()
