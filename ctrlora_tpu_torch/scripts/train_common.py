"""What the training CLIs (finetune, pretrain and the baselines' train_cn)
share: their common flags, the device check, the training pipeline from
reference-format checkpoints, the global batch, and the run from a loader
to the last checkpoint.

--gradacc N: the loader's global batch is N x --bs examples of one task,
split into N micro-batches of --bs for the step, whose gradient is their
mean (the JAX CLIs hand the step a --bs batch with no micro-batch axis and
fail there).

Several ranks (``torchrun --nproc_per_node N -m ctrlora_tpu_torch.scripts.
<cli> ...``): each rank joins the process group (``parallel.mesh.
init_distributed``, NCCL on ``cuda:LOCAL_RANK``, gloo with --device cpu),
--bs stays the global batch, and each rank's loader reads that rank's rows
of it (of each micro-batch under --gradacc), with the one-rank run's
per-example draws. --tp N splits the attention heads and GEGLU hidden over
N model ranks; --shard_opt_state deals the AdamW state over the data ranks.
Only rank 0 writes the run's files."""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import time
from typing import Dict, Sequence

import torch

from ctrlora_tpu_torch.configs import ModelConfig, TrainConfig
from ctrlora_tpu_torch.data.loader import Loader, to_device
from ctrlora_tpu_torch.parallel.mesh import init_distributed, rank_device
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.training.step import split_micro_batches
from ctrlora_tpu_torch.training.trainer import Trainer, make_image_log_hook
from ctrlora_tpu_torch.utils.loading import load_ctrlora


def add_common_flags(p: argparse.ArgumentParser, bs: int, max_steps: int, log_freq: int,
                     num_workers: int, baseline: bool = False) -> None:
    """The flags the JAX training scripts take (their defaults differ; the
    baselines' script, `baseline`, has no --resolution or --lora_rank and
    takes -n for --name), and the port's --device and --log_every."""
    p.add_argument("--sd_ckpt", type=str, default=None)
    p.add_argument("--cn_ckpt", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="a ckpt_*.pt of an earlier run (Trainer.save)")
    if not baseline:
        p.add_argument("--resolution", type=int, default=512)
        p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--bs", type=int, default=bs)
    p.add_argument("--gradacc", type=int, default=1,
                   help="micro-batches of --bs a step (their gradients averaged)")
    p.add_argument("--max_steps", type=int, default=max_steps)
    p.add_argument("--drop_rate", type=float, default=0.3)
    p.add_argument("--img_logger_freq", type=int, default=log_freq)
    p.add_argument("--ckpt_logger_freq", type=int, default=log_freq)
    p.add_argument(*(("-n", "--name") if baseline else ("--name",)), type=str, default=None,
                   help="the run's directory under runs/ (an absolute path is used as it is)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: train over a (data, model) mesh with attention "
                        "heads / GEGLU hidden sharded over N-way model parallelism (must "
                        "divide the ranks; parallel/tp.py)")
    p.add_argument("--use_ema", action="store_true", help="EMA of trainable params")
    p.add_argument("--shard_opt_state", action="store_true",
                   help="ZeRO-style Adam-moment sharding over the data ranks")
    p.add_argument("--num_workers", type=int, default=num_workers)
    p.add_argument("--log_every", type=int, default=100, help="steps per metrics line")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (no fallback to the CPU)")


def check_args(args: argparse.Namespace) -> torch.device:
    """The device to train on; joins the process group where one is
    configured (torchrun's environment), and then the rank's device."""
    if args.gradacc < 1:
        raise ValueError(f"--gradacc must be >= 1, got {args.gradacc}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; pass --device cpu "
                         "to train on the CPU")
    init_distributed(device=None if args.device == "cuda" else device)
    return rank_device() or device


def load_training_pipeline(cfg: ModelConfig, device, sd_ckpt, cn_ckpt,
                           seed: int) -> CtrLoraPipeline:
    """The unfused pipeline with the SD checkpoint and every Base ControlNet
    key but the LoRA's (``basecn_skip='lora'``, as the JAX scripts load
    it); what no file gives keeps the initialisation seeded with `seed`."""
    torch.manual_seed(seed)
    pipe = CtrLoraPipeline(cfg, device, fuse_lora=False)
    pipe.load_state_dicts(*load_ctrlora(pipe, sd_ckpt, cn_ckpt, basecn_skip="lora"))
    return pipe


def global_batch(args: argparse.Namespace) -> int:
    """Examples a step: --bs for each of --gradacc micro-batches."""
    return args.bs * args.gradacc


def train_config(args: argparse.Namespace, trainable: str, **kw) -> TrainConfig:
    return TrainConfig(learning_rate=args.lr, batch_size=args.bs, grad_accum=args.gradacc,
                       max_steps=args.max_steps, trainable=trainable, seed=args.seed,
                       log_every=args.log_every, ckpt_every=args.ckpt_logger_freq,
                       image_log_every=args.img_logger_freq, use_ema=args.use_ema,
                       shard_opt_state=args.shard_opt_state, **kw)


@dataclasses.dataclass
class TrainRun:
    """What a CLI run leaves: its trainer (the state at the end), its
    loader (``wait_s``, ``last_step``), its directory and its set-up times
    in seconds ('load': the pipeline and its checkpoints; 'precompute':
    the latent cache's pre-pass)."""

    trainer: Trainer
    loader: Loader
    workdir: str
    seconds: Dict[str, float]


def run(args: argparse.Namespace, pipe: CtrLoraPipeline, tcfg: TrainConfig,
        datasets: Sequence, schedule, seconds: Dict[str, float]) -> TrainRun:
    """Trainer (restored from --resume), loader from the train state's step
    (`schedule` gives ``global_batch(args)`` examples a step), split into
    micro-batches under --gradacc, image-log hook, fit to --max_steps, and
    a checkpoint of the last step."""
    name = args.name or datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    workdir = os.path.join("runs", name)
    trainer = Trainer(pipe, tcfg, workdir, tp=args.tp)
    if args.resume:
        trainer.restore(args.resume)
    mesh = trainer.mesh
    loader = Loader(datasets, schedule, num_workers=args.num_workers,
                    max_length=pipe.cfg.clip.max_length,
                    host_id=0 if mesh is None else mesh.data_index,
                    host_count=1 if mesh is None else mesh.dp, micro=tcfg.grad_accum)
    hook = make_image_log_hook(pipe, workdir) if trainer.is_main else None
    batches = loader.iterate(trainer.state.step)
    on_device = (to_device(b, pipe.device) for b in batches)
    if tcfg.grad_accum > 1:
        on_device = (split_micro_batches(b, tcfg.grad_accum) for b in on_device)
    trainer.fit(on_device, sample_hook=hook, global_batches=False)
    batches.close()
    if trainer.state.step % tcfg.ckpt_every:
        trainer.save(trainer.state.step)
    return TrainRun(trainer, loader, workdir, seconds)


def timed(fn, device):
    """(fn(), seconds), the device's queue drained before the clock stops."""
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0
