"""Batch sampling over a dataset with the PyTorch port (counterpart of
``scripts/sample.py``).

Writes sample/, control/ and img/ (PNG, one per dataset item) and
prompt.txt under --save_dir, sampling each item of a CustomDataset
directory with DDIM, PLMS or DPM-Solver and classifier-free guidance, on
top of an SD checkpoint and a Base ControlNet, with a LoRA from a
reference-format ``.ckpt`` or from the port trainer's ``ckpt_*.pt``:

  python -m ctrlora_tpu_torch.scripts.sample --dataroot data/mycond \\
      --sd_ckpt ckpts/sd15/v1-5-pruned.ckpt --cn_ckpt ckpts/basecn.ckpt \\
      --lora_ckpt runs/mycond/ckpt_00001000.pt --save_dir out --n_samples 4

The flags and defaults are the JAX script's, with --device (default cuda;
the script never falls back to the CPU, ask for it with --device cpu).
``sample_batch`` is the per-batch work on arrays, and needs neither cv2 nor
PIL; only reading the dataset and writing the PNGs do.

Several ranks (``torchrun --nproc_per_node N -m ctrlora_tpu_torch.scripts.
sample ... --dp`` or ``--tp T``; gloo ranks with --device cpu): every rank
loads the same weights, draws the global batch's starting noise (and eta
draws) and samples its rows (``parallel.mesh.dp_sample``; under --tp with
the attention heads and GEGLU hidden split over T model ranks,
``parallel.tp.tp_sample``); rank 0 gathers the rows and writes the files,
which equal the one-rank run's.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch import lora_fuse
from ctrlora_tpu_torch.configs import ModelConfig, ctrlora_finetune_config, load_model_config
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.parallel.mesh import (
    create_mesh, create_mesh_2d, dp_sample, init_distributed, process_index, rank_device,
    replicate, world_size,
)
from ctrlora_tpu_torch.parallel.tp import tp_sample
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import draw_normal
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample, make_ddim_schedule
from ctrlora_tpu_torch.sampling.dpm_solver import (
    dpm_solver_sample, dpm_solver_singlestep_sample,
)
from ctrlora_tpu_torch.sampling.plms import plms_sample
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import trace
from ctrlora_tpu_torch.utils.image import write_png
from ctrlora_tpu_torch.utils.loading import States, load_ctrlora, load_lora_slot_into
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataroot", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--sd_ckpt", type=str, default=None)
    p.add_argument("--cn_ckpt", type=str, default=None)
    p.add_argument("--lora_ckpt", type=str, default=None,
                   help="a reference-format LoRA .ckpt, or the port trainer's ckpt_*.pt")
    p.add_argument("--config", type=str, default=None,
                   help="preset name or YAML file (default: ctrlora_finetune)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--n_samples", type=int, default=-1, help="-1 = all")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "plms", "dpm_solver"])
    p.add_argument("--dpm_order", type=int, default=2, choices=[1, 2, 3])
    p.add_argument("--dpm_method", type=str, default="multistep",
                   choices=["multistep", "singlestep"])
    p.add_argument("--dpm_algorithm", type=str, default="dpmsolver++",
                   choices=["dpmsolver++", "dpmsolver"])
    p.add_argument("--dpm_thresholding", action="store_true",
                   help="dynamic thresholding (dpmsolver++ only)")
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel sampling over all devices (batch "
                        "sharded on a 1-D mesh; --bs must divide evenly)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: sample over a (data, model) "
                        "mesh, attention heads / GEGLU hidden sharded N-way "
                        "(latency path for small batches; must divide the "
                        "device count, --bs must divide devices/tp)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to sample on (no fallback to the CPU)")
    return p


@dataclasses.dataclass(frozen=True)
class SampleOptions:
    """What the sampler flags select."""

    sampler: str = "ddim"
    steps: int = 50
    scale: float = 7.5
    eta: float = 0.0
    strength: float = 1.0
    dpm_order: int = 2
    dpm_method: str = "multistep"
    dpm_algorithm: str = "dpmsolver++"
    dpm_thresholding: bool = False

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "SampleOptions":
        return cls(args.sampler, args.ddim_steps, args.scale, args.eta, args.strength,
                   args.dpm_order, args.dpm_method, args.dpm_algorithm, args.dpm_thresholding)


def load_trainer_checkpoint(states: States, path: str) -> int:
    """The trainable tensors of a port trainer checkpoint (``ckpt_*.pt``,
    ``{'trainable': {'branch.name': tensor}}``) into the loaded states;
    returns the count. The counterpart of restoring the JAX trainer's
    orbax directory."""
    trainable = torch.load(path, map_location="cpu", weights_only=True)["trainable"]
    for key, value in trainable.items():
        branch, name = key.split(".", 1)
        dst = getattr(states, branch)
        if name not in dst or dst[name].shape != value.shape:
            raise KeyError(f"{path}: {key} {tuple(value.shape)} does not fit the model")
        dst[name] = value.detach().to("cpu", torch.float32)
    return len(trainable)


def load_pipeline(cfg: ModelConfig, device, sd_ckpt: Optional[str] = None,
                  cn_ckpt: Optional[str] = None,
                  lora_ckpt: Optional[str] = None) -> CtrLoraPipeline:
    """SD + Base ControlNet (every key but the LoRA's, as the JAX script
    loads it), then the LoRA into slot 0, fused into the ControlNet; the
    towers cast to their compute dtype once."""
    pipe = CtrLoraPipeline(cfg, device)
    states = load_ctrlora(pipe, sd_ckpt, cn_ckpt, basecn_skip="lora")
    if lora_ckpt and lora_ckpt.endswith(".pt"):
        load_trainer_checkpoint(states, lora_ckpt)
    elif lora_ckpt:
        if load_lora_slot_into(cfg, states, bridge.load_torch_state_dict(lora_ckpt), 0) == 0:
            raise ValueError(f"no LoRA keys in {lora_ckpt}")
    for module, sd in ((pipe.unet, states.unet), (pipe.vae, states.vae),
                       (pipe.clip, states.clip)):
        module.load_state_dict(sd, strict=True)
    pipe.control.load_state_dict(lora_fuse.fuse_control_tree(
        pipe.control, states.control, 0, cfg.control.lora), strict=True)
    pipe.cast_for_inference()
    return pipe


def sample_draws(pipe: CtrLoraPipeline, hint_shape: Sequence[int], opts: SampleOptions,
                 seed: int):
    """(x_T [B, h, w, 4], the DDIM eta draws [B, S, h, w, 4] or None) of a
    batch of hints of `hint_shape`, from a CPU generator seeded with `seed`
    in the samplers' order: the starting noise, then the eta draws (DDIM
    with a sigma above 0 only), batch-first so that a rank takes its rows."""
    b, h, w = hint_shape[:3]
    f = 2 ** (len(pipe.cfg.vae.ch_mult) - 1)
    shape = (b, h // f, w // f, 4)
    gen = torch.Generator().manual_seed(seed)
    x_T = torch.randn(shape, generator=gen)
    noise = None
    if opts.sampler == "ddim":
        dd = make_ddim_schedule(pipe.schedule, opts.steps, eta=opts.eta)
        if dd.num_steps and np.max(dd.sigmas) > 0:
            noise = draw_normal((dd.num_steps, *shape), gen, "cpu").transpose(0, 1)
    return x_T, noise


def sample_batch(pipe: CtrLoraPipeline, hint: np.ndarray, ids: np.ndarray, nids: np.ndarray,
                 opts: SampleOptions, seed: int, parallel=None) -> Optional[np.ndarray]:
    """One batch: hints [B, H, W, 3] float32 in [0, 1], prompt and negative
    token ids [B, L] -> uint8 samples [B, H, W, 3], with the sampler the
    options name. The starting noise, then any eta draws, come from a CPU
    generator seeded with `seed`. `parallel` (from :func:`parallel_sampler`)
    runs each rank's rows of the batch and gathers them on rank 0 (None on
    the other ranks)."""
    rows = lambda *a: sample_rows(pipe, *a[:3], opts, *a[3:])
    run = rows if parallel is None else parallel(rows)
    return run(hint, ids, nids, *sample_draws(pipe, hint.shape, opts, seed))


_REQUESTS = itertools.count()  # the index of each request's span


def sample_rows(pipe: CtrLoraPipeline, hint: np.ndarray, ids: np.ndarray, nids: np.ndarray,
                opts: SampleOptions, x_T: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """``sample_batch`` on given draws (:func:`sample_draws`, or a rank's
    rows of them). A latent-hint ControlNet takes the hints' latents, an
    image-hint one (SDXL's) the hint pixels; a model that takes y gets each
    row's vector conditioning at the hints' size (``encode_prompts``)."""
    with trace.span("sample.request", next(_REQUESTS)):
        dev = pipe.device
        with trace.span("sample.text"):
            ctx, unc, vec, uvec = pipe.encode_prompts(
                torch.from_numpy(np.asarray(ids)).to(dev),
                torch.from_numpy(np.asarray(nids)).to(dev), hint.shape[1:3])
        with trace.span("sample.hint"):
            hz = torch.from_numpy(np.asarray(hint)).to(dev)
            if pipe.cfg.control.hint_mode == "latent":
                hz = pipe.encode_first_stage(hz)
        n_taps = len(encoder_plan(pipe.cfg.control.unet)[0]) + 1
        args = (pipe, ctx, unc, [Conditioning(hz)], tuple(x_T.shape),
                DDIMConfig(steps=opts.steps, guidance_scale=opts.scale, eta=opts.eta))
        kw = dict(x_T=x_T, control_scales=[opts.strength] * n_taps)
        if vec is not None:
            kw.update(vector=vec, uncond_vector=uvec)
        if noise is not None:
            kw["noise"] = noise.transpose(0, 1)
        with trace.span("sample.sampler"):
            if opts.sampler == "ddim":
                z = ddim_sample(*args, **kw)
            elif opts.sampler == "plms":
                z = plms_sample(*args, **kw)
            elif opts.sampler == "dpm_solver":
                fn = (dpm_solver_singlestep_sample if opts.dpm_method == "singlestep" else
                      dpm_solver_sample)
                z = fn(*args, **kw, order=opts.dpm_order, algorithm=opts.dpm_algorithm,
                       thresholding=opts.dpm_thresholding)
            else:
                raise ValueError(f"unknown sampler {opts.sampler!r}")
        with trace.span("sample.decode"):
            img = pipe.decode_first_stage(z)
        with trace.span("sample.to_host"):
            return torch.clamp(img.float() * 127.5 + 127.5, 0, 255).to(torch.uint8).cpu().numpy()


def parallel_sampler(args: argparse.Namespace):
    """(the mesh, dp_sample or tp_sample) that --dp / --tp ask for over the
    process group's ranks, or (None, None) for one rank; the JAX script's
    divisibility checks, as ValueErrors. ``sample_batch`` takes the second
    bound to the mesh."""
    n = world_size()
    if args.tp > 1:
        if n % args.tp:
            raise ValueError(f"--tp {args.tp} must divide the {n} devices")
        dp_size = n // args.tp
        if args.bs % dp_size:
            raise ValueError(f"--bs {args.bs} must be a multiple of dp={dp_size} "
                             f"({n} devices / tp {args.tp})")
        if process_index() == 0:
            print(f"tensor-parallel sampling: {dp_size}x{args.tp} mesh", flush=True)
        return create_mesh_2d(dp_size, args.tp), tp_sample
    if args.dp:
        if args.bs % n:
            raise ValueError(f"--bs {args.bs} must be a multiple of the {n} devices")
        if process_index() == 0:
            print(f"data-parallel sampling over {n} devices", flush=True)
        return create_mesh(), dp_sample
    if n > 1:
        raise ValueError(f"{n} ranks: pass --dp or --tp so that they split the batch")
    return None, None


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ctrlora_tpu_torch.data.datasets import CustomDataset

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; pass --device cpu "
                         "to sample on the CPU")
    init_distributed(device=None if args.device == "cuda" else device)
    device = rank_device() or device
    mesh, wrap = parallel_sampler(args)
    parallel = None if wrap is None else (lambda fn: wrap(fn, mesh))
    main_rank = process_index() == 0
    cfg = (load_model_config(args.config) if args.config else
           ctrlora_finetune_config(lora_rank=args.lora_rank))
    pipe = load_pipeline(cfg, device, args.sd_ckpt, args.cn_ckpt, args.lora_ckpt)
    if mesh is not None:  # what no file gives is seeded per rank: rank 0's for all
        replicate(mesh, [m for m in (pipe.unet, pipe.control, pipe.vae, pipe.clip) if m])
    opts = SampleOptions.from_args(args)

    ds = CustomDataset(args.dataroot, drop_rate=0.0, resolution=args.resolution)
    n = len(ds) if args.n_samples < 0 else min(args.n_samples, len(ds))
    if main_rank:
        for sub in ("sample", "control", "img"):
            os.makedirs(os.path.join(args.save_dir, sub), exist_ok=True)
    tok = default_tokenizer()
    max_length = cfg.clip.max_length
    prompts = []
    rng = np.random.default_rng(args.seed)
    for start in range(0, n, args.bs):
        idxs = list(range(start, min(start + args.bs, n)))
        items = [ds.get(i, rng) for i in idxs]
        # the short final batch is padded to a full one, as the JAX script does
        padded = items + [items[-1]] * (args.bs - len(items))
        hint = np.stack([it["hint"] for it in padded])
        ids = tok([it["txt"] for it in padded], max_length=max_length)
        nids = tok([""] * len(padded), max_length=max_length)
        out = sample_batch(pipe, hint, ids, nids, opts, args.seed + start, parallel)
        if not main_rank:
            continue
        for j, i in enumerate(idxs):
            write_png(os.path.join(args.save_dir, "sample", f"{i:06d}.png"), out[j])
            write_png(os.path.join(args.save_dir, "control", f"{i:06d}.png"),
                      (hint[j] * 255).astype(np.uint8))
            write_png(os.path.join(args.save_dir, "img", f"{i:06d}.png"),
                      ((items[j]["jpg"] + 1) * 127.5).clip(0, 255).astype(np.uint8))
            prompts.append(f"{i:06d}: {items[j]['txt']}")
        print(f"sampled {min(start + args.bs, n)}/{n}", flush=True)
    if main_rank:
        with open(os.path.join(args.save_dir, "prompt.txt"), "w") as fp:
            fp.write("\n".join(prompts) + "\n")


if __name__ == "__main__":
    main()
