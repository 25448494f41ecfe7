"""The training step: frozen-tower encodes, eps-MSE, AdamW on the trainable
set (counterpart of ``ctrlora_tpu/training/step.py``).

Batches are dicts of tensors on the pipeline's device:
  jpg       [B, H, W, 3] float32 in [-1, 1]  (target image)
  hint      [B, H, W, 3] float32 in [0, 1]   (condition; the latent-hint
            branch feeds the [0, 1] hint to the VAE, as the reference does;
            an image-hint branch takes the pixels as they are, at 8x the
            latent's size)
  token_ids [B, 77] int                      (tokenized prompt)
  task_idx  optional int or [B] int          (LoRA index; batches are single-task)
Latent-cached batches carry jpg_moments / hint_moments (posterior mean |
logvar) instead of jpg / hint (latent-hint models only). With grad_accum >
1 every tensor has a leading [accum] axis of micro-batches
(``split_micro_batches`` makes it from a loader's batch).

The frozen towers (VAE, CLIP) run under ``torch.no_grad``; the UNet's
parameters are frozen by the trainable mask (sd_locked), so autograd
computes activation gradients through its decoder but no weight gradient
of a frozen parameter (see ``trainable_grad_norm``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.training.ema import ema_update
from ctrlora_tpu_torch.training.losses import p_losses
from ctrlora_tpu_torch.training.train_state import TrainState
from ctrlora_tpu_torch.utils import trace

Batch = Mapping[str, torch.Tensor]


def _latent(pipe: CtrLoraPipeline, batch: Batch, key: str, generator, eps):
    if f"{key}_moments" in batch:  # latent cache: same sampling, no encode
        return pipe.first_stage_from_moments(batch[f"{key}_moments"], generator, eps)
    return pipe.encode_first_stage(batch[key], generator, eps)


def loss_for_batch(pipe: CtrLoraPipeline, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss of one batch. The random draws (posterior noise of jpg and, for
    a latent-hint model, of the hint; t; the diffusion noise) come from
    `generator` in that order, or from `draws` ('z_eps', 'hint_eps', 't',
    'noise') where given, so two runs can share them exactly. An
    image-hint model takes the pixel hint as its condition: no encode, no
    'hint_eps'."""
    draws = draws or {}
    latent_hint = pipe.cfg.control.hint_mode == "latent"
    if "hint" not in batch and not latent_hint:
        raise ValueError("latent-cached batches (hint_moments) require hint_mode='latent'; "
                         "image-hint models consume raw pixels")
    with torch.no_grad():
        z = _latent(pipe, batch, "jpg", generator, draws.get("z_eps"))
        context = pipe.encode_text_tokens(batch["token_ids"])
        hint = (_latent(pipe, batch, "hint", generator, draws.get("hint_eps")) if latent_hint
                else batch["hint"])
    task_idx = batch.get("task_idx")
    if isinstance(task_idx, torch.Tensor) and task_idx.ndim > 0:
        task_idx = task_idx[0]  # batches are single-task
    conds = [Conditioning(hint, lora_idx=task_idx)]
    return p_losses(pipe, z, context, conds, t=draws.get("t"), noise=draws.get("noise"),
                    generator=generator)


def trainable_grad_norm(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    """Global L2 norm of the trainable parameters' gradients (fp32). Frozen
    parameters have no gradient: the JAX step's norm also counts the frozen
    base-ControlNet weights' gradients, which the reference never computes."""
    grads = [p.grad.float() for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def split_micro_batches(batch: Batch, accum: int) -> Dict[str, torch.Tensor]:
    """A loader's batch of accum * B examples -> [accum, B, ...] tensors:
    micro-batch i holds examples i*B .. (i+1)*B - 1."""
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}


def global_draws(pipe: CtrLoraPipeline, batch: Batch, generator: torch.Generator,
                 dp: int) -> Dict[str, torch.Tensor]:
    """The draws ``loss_for_batch`` makes from `generator`, in its order, for
    the global batch of `dp` times this batch's rows: each data rank draws
    them all and keeps its rows (``mesh.shard_batch``), so a step of an
    N-rank run draws what the one-rank step on the global batch draws."""
    dev = generator.device
    src = batch["jpg_moments" if "jpg_moments" in batch else "jpg"]
    b = src.shape[0] * dp
    if "jpg_moments" in batch:
        lat = (b, *src.shape[1:3], src.shape[3] // 2)
    else:
        f = 2 ** (len(pipe.cfg.vae.ch_mult) - 1)
        lat = (b, src.shape[1] // f, src.shape[2] // f, pipe.cfg.vae.embed_dim)
    out = {"z_eps": torch.randn(lat, generator=generator, device=dev)}
    if pipe.cfg.control.hint_mode == "latent":
        out["hint_eps"] = torch.randn(lat, generator=generator, device=dev)
    out["t"] = torch.randint(0, pipe.schedule.num_timesteps, (b,), generator=generator,
                             device=dev)
    out["noise"] = torch.randn(lat, generator=generator, device=dev)
    return out


def make_train_step(pipe: CtrLoraPipeline, optimizer, cfg: TrainConfig,
                    mesh=None) -> Callable:
    """Returns step(state, batch, generator, draws=None) -> (state, metrics):
    gradients of the batch loss (micro-batch gradients averaged under
    grad_accum, micro-batch i drawing from `generator` after micro-batch
    i - 1), their global norm, one AdamW step, then the EMA update of
    ``state.ema`` when ``cfg.use_ema``. `draws` (see ``loss_for_batch``)
    replace the generator's draws: one dict, or under grad_accum a
    sequence of one dict per micro-batch.

    Over a `mesh` (``parallel.mesh``) `batch` holds this rank's rows (of
    each micro-batch), and `draws` are the global batch's (each rank
    takes its rows; from `generator`, each rank draws the global batch's,
    :func:`global_draws`). After the last micro-batch, and not before
    (DDP's no_sync), the split sites' gradients are summed over the model
    group (``parallel.tp``), then every trainable gradient is averaged
    over the data group in one bucketed all-reduce (a sum divided by dp),
    and the loss metrics with them; ``grad_norm`` is taken after that."""
    from ctrlora_tpu_torch.parallel import mesh as pmesh
    from ctrlora_tpu_torch.parallel import tp

    distributed = mesh is not None and mesh.distributed

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Mapping[str, torch.Tensor]] = None):
        with trace.span("train.step", state.step):
            optimizer.zero_grad(set_to_none=True)
            micro = ([{k: v[i] for k, v in batch.items()} for i in range(cfg.grad_accum)]
                     if cfg.grad_accum > 1 else [batch])
            if draws is None or cfg.grad_accum == 1:
                draws = [draws] * len(micro)
            elif len(draws) != len(micro):
                raise ValueError(f"{len(draws)} draws for {len(micro)} micro-batches")
            if distributed and generator is None and any(d is None for d in draws):
                raise ValueError("a step over a mesh needs a generator or draws: every rank "
                                 "draws the global batch's")
            sums: Dict[str, torch.Tensor] = {}
            for mb, mb_draws in zip(micro, draws):
                if distributed:
                    mb_draws = pmesh.shard_batch(mesh, dict(
                        mb_draws if mb_draws is not None else
                        global_draws(pipe, mb, generator, mesh.dp)))
                with trace.span("train.forward"):
                    loss, metrics = loss_for_batch(pipe, mb, generator, mb_draws)
                with trace.span("train.backward"):
                    (loss / len(micro)).backward()
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v / len(micro)
            if distributed:
                params = optimizer.param_groups[0]["params"]
                tp.reduce_split_grads(params)
                pmesh.all_reduce_tensors_([p.grad for p in params if p.grad is not None],
                                          mesh.data_group, divide=mesh.dp)
                names = list(sums)
                means = torch.stack([sums[k].float() for k in names])
                pmesh.all_reduce_tensors_([means], mesh.data_group, divide=mesh.dp)
                sums = dict(zip(names, means.unbind()))
            with trace.span("train.update"):
                sums["grad_norm"] = trainable_grad_norm(optimizer)
                optimizer.step()
                if cfg.use_ema:
                    ema_update(state.ema, state.trainable, cfg.ema_decay)
            state.step += 1
            return state, sums

    return step
