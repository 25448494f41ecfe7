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


def make_train_step(pipe: CtrLoraPipeline, optimizer: torch.optim.Optimizer,
                    cfg: TrainConfig) -> Callable:
    """Returns step(state, batch, generator, draws=None) -> (state, metrics):
    gradients of the batch loss (micro-batch gradients averaged under
    grad_accum, micro-batch i drawing from `generator` after micro-batch
    i - 1), their global norm, one AdamW step, then the EMA update of
    ``state.ema`` when ``cfg.use_ema``. `draws` (see ``loss_for_batch``)
    replace the generator's draws: one dict, or under grad_accum a
    sequence of one dict per micro-batch."""
    if cfg.shard_opt_state:
        raise NotImplementedError("shard_opt_state shards the AdamW moments over several "
                                  "devices: not ported (ROADMAP queue 1 item 12)")

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Mapping[str, torch.Tensor]] = None):
        optimizer.zero_grad(set_to_none=True)
        micro = ([{k: v[i] for k, v in batch.items()} for i in range(cfg.grad_accum)]
                 if cfg.grad_accum > 1 else [batch])
        if draws is None or cfg.grad_accum == 1:
            draws = [draws] * len(micro)
        elif len(draws) != len(micro):
            raise ValueError(f"{len(draws)} draws for {len(micro)} micro-batches")
        sums: Dict[str, torch.Tensor] = {}
        for mb, mb_draws in zip(micro, draws):
            loss, metrics = loss_for_batch(pipe, mb, generator, mb_draws)
            (loss / len(micro)).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v / len(micro)
        sums["grad_norm"] = trainable_grad_norm(optimizer)
        optimizer.step()
        if cfg.use_ema:
            ema_update(state.ema, state.trainable, cfg.ema_decay)
        state.step += 1
        return state, sums

    return step
