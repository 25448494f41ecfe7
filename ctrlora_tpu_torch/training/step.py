"""The training step: frozen-tower encodes, eps-MSE, AdamW on the trainable
set (counterpart of ``ctrlora_tpu/training/step.py``).

Batches are dicts of tensors on the pipeline's device:
  jpg       [B, H, W, 3] float32 in [-1, 1]  (target image)
  hint      [B, H, W, 3] float32 in [0, 1]   (condition; the latent-hint
            branch feeds the [0, 1] hint to the VAE, as the reference does)
  token_ids [B, 77] int                      (tokenized prompt)
  task_idx  optional int or [B] int          (LoRA index; batches are single-task)
Latent-cached batches carry jpg_moments / hint_moments (posterior mean |
logvar) instead of jpg / hint. With grad_accum > 1 every tensor has a
leading [accum] axis of micro-batches.

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
    """Loss of one batch. The random draws (posterior noise of jpg and hint,
    t, the diffusion noise) come from `generator` in that order, or from
    `draws` ('z_eps', 'hint_eps', 't', 'noise') where given, so two runs can
    share them exactly."""
    draws = draws or {}
    if pipe.cfg.control is None or pipe.cfg.control.hint_mode != "latent":
        raise ValueError("the port's training step is the latent-hint CtrLoRA branch")
    with torch.no_grad():
        z = _latent(pipe, batch, "jpg", generator, draws.get("z_eps"))
        context = pipe.encode_text_tokens(batch["token_ids"])
        hint_z = _latent(pipe, batch, "hint", generator, draws.get("hint_eps"))
    task_idx = batch.get("task_idx")
    if isinstance(task_idx, torch.Tensor) and task_idx.ndim > 0:
        task_idx = task_idx[0]  # batches are single-task
    conds = [Conditioning(hint_z, lora_idx=task_idx)]
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


def make_train_step(pipe: CtrLoraPipeline, optimizer: torch.optim.Optimizer,
                    cfg: TrainConfig) -> Callable:
    """Returns step(state, batch, generator, draws=None) -> (state, metrics):
    gradients of the batch loss (micro-batch gradients averaged under
    grad_accum), their global norm, one AdamW step, then the EMA update of
    ``state.ema`` when ``cfg.use_ema``. `draws` (one batch's, see
    ``loss_for_batch``) replace the generator's draws."""
    if cfg.shard_opt_state:
        raise NotImplementedError("shard_opt_state shards the AdamW moments over several "
                                  "devices: not ported (ROADMAP queue 1 item 12)")

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Mapping[str, torch.Tensor]] = None):
        optimizer.zero_grad(set_to_none=True)
        micro = ([{k: v[i] for k, v in batch.items()} for i in range(cfg.grad_accum)]
                 if cfg.grad_accum > 1 else [batch])
        sums: Dict[str, torch.Tensor] = {}
        for mb in micro:
            loss, metrics = loss_for_batch(pipe, mb, generator, draws)
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
