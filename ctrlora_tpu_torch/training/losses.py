"""Diffusion training loss (counterpart of ``ctrlora_tpu/training/losses.py``;
reference: ldm/models/diffusion/ddpm.py:885-921).

loss = l_simple_weight * mean(mse / exp(logvar_t) + logvar_t)
     + original_elbo_weight * mean(lvlb_weights[t] * mse)

The target is the noise (eps), the clean latent (x0) or v = sqrt(ac_t)
noise - sqrt(1 - ac_t) x0 (v), by the config's parameterization. With the
ctrlora defaults (eps, logvar 0, l_simple_weight 1, elbo weight 0) this is
plain eps-MSE; the full form is kept for config parity.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.schedules import extract, get_v, q_sample


def p_losses(pipe: CtrLoraPipeline, z: torch.Tensor, context: torch.Tensor,
             conds: Optional[Sequence[Conditioning]], t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Diffusion loss for clean latents z [B, h, w, c] (scaled). t [B]
    and noise (z's shape) are drawn from `generator` when not given.
    Returns (loss, detached metrics)."""
    dcfg = pipe.cfg.diffusion
    sched = pipe.schedule
    b = z.shape[0]
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (b,), generator=generator, device=z.device)
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=z.device)
    x_noisy = q_sample(sched, z, t, noise)
    out = pipe.apply_model(x_noisy, t, context, conds)
    if dcfg.parameterization == "eps":
        target = noise
    elif dcfg.parameterization == "x0":
        target = z
    elif dcfg.parameterization == "v":
        target = get_v(sched, z, noise, t)
    else:
        raise NotImplementedError(dcfg.parameterization)
    mse = (out - target).square().mean(dim=(1, 2, 3))  # [B]
    logvar_t = torch.full((b,), dcfg.logvar_init, device=z.device)
    loss = dcfg.l_simple_weight * (mse / logvar_t.exp() + logvar_t).mean()
    lvlb = (extract(sched.lvlb_weights, t, 1) * mse).mean()
    loss = loss + dcfg.original_elbo_weight * lvlb
    metrics = {"loss": loss, "loss_simple": mse.mean(), "loss_vlb": lvlb,
               "t_mean": t.float().mean()}
    return loss, {k: v.detach() for k, v in metrics.items()}
