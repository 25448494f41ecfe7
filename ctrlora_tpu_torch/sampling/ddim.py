"""DDIM sampler of the port (counterpart of ``ctrlora_tpu/sampling/ddim.py``
``ddim_sample``): eta 0, classifier-free guidance on one stacked 2B batch
per step, the time-embedding projections hoisted out of the loop, eps
parameterization. The JAX ``lax.scan`` is a plain Python loop here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import make_emb_row_tables
from ctrlora_tpu_torch.schedules import make_ddim_schedule


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    steps: int = 50
    guidance_scale: float = 7.5


@torch.no_grad()
def ddim_sample(pipe: CtrLoraPipeline, context: torch.Tensor,
                uncond_context: Optional[torch.Tensor],
                conds: Optional[Sequence[Conditioning]], latent_shape: Sequence[int],
                cfg: DDIMConfig = DDIMConfig(), x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                control_scales: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Returns the final latents [B, h, w, 4] fp32, deterministic DDIM
    (eta 0). `x_T` is the starting noise; without it the noise comes from
    `generator`. `control_scales` (one per control tap) pass through to
    ``pipe.apply_model``."""
    if pipe.cfg.diffusion.parameterization != "eps":
        raise ValueError("the port's DDIM sampler implements eps parameterization")
    device = pipe.device
    dd = make_ddim_schedule(pipe.schedule, cfg.steps)
    b = latent_shape[0]
    use_cfg = uncond_context is not None and cfg.guidance_scale != 1.0
    img = (x_T.to(device, torch.float32) if x_T is not None else
           torch.randn(tuple(latent_shape), generator=generator, device=device))

    if use_cfg:  # uncond reuses the cond hints
        full_context = torch.cat([context, uncond_context])
        full_conds = [dataclasses.replace(c, hint=torch.cat([c.hint, c.hint]))
                      for c in (conds or [])]
    else:
        full_context, full_conds = context, list(conds or [])

    order = np.arange(dd.num_steps - 1, -1, -1)  # t descending
    ts_seq = dd.timesteps[order]
    packed, rows_of = make_emb_row_tables(
        pipe, full_conds, torch.as_tensor(ts_seq, dtype=torch.int32, device=device))

    f32 = np.float32
    scale = f32(cfg.guidance_scale)
    for i, k in enumerate(order):
        a_t, a_prev = f32(dd.alphas[k]), f32(dd.alphas_prev[k])
        s1m = f32(dd.sqrt_one_minus_alphas[k])
        rows = rows_of(packed[i])
        n = 2 * b if use_cfg else b
        tvec = torch.full((n,), int(ts_seq[i]), dtype=torch.int32, device=device)
        x_in = torch.cat([img, img]) if use_cfg else img
        out = pipe.apply_model(x_in, tvec, full_context, full_conds, emb_rows=rows,
                               control_scales=control_scales)
        e_t = out[b:] + float(scale) * (out[:b] - out[b:]) if use_cfg else out
        pred_x0 = (img - float(s1m) * e_t) / float(np.sqrt(a_t))
        dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev, f32(0.0)))
        img = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
    return img
