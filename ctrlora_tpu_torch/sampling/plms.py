"""PLMS sampler of the port (pseudo linear multistep, Liu et al. 2022;
counterpart of ``ctrlora_tpu/sampling/plms.py``).

The eps history is three tensors and the order comes from the Python step
counter: order 1 at the first step (an Euler probe to t_next and a second
model evaluation there, reference plms.py:192-198), then the 2-, 3- and
4-step Adams-Bashforth combinations. One [S+1, n, Cmax] row table over the
ladder's timesteps and a trailing 0 serves both t (rows 0..S-1) and t_next
(rows 1..S). eta 0 and eps parameterization only, as the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import (
    initial_latents, make_emb_row_tables, make_guided_eps_fn,
)
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, v_model
from ctrlora_tpu_torch.schedules import make_ddim_schedule
from ctrlora_tpu_torch.utils import trace

f32 = np.float32


@torch.no_grad()
def plms_sample(pipe: CtrLoraPipeline, context: torch.Tensor,
                uncond_context: Optional[torch.Tensor],
                conds: Optional[Sequence[Conditioning]], latent_shape: Sequence[int],
                cfg: DDIMConfig = DDIMConfig(), x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                control_scales: Optional[Sequence[float]] = None,
                ip_context: Optional[torch.Tensor] = None,
                vector: Optional[torch.Tensor] = None,
                uncond_vector: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns the final latents [B, h, w, 4] fp32; cfg.steps ladder rungs,
    cfg.steps + 1 model evaluations. `ip_context`: a style UNet's
    image-prompt tokens, `vector` / `uncond_vector` the rows' vector
    conditioning, as in ``ddim_sample``."""
    if cfg.eta != 0.0:
        raise ValueError("PLMS requires eta=0")
    if v_model(pipe):
        raise ValueError("PLMS implements eps parameterization; this model predicts v")
    device = pipe.device
    dd = make_ddim_schedule(pipe.schedule, cfg.steps)
    img = initial_latents(x_T, latent_shape, generator, device)
    eps_fn = make_guided_eps_fn(pipe, context, uncond_context, conds, cfg.guidance_scale,
                                control_scales, cfg.guess_mode, ip_context,
                                vector=vector, uncond_vector=uncond_vector)
    order = np.arange(dd.num_steps - 1, -1, -1)
    ts = dd.timesteps[order]
    ts_next = np.concatenate([ts[1:], [0]])  # one rung down, 0 past the end
    packed, rows_of = make_emb_row_tables(
        pipe, eps_fn.conds,
        torch.as_tensor(np.concatenate([ts, [0]]), dtype=torch.int32, device=device),
        eps_fn.vector)

    def x_prev(x, e, k):
        a_t, a_prev = f32(dd.alphas[k]), f32(dd.alphas_prev[k])
        pred_x0 = (x - float(f32(dd.sqrt_one_minus_alphas[k])) * e) / float(np.sqrt(a_t))
        dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev, f32(0.0)))
        return float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e

    e1 = e2 = e3 = None  # the last three eps, newest first
    for i, k in enumerate(order):
        with trace.span("plms.step", i):
            e_t = eps_fn(img, int(ts[i]), rows_of(packed[i]))
            if i == 0:
                e_next = eps_fn(x_prev(img, e_t, k), int(ts_next[i]), rows_of(packed[i + 1]))
                e_prime = (e_t + e_next) / 2.0
            elif i == 1:
                e_prime = (3.0 * e_t - e1) / 2.0
            elif i == 2:
                e_prime = (23.0 * e_t - 16.0 * e1 + 5.0 * e2) / 12.0
            else:
                e_prime = (55.0 * e_t - 59.0 * e1 + 37.0 * e2 - 9.0 * e3) / 24.0
            img = x_prev(img, e_prime, k)
            e1, e2, e3 = e_t, e1, e2
    return img
