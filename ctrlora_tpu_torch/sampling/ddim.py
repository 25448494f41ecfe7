"""DDIM sampler of the port (counterpart of ``ctrlora_tpu/sampling/ddim.py``):
classifier-free guidance on one stacked 2B batch per step, the
time-embedding projections and the cross-attention k|v products hoisted
out of the loop, eta noise and
temperature, guess mode, per-step guidance (``ucg_schedule``), mask
inpainting, eps and v parameterization; and the DDIM inversion
(``ddim_encode``), the img2img pair ``ddim_stochastic_encode`` /
``ddim_decode_from``. The JAX ``lax.scan`` is a plain Python loop here.

Random draws: the package RNGs differ, so every stochastic function takes
its noise as an argument, or draws all of it up front in one call from the
caller's generator (``common.draw_normal``) and copies it to the device
once. The step loop reads no value back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import (
    draw_normal, initial_latents, make_emb_row_tables, make_guided_eps_fn,
)
from ctrlora_tpu_torch.schedules import DDIMSchedule, make_ddim_schedule
from ctrlora_tpu_torch.utils import trace

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    """The JAX ``DDIMConfig``'s fields that change results. The time
    embedding and the cross-attention k|v are always hoisted
    (``hoist_time_embed``, ``hoist_xattn_kv``: the same products, made once,
    so neither changes a result); ``scan_unroll`` steers only XLA."""

    steps: int = 50
    eta: float = 0.0
    guidance_scale: float = 7.5
    temperature: float = 1.0
    # guess mode: the uncond CFG half runs without control (reference:
    # app/gradio_ctrlora.py:308); combine with decayed control_scales
    guess_mode: bool = False
    # per-step guidance scales overriding guidance_scale, in sampling
    # order (t descending)
    ucg_schedule: Optional[Sequence[float]] = None


def v_model(pipe: CtrLoraPipeline) -> bool:
    return pipe.cfg.diffusion.parameterization == "v"


@torch.no_grad()
def ddim_sample(pipe: CtrLoraPipeline, context: torch.Tensor,
                uncond_context: Optional[torch.Tensor],
                conds: Optional[Sequence[Conditioning]], latent_shape: Sequence[int],
                cfg: DDIMConfig = DDIMConfig(), x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                control_scales: Optional[Sequence[float]] = None,
                mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                ddim_schedule: Optional[DDIMSchedule] = None,
                noise: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None,
                ip_context: Optional[torch.Tensor] = None,
                uncond_ip_context: Optional[torch.Tensor] = None,
                vector: Optional[torch.Tensor] = None,
                uncond_vector: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns the final latents [B, h, w, 4] fp32.

    `x_T` is the starting noise; without it the noise comes from
    `generator`. `control_scales` (one per control tap) pass through to
    ``pipe.apply_model``. `mask` [B, h, w, 4] (1 keeps the x0 region) with
    `x0`: inpainting, each step resetting the kept region to x0 noised to
    the step's t. `noise` [S, B, h, w, 4] are the eta draws (used where a
    sigma is above 0), `mask_noise` [S, ...] the draws that noise x0; each
    missing one is drawn from `generator` after x_T, eta draws first. At
    eta 0 without a mask the loop draws and launches nothing for noise.
    `ip_context` [B, ip_tokens, D] are a style UNet's image-prompt tokens,
    `uncond_ip_context` the uncond CFG half's (default: the same tokens).
    `vector` / `uncond_vector` [B, P + 6]: each row's vector conditioning
    (``CtrLoraPipeline.encode_prompts``) for a model that takes y.
    """
    device = pipe.device
    dd = ddim_schedule or make_ddim_schedule(pipe.schedule, cfg.steps, eta=cfg.eta)
    n_steps = dd.num_steps
    img = initial_latents(x_T, latent_shape, generator, device)
    # decided from the concrete sigma table, so explicit sub-schedules
    # (ddim_decode_from) get the eta-0 path too
    stochastic = bool(n_steps and np.max(dd.sigmas) > 0)
    draws = (n_steps, *img.shape)
    if stochastic:
        noise = (draw_normal(draws, generator, device) if noise is None else
                 noise.to(device, torch.float32))
    if mask is not None:
        if x0 is None:
            raise ValueError("mask needs x0")
        mask_noise = (draw_normal(draws, generator, device) if mask_noise is None else
                      mask_noise.to(device, torch.float32))
        mask, x0 = mask.to(device, torch.float32), x0.to(device, torch.float32)
        keep_img = 1.0 - mask

    eps_fn = make_guided_eps_fn(pipe, context, uncond_context, conds, cfg.guidance_scale,
                                control_scales, cfg.guess_mode, ip_context, uncond_ip_context,
                                vector, uncond_vector)
    if cfg.ucg_schedule is not None:
        if len(cfg.ucg_schedule) != n_steps:
            raise ValueError(f"ucg_schedule has {len(cfg.ucg_schedule)} scales for "
                             f"{n_steps} steps")
        scales = [float(f32(s)) for s in cfg.ucg_schedule]
    else:
        scales = [None] * n_steps

    order = np.arange(n_steps - 1, -1, -1)  # t descending
    ts_seq = dd.timesteps[order]
    packed, rows_of = make_emb_row_tables(
        pipe, eps_fn.conds, torch.as_tensor(ts_seq, dtype=torch.int32, device=device),
        eps_fn.vector)
    sched = pipe.schedule
    v_param = v_model(pipe)
    for i, k in enumerate(order):
        with trace.span("ddim.step", i):
            t = int(ts_seq[i])
            a_t, a_prev = f32(dd.alphas[k]), f32(dd.alphas_prev[k])
            s1m, sigma = f32(dd.sqrt_one_minus_alphas[k]), f32(dd.sigmas[k])
            if mask is not None:
                img_orig = (float(sched.sqrt_alphas_cumprod[t]) * x0
                            + float(sched.sqrt_one_minus_alphas_cumprod[t]) * mask_noise[i])
                img = img_orig * mask + keep_img * img
            out = eps_fn(img, t, rows_of(packed[i]), scales[i])
            if v_param:  # schedules.predict_*_from_z_and_v with the step's scalars
                sa = float(sched.sqrt_alphas_cumprod[t])
                sb = float(sched.sqrt_one_minus_alphas_cumprod[t])
                e_t, pred_x0 = sa * out + sb * img, sa * img - sb * out
            else:
                e_t = out
                pred_x0 = (img - float(s1m) * e_t) / float(np.sqrt(a_t))
            dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev - sigma * sigma, f32(0.0)))
            img = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
            if stochastic:
                img = img + float(sigma * f32(cfg.temperature)) * noise[i]
    return img


@torch.no_grad()
def ddim_encode(pipe: CtrLoraPipeline, x0: torch.Tensor, t_enc: int, context: torch.Tensor,
                uncond_context: Optional[torch.Tensor] = None,
                conds: Optional[Sequence[Conditioning]] = None, steps: int = 50,
                guidance_scale: float = 1.0,
                control_scales: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Deterministic DDIM inversion: the first `t_enc` rungs of the ladder
    walked in ascending t, mapping clean latents x0 to x_{t_enc} that eta-0
    decoding takes back to x0 (reference: cldm/ddim_hacked.py:233-279).
    Per rung i (a = alphas_prev[i], a_next = alphas[i]):
    x <- sqrt(a_next / a) x + sqrt(a_next) (sqrt(1/a_next - 1) - sqrt(1/a - 1)) eps."""
    dd = make_ddim_schedule(pipe.schedule, steps)
    if t_enc > dd.num_steps:
        raise ValueError(f"t_enc {t_enc} is beyond the {dd.num_steps}-step ladder")
    a_next, a = dd.alphas[:t_enc], dd.alphas_prev[:t_enc]  # float32, as JAX computes them
    w_x = np.sqrt(a_next / a)
    w_e = np.sqrt(a_next) * (np.sqrt(1.0 / a_next - 1.0) - np.sqrt(1.0 / a - 1.0))
    ts = dd.timesteps[:t_enc]
    eps_fn = make_guided_eps_fn(pipe, context, uncond_context, conds, guidance_scale,
                                control_scales)
    packed, rows_of = make_emb_row_tables(
        pipe, eps_fn.conds, torch.as_tensor(ts, dtype=torch.int32, device=pipe.device))
    x = x0.to(pipe.device, torch.float32)
    for i in range(t_enc):
        eps = eps_fn(x, int(ts[i]), rows_of(packed[i]))
        x = float(w_x[i]) * x + float(w_e[i]) * eps
    return x


@torch.no_grad()
def ddim_stochastic_encode(pipe: CtrLoraPipeline, x0: torch.Tensor,
                           t_index: Union[int, Sequence[int], torch.Tensor], steps: int,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x0 noised to DDIM step index t_index (a scalar or one per sample):
    sqrt(a) x0 + sqrt(1 - a) noise (reference: ddim_hacked.py:281-295), the
    style pipeline's img2img start. `noise` is drawn from `generator` when
    not given."""
    dd = make_ddim_schedule(pipe.schedule, steps)
    x0 = x0.to(pipe.device, torch.float32)
    if noise is None:
        noise = draw_normal(x0.shape, generator, x0.device)
    idx = torch.as_tensor(np.asarray(t_index, dtype=np.int64).reshape(-1))
    sel = lambda tab: torch.from_numpy(tab)[idx].to(x0.device).reshape(
        -1, *([1] * (x0.ndim - 1)))
    return sel(np.sqrt(dd.alphas)) * x0 + sel(dd.sqrt_one_minus_alphas) * noise.to(x0.device)


def ddim_decode_from(pipe: CtrLoraPipeline, x_latent: torch.Tensor, t_start: int,
                     context: torch.Tensor, uncond_context: Optional[torch.Tensor],
                     conds: Optional[Sequence[Conditioning]], cfg: DDIMConfig,
                     control_scales: Optional[Sequence[float]] = None,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     ip_context: Optional[torch.Tensor] = None,
                     uncond_ip_context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM decoding from an intermediate step (reference:
    ddim_hacked.py:297-317): the first t_start rungs of the cfg.steps
    ladder, from x_latent down to t = 0 (the style pipeline's img2img)."""
    sub = make_ddim_schedule(pipe.schedule, cfg.steps, eta=cfg.eta)[:t_start]
    return ddim_sample(pipe, context, uncond_context, conds, tuple(x_latent.shape),
                       dataclasses.replace(cfg, steps=t_start), x_T=x_latent,
                       generator=generator, control_scales=control_scales,
                       ddim_schedule=sub, noise=noise, ip_context=ip_context,
                       uncond_ip_context=uncond_ip_context)
