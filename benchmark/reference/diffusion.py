"""Plain reference of the diffusion arithmetic around the model: the
beta schedule, the DDIM ladder and its update, classifier-free guidance,
the eps-MSE training loss and AdamW (decoupled weight decay), written from
the DDPM / DDIM / LDM papers and torch's documented AdamW, in float64 on
the host and float32 on the device. Imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.sd15 import CLIPRef, Tower, UNetRef, VAERef, nchw, nhwc


def alphas_cumprod(d: dict) -> np.ndarray:
    """The cumulative product of 1 - beta, float64, for the configuration's
    diffusion section (SD's 'linear' schedule: linear in sqrt(beta))."""
    if d["beta_schedule"] != "linear":
        raise ValueError(f"the reference has SD's linear schedule, not {d['beta_schedule']!r}")
    betas = np.linspace(d["linear_start"] ** 0.5, d["linear_end"] ** 0.5, d["timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_ladder(d: dict, steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(timesteps, alpha_t, alpha_prev) of the uniform DDIM ladder, in the
    order the sampler walks it (t descending): t = 1, 1 + T/S, ...; the
    last step's previous alpha is alphas_cumprod[0]."""
    ac = alphas_cumprod(d)
    ts = np.arange(steps) * (d["timesteps"] // steps) + 1
    prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
    order = np.arange(len(ts) - 1, -1, -1)
    return ts[order], ac[ts][order], prev[order]


def ddim_coefficients(a_t: float, a_prev: float) -> Tuple[float, float]:
    """(c_x, c_e) of the eta-0 DDIM update x_prev = c_x x + c_e eps, where
    x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t) and x_prev = sqrt(a_prev) x0 +
    sqrt(1 - a_prev) eps."""
    r = math.sqrt(a_prev) / math.sqrt(a_t)
    return r, math.sqrt(1.0 - a_prev) - r * math.sqrt(1.0 - a_t)


def guided_eps(model: UNetRef, x: torch.Tensor, t: int, ctx: torch.Tensor,
               unc: torch.Tensor, hint_latent: torch.Tensor, scale: float,
               strength: float) -> torch.Tensor:
    """eps_u + scale (eps_c - eps_u) for latents x [B, 4, h, w] at timestep
    t, the cond and uncond halves in one call, the hint latent feeding
    both, every tap times `strength`."""
    b = x.shape[0]
    tv = torch.full((2 * b,), int(t), device=x.device)
    out = model.controlled(torch.cat([x, x]), tv, torch.cat([ctx, unc]),
                           torch.cat([hint_latent, hint_latent]),
                           [strength] * (len(model.enc) + 1))
    return out[b:] + scale * (out[:b] - out[b:])


class Reference:
    """The four towers over the benchmark's raw weights (`weights`:
    {'unet', 'control', 'vae', 'clip'} -> name -> tensor) and the
    configuration's model section `m`. `low`: the control (see
    ``sd15``'s module docstring). `fuse`: fold the LoRA into its weights
    (no gradient to it)."""

    def __init__(self, m: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                 low: bool = False, fuse: bool = False):
        self.m = m
        tw = lambda k, tf32=False: Tower(weights[k], low=low, tf32=tf32 and low, fuse=fuse)
        self.unet = UNetRef(m["unet"], tw("unet"), tw("control"))
        self.vae = VAERef(m["vae"], tw("vae"))
        self.clip_tower = tw("clip", tf32=True)
        self.clip = CLIPRef(m["clip"], self.clip_tower)
        self.scale_factor = m["diffusion"]["scale_factor"]

    def text(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids [B, 77] -> context [B, 77, 768]."""
        from benchmark.reference.sd15 import fp32_products

        with fp32_products(tf32=self.clip_tower.tf32):
            return self.clip(ids)

    def latent(self, img: torch.Tensor, eps: torch.Tensor = None) -> torch.Tensor:
        """Images [B, H, W, 3] -> scaled latents [B, 4, h, w]: the posterior
        mean, or mean + exp(logvar / 2) eps with eps [B, h, w, 4]."""
        mean, logvar = self.vae.encode(nchw(img.float()))
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * nchw(eps.float())
        return self.scale_factor * z

    def pixels(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [B, h, w, 4] -> images [B, H, W, 3] in about [-1, 1]."""
        return nhwc(self.vae.decode(nchw(z.float()) / self.scale_factor))


def eps_mse_loss(ref: Reference, batch: Dict[str, torch.Tensor],
                 draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum over rows of each row's eps-MSE (the batch loss times its
    rows): z and the hint latent from the posterior draws, x_t =
    sqrt(ac_t) z + sqrt(1 - ac_t) noise, the controlled UNet's output
    against the noise."""
    ac = torch.as_tensor(alphas_cumprod(ref.m["diffusion"]), device=draws["t"].device)
    with torch.no_grad():
        z = ref.latent(batch["jpg"], draws["z_eps"])
        hint = ref.latent(batch["hint"], draws["hint_eps"])
        ctx = ref.text(batch["token_ids"])
    t = draws["t"].long()
    a = ac[t].float()[:, None, None, None]
    noise = nchw(draws["noise"].float())
    x = a.sqrt() * z + (1 - a).sqrt() * noise
    out = ref.unet.controlled(x, t, ctx, hint)
    return (out - noise).square().mean(dim=(1, 2, 3)).sum()


def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, Dict[str, torch.Tensor]], step: int, lr: float,
               betas: Sequence[float], eps: float, weight_decay: float) -> None:
    """One AdamW step in place (Loshchilov & Hutter; torch's form): p <-
    p (1 - lr wd), m and v the moving moments, p <- p - lr m_hat /
    (sqrt(v_hat) + eps) with the bias corrections of `step` (1-based)."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        st = state.setdefault(name, {"m": torch.zeros_like(p), "v": torch.zeros_like(p)})
        st["m"].mul_(b1).add_(g, alpha=1 - b1)
        st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * weight_decay)
        denom = (st["v"] / (1 - b2 ** step)).sqrt_().add_(eps)
        p.addcdiv_(st["m"], denom, value=-lr / (1 - b1 ** step))
