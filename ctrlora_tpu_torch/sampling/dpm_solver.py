"""DPM-Solver / DPM-Solver++ samplers of the port (Lu et al. 2022;
counterpart of ``ctrlora_tpu/sampling/dpm_solver.py``).

* ``dpm_solver_sample``: the multistep method, orders 1-3 with the warm-up
  ramp and lower-order final steps (``order_schedule``), "dpmsolver++"
  (data prediction, optional dynamic thresholding) or "dpmsolver" (noise
  prediction), eps or v models, on the time-uniform grid of the discrete
  schedule; the hoisted time-embedding rows, one per step.
* ``dpm_solver_singlestep_sample``: "DPM-Solver-fast", blocks of `order`
  chained model evaluations (``singlestep_orders``), each block's
  intermediate points snapped to discrete timesteps and its coefficients
  recomputed from the snapped points (``_singlestep_block_coeffs``). Its
  model calls compute the time embedding inside the UNet, as in JAX.

Every table and coefficient is computed once on the host in numpy (float64
where the JAX package uses it, float32 where it does), and the per-step
order is a Python value: the loop reads nothing back from the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import (
    initial_latents, make_emb_row_tables, make_guided_eps_fn,
)
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, v_model
from ctrlora_tpu_torch.utils import trace

f32 = np.float32
ALGORITHMS = ("dpmsolver++", "dpmsolver")


def _dynamic_threshold(x0: torch.Tensor, ratio: float, max_val: float) -> torch.Tensor:
    """Imagen-style dynamic thresholding (reference
    dpm_solver_pytorch.py::dynamic_thresholding_fn): the per-sample |x0|
    quantile `ratio` (linear interpolation), floored at max_val; x0 clipped
    to +-s and divided by s."""
    b = x0.shape[0]
    s = torch.quantile(x0.abs().reshape(b, -1), ratio, dim=1, interpolation="linear")
    s = torch.clamp_min(s, max_val).reshape(b, *([1] * (x0.ndim - 1)))
    return torch.minimum(torch.maximum(x0, -s), s) / s


def order_schedule(n_steps: int, order: int, lower_order_final: bool = True) -> np.ndarray:
    """Per-step solver order: the warm-up ramp 1..order, then `order`; with
    lower_order_final the final steps step down, but only below 15 steps,
    as the reference's multistep loop (dpm_solver.py:1062)."""
    ords = np.minimum(np.arange(n_steps) + 1, order)
    if lower_order_final and n_steps < 15:
        ords = np.minimum(ords, n_steps - np.arange(n_steps))
    return ords


def _check(order: int, algorithm: str) -> bool:
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    return algorithm == "dpmsolver++"


def _time_uniform_nodes(n_train: int, steps: int) -> np.ndarray:
    """T-1 = t_0 > t_1 > ... > t_N = 0, rounded to discrete timesteps."""
    return np.ascontiguousarray(
        np.unique(np.round(np.linspace(n_train - 1, 0, steps + 1)).astype(np.int64))[::-1])


def _model_fn(pipe, eps_fn, data_pred, thresholding, ratio, max_val):
    """m(x, t, alpha_t, sigma_t, rows): the solver's model quantity, the
    data prediction x0 (thresholded on request) or the noise eps."""
    v_param = v_model(pipe)

    def m(x, t, a_t, s_t, rows):
        out = eps_fn(x, t, rows)
        if v_param:
            if not data_pred:
                return float(s_t) * x + float(a_t) * out
            x0 = float(a_t) * x - float(s_t) * out
        else:
            if not data_pred:
                return out
            x0 = (x - float(s_t) * out) / float(a_t)
        return _dynamic_threshold(x0, ratio, max_val) if thresholding else x0

    return m


@torch.no_grad()
def dpm_solver_sample(pipe: CtrLoraPipeline, context: torch.Tensor,
                      uncond_context: Optional[torch.Tensor],
                      conds: Optional[Sequence[Conditioning]], latent_shape: Sequence[int],
                      cfg: DDIMConfig = DDIMConfig(), x_T: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      control_scales: Optional[Sequence[float]] = None, order: int = 2,
                      algorithm: str = "dpmsolver++", thresholding: bool = False,
                      dynamic_thresholding_ratio: float = 0.995,
                      thresholding_max_val: float = 1.0,
                      lower_order_final: bool = True,
                      ip_context: Optional[torch.Tensor] = None,
                      vector: Optional[torch.Tensor] = None,
                      uncond_vector: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The multistep solver, cfg.steps model evaluations. Returns the final
    latents [B, h, w, 4] fp32. `ip_context`: a style UNet's image-prompt
    tokens, `vector` / `uncond_vector` the rows' vector conditioning, as in
    ``ddim_sample``."""
    data_pred = _check(order, algorithm)
    device = pipe.device
    x = initial_latents(x_T, latent_shape, generator, device)
    eps_fn = make_guided_eps_fn(pipe, context, uncond_context, conds, cfg.guidance_scale,
                                control_scales, cfg.guess_mode, ip_context,
                                vector=vector, uncond_vector=uncond_vector)
    m_fn = _model_fn(pipe, eps_fn, data_pred, thresholding, dynamic_thresholding_ratio,
                     thresholding_max_val)

    ac = np.asarray(pipe.schedule.alphas_cumprod, np.float64)
    nodes = _time_uniform_nodes(len(ac), cfg.steps)
    n_steps = len(nodes) - 1
    alpha, sigma = np.sqrt(ac[nodes]), np.sqrt(1.0 - ac[nodes])
    lam = np.log(alpha) - np.log(sigma)
    alpha, sigma = alpha.astype(f32), sigma.astype(f32)
    hs = (lam[1:] - lam[:-1]).astype(f32)  # > 0
    ords = order_schedule(n_steps, order, lower_order_final)
    packed, rows_of = make_emb_row_tables(
        pipe, eps_fn.conds, torch.as_tensor(nodes[:-1], dtype=torch.int32, device=device),
        eps_fn.vector)

    m1 = m2 = None  # the previous two model quantities
    h1 = h2 = f32(1.0)  # and their step sizes
    for i in range(n_steps):
        with trace.span("dpm.step", i):
            a_t, s_t, a_n, s_n, h = alpha[i], sigma[i], alpha[i + 1], sigma[i + 1], hs[i]
            m0 = m_fn(x, int(nodes[i]), a_t, s_t, rows_of(packed[i]))
            o = int(ords[i])
            if data_pred:  # x_t = (s_n/s_t) x - a_n phi_1 m0 [+ a_n phi_2 D1 - a_n phi_3 D2]
                phi_1 = np.expm1(-h)
                x_next = float(s_n / s_t) * x - float(a_n * phi_1) * m0
            else:  # x_t = (a_n/a_t) x - s_n phi_1 m0 [- s_n phi_2 D1 - s_n phi_3 D2]
                phi_1 = np.expm1(h)
                x_next = float(a_n / a_t) * x - float(s_n * phi_1) * m0
            c = a_n if data_pred else s_n
            if o >= 2:
                r0 = h1 / h
                d1_0 = (m0 - m1) / float(r0)
            if o == 2:
                x_next = x_next - float(f32(0.5) * c * phi_1) * d1_0
            elif o == 3:
                r1 = h2 / h
                d1_1 = (m1 - m2) / float(r1)
                d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
                d2 = (d1_0 - d1_1) / float(r0 + r1)
                if data_pred:
                    phi_2 = phi_1 / h + f32(1.0)
                    phi_3 = phi_2 / h - f32(0.5)
                    x_next = x_next + float(c * phi_2) * d1 - float(c * phi_3) * d2
                else:
                    phi_2 = phi_1 / h - f32(1.0)
                    phi_3 = phi_2 / h - f32(0.5)
                    x_next = x_next - float(c * phi_2) * d1 - float(c * phi_3) * d2
            x = x_next
            m1, m2, h1, h2 = m0, m1, h, h1
    return x


def singlestep_orders(steps: int, order: int) -> List[int]:
    """Per-block solver orders of "DPM-Solver-fast" (reference
    dpm_solver.py:436-456): blocks of `order` model evaluations with a
    lower-order tail, `steps` evaluations in all."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        return [2] * (steps // 2) + ([1] if steps % 2 else [])
    return [1] * steps


def _singlestep_block_coeffs(lam, alpha, sigma, s_idx, t_idx, o, data_pred):
    """Host-side (float64) coefficients of ONE singlestep block from discrete
    node s_idx to t_idx with `o` model evaluations (reference
    dpm_solver.py:469-513 order 1, :515-596 order 2 with r1 = 1/2, :599-720
    order 3 with r1 = 1/3, r2 = 2/3; solver_type 'dpm_solver'). The
    intermediate points are the discrete timesteps nearest to
    inverse_lambda(lam_s + r h), and the r's are recomputed from the snapped
    lambdas, so each formula holds for the grid actually evaluated.

    Returns (ts[o], av[o], sv[o], A[o], B[o], C[o]): evaluation j runs at
    ts[j] (av/sv its alpha and sigma), and state j is
    A[j] x + B[j] m_s + C[j] (m_last - m_s); state o-1 is x_t."""
    lam_s, lam_t = lam[s_idx], lam[t_idx]
    h = lam_t - lam_s
    if not (h > 0 and s_idx - t_idx >= o):
        raise ValueError(f"block {s_idx} -> {t_idx} cannot hold {o} evaluations")

    def nearest(target_lam, lo, hi):
        # lam is monotone in t on [t_idx, s_idx]; snap within (t, s)
        return lo + int(np.argmin(np.abs(lam[lo:hi] - target_lam)))

    ts = [s_idx]
    if o >= 2:
        ts.append(nearest(lam_s + (0.5 if o == 2 else 1.0 / 3.0) * h, t_idx + 1, s_idx))
    if o == 3:
        ts.append(nearest(lam_s + (2.0 / 3.0) * h, t_idx + 1, ts[1]))
        ts[1], ts[2] = ts[2], ts[1]  # lam falls with the index: s1 has the larger one
    if len(set(ts)) != o:
        raise ValueError(f"degenerate block {ts} (grid too coarse)")

    a = [alpha[i] for i in ts]
    s = [sigma[i] for i in ts]
    A, B, C = np.zeros(o), np.zeros(o), np.zeros(o)
    if o == 1:
        if data_pred:
            A[0] = sigma[t_idx] / s[0]
            B[0] = -alpha[t_idx] * np.expm1(-h)
        else:
            A[0] = alpha[t_idx] / a[0]
            B[0] = -sigma[t_idx] * np.expm1(h)
        return ts, a, s, A, B, C
    r1 = (lam[ts[1]] - lam_s) / h
    phi_1m, phi_1p = np.expm1(-h), np.expm1(h)
    if data_pred:
        A[0] = s[1] / s[0]
        B[0] = -a[1] * np.expm1(-r1 * h)
    else:
        A[0] = a[1] / a[0]
        B[0] = -s[1] * np.expm1(r1 * h)
    if o == 2:
        if data_pred:
            A[1] = sigma[t_idx] / s[0]
            B[1] = -alpha[t_idx] * phi_1m
            C[1] = -(0.5 / r1) * alpha[t_idx] * phi_1m
        else:
            A[1] = alpha[t_idx] / a[0]
            B[1] = -sigma[t_idx] * phi_1p
            C[1] = -(0.5 / r1) * sigma[t_idx] * phi_1p
        return ts, a, s, A, B, C
    r2 = (lam[ts[2]] - lam_s) / h
    if data_pred:
        phi_22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1m / h + 1.0
        A[1] = s[2] / s[0]
        B[1] = -a[2] * np.expm1(-r2 * h)
        C[1] = (r2 / r1) * a[2] * phi_22
        A[2] = sigma[t_idx] / s[0]
        B[2] = -alpha[t_idx] * phi_1m
        C[2] = (1.0 / r2) * alpha[t_idx] * phi_2
    else:
        phi_22 = np.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1p / h - 1.0
        A[1] = a[2] / a[0]
        B[1] = -s[2] * np.expm1(r2 * h)
        C[1] = -(r2 / r1) * s[2] * phi_22
        A[2] = alpha[t_idx] / a[0]
        B[2] = -sigma[t_idx] * phi_1p
        C[2] = -(1.0 / r2) * sigma[t_idx] * phi_2
    return ts, a, s, A, B, C


@torch.no_grad()
def dpm_solver_singlestep_sample(pipe: CtrLoraPipeline, context: torch.Tensor,
                                 uncond_context: Optional[torch.Tensor],
                                 conds: Optional[Sequence[Conditioning]],
                                 latent_shape: Sequence[int], cfg: DDIMConfig = DDIMConfig(),
                                 x_T: Optional[torch.Tensor] = None,
                                 generator: Optional[torch.Generator] = None,
                                 control_scales: Optional[Sequence[float]] = None,
                                 order: int = 2, algorithm: str = "dpmsolver++",
                                 thresholding: bool = False,
                                 dynamic_thresholding_ratio: float = 0.995,
                                 thresholding_max_val: float = 1.0,
                                 ip_context: Optional[torch.Tensor] = None,
                                 vector: Optional[torch.Tensor] = None,
                                 uncond_vector: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The singlestep solver, cfg.steps model evaluations in blocks of
    `order` (reference dpm_solver.py:827-853, method 'singlestep'). Returns
    the final latents [B, h, w, 4] fp32. `vector` / `uncond_vector`: as
    ``ddim_sample``'s."""
    data_pred = _check(order, algorithm)
    x = initial_latents(x_T, latent_shape, generator, pipe.device)
    eps_fn = make_guided_eps_fn(pipe, context, uncond_context, conds, cfg.guidance_scale,
                                control_scales, cfg.guess_mode, ip_context,
                                vector=vector, uncond_vector=uncond_vector)
    m_fn = _model_fn(pipe, eps_fn, data_pred, thresholding, dynamic_thresholding_ratio,
                     thresholding_max_val)

    ac = np.asarray(pipe.schedule.alphas_cumprod, np.float64)
    alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
    lam = np.log(alpha) - np.log(sigma)
    # block boundaries at cumsum(orders) of the time-uniform fine grid
    # (reference dpm_solver.py:457-461)
    fine = _time_uniform_nodes(len(ac), cfg.steps)
    orders = singlestep_orders(len(fine) - 1, order)
    outer = fine[np.cumsum([0] + orders)]
    for i, o in enumerate(orders):
        with trace.span("dpm.step", i):
            coeffs = _singlestep_block_coeffs(lam, alpha, sigma, int(outer[i]), int(outer[i + 1]),
                                              o, data_pred)
            ts = coeffs[0]
            av, sv, A, B, C = (np.asarray(c, dtype=f32) for c in coeffs[1:])
            m0 = m_fn(x, int(ts[0]), av[0], sv[0], None)
            m_last, x_s = m0, x
            for j in range(o):
                x = float(A[j]) * x_s + float(B[j]) * m0 + float(C[j]) * (m_last - m0)
                if j < o - 1:
                    m_last = m_fn(x, int(ts[j + 1]), av[j + 1], sv[j + 1], None)
    return x
