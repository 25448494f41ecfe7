"""Diffusion noise schedules and DDIM tables (numpy), timestep embedding,
forward diffusion ``q_sample`` and the v-parameterization helpers (torch).

The tables are computed in float64 and stored as float32, exactly as
``ctrlora_tpu/schedules.py`` does, so both packages sample and train with
the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Tuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """betas[t] for t in [0, n_timestep), float64: 'linear' (SD's, linear in
    sqrt(beta)), 'cosine' (Nichol & Dhariwal, clipped to [0, 0.999]),
    'sqrt_linear' (linear in beta) or 'sqrt' (the square root of that)."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The per-timestep tables sampling and the training loss need,
    float32."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    lvlb_weights: np.ndarray  # of the schedule's parameterization

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(beta_schedule: str = "linear", timesteps: int = 1000,
                  linear_start: float = 0.00085, linear_end: float = 0.012,
                  cosine_s: float = 8e-3, v_posterior: float = 0.0,
                  parameterization: str = "eps") -> DiffusionSchedule:
    """The tables of `beta_schedule`, with the posterior variance mixed
    toward beta by `v_posterior` and the variational-bound weights of
    `parameterization` ('eps', 'x0' or 'v')."""
    betas = make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                               linear_end=linear_end, cosine_s=cosine_s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (
        1.0 - alphas_cumprod) + v_posterior * betas
    if parameterization == "eps":
        with np.errstate(divide="ignore"):  # posterior_variance[0] == 0 at v_posterior 0
            lvlb_weights = betas**2 / (2 * posterior_variance * alphas * (1 - alphas_cumprod))
    elif parameterization == "x0":
        # ldm's expression, "2.0 * 1" included
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    elif parameterization == "v":
        lvlb_weights = np.ones_like(betas)
    else:
        raise NotImplementedError(parameterization)
    lvlb_weights[0] = lvlb_weights[1]
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        lvlb_weights=f32(lvlb_weights),
    )


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        discr_method: str = "uniform") -> np.ndarray:
    """DDIM sub-sequence of DDPM timesteps, shifted by one so the last step
    maps back to the data: 'uniform' (S steps c = T // S apart) or 'quad'."""
    if discr_method == "uniform":
        ts = np.arange(num_ddim_timesteps) * (num_ddpm_timesteps // num_ddim_timesteps)
    elif discr_method == "quad":
        ts = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
              ).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization {discr_method!r}")
    return ts + 1


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step tables, ordered from small t to large t."""

    timesteps: np.ndarray  # int32 [S]
    alphas: np.ndarray  # float32 [S]
    alphas_prev: np.ndarray  # float32 [S]
    sqrt_one_minus_alphas: np.ndarray  # float32 [S]
    sigmas: np.ndarray  # float32 [S], all 0 at eta 0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    def __getitem__(self, steps: slice) -> "DDIMSchedule":
        """The tables of the steps `steps` (a sub-ladder)."""
        return DDIMSchedule(*(getattr(self, f.name)[steps] for f in dataclasses.fields(self)))


def make_ddim_schedule(schedule: DiffusionSchedule, num_ddim_steps: int, eta: float = 0.0,
                       discr_method: str = "uniform") -> DDIMSchedule:
    """DDIM tables; sigma_t = eta sqrt((1 - a_prev) / (1 - a) (1 - a / a_prev))."""
    ts = make_ddim_timesteps(num_ddim_steps, schedule.num_timesteps, discr_method)
    alphacums = schedule.alphas_cumprod.astype(np.float64)
    alphas = alphacums[ts]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ts[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return DDIMSchedule(
        timesteps=ts.astype(np.int32),
        alphas=alphas.astype(np.float32),
        alphas_prev=alphas_prev.astype(np.float32),
        sqrt_one_minus_alphas=np.sqrt(1.0 - alphas).astype(np.float32),
        sigmas=sigmas.astype(np.float32),
    )


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings [N] -> [N, dim] float32, layout [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


# id(table) -> (a weak reference to the table, {device: the table's copy there})
_on_device: Dict[int, Tuple[weakref.ref, Dict[torch.device, torch.Tensor]]] = {}


def device_table(table: np.ndarray, device) -> torch.Tensor:
    """`table` as a tensor of its dtype on `device`, copied there once per
    table and device and kept while the table lives. A copy from the host's
    pageable memory waits for the device's queue, and a CUDA graph cannot
    capture one, so the training step reads its tables from here."""
    key = id(table)
    entry = _on_device.get(key)
    if entry is None or entry[0]() is not table:
        entry = _on_device[key] = (
            weakref.ref(table, lambda _, k=key: _on_device.pop(k, None)), {})
    device = torch.device(device)
    out = entry[1].get(device)
    if out is None:
        out = entry[1][device] = torch.as_tensor(table, device=device)
    return out


def extract(table: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] as a [B, 1, ...] float32 tensor on t's device that
    broadcasts over an ndim tensor."""
    out = device_table(table, t.device)[t.long()]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) = sqrt(ac_t) x_0 + sqrt(1 - ac_t) noise."""
    n = x_start.ndim
    return (extract(schedule.sqrt_alphas_cumprod, t, n) * x_start
            + extract(schedule.sqrt_one_minus_alphas_cumprod, t, n) * noise)


def get_v(schedule: DiffusionSchedule, x: torch.Tensor, noise: torch.Tensor,
          t: torch.Tensor) -> torch.Tensor:
    """The v-parameterization target sqrt(ac_t) noise - sqrt(1 - ac_t) x."""
    n = x.ndim
    return (extract(schedule.sqrt_alphas_cumprod, t, n) * noise
            - extract(schedule.sqrt_one_minus_alphas_cumprod, t, n) * x)


def predict_eps_from_z_and_v(schedule: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    n = x_t.ndim
    return (extract(schedule.sqrt_alphas_cumprod, t, n) * v
            + extract(schedule.sqrt_one_minus_alphas_cumprod, t, n) * x_t)


def predict_start_from_z_and_v(schedule: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    n = x_t.ndim
    return (extract(schedule.sqrt_alphas_cumprod, t, n) * x_t
            - extract(schedule.sqrt_one_minus_alphas_cumprod, t, n) * v)
