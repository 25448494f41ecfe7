"""Everything a run makes from ``--seed``: the model's weights, prompts,
hint images and training batches, and the random draws of the training
step. The same seed gives the same tensors on any run.

Weights are made on the device in one normal draw a tower (a
``torch.Generator`` on the card, in the dtype the tower is held in) and
then scaled leaf by leaf: Linear and conv weights at 1/sqrt(fan-in)
(LeCun), the layers a fresh SD model starts at zero included, so that every
branch carries signal as a trained checkpoint does; biases N(0, 0.02^2);
norm scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2); LoRA down at
1/sqrt(in), LoRA up at 0.25/sqrt(rank); token embeddings N(0, 0.02^2) and
position embeddings N(0, 0.01^2). (The pattern of ``random_init_`` in
``chip_smoke.py`` at commit a86232d, rewritten so that a tower takes one
draw, not one per leaf.)
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

SOT, EOT = 49406, 49407  # CLIP's start and end-of-text ids; rows pad with EOT


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose: a function of `seed` and `parts`
    (strings or whole numbers) only."""
    words = [int(seed) % 2 ** 64]
    for p in parts:
        words.append(zlib.crc32(p.encode()) if isinstance(p, str) else int(p) % 2 ** 64)
    ss = np.random.SeedSequence([w & 0xFFFFFFFF for w in words] +
                                [w >> 32 for w in words])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def leaf_init(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of the leaf `name` of `shape`: see the module docstring."""
    leaf = name.rsplit(".", 1)[-1]
    site = name.rsplit(".", 1)[0].rsplit(".", 1)[-1] if "." in name else ""
    if leaf == "lora_down":
        return 0.0, shape[-2] ** -0.5
    if leaf == "lora_up":
        return 0.0, 0.25 * shape[-2] ** -0.5
    if leaf == "token_embedding":
        return 0.0, 0.02
    if leaf == "position_embedding":
        return 0.0, 0.01
    if "norm" in site:
        return (1.0, 0.1) if leaf == "weight" else (0.0, 0.1)
    if leaf == "bias":
        return 0.0, 0.02
    # a Linear [out, in], a conv [out, in, kh, kw], a banked zero conv [n, out, in, 1, 1]
    fan_in = math.prod(shape[2:]) if len(shape) == 5 else math.prod(shape[1:])
    return 0.0, fan_in ** -0.5


def seeded_tower(shapes: Mapping[str, Tuple[int, ...]], seed: int, device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the leaves `shapes` in `dtype` on `device`: one
    normal draw for the whole tower, views of it scaled leaf by leaf."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        mean, std = leaf_init(name, tuple(shape))
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
    return out


def seeded_weights(shapes: Mapping[str, Mapping[str, Tuple[int, ...]]], seed: int, device,
                   dtypes: Mapping[str, torch.dtype]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every tower's weights ({tower: {name: tensor}}), tower `k` in
    ``dtypes[k]``, each from its own sub-seed of `seed`."""
    return {k: seeded_tower(s, sub_seed(seed, "weights", k), device, dtypes[k])
            for k, s in shapes.items()}


def prompt_ids(rng: np.random.Generator, rows: int, lo: int, hi: int,
               length: int = 77) -> np.ndarray:
    """[rows, length] int64 token ids: SOT, a prompt of n - 2 ids with n
    drawn from [lo, hi], EOT, then EOT padding (as CLIP's tokenizer pads)."""
    out = np.full((rows, length), EOT, dtype=np.int64)
    for r in range(rows):
        n = int(rng.integers(lo, hi + 1))
        out[r, 0] = SOT
        out[r, 1:n - 1] = rng.integers(256, SOT, size=n - 2)
    return out


def empty_prompt_ids(rows: int, length: int = 77) -> np.ndarray:
    """The empty prompt's ids: SOT, EOT, EOT padding."""
    out = np.full((rows, length), EOT, dtype=np.int64)
    out[:, 0] = SOT
    return out


def hint_images(rng: np.random.Generator, rows: int, size: int) -> np.ndarray:
    """[rows, size, size, 3] float32 hint images in [0, 1]."""
    return rng.random((rows, size, size, 3), dtype=np.float32)


def prompt_ids_on(gen: torch.Generator, rows: int, lo: int, hi: int, length: int,
                  device) -> torch.Tensor:
    """``prompt_ids`` drawn on the device from `gen` (no host copy in a
    training step): SOT, n - 2 ids with n in [lo, hi], EOT padding."""
    ids = torch.randint(256, SOT, (rows, length), generator=gen, device=device)
    n = torch.randint(lo, hi + 1, (rows, 1), generator=gen, device=device)
    pos = torch.arange(length, device=device)[None]
    ids = torch.where(pos >= n - 1, torch.full_like(ids, EOT), ids)
    ids[:, 0] = SOT
    return ids


def train_draws(seed: int, step: int, rows: int, latent: Tuple[int, int, int],
                timesteps: int, device) -> Dict[str, torch.Tensor]:
    """The random draws of training step `step` (0-based) for `rows` rows:
    the posterior noise of the target and of the hint, t uniform in
    [0, timesteps), the diffusion noise."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "draws", step))
    noise = torch.randn((3, rows, *latent), generator=gen, device=device)
    return {"z_eps": noise[0], "hint_eps": noise[1],
            "t": torch.randint(0, timesteps, (rows,), generator=gen, device=device),
            "noise": noise[2]}


def train_rows(seed: int, part: int, rows: int, size: int, tokens: Tuple[int, int],
               device, length: int = 77) -> Dict[str, torch.Tensor]:
    """`rows` training rows, made on the device: target images in [-1, 1]
    and hints in [0, 1], [rows, size, size, 3], and prompt ids; `part`
    numbers the blocks of rows (a step)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "batch", part))
    img = torch.rand((2, rows, size, size, 3), generator=gen, device=device)
    return {"jpg": img[0] * 2 - 1, "hint": img[1],
            "token_ids": prompt_ids_on(gen, rows, *tokens, length, device)}


def train_batch(seed: int, step: int, rows: int, size: int, tokens: Tuple[int, int],
                latent: Tuple[int, int, int], timesteps: int, device, length: int = 77
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(batch, draws) of training step `step`."""
    return (train_rows(seed, step, rows, size, tokens, device, length),
            train_draws(seed, step, rows, latent, timesteps, device))


def rows_of(d: Mapping[str, torch.Tensor], lo: int, hi: int) -> Dict[str, torch.Tensor]:
    return {k: v[lo:hi] for k, v in d.items()}

