"""Latent-moment cache for deterministic training datasets (counterpart
of ``ctrlora_tpu/training/latent_cache.py``).

A CustomDataset example is a pure function of its files (resize only, no
random crop), so the frozen VAE encoder's posterior moments (mean |
logvar) of its target and hint can be computed once, and each step draws
z = mean + std * eps from them with the same draws as the pixel step
(``training.step._latent``). MultiGen-20M crops at random per visit, so
its moments change every visit: the CLIs offer the cache for --dataroot
only.

The moments are stored as fp32 numpy arrays [N, h, w, 8]: numpy has no
bf16, and the bf16 encoder's output widens to fp32 exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ctrlora_tpu_torch.pipeline import CtrLoraPipeline


@torch.no_grad()
def precompute_moments(pipe: CtrLoraPipeline, ds, batch_size: int = 8,
                       log=print) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every (target, hint) pair of `ds` once on the pipeline's
    device, `batch_size` at a time (the tail padded with zeros to a full
    batch, as the JAX pre-pass pads it); returns the two [N, h, w, 8]
    fp32 arrays of concatenated (mean | logvar)."""
    n = len(ds)
    rng = np.random.default_rng(0)  # prompt dropout is irrelevant here
    outs = None
    for lo in range(0, n, batch_size):
        ex = [ds.get(i, rng) for i in range(lo, min(lo + batch_size, n))]
        got = []
        for key in ("jpg", "hint"):
            x = np.stack([e[key] for e in ex])
            x = np.concatenate([x, np.zeros((batch_size - len(ex), *x.shape[1:]), x.dtype)])
            moments = torch.cat(pipe.vae.encode(torch.from_numpy(x).to(pipe.device)), dim=-1)
            got.append(moments[:len(ex)].float().cpu().numpy())
        if outs is None:
            outs = tuple(np.empty((n, *g.shape[1:]), np.float32) for g in got)
        for out, g in zip(outs, got):
            out[lo:lo + len(ex)] = g
        if lo // batch_size % 16 == 0:
            log(f"# latent cache: {lo + len(ex)}/{n}")
    return outs


class LatentCachedDataset:
    """A deterministic dataset whose examples carry the precomputed VAE
    posterior moments (``jpg_moments``, ``hint_moments``) instead of
    pixels; the prompt and its dropout draw are the wrapped dataset's, in
    the same order, so swapping the wrapper in changes nothing but the
    encode cost."""

    def __init__(self, ds, jpg_moments: np.ndarray, hint_moments: np.ndarray):
        if len(ds) != len(jpg_moments) or len(ds) != len(hint_moments):
            raise ValueError(f"cache size {len(jpg_moments)}/{len(hint_moments)} != "
                             f"dataset size {len(ds)}")
        self.ds = ds
        self.jpg_moments = jpg_moments
        self.hint_moments = hint_moments

    def __len__(self) -> int:
        return len(self.ds)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        prompt = self.ds.data[idx]["prompt"]
        if rng.random() < self.ds.drop_rate:  # CustomDataset.get's single draw
            prompt = ""
        return dict(jpg_moments=self.jpg_moments[idx], hint_moments=self.hint_moments[idx],
                    txt=prompt)
