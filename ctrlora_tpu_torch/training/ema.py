"""Exponential moving average of the trainable parameters (counterpart of
``ctrlora_tpu/training/ema.py``; reference: ldm/modules/ema.py LitEma,
decay min(decay, (1+updates)/(10+updates)), hooked by the trainer behind
``TrainConfig.use_ema``).

The shadow holds the trainable parameters only, in fp32, keyed by the
'branch.name' of ``train_state.trainable_parameters``; the frozen towers
have none. An update is one group of ``torch._foreach_*`` launches over all
shadow tensors, not a launch per tensor. ``ema_scope`` is the reference's
``ema_scope`` swap (ldm/models/diffusion/ddpm.py:185-199).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Mapping, Optional

import torch


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # fp32 shadow of each trainable parameter
    updates: int = 0


def ema_init(params: Mapping[str, torch.Tensor]) -> EmaState:
    """An fp32 copy of `params` (own storage, never a view of the live one)."""
    return EmaState({k: p.detach().to(torch.float32, copy=True) for k, p in params.items()})


@torch.no_grad()
def ema_update(state: EmaState, params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> None:
    """shadow <- shadow - (1 - d) (shadow - live), in place, with
    d = min(decay, (1 + n) / (10 + n)) for the n-th update."""
    state.updates += 1
    n = state.updates
    d = min(decay, (1.0 + n) / (10.0 + n))
    shadow = list(state.params.values())
    live = [params[k].detach().float() for k in state.params]
    torch._foreach_add_(shadow, torch._foreach_sub(shadow, live), alpha=-(1.0 - d))


def ema_params(params: Mapping[str, torch.Tensor], ema: EmaState) -> Dict[str, torch.Tensor]:
    """Evaluation values: the shadow where it is kept, the live parameter
    elsewhere."""
    return {k: ema.params.get(k, p) for k, p in params.items()}


@contextlib.contextmanager
def ema_scope(params: Mapping[str, torch.nn.Parameter],
              ema: Optional[EmaState]) -> Iterator[None]:
    """Inside the block the live parameters hold the shadow's values; on
    leaving, their own values come back bit for bit. Without an EMA it does
    nothing."""
    if ema is None:
        yield
        return
    live = [p.data for p in params.values()]
    saved = [t.clone() for t in live]
    with torch.no_grad():
        torch._foreach_copy_(live, [v.to(t.dtype) for v, t in
                                    zip(ema_params(params, ema).values(), live)])
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_(live, saved)
