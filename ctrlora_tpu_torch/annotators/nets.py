"""What the port's CNN detectors (``hed.py``, ``lineart.py``, ``mlsd.py``,
``midas.py``, ``uniformer.py``, ``openpose/``) share: the device they run
on, their weights and the fp32 forward.

Device: the card unless the caller asks for the CPU; a detector asked for
``cuda`` on a host without one raises (no fallback). Weights: the published
``.pth`` file where it is present (``download.ensure_ckpt``), read with
``weights_only=True``; else torch's initialisation under the fixed seed
``INIT_SEED``, and the detector logs that it did (the JAX package takes
Flax's initialisation under PRNGKey(0) there, so the two differ then; given
one file, both load the same weights). Forward: in full fp32 with TF32 off
(``utils.precision.fp32_exact``), NHWC numpy in, NCHW tensors inside.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ctrlora_tpu_torch.annotators.download import ckpts_dir, ensure_ckpt
from ctrlora_tpu_torch.utils.precision import fp32_exact

log = logging.getLogger(__name__)

INIT_SEED = 0

StateDict = Dict[str, torch.Tensor]


def net_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device torch cannot see."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a detector was asked to run on {device}, but torch sees no CUDA "
                           f"device; pass device='cpu' to run it on the CPU")
    return device


def read_weights(name: str, ckpt_dir: Optional[str] = None, strip_module: bool = False,
                 drop: Tuple[str, ...] = ()) -> Optional[StateDict]:
    """The tensors of weight file `name` in `ckpt_dir` (default
    ``ckpts_dir()``), or None where it is absent. A checkpoint that nests
    its tensors under 'state_dict' (MiDaS's, mmseg's beside a 'meta' dict)
    is unwrapped, as the JAX package's loaders do. ``strip_module`` drops
    every 'module.' from the keys (files saved from DataParallel); keys
    that start with a prefix in ``drop`` are left out (parts of the
    published network the detector never runs)."""
    path = ensure_ckpt(name, os.path.join(ckpt_dir or ckpts_dir(), name))
    if not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {(k.replace("module.", "") if strip_module else k): v for k, v in sd.items()
            if isinstance(v, torch.Tensor) and not k.startswith(drop)}


def build(factory: Callable[[], nn.Module], state: Optional[StateDict], what: str,
          device) -> nn.Module:
    """factory() with `state` loaded (strict), or with torch's
    initialisation under INIT_SEED where `state` is None; in eval mode,
    without gradients, on `device`."""
    device = net_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INIT_SEED)
        model = factory()
    if state is None:
        log.warning("%s: no weight file; running on torch's initialisation under seed %d",
                    what, INIT_SEED)
    else:
        model.load_state_dict(state, strict=True)
    return model.to(device).eval().requires_grad_(False)


def device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def forward(model: nn.Module, x: np.ndarray):
    """model(x) for a float32 NHWC numpy batch, as NCHW on the model's
    device, in full fp32; tensors come back on the CPU (a list stays a
    list)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device_of(model))
    with fp32_exact():
        out = model(t.permute(0, 3, 1, 2))
    if isinstance(out, (list, tuple)):
        return [o.cpu() for o in out]
    return out.cpu()
