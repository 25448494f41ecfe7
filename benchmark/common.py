"""Pieces the drivers share: the program's configuration from a
configuration file, the weights' shapes, the device record, comparisons."""

from __future__ import annotations

import math
import statistics
import subprocess
from typing import Dict, Iterable, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(model: dict):
    """The program's ModelConfig of a configuration file's ``model`` section
    (every field of the program's config tree, as ``dataclasses.asdict``
    writes it)."""
    from ctrlora_tpu_torch import configs

    return configs.check_ported(configs._dataclass_from_dict(configs.ModelConfig, model))


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def unfused_control_shapes(model_cfg) -> Dict[str, Tuple[int, ...]]:
    """The leaves of the control tree as a LoRA checkpoint holds it (every
    Linear's ``lora_down`` / ``lora_up``, switchable banks where the
    configuration has them), from a ControlNet built on the meta device."""
    from ctrlora_tpu_torch.models.unet import ControlNet

    with torch.device("meta"):
        return shapes_of(ControlNet(model_cfg.control))


def tower_dtypes(model: dict, training: bool) -> Dict[str, torch.dtype]:
    """The dtype each tower's weights are held in: training keeps float32
    masters; serving holds the UNet, ControlNet and VAE in their compute
    dtype, CLIP in float32."""
    if training:
        return {k: torch.float32 for k in ("unet", "control", "vae", "clip")}
    return {"unet": DTYPES[model["unet"]["dtype"]],
            "control": DTYPES[model["control"]["unet"]["dtype"]],
            "vae": DTYPES[model["vae"]["dtype"]], "clip": DTYPES[model["clip"]["dtype"]]}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's |got - want| / max(want, the median leaf's want) and
    its name, over `names` (default every leaf of `want`)."""
    names = list(want if names is None else names)
    if not names:
        return 0.0, ""
    med = statistics.median(want[n] for n in names)
    worst, at = -1.0, ""
    for n in names:
        gap = abs(got.get(n, 0.0) - want[n]) / max(want[n], med, 1e-300)
        if not math.isfinite(gap):
            return float("inf"), n
        if gap > worst:
            worst, at = gap, n
    return worst, at


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts (nvidia-smi), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_record(chips: int, device: torch.device, peak: int) -> dict:
    """``device`` of the result line: platform, the card's name, the cards
    used, `peak` (the fullest card's peak memory), the power limit."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
