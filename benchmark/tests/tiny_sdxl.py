"""A benchmark root with one SDXL sampling cell on the program's tiny SDXL
configuration (``tiny.sdxl``), at a size a CPU test holds: its own
``BENCHMARK.json``, configuration, traffic and the full cell's limits, in a
directory of its own; the driver and metric readers are the benchmark's."""

from __future__ import annotations

import dataclasses
import json
import os

TINY_SDXL = {"kind": "sample_sdxl", "why": "tiny", "batch": 2, "resolution": 64, "steps": 3,
             "eta": 0.0, "scale": 5.0, "strength": 1.0, "prompt_tokens": [4, 16],
             "hint_pool": 2, "trace_requests": 1, "check": {"rows": 2, "steps": 3}}
FULL_CELL = "sdxl_cn.b4.ddim50"


def tiny_model(**unet) -> dict:
    """The tiny SDXL model section; `unet` overrides both UNet sections."""
    from ctrlora_tpu_torch import configs

    m = dataclasses.asdict(configs.tiny_sdxl_test_config())
    for section in (m["unet"], m["control"]["unet"]):
        section.update(unet)
    return m


def write_root(root: str, traffic: dict = None, **unet) -> str:
    """The tiny SDXL benchmark under `root` (its ``paths`` directory 'tb');
    returns `root`."""
    from benchmark.spec import Spec

    full = Spec()
    d = os.path.join(root, "tb")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)

    def dump(path, obj):
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)

    dump("tb/configs/tiny_sdxl.json", {"name": "tiny_sdxl", "model": tiny_model(**unet)})
    dump("tb/traffic/tiny_sdxl.json", dict(TINY_SDXL, **(traffic or {})))
    with open(full.find("limits", FULL_CELL)) as f:
        dump("tb/limits/tiny.sdxl.json", json.load(f))
    per_layer = [dict(m, workloads=["tiny.sdxl"]) for m in full.data["per_layer"]
                 if FULL_CELL in m.get("workloads", [])]
    end_to_end = [dict(m, workloads=["tiny.sdxl"]) if "workloads" in m else m
                  for m in full.data["end_to_end"] if FULL_CELL in m.get("workloads", [FULL_CELL])]
    dump("BENCHMARK.json", {
        "command": ["python3", "-m", "benchmark.run"], "paths": ["tb"], "run_seconds": 1,
        "configs": [{"name": "tiny_sdxl", "source": "test", "file": "tb/configs/tiny_sdxl.json",
                     "reduced": [], "why": "tiny"}],
        "workloads": [{"name": "tiny.sdxl", "config": "tiny_sdxl", "traffic": "tiny_sdxl",
                       "chips": 1, "why": "tiny"}],
        "end_to_end": end_to_end, "per_layer": per_layer})
    return root
