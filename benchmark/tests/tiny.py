"""A benchmark root at a size a CPU test holds: ``BENCHMARK.json`` with one
sampling and one training cell on the program's tiny configuration, their
traffic and limits, in a directory of its own; the drivers and metric
readers are the benchmark's."""

from __future__ import annotations

import dataclasses
import json
import os

TINY_SAMPLE = {"kind": "sample", "why": "tiny", "batch": 2, "resolution": 16, "steps": 3,
               "eta": 0.0, "scale": 7.5, "strength": 1.0, "prompt_tokens": [4, 16],
               "hint_pool": 2, "trace_requests": 1, "check": {"rows": 2, "steps": 3}}
TINY_TRAIN = {"kind": "train", "why": "tiny", "batch": 4, "resolution": 16,
              "prompt_tokens": [4, 16], "check_steps": 3, "trace_steps": 1, "row_block": 2}
TRAIN = {"learning_rate": 1e-3, "weight_decay": 0.01, "adam_b1": 0.9, "adam_b2": 0.999,
         "adam_eps": 1e-8, "trainable": "lora"}


def tiny_model(switchable: bool) -> dict:
    from ctrlora_tpu_torch import configs

    return dataclasses.asdict(configs.tiny_test_config(switchable_banks=switchable))


def write_root(root: str, limits: dict = None) -> str:
    """The tiny benchmark under `root` (its own ``paths`` directory 'tb');
    returns `root`. `limits`: {workload: {number: limit}} to use instead of
    the full-size cells' limits."""
    from benchmark.spec import Spec

    full = Spec()
    d = os.path.join(root, "tb")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)

    def dump(path, obj):
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)

    dump("tb/configs/tiny_sample.json", {"name": "tiny_sample", "model": tiny_model(True)})
    dump("tb/configs/tiny_train.json", {"name": "tiny_train", "model": tiny_model(False),
                                        "train": TRAIN})
    dump("tb/traffic/tiny_sample.json", TINY_SAMPLE)
    dump("tb/traffic/tiny_train.json", TINY_TRAIN)
    limits = limits or {}
    for cell, full_cell in (("tiny.sample", "sample.b8.ddim50"), ("tiny.train", "finetune.b16")):
        with open(full.find("limits", full_cell)) as f:
            dump(f"tb/limits/{cell}.json", limits.get(cell, json.load(f)))
    per_layer = [dict(m, workloads=["tiny.sample" if "sample" in m["name"] else "tiny.train"])
                 for m in full.data["per_layer"]]
    dump("BENCHMARK.json", {
        "command": ["python3", "-m", "benchmark.run"], "paths": ["tb"], "run_seconds": 1,
        "configs": [{"name": "tiny_sample", "source": "test", "file": "tb/configs/tiny_sample.json",
                     "reduced": [], "why": "tiny"},
                    {"name": "tiny_train", "source": "test", "file": "tb/configs/tiny_train.json",
                     "reduced": [], "why": "tiny"}],
        "workloads": [{"name": "tiny.sample", "config": "tiny_sample", "traffic": "tiny_sample",
                       "chips": 1, "why": "tiny"},
                      {"name": "tiny.train", "config": "tiny_train", "traffic": "tiny_train",
                       "chips": 1, "why": "tiny"}],
        "end_to_end": [dict(m, workloads=["tiny.sample"]) if m["name"].startswith("sample") else
                       dict(m, workloads=["tiny.train"])
                       if m["name"].startswith("train") else m
                       for m in full.data["end_to_end"]],
        "per_layer": per_layer})
    return root
