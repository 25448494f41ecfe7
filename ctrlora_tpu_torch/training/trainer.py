"""Training loop on one device: metrics logging and checkpoints
(counterpart of ``ctrlora_tpu/training/trainer.py`` without the mesh and
the image-log hook).

``workdir/metrics.jsonl`` gets the JAX trainer's JSON lines: one ``init``
line (``trainable_params_m``) and a ``train`` line every ``log_every``
steps (``steps_per_sec`` and the window means of ``loss``, ``grad_norm``
and the other step metrics); ``workdir/trainable_params.txt`` lists the
trainable parameters. A checkpoint is ``torch.save`` of the trainable
parameters and the AdamW state.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

import torch

from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.training.step import make_train_step
from ctrlora_tpu_torch.training.train_state import (
    TrainState, branches, count_trainable, make_optimizer, trainable_mask, trainable_parameters,
)


class Trainer:
    def __init__(self, pipe: CtrLoraPipeline, cfg: TrainConfig, workdir: str):
        """`pipe` holds the weights to train (``fuse_lora=False`` for a LoRA
        finetune); its parameters outside the trainable mask are frozen."""
        self.pipe = pipe
        self.cfg = cfg
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.mask = trainable_mask(pipe, cfg)
        optimizer = make_optimizer(pipe, cfg, self.mask)
        self.state = TrainState(0, branches(pipe), optimizer)
        self.step_fn = make_train_step(pipe, optimizer, cfg)
        # the steps' random draws, one stream across fit() calls
        self.generator = torch.Generator(device=pipe.device).manual_seed(cfg.seed + 1)
        self._log({"event": "init",
                   "trainable_params_m": round(count_trainable(pipe, self.mask) / 1e6, 2),
                   "device": str(pipe.device)})
        with open(os.path.join(workdir, "trainable_params.txt"), "w") as f:
            for name in trainable_parameters(pipe, self.mask):
                f.write(name + "\n")

    def _log(self, d: dict) -> None:
        d.setdefault("time", round(time.time(), 2))
        line = json.dumps(d)
        print(line, flush=True)
        with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
            f.write(line + "\n")

    def fit(self, batches: Iterable[dict], max_steps: Optional[int] = None) -> TrainState:
        """Step through `batches` until the state reaches max_steps; the
        steps' random draws come from the trainer's generator."""
        cfg = self.cfg
        max_steps = max_steps or cfg.max_steps
        t0 = time.perf_counter()
        window = []
        for batch in batches:
            if self.state.step >= max_steps:
                break
            self.state, metrics = self.step_fn(self.state, batch, self.generator)
            window.append(metrics)
            step = self.state.step
            if step % cfg.log_every == 0:
                means = {k: round(float(torch.stack([w[k].float().cpu() for w in window]).mean()), 5)
                         for k in window[0]}
                self._log({"event": "train", "step": step,
                           "steps_per_sec": round(len(window) / (time.perf_counter() - t0), 3),
                           **means})
                window, t0 = [], time.perf_counter()
            if step % cfg.ckpt_every == 0:
                self.save(step)
        return self.state

    def save(self, step: int) -> str:
        path = os.path.join(self.workdir, f"ckpt_{step:08d}.pt")
        torch.save({"step": self.state.step,
                    "trainable": {k: p.detach() for k, p in
                                  trainable_parameters(self.pipe, self.mask).items()},
                    "optimizer": self.state.optimizer.state_dict()}, path)
        self._log({"event": "ckpt", "step": step, "path": path})
        return path

    def restore(self, path: str) -> None:
        ckpt = torch.load(path, map_location=self.pipe.device)
        params = trainable_parameters(self.pipe, self.mask)
        if set(ckpt["trainable"]) != set(params):
            raise ValueError(f"{path}: trainable set differs from this trainer's")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(ckpt["trainable"][name])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        self.state.step = ckpt["step"]
