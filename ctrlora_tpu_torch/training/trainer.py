"""Training loop: the mesh, metrics logging, checkpoints, the EMA swap and
the image log (counterpart of ``ctrlora_tpu/training/trainer.py``).

In a process group (``parallel.mesh.init_distributed``) the trainer runs
over a ``(world / tp, tp)`` mesh: the weights are broadcast from rank 0 at
init, ``fit`` takes each rank's rows of a host-global batch (or, with
``global_batches=False``, batches that already are this rank's rows, as the
CLIs' loaders give them), and the step averages the gradients over the
data ranks (``training.step``) with the attention and feed-forward sites
split over the model ranks under ``tp > 1`` (``parallel.tp``). Only rank 0
writes the log lines, ``metrics.jsonl``, ``trainable_params.txt``, the
checkpoints and the image log; every rank restores.

``workdir/metrics.jsonl`` gets the JAX trainer's JSON lines: one ``init``
line (``trainable_params_m``), a ``train`` line every ``log_every`` steps
(``steps_per_sec`` and the window means of ``loss``, ``grad_norm`` and the
other step metrics), a ``ckpt`` line per checkpoint and an ``image_log``
line per image grid (its path and seconds); ``workdir/trainable_params.txt``
lists the trainable parameters. A checkpoint is ``torch.save`` of the step,
the trainable parameters, the AdamW state and the EMA shadow.

Each step's random draws come from a generator seeded with (seed + 1,
step), as the JAX step folds the step into its key: a run resumed from a
checkpoint draws what the straight run draws.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.parallel import mesh as pmesh
from ctrlora_tpu_torch.parallel import tp as tp_mod
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.training.ema import EmaState, ema_init, ema_scope
from ctrlora_tpu_torch.training.step import make_train_step
from ctrlora_tpu_torch.training.train_state import (
    TrainState, branches, count_trainable, make_optimizer, trainable_mask, trainable_parameters,
)
from ctrlora_tpu_torch.utils.image import png_writer, write_png
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's generator: a function of (seed, step) only."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    def __init__(self, pipe: CtrLoraPipeline, cfg: TrainConfig, workdir: str, tp: int = 1):
        """`pipe` holds the weights to train (``fuse_lora=False`` for a LoRA
        finetune); its parameters outside the trainable mask are frozen.
        `tp` > 1 splits the attention heads and GEGLU hidden over `tp` model
        ranks (it must divide the world's ranks)."""
        self.pipe = pipe
        self.cfg = cfg
        self.workdir = workdir
        self.tp = int(tp)
        n = pmesh.world_size()
        if self.tp < 1 or n % self.tp:
            raise ValueError(f"--tp {self.tp} does not divide {n} devices")
        self.mesh = pmesh.create_mesh_2d(n // self.tp, self.tp) if pmesh.in_group() else None
        self.is_main = pmesh.process_index() == 0
        if self.is_main:
            os.makedirs(workdir, exist_ok=True)
        self.mask = trainable_mask(pipe, cfg)
        optimizer = make_optimizer(pipe, cfg, self.mask, self.mesh)
        trainable = trainable_parameters(pipe, self.mask)
        if self.mesh is not None:
            pmesh.replicate(self.mesh, list(branches(pipe).values()))
        self.state = TrainState(0, branches(pipe), optimizer, trainable,
                                ema_init(trainable) if cfg.use_ema else None)
        self.step_fn = make_train_step(pipe, optimizer, cfg, self.mesh)
        self.generator = torch.Generator(device=pipe.device)
        init = {"event": "init",
                "trainable_params_m": round(count_trainable(pipe, self.mask) / 1e6, 2),
                "device": str(pipe.device)}
        if self.mesh is not None:
            init["mesh"] = list(self.mesh.shape)
        self._log(init)
        if self.is_main:
            with open(os.path.join(workdir, "trainable_params.txt"), "w") as f:
                for name in trainable:
                    f.write(name + "\n")

    def _tp_scope(self):
        """The tensor-parallel context around each step (a no-op at tp 1)."""
        if self.tp > 1:
            return tp_mod.tensor_parallel(self.mesh)
        return contextlib.nullcontext()

    def _log(self, d: dict) -> None:
        if not self.is_main:
            return
        d.setdefault("time", round(time.time(), 2))
        line = json.dumps(d)
        print(line, flush=True)
        with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
            f.write(line + "\n")

    def fit(self, batches: Iterable[dict], max_steps: Optional[int] = None,
            sample_hook: Optional[Callable[[TrainState, int, dict], object]] = None,
            global_batches: bool = True) -> TrainState:
        """Step through `batches` until the state reaches max_steps (a batch
        is taken only for a step that runs); ``sample_hook(state, step,
        batch)`` runs on rank 0 after every ``image_log_every``-th step, on
        the step's first micro-batch under grad_accum. Over a mesh each
        batch is host-global and the step takes this rank's rows of it (of
        each micro-batch under grad_accum), unless `global_batches` is False:
        then the batches are this rank's rows already."""
        cfg = self.cfg
        max_steps = max_steps or cfg.max_steps
        batches = iter(batches)
        t0 = time.perf_counter()
        window = []
        while self.state.step < max_steps:
            batch = next(batches, None)
            if batch is None:
                break
            local = batch
            if self.mesh is not None and global_batches:
                local = pmesh.shard_batch(self.mesh, batch, axis=1 if cfg.grad_accum > 1 else 0)
            self.generator.manual_seed(step_seed(cfg.seed + 1, self.state.step))
            with self._tp_scope():
                self.state, metrics = self.step_fn(self.state, local, self.generator)
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
            if sample_hook is not None and self.is_main and step % cfg.image_log_every == 0:
                t_hook = time.perf_counter()
                if cfg.grad_accum > 1:
                    batch = {k: v[0] for k, v in batch.items()}
                path = sample_hook(self.state, step, batch)
                self._log({"event": "image_log", "step": step, "path": path,
                           "seconds": round(time.perf_counter() - t_hook, 3)})
        return self.state

    def eval_params(self):
        """Context manager: inside it the live parameters hold the EMA
        shadow when use_ema is set (the reference's ema_scope), and on
        leaving their own values come back bit for bit."""
        return ema_scope(self.state.trainable, self.state.ema)

    def save(self, step: int) -> str:
        """Write the checkpoint on rank 0 (every rank calls it: a sharded
        optimizer state is gathered first); returns its path."""
        path = os.path.join(self.workdir, f"ckpt_{step:08d}.pt")
        ema = self.state.ema
        optimizer = self.state.optimizer.state_dict()
        if self.is_main:
            torch.save({"step": self.state.step,
                        "trainable": {k: p.detach() for k, p in self.state.trainable.items()},
                        "optimizer": optimizer,
                        "ema": None if ema is None else {"params": ema.params,
                                                         "updates": ema.updates}}, path)
        self._log({"event": "ckpt", "step": step, "path": path})
        return path

    def restore(self, path: str) -> None:
        # on the CPU: the optimizer moves its state to each parameter's
        # device, and keeps AdamW's step count on the host where it was
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        params = self.state.trainable
        if set(ckpt["trainable"]) != set(params):
            raise ValueError(f"{path}: trainable set differs from this trainer's")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(ckpt["trainable"][name])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        self.state.step = ckpt["step"]
        if self.cfg.use_ema:
            if ckpt.get("ema") is None:
                raise ValueError(f"{path} holds no EMA shadow, and use_ema is set")
            self.state.ema = EmaState({k: v.to(self.pipe.device)
                                       for k, v in ckpt["ema"]["params"].items()},
                                      ckpt["ema"]["updates"])


# ---------------------------------------------------------------------------
# the image log
# ---------------------------------------------------------------------------

def _prompts(token_ids: torch.Tensor) -> list:
    """The prompt text of each row of token ids (between SOT and EOT)."""
    tok = default_tokenizer()
    out = []
    for row in token_ids.cpu().tolist():
        body = row[1:row.index(tok.eot_token)] if tok.eot_token in row else row[1:]
        out.append(tok.decode(body).strip())
    return out


def _txt_strip(prompts, width: int, height: int = 48) -> np.ndarray:
    """The prompts rendered as one white uint8 [height, width, 3] strip, a
    tile each side by side (the role of log_txt_as_img, ldm/util.py:11):
    PIL's default font where PIL is installed, as the JAX hook draws, else
    cv2's."""
    per = max(1, width // max(1, len(prompts)))
    n = max(4, per // 7)  # ~7 px per character
    pil = importlib.util.find_spec("PIL") is not None
    tiles = []
    for p in prompts:
        lines = [str(p)[i:i + n] for i in range(0, len(str(p)), n)]
        if pil:
            from PIL import Image, ImageDraw

            tile = Image.new("RGB", (per, height), "white")
            ImageDraw.Draw(tile).text((2, 2), "\n".join(lines)[:256], fill="black")
            tiles.append(np.asarray(tile))
        else:
            import cv2

            tile = np.full((height, per, 3), 255, np.uint8)
            for j, line in enumerate(lines[:3]):
                cv2.putText(tile, line, (2, 12 + 14 * j), cv2.FONT_HERSHEY_PLAIN, 0.8,
                            (0, 0, 0), 1)
            tiles.append(tile)
    strip = np.concatenate(tiles, axis=1)
    if strip.shape[1] < width:
        strip = np.concatenate([strip, np.full((height, width - strip.shape[1], 3), 255,
                                               np.uint8)], axis=1)
    return strip[:, :width]


@torch.no_grad()
def image_log_rows(pipe: CtrLoraPipeline, batch: dict, step: int, ddim_steps: int = 20,
                   x_T: Optional[torch.Tensor] = None) -> dict:
    """The image log's pictures of the batch's first two examples, before
    the uint8 cast: 'control' [B, H, W, 3] in [0, 1], 'reconstruction' and
    'samples' (DDIM at CFG 9.0 against all-zero uncond token ids) in
    [-1, 1]. A latent-cached batch is decoded from its moments: the
    control from the hint's posterior mean, the reconstruction from the
    target's. A latent-hint model samples from the control's latent, an
    image-hint one from its pixels (with ControlNet-Lite, no row tables).
    The starting noise is `x_T`, else a CPU generator seeded with
    `step`."""
    cached = "jpg_moments" in batch
    latent_hint = pipe.cfg.control.hint_mode == "latent"
    ids = batch["token_ids"]
    b = min(2, ids.shape[0])
    ids = ids[:b]
    ctx, unc = pipe.encode_text_cond_uncond(ids, torch.zeros_like(ids))
    if cached:
        hint_z = pipe.first_stage_from_moments(batch["hint_moments"][:b])
        control = pipe.decode_first_stage(hint_z) * 0.5 + 0.5
        hint_in = hint_z if latent_hint else control
        recon = pipe.decode_first_stage(pipe.first_stage_from_moments(batch["jpg_moments"][:b]))
    else:
        control = batch["hint"][:b].float()
        hint_in = pipe.encode_first_stage(control) if latent_hint else control
        recon = pipe.decode_first_stage(pipe.encode_first_stage(batch["jpg"][:b]))
    task = batch.get("task_idx")
    conds = [Conditioning(hint_in, lora_idx=None if task is None else int(task.reshape(-1)[0]))]
    f = 2 ** (len(pipe.cfg.vae.ch_mult) - 1)
    shape = (b, control.shape[1] // f, control.shape[2] // f, 4)
    z = ddim_sample(pipe, ctx, unc, conds, shape,
                    DDIMConfig(steps=ddim_steps, guidance_scale=9.0), x_T=x_T,
                    generator=torch.Generator().manual_seed(step))
    return {"control": control.float().cpu().numpy(), "reconstruction": recon.cpu().numpy(),
            "samples": pipe.decode_first_stage(z).cpu().numpy()}


def make_image_log_hook(pipe: CtrLoraPipeline, workdir: str, ddim_steps: int = 20):
    """The periodic training grid (role of ImageLogger, cldm/logger.py:12-78):
    the prompts as text, then rows of control, reconstruction and CFG-9.0
    samples of the batch's first two examples, written to
    ``workdir/image_log/step_<step>.png``. It samples the training
    pipeline's own (unfused) modules, under the EMA shadow when the state
    keeps one. ``hook(state, step, batch, x_T=None)`` returns the PNG's
    path. Raises ImportError at once where the host cannot write PNGs."""
    png_writer()
    os.makedirs(os.path.join(workdir, "image_log"), exist_ok=True)

    def hook(state: TrainState, step: int, batch: dict,
             x_T: Optional[torch.Tensor] = None) -> str:
        with ema_scope(state.trainable, state.ema):
            rows = image_log_rows(pipe, batch, step, ddim_steps, x_T)
        u8 = lambda x: np.concatenate(list(x.clip(0, 255).astype(np.uint8)), axis=1)
        grid = [u8(rows["control"] * 255), u8(rows["reconstruction"] * 127.5 + 127.5),
                u8(rows["samples"] * 127.5 + 127.5)]
        grid.insert(0, _txt_strip(_prompts(batch["token_ids"][:len(rows["control"])]),
                                  grid[0].shape[1]))
        path = os.path.join(workdir, "image_log", f"step_{step:08d}.png")
        write_png(path, np.concatenate(grid, axis=0))
        return path

    return hook
