"""Driver of the training mixes (``"kind": "train"``): the program's
trainer (``training.trainer.Trainer``) stepping on batches and draws made
from the seed.

The window calls the trainer's own step, ``trainer.step_fn`` (made by
``training.step.make_train_step``: the frozen encodes, the eps-MSE loss,
backward, the gradient norm, AdamW), with each step's batch and its random
draws (posterior noise, t, diffusion noise) handed over by the benchmark,
so that the reference receives the same. ``Trainer.fit`` draws them from
its own generator and cannot take them.

The mix's file gives: ``batch`` rows a step at ``resolution``, prompts of
``prompt_tokens`` = [lo, hi] ids, ``check_steps`` (the set-up steps the
reference follows), ``trace_steps`` and the reference's ``row_block``.
The configuration's ``train`` section gives the trainer's settings.

Correctness: set-up builds one trainer and drives it through the first
``check_steps`` steps through the same call as the window, on rows that
all differ; it keeps each step's loss, the gradient AdamW received at the
first step (its first moment over 1 - beta1) and each trainable leaf's
change after the last. After the window the float32 reference starts from
the same seeded weights and follows those steps on its own: its loss, its
gradient (summed over blocks of rows) and its own AdamW.
"""

from __future__ import annotations

import math
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import common, seeding
from benchmark.flops import fn_flops
from benchmark.reference.diffusion import Reference, adamw_step, eps_mse_loss
from benchmark.reference.sd15 import fp32_products

KIND = "train"
_NORM_NAMES = {"norm", "norm1", "norm2", "norm3"}
NEVER = 10 ** 9


def trains(name: str, train: dict) -> bool:
    """Whether the control leaf `name` trains under the configuration's
    ``train`` section (CtrLoRA's recipes: 'lora' trains the LoRA matrices,
    the zero convs and the transformer norms; 'all' every control leaf)."""
    parts = name.split(".")
    if train["trainable"] == "all":
        return True
    if train["trainable"] != "lora":
        raise ValueError(f"the reference knows trainable 'lora' and 'all', not "
                         f"{train['trainable']!r}")
    return (any(p in ("lora_down", "lora_up") for p in parts)
            or (train.get("zero_trainable", True) and any(p.startswith("zero_") for p in parts))
            or (train.get("norm_trainable", True) and any(p in _NORM_NAMES for p in parts)))


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.model, self.train = cfg["model"], cfg["train"]
        b, r = traffic["batch"], traffic["resolution"]
        f = 2 ** (len(self.model["vae"]["ch_mult"]) - 1)
        self.latent = (r // f, r // f, self.model["vae"]["embed_dim"])
        self.step_index = 0  # the next batch's index

    def batch(self, step: int):
        """(batch, draws) of step `step` as the program's step takes them."""
        t = self.traffic
        return seeding.train_batch(self.seed, step, t["batch"], t["resolution"],
                                   tuple(t["prompt_tokens"]), self.latent,
                                   self.model["diffusion"]["timesteps"], self.device,
                                   self.model["clip"]["max_length"])

    def raw_weights(self):
        return seeding.seeded_weights(self.shapes, self.seed, self.device,
                                      common.tower_dtypes(self.model, training=True))

    def setup(self) -> None:
        from ctrlora_tpu_torch.configs import TrainConfig
        from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
        from ctrlora_tpu_torch.training.trainer import Trainer

        model_cfg = common.port_config(self.model)
        pipe = CtrLoraPipeline(model_cfg, self.device, fuse_lora=False)
        self.shapes = {k: common.shapes_of(getattr(pipe, k))
                       for k in ("unet", "control", "vae", "clip")}
        raw = self.raw_weights()
        for k in self.shapes:
            getattr(pipe, k).load_state_dict(raw[k], strict=True)
        del raw
        self.workdir = tempfile.mkdtemp(prefix="ctrlora_bench_")
        tcfg = TrainConfig(**self.train, batch_size=self.traffic["batch"], seed=self.seed,
                           log_every=NEVER, ckpt_every=NEVER, image_log_every=NEVER)
        self.trainer = Trainer(pipe, tcfg, self.workdir)
        trainable = self.trainer.state.trainable
        expected = {f"control.{n}" for n in self.shapes["control"] if trains(n, self.train)}
        self.trainable_set_matches = set(trainable) == expected
        p0 = {n: p.detach().clone() for n, p in trainable.items()}
        opt = self.trainer.state.optimizer
        b1 = self.train["adam_b1"]
        self.losses: List[float] = []
        for s in range(self.traffic["check_steps"]):
            metrics = self.step()
            self.losses.append(float(metrics["loss"]))
            if s == 0:  # a leaf AdamW kept no moment of reads as no gradient
                self.grad1 = {n: float(opt.state.get(p, {}).get(
                    "exp_avg", torch.zeros(())).double().norm() / (1 - b1))
                    for n, p in trainable.items()}
        self.change = {n: float((p.detach().double() - p0[n].double()).norm())
                       for n, p in trainable.items()}
        del p0
        common.sync(self.device)

    def step(self):
        batch, draws = self.batch(self.step_index)
        self.step_index += 1
        self.trainer.state, metrics = self.trainer.step_fn(self.trainer.state, batch, None, draws)
        return metrics

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Whole steps until `seconds` have passed on the host, then a
        synchronise: images/s over all the rows stepped and all the time."""
        n, t0 = 0, time.perf_counter()
        while True:
            self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"attempted": n, "failed": 0,
                "metrics": {"train_images_per_s": n * self.traffic["batch"] / elapsed}}

    def traced(self):
        from benchmark import trace

        n = self.traffic["trace_steps"]
        t0 = time.perf_counter()
        for _ in range(n):  # the same work untraced: the pace the peak share is taken at
            self.step()
        common.sync(self.device)
        untraced_s = time.perf_counter() - t0

        def run():
            for _ in range(n):
                with torch.profiler.record_function(trace.SPAN_PREFIX + "train_step"):
                    self.step()

        tr = trace.profile(run, trace.op_spans)
        return tr, {"steps": n, "images": n * self.traffic["batch"],
                    "untraced_s": untraced_s}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def release(self) -> None:
        self.trainer = None
        shutil.rmtree(self.workdir, ignore_errors=True)
        common.free_cuda()

    # ------------------------------------------------------------------
    def flops(self, units: dict) -> float:
        """The reference's FLOPs of the traced steps."""
        return units["steps"] * self.flops_per_step()

    def flops_per_step(self) -> float:
        """The reference's FLOPs of one step, forward and backward without
        recomputation, counted on meta tensors."""
        meta = torch.device("meta")
        raw = {k: {n: torch.empty(s, device=meta) for n, s in v.items()}
               for k, v in self.shapes.items()}
        for n in raw["control"]:
            if trains(n, self.train):
                raw["control"][n].requires_grad_(True)
        ref = Reference(self.model, raw)
        t = self.traffic
        b, r = t["batch"], t["resolution"]
        batch = {"jpg": torch.empty((b, r, r, 3), device=meta),
                 "hint": torch.empty((b, r, r, 3), device=meta),
                 "token_ids": torch.zeros((b, self.model["clip"]["max_length"]),
                                          dtype=torch.long, device=meta)}
        draws = {k: torch.empty((b, *self.latent), device=meta)
                 for k in ("z_eps", "hint_eps", "noise")}
        draws["t"] = torch.zeros((b,), dtype=torch.long, device=meta)
        return fn_flops(lambda: eps_mse_loss(ref, batch, draws).backward())

    def reference_run(self, low: bool = False, half: bool = False) -> Dict:
        """The reference's own run through the check steps from the seeded
        weights: per-step losses, the first step's gradient norm per leaf,
        each leaf's change after the last step. `half`: each step on the
        first half of its rows only (a fault's reading)."""
        raw = self.raw_weights()
        control = raw["control"]
        names = [n for n in control if trains(n, self.train)]
        params = {n: control[n].clone().requires_grad_(True) for n in names}
        p0 = {n: control[n].clone() for n in names}
        weights = {**raw, "control": {**control, **params}}
        tr = self.train
        share = 2 if half else 1
        state: Dict = {}
        losses, grad1 = [], {}
        for s in range(self.traffic["check_steps"]):
            batch, draws = self.batch(s)
            ref = Reference(self.model, weights, low=low)
            rows = batch["jpg"].shape[0] // share
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            for lo in range(0, rows, self.traffic["row_block"]):
                hi = min(rows, lo + self.traffic["row_block"])
                with fp32_products():
                    loss = eps_mse_loss(ref, seeding.rows_of(batch, lo, hi),
                                        seeding.rows_of(draws, lo, hi))
                    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                total += loss.detach().double()
                for n, gi in zip(params, g):
                    if gi is not None:
                        grads[n] += gi
            grads = {n: g / rows for n, g in grads.items()}
            losses.append(float(total) / rows)
            if s == 0:
                grad1 = {f"control.{n}": float(g.double().norm()) for n, g in grads.items()}
            with torch.no_grad():
                adamw_step(params, grads, state, s + 1, tr["learning_rate"],
                           (tr["adam_b1"], tr["adam_b2"]), tr["adam_eps"], tr["weight_decay"])
        change = {f"control.{n}": float((params[n].detach().double() - p0[n].double()).norm())
                  for n in names}
        del raw, control, params, p0, weights, state
        common.free_cuda()
        return {"losses": losses, "grad1": grad1, "change": change}

    @staticmethod
    def readings(got: Dict, ref: Dict) -> Dict[str, float]:
        """loss_gap: the worst step's |loss - ref| / ref; grad_gap: the worst
        leaf's gap of first-step gradient norms; change_gap: the worst
        leaf's gap of changes after the check steps, over the leaves whose
        reference gradient is at least a thousandth of the median leaf's."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        if len(got["losses"]) != len(ref["losses"]):
            loss_gap = math.inf
        g_ref = ref["grad1"]
        med = statistics.median(g_ref.values())
        moved = [n for n, g in g_ref.items() if g >= 1e-3 * med]
        return {"loss_gap": loss_gap,
                "grad_gap": common.leaf_gap(got["grad1"], g_ref)[0],
                "change_gap": common.leaf_gap(got["change"], ref["change"], moved)[0]}

    def check(self, control: bool = False) -> Dict[str, Dict[str, float]]:
        ref = self.reference_run()
        prog = {"losses": self.losses, "grad1": self.grad1, "change": self.change}
        out = {"program": self.readings(prog, ref), "control": {}}
        if not self.trainable_set_matches:
            out["program"]["grad_gap"] = math.inf
        if control:
            out["control"] = self.readings(self.reference_run(low=True), ref)
            out["half_batch"] = self.readings(self.reference_run(half=True), ref)
        return out
