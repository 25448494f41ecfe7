"""Driver of the sampling mixes (``"kind": "sample"``): one client in a
closed loop, each request a batch of hint images and prompts sampled to
uint8 pixels through the sample CLI's per-batch function
(``ctrlora_tpu_torch.scripts.sample.sample_batch``: the CLIP pair, the VAE
encode of the hint, DDIM with the hoisted k|v, the VAE decode).

The mix's file gives: ``batch`` images a request at ``resolution``,
``steps`` DDIM steps at ``eta``, guidance ``scale``, control ``strength``,
prompts of ``prompt_tokens`` = [lo, hi] ids, the empty negative prompt,
``hint_pool`` distinct hint batches dealt out in turn, ``trace_requests``
requests in a traced run, and ``check``: how many (request, row) pairs and
DDIM steps the reference follows.

Correctness follows the program's own trajectory. The sampler has no
per-step interface, so the pipeline's ``apply_model`` and
``decode_first_stage`` are wrapped on the instance: of every request they
keep the context pair, the hint latent, every row's latent at the first
and the last DDIM step and the decoded one, and one row's latent at every
step. After the window, for requests drawn from the seed, the float32
reference recomputes every row's CLIP context, hint latent and pixels
(from the program's final latent), every row's guided eps at the first and
the last step, and the kept row's at steps drawn between (the program's
eps read off its DDIM update). A request whose model calls the wrappers
did not all see fails the check.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import common, seeding
from benchmark.flops import fn_flops
from benchmark.reference.diffusion import Reference, ddim_coefficients, ddim_ladder, guided_eps
from benchmark.reference.sd15 import fp32_products, nchw

KIND = "sample"
KEPT = 32  # requests the check may follow (a window finishes ~15)


def end_steps(steps: int) -> List[int]:
    """The steps at which every row's latent is kept: the first step's
    input and output, the last step's input and output (the decoded
    latent)."""
    return sorted({0, 1, steps - 1, steps})


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.model = cfg["model"]
        self.records: List[Dict] = []
        self.outputs: List[np.ndarray] = []

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------
    def weight_shapes(self, model_cfg, pipe) -> Dict[str, Dict]:
        return {"unet": common.shapes_of(pipe.unet),
                "control": common.unfused_control_shapes(model_cfg),
                "vae": common.shapes_of(pipe.vae), "clip": common.shapes_of(pipe.clip)}

    def raw_weights(self, shapes) -> Dict[str, Dict[str, torch.Tensor]]:
        return seeding.seeded_weights(shapes, self.seed, self.device,
                                      common.tower_dtypes(self.model, training=False))

    def setup(self) -> None:
        from ctrlora_tpu_torch import lora_fuse
        from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
        from ctrlora_tpu_torch.scripts.sample import SampleOptions

        t = self.traffic
        self.model_cfg = common.port_config(self.model)
        pipe = CtrLoraPipeline(self.model_cfg, self.device)
        self.shapes = self.weight_shapes(self.model_cfg, pipe)
        raw = self.raw_weights(self.shapes)
        for name in ("unet", "vae", "clip"):
            getattr(pipe, name).load_state_dict(raw[name], strict=True)
        pipe.control.load_state_dict(lora_fuse.fuse_control_tree(
            pipe.control, raw["control"], 0, self.model_cfg.control.lora), strict=True)
        del raw
        pipe.cast_for_inference()
        self.pipe = pipe
        self.opts = SampleOptions(sampler="ddim", steps=t["steps"], scale=t["scale"],
                                  eta=t["eta"], strength=t["strength"])
        rng = np.random.default_rng(seeding.sub_seed(self.seed, "hints"))
        self.hints = [seeding.hint_images(rng, t["batch"], t["resolution"])
                      for _ in range(t["hint_pool"])]
        self.nids = seeding.empty_prompt_ids(t["batch"], self.model["clip"]["max_length"])
        f = 2 ** (len(self.model["vae"]["ch_mult"]) - 1)
        lat = (t["resolution"] // f, t["resolution"] // f, self.model["vae"]["embed_dim"])
        b = t["batch"]
        ctx = (2 * b, self.model["clip"]["max_length"], self.model["unet"]["context_dim"])
        # what the check reads, in buffers made here, not in the window
        self.kept = {"x": torch.empty((KEPT, t["steps"] + 1, *lat), device=self.device),
                     "ends": torch.empty((KEPT, len(end_steps(t["steps"])), b, *lat),
                                         device=self.device),
                     "ctx": torch.empty((KEPT, *ctx), device=self.device),
                     "hint": torch.empty((KEPT, b, *lat), device=self.device)}
        self._wrap(pipe)
        self.request(-1)  # every shape the window uses, with a seed of its own
        common.sync(self.device)
        self.records.clear()
        self.outputs.clear()

    def _wrap(self, pipe) -> None:
        """Keep, of the current request, the context pair and hint latent
        the first model call is given, the latent each model call is handed
        (the kept row's at every step, every row's at the end steps) and
        the latent the sampler decodes."""
        apply_model, decode = pipe.apply_model, pipe.decode_first_stage
        b = self.traffic["batch"]
        ends = {k: j for j, k in enumerate(end_steps(self.traffic["steps"]))}

        def keep(rec, x):
            q, k = rec["slot"], rec["step"]
            self.kept["x"][q, k].copy_(x[rec["row"]])
            if k in ends:
                self.kept["ends"][q, ends[k]].copy_(x[:b])

        def kept_apply_model(x, t, context, conds=None, **kw):
            rec = self.records[-1]
            if rec["slot"] is not None:
                if rec["step"] == 0:
                    self.kept["ctx"][rec["slot"]].copy_(context)
                    self.kept["hint"][rec["slot"]].copy_(conds[0].hint[:b])
                keep(rec, x)
            rec["step"] += 1
            return apply_model(x, t, context, conds, **kw)

        def kept_decode(z):
            rec = self.records[-1]
            if rec["slot"] is not None:
                keep(rec, z)
            rec["decoded"] = True
            rec["t_decode"] = time.perf_counter()
            return decode(z)

        pipe.apply_model, pipe.decode_first_stage = kept_apply_model, kept_decode

    def request_inputs(self, i: int):
        """(hints, prompt ids, the seed of the starting noise, the row the
        check may follow) of request `i`."""
        t = self.traffic
        rng = np.random.default_rng(seeding.sub_seed(self.seed, "prompts", i))
        ids = seeding.prompt_ids(rng, t["batch"], *t["prompt_tokens"],
                                 length=self.model["clip"]["max_length"])
        return (self.hints[i % len(self.hints)], ids, seeding.sub_seed(self.seed, "x_T", i),
                int(rng.integers(t["batch"])))

    def request(self, i: int) -> np.ndarray:
        from ctrlora_tpu_torch.scripts.sample import sample_batch

        hint, ids, x_seed, row = self.request_inputs(i)
        slot = len(self.records) if 0 <= i and len(self.records) < KEPT else None
        self.records.append({"i": i, "slot": slot, "row": row, "step": 0, "decoded": False})
        out = sample_batch(self.pipe, hint, ids, self.nids, self.opts, x_seed)
        self.outputs.append(out if slot is not None else None)
        return out

    # ------------------------------------------------------------------
    # the window
    # ------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Whole requests until `seconds` have passed; images/s over the
        time from the first request's start to the last one's end. Each
        request's seconds, and the seconds the host took to reach its
        decode (all its steps dispatched), go to standard error."""
        n, t0 = 0, time.perf_counter()
        walls, hosts = [], []
        while True:
            start = time.perf_counter()
            self.request(n)
            end = time.perf_counter()
            walls.append(end - start)
            hosts.append(self.records[-1].get("t_decode", end) - start)
            n += 1
            elapsed = end - t0
            if elapsed >= seconds:
                break
        print(f"window: {n} requests in {elapsed!r} s; request s {[round(w, 4) for w in walls]}; "
              f"host s to decode {[round(h, 4) for h in hosts]}", file=sys.stderr)
        return {"attempted": n, "failed": 0,
                "metrics": {"sample_images_per_s": n * self.traffic["batch"] / elapsed}}

    def traced(self):
        """``trace_requests`` whole requests untraced, timed, then the same
        requests profiled (``trace.profile``: the device alone, then with
        the spans): (the trace, the units of work with the untraced
        seconds)."""
        from benchmark import trace

        n = self.traffic["trace_requests"]
        t0 = time.perf_counter()
        for i in range(n):  # the same work untraced: the pace the peak share is taken at
            self.request(i)
        untraced_s = time.perf_counter() - t0
        names = {"encode_text_cond_uncond": "text", "encode_first_stage": "vae_encode",
                 "decode_first_stage": "vae_decode", "apply_model": "model_call"}

        @contextlib.contextmanager
        def spans():
            with trace.op_spans(), trace.method_spans(self.pipe, names):
                yield

        tr = trace.profile(lambda: [self.request(i) for i in range(n)], spans)
        return tr, {"requests": n, "steps": n * self.traffic["steps"],
                    "images": n * self.traffic["batch"], "untraced_s": untraced_s}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def release(self) -> None:
        self.pipe = None
        common.free_cuda()

    # ------------------------------------------------------------------
    # the reference
    # ------------------------------------------------------------------
    def flops(self, units: dict) -> float:
        """The reference's FLOPs of the traced requests."""
        return units["requests"] * self.flops_per_request()

    def flops_per_request(self) -> float:
        """The reference's FLOPs of one request, counted on meta tensors:
        the CLIP pair, the hint's encode, `steps` guided model calls, the
        decode."""
        t = self.traffic
        meta = torch.device("meta")
        raw = {k: {n: torch.empty(s, device=meta) for n, s in v.items()}
               for k, v in self.shapes.items()}
        ref = Reference(self.model, raw, fuse=True)
        b, r = t["batch"], t["resolution"]
        lat = r // 2 ** (len(self.model["vae"]["ch_mult"]) - 1)
        ids = torch.zeros((2 * b, self.model["clip"]["max_length"]), dtype=torch.long,
                          device=meta)
        img = torch.empty((b, r, r, 3), device=meta)
        z = torch.empty((b, lat, lat, 4), device=meta)
        ctx = torch.empty((b, self.model["clip"]["max_length"],
                           self.model["unet"]["context_dim"]), device=meta)
        total = fn_flops(ref.text, ids) + fn_flops(ref.latent, img) + fn_flops(ref.pixels, z)
        step = fn_flops(guided_eps, ref.unet, nchw(z), 981, ctx, ctx, nchw(z), t["scale"],
                        t["strength"])
        return total + t["steps"] * step

    def check_plan(self):
        """(record, steps) the reference follows: ``check.rows`` finished
        requests drawn from the seed, at ``check.steps`` steps each (the
        first, the last and ones drawn between)."""
        t, c = self.traffic, self.traffic["check"]
        rng = np.random.default_rng(seeding.sub_seed(self.seed, "check"))
        kept = [rec for rec in self.records if rec["slot"] is not None]
        plan = []
        for q in rng.choice(len(kept), size=min(c["rows"], len(kept)), replace=False):
            middle = rng.choice(np.arange(1, t["steps"] - 1), size=max(0, c["steps"] - 2),
                                replace=False)
            plan.append((kept[int(q)], sorted({0, t["steps"] - 1, *middle.tolist()})))
        return plan

    def check(self, control: bool = False) -> Dict[str, Dict[str, float]]:
        """Readings of the program against the float32 reference: 'program'
        always, and 'control' (the reference in float8 / TF32 in the
        program's place, at the program's own latents) where asked. Each
        is the worst row's."""
        t = self.traffic
        raw = self.raw_weights(self.shapes)
        sides = {"program": Reference(self.model, raw, fuse=True)}
        if control:
            sides["control"] = Reference(self.model, raw, low=True, fuse=True)
        ref = sides["program"]
        ts, a_t, a_prev = ddim_ladder(self.model["diffusion"], t["steps"])
        ends = end_steps(t["steps"])
        out = {"program": {}, "control": {}}

        def worst(side: str, key: str, value: float) -> None:
            d = out[side]
            d[key] = max(d.get(key, 0.0), value)

        def rows_rel(got: torch.Tensor, want: torch.Tensor) -> float:
            return max(common.rel_l2(g, w) for g, w in zip(got, want))

        dev = self.device
        with torch.no_grad(), fp32_products():
            for rec, steps in self.check_plan():
                if rec["step"] != t["steps"] or not rec["decoded"]:
                    # the wrappers did not see the request's model calls
                    worst("program", "eps_rel", math.inf)
                    continue
                hint, ids, _, r = self.request_inputs(rec["i"])
                q = rec["slot"]
                ids_d = torch.from_numpy(ids).to(dev)
                nids_d = torch.from_numpy(self.nids).to(dev)
                hint_d = torch.from_numpy(hint).to(dev)
                ctx, unc = ref.text(ids_d), ref.text(nids_d)
                hz = ref.latent(hint_d)
                px_ref = (ref.pixels(self.kept["ends"][q, -1]) * 127.5 + 127.5).clamp(0, 255)
                prog = {"ctx": self.kept["ctx"][q], "hint": nchw(self.kept["hint"][q]),
                        "px": torch.from_numpy(self.outputs[self.records.index(rec)]).to(dev)}
                for side, model in sides.items():
                    if side == "program":
                        got = prog
                    else:
                        got = {"ctx": torch.cat([model.text(ids_d), model.text(nids_d)]),
                               "hint": model.latent(hint_d),
                               "px": (model.pixels(self.kept["ends"][q, -1]) * 127.5
                                      + 127.5).clamp(0, 255).to(torch.uint8)}
                    worst(side, "clip_rel", rows_rel(
                        got["ctx"].view(2, t["batch"], *ctx.shape[1:]).transpose(0, 1),
                        torch.stack([ctx, unc], 1)))
                    worst(side, "hint_rel", rows_rel(got["hint"], hz))
                    worst(side, "pixel_mae", max(float((g.float() - w).abs().mean())
                                                 for g, w in zip(got["px"], px_ref)))
                # (row, step, x, x_next): every row at the first and the last
                # step, the kept row at the steps drawn between
                pairs = [(j, k, self.kept["ends"][q, ends.index(k), j],
                          self.kept["ends"][q, ends.index(k + 1), j])
                         for k in (0, t["steps"] - 1) for j in range(t["batch"])]
                xs = self.kept["x"][q]
                pairs += [(r, k, xs[k], xs[k + 1]) for k in steps if 0 < k < t["steps"] - 1]
                for j, k, x, x_next in pairs:
                    x, x_next = nchw(x[None]), nchw(x_next[None])
                    c_x, c_e = ddim_coefficients(float(a_t[k]), float(a_prev[k]))
                    e_prog = (x_next.double() - c_x * x.double()) / c_e
                    args = (x, int(ts[k]), ctx[j:j + 1], unc[j:j + 1], hz[j:j + 1], t["scale"],
                            t["strength"])
                    e_ref = guided_eps(ref.unet, *args)
                    worst("program", "eps_rel", common.rel_l2(e_prog, e_ref))
                    if control:
                        worst("control", "eps_rel", common.rel_l2(
                            guided_eps(sides["control"].unet, *args), e_ref))
        del raw, ref, sides
        common.free_cuda()
        return out
