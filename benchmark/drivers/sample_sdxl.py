"""Driver of the SDXL sampling mixes (``"kind": "sample_sdxl"``): the
``sample`` driver's closed loop, one client, each request a batch of pixel
hints and prompts sampled to uint8 pixels through the sample CLI's
per-batch function (``ctrlora_tpu_torch.scripts.sample.sample_batch``: both
text towers, the vector conditioning, DDIM with the hoisted per-row
time-embedding tables and k|v, the pixel hint into the ControlNet at every
step, the VAE decode).

The mix's file has the ``sample`` mix's keys. The negative prompt is the
empty one, which the program conditions with zeros; the micro-conditioning
is the hints' size, crop (0, 0).

Correctness follows the program's trajectory as the ``sample`` driver does,
through the pipeline's wrapped ``apply_model`` and ``decode_first_stage``:
of every request they keep the context pair and the vector conditioning
the first model call is given, every row's latent at the first and the
last DDIM step and the decoded one, and one row's latent at every step.
After the window, for requests drawn from the seed, the float32 reference
(``benchmark/reference/sdxl.py``) recomputes every row's context pair
(``clip_rel``), its y from the program's vectors against its own
(``vector_rel``), pixels from the program's final latent (``pixel_mae``),
every row's guided eps at the first and the last step and the kept row's
at the steps drawn between (``eps_rel``, the program's eps read off its
DDIM update).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark import common, seeding
from benchmark.drivers import sample
from benchmark.flops import fn_flops
from benchmark.reference.diffusion import ddim_coefficients, ddim_ladder
from benchmark.reference.sd15 import fp32_products, nchw
from benchmark.reference.sdxl import SDXLReference, guided_eps_xl

KIND = "sample_sdxl"
KEPT = 12  # requests the check may follow (a window finishes ~5)
TOWERS = ("unet", "control", "vae", "clip", "clip2")
end_steps = sample.end_steps


class Cell(sample.Cell):
    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------
    def weight_shapes(self, model_cfg, pipe) -> Dict[str, Dict]:
        return {k: common.shapes_of(getattr(pipe, k)) for k in TOWERS}

    def raw_weights(self, shapes) -> Dict[str, Dict[str, torch.Tensor]]:
        m = self.model
        dtypes = {"unet": m["unet"]["dtype"], "control": m["control"]["unet"]["dtype"],
                  "vae": m["vae"]["dtype"], "clip": m["clip"]["dtype"],
                  "clip2": m["conditioner"]["clip2"]["dtype"]}
        return seeding.seeded_weights(shapes, self.seed, self.device,
                                      {k: common.DTYPES[v] for k, v in dtypes.items()})

    def setup(self) -> None:
        from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
        from ctrlora_tpu_torch.scripts.sample import SampleOptions

        t, m = self.traffic, self.model
        self.model_cfg = common.port_config(m)
        pipe = CtrLoraPipeline(self.model_cfg, self.device)
        self.shapes = self.weight_shapes(self.model_cfg, pipe)
        raw = self.raw_weights(self.shapes)
        for name in TOWERS:
            getattr(pipe, name).load_state_dict(raw[name], strict=True)
        del raw
        pipe.cast_for_inference()
        self.pipe = pipe
        self.opts = SampleOptions(sampler="ddim", steps=t["steps"], scale=t["scale"],
                                  eta=t["eta"], strength=t["strength"])
        rng = np.random.default_rng(seeding.sub_seed(self.seed, "hints"))
        self.hints = [seeding.hint_images(rng, t["batch"], t["resolution"])
                      for _ in range(t["hint_pool"])]
        length = m["clip"]["max_length"]
        self.nids = seeding.empty_prompt_ids(t["batch"], length)
        f = 2 ** (len(m["vae"]["ch_mult"]) - 1)
        lat = (t["resolution"] // f, t["resolution"] // f, m["vae"]["embed_dim"])
        b = t["batch"]
        con = m["conditioner"]
        vec = (con["clip2"] if con["pooled"] == "clip2" else m["clip"])["projection_dim"] + 6
        # what the check reads, in buffers made here, not in the window
        self.kept = {"x": torch.empty((KEPT, t["steps"] + 1, *lat), device=self.device),
                     "ends": torch.empty((KEPT, len(end_steps(t["steps"])), b, *lat),
                                         device=self.device),
                     "ctx": torch.empty((KEPT, 2 * b, length, m["unet"]["context_dim"]),
                                        device=self.device),
                     "vec": torch.empty((KEPT, 2 * b, vec), device=self.device)}
        self._wrap(pipe)
        self.request(-1)  # every shape the window uses, with a seed of its own
        common.sync(self.device)
        self.records.clear()
        self.outputs.clear()

    def _wrap(self, pipe) -> None:
        """Keep, of the current request, the context pair and the vectors
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
                    vec = kw.get("vector")
                    if vec is None:
                        self.kept["vec"][rec["slot"]].fill_(math.nan)
                    else:
                        self.kept["vec"][rec["slot"]].copy_(vec)
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

    def request(self, i: int) -> np.ndarray:
        from ctrlora_tpu_torch.scripts.sample import sample_batch

        hint, ids, x_seed, row = self.request_inputs(i)
        slot = len(self.records) if 0 <= i and len(self.records) < KEPT else None
        self.records.append({"i": i, "slot": slot, "row": row, "step": 0, "decoded": False})
        out = sample_batch(self.pipe, hint, ids, self.nids, self.opts, x_seed)
        self.outputs.append(out if slot is not None else None)
        return out

    # ------------------------------------------------------------------
    # the traced run
    # ------------------------------------------------------------------
    def traced(self):
        """As the ``sample`` driver's, with the benchmark's host ranges on
        this model's text call (``encode_prompts``), the model calls and
        the decode."""
        from benchmark import trace

        n = self.traffic["trace_requests"]
        t0 = time.perf_counter()
        for i in range(n):
            self.request(i)
        untraced_s = time.perf_counter() - t0
        names = {"encode_prompts": "text", "decode_first_stage": "vae_decode",
                 "apply_model": "model_call"}

        @contextlib.contextmanager
        def spans():
            with trace.op_spans(), trace.method_spans(self.pipe, names):
                yield

        tr = trace.profile(lambda: [self.request(i) for i in range(n)], spans)
        return tr, {"requests": n, "steps": n * self.traffic["steps"],
                    "images": n * self.traffic["batch"], "untraced_s": untraced_s}

    # ------------------------------------------------------------------
    # the reference
    # ------------------------------------------------------------------
    def flops_per_request(self) -> float:
        """The reference's FLOPs of one request, counted on meta tensors:
        both text towers on the CFG pair, `steps` guided model calls (the
        pixel hint's encoder in each), the decode."""
        t, m = self.traffic, self.model
        meta = torch.device("meta")
        raw = {k: {n: torch.empty(s, device=meta) for n, s in v.items()}
               for k, v in self.shapes.items()}
        ref = SDXLReference(m, raw)
        b, r = t["batch"], t["resolution"]
        lat = r // 2 ** (len(m["vae"]["ch_mult"]) - 1)
        length = m["clip"]["max_length"]
        ids = torch.zeros((2 * b, length), dtype=torch.long, device=meta)
        z = torch.empty((b, lat, lat, 4), device=meta)
        ctx = torch.empty((b, length, m["unet"]["context_dim"]), device=meta)
        y = torch.empty((b, m["unet"]["adm_in_channels"]), device=meta)
        hint = torch.empty((b, 3, r, r), device=meta)
        total = fn_flops(ref.text, ids) + fn_flops(ref.pixels, z)
        step = fn_flops(guided_eps_xl, ref.unet, nchw(z), 981, ctx, ctx, y, y, hint,
                        t["scale"], t["strength"])
        return total + t["steps"] * step

    def check(self, control: bool = False) -> Dict[str, Dict[str, float]]:
        """Readings of the program against the float32 reference: 'program'
        always, and 'control' (the reference in float8 / TF32 in the
        program's place, at the program's own latents) where asked. Each
        is the worst row's."""
        t = self.traffic
        raw = self.raw_weights(self.shapes)
        sides = {"program": SDXLReference(self.model, raw)}
        if control:
            sides["control"] = SDXLReference(self.model, raw, low=True)
        ref = sides["program"]
        ts, a_t, a_prev = ddim_ladder(self.model["diffusion"], t["steps"])
        ends = end_steps(t["steps"])
        size = (t["resolution"], t["resolution"])
        b = t["batch"]
        out: Dict[str, Dict[str, float]] = {"program": {}, "control": {}}

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
                ids_d, nids_d = (torch.from_numpy(a).to(dev) for a in (ids, self.nids))
                hint_d = nchw(torch.from_numpy(hint).to(dev))
                ctx, unc, y, uy = ref.prompts(ids_d, nids_d, size)
                want_ctx, want_y = torch.cat([ctx, unc]), torch.cat([y, uy])
                px_ref = (ref.pixels(self.kept["ends"][q, -1]) * 127.5 + 127.5).clamp(0, 255)
                prog = {"ctx": self.kept["ctx"][q], "y": ref.y_of(self.kept["vec"][q]),
                        "px": torch.from_numpy(self.outputs[self.records.index(rec)]).to(dev)}
                for side, model in sides.items():
                    if side == "program":
                        got = prog
                    else:
                        c2, u2, y2, uy2 = model.prompts(ids_d, nids_d, size)
                        got = {"ctx": torch.cat([c2, u2]), "y": torch.cat([y2, uy2]),
                               "px": (model.pixels(self.kept["ends"][q, -1]) * 127.5
                                      + 127.5).clamp(0, 255).to(torch.uint8)}
                    worst(side, "clip_rel", rows_rel(got["ctx"], want_ctx))
                    worst(side, "vector_rel", rows_rel(got["y"], want_y))
                    worst(side, "pixel_mae", max(float((g.float() - w).abs().mean())
                                                 for g, w in zip(got["px"], px_ref)))
                # (row, step, x, x_next): every row at the first and the last
                # step, the kept row at the steps drawn between
                pairs = [(j, k, self.kept["ends"][q, ends.index(k), j],
                          self.kept["ends"][q, ends.index(k + 1), j])
                         for k in (0, t["steps"] - 1) for j in range(b)]
                xs = self.kept["x"][q]
                pairs += [(r, k, xs[k], xs[k + 1]) for k in steps if 0 < k < t["steps"] - 1]
                for j, k, x, x_next in pairs:
                    x, x_next = nchw(x[None]), nchw(x_next[None])
                    c_x, c_e = ddim_coefficients(float(a_t[k]), float(a_prev[k]))
                    e_prog = (x_next.double() - c_x * x.double()) / c_e
                    rows = slice(j, j + 1)
                    args = (x, int(ts[k]), ctx[rows], unc[rows], y[rows], uy[rows],
                            hint_d[rows], t["scale"], t["strength"])
                    e_ref = guided_eps_xl(ref.unet, *args)
                    worst("program", "eps_rel", common.rel_l2(e_prog, e_ref))
                    if control:
                        worst("control", "eps_rel", common.rel_l2(
                            guided_eps_xl(sides["control"].unet, *args), e_ref))
        del raw, ref, sides
        common.free_cuda()
        return out

