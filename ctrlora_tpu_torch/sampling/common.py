"""Sampler plumbing shared by the port's samplers (counterpart of
``ctrlora_tpu/sampling/common.py``): the classifier-free-guided model call
on one stacked 2B batch (with the cross-attention k|v hoisted out of the
loop), the hoisted time-embedding tables, and the draws of a
sampler's noise."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ctrlora_tpu_torch.ops import unpack_rows as unpack_ops
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline


def draw_normal(shape: Sequence[int], generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Standard normal fp32 draws of `shape` in ONE call on the generator's
    device (the CPU without one), copied to `device` once: the same
    generator state gives the same numbers on any device."""
    src = generator.device if generator is not None else torch.device("cpu")
    return torch.randn(tuple(shape), generator=generator, device=src).to(device)


def initial_latents(x_T: Optional[torch.Tensor], shape: Sequence[int],
                    generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A sampler's starting latents: x_T on `device` in fp32, else drawn."""
    if x_T is not None:
        return x_T.to(device, torch.float32)
    return draw_normal(shape, generator, device)


class _GuidedEps:
    """``eps_fn(x, t, emb_rows=None, scale=None)``: the guided model output
    [B, ...] for latents x [B, ...] at the integer timestep t.

    With guidance (an uncond context and a scale other than 1) it makes one
    model call on the stacked 2B batch, the uncond half reusing the cond
    hints (reference: cldm/cldm.py:398), and returns
    ``out_u + scale * (out_c - out_u)``; `scale` overrides the guidance
    scale for one call (a ``ucg_schedule``). Guess mode runs the uncond half
    without control (a control_batch_mask of ones then zeros). The
    image-prompt tokens ``ip_context`` are stacked as [cond; uncond], the
    uncond half taking ``uncond_ip_context`` where given, else the cond
    tokens (the style app gives ``image_proj(zeros)``). ``conds`` is the
    condition list the model calls take (hints doubled under guidance),
    which ``make_emb_row_tables`` also takes. The cross-attention k|v
    products of the stacked context are made once here
    (``kv_tables``: ``pipe.xattn_kv_tables`` of it and ``conds``, None where
    the pipeline has none) and every call takes them: the same products
    the sites would make each step, so no result changes (the time
    embedding's rows are hoisted the same way). A model that takes y gets
    each row's ``vector`` (``CtrLoraPipeline.encode_prompts``), stacked as
    [cond; uncond] as the context is (``uncond_vector`` the uncond half's)."""

    def __init__(self, pipe: CtrLoraPipeline, context: torch.Tensor,
                 uncond_context: Optional[torch.Tensor],
                 conds: Optional[Sequence[Conditioning]], guidance_scale: float,
                 control_scales: Optional[Sequence[float]] = None, guess_mode: bool = False,
                 ip_context: Optional[torch.Tensor] = None,
                 uncond_ip_context: Optional[torch.Tensor] = None,
                 vector: Optional[torch.Tensor] = None,
                 uncond_vector: Optional[torch.Tensor] = None):
        self.pipe = pipe
        self.guidance_scale = guidance_scale
        self.control_scales = control_scales
        self.use_cfg = uncond_context is not None and guidance_scale != 1.0
        self.cmask = None
        self.ip_context = ip_context
        self.vector = vector
        if self.use_cfg:
            # replace() keeps every other field, the condition's own control
            # module among them
            self.context = torch.cat([context, uncond_context])
            self.conds = [dataclasses.replace(c, hint=torch.cat([c.hint, c.hint]))
                          for c in (conds or [])]
            if guess_mode:
                b = context.shape[0]
                self.cmask = torch.cat([torch.ones(b), torch.zeros(b)]).to(pipe.device)
            if ip_context is not None:
                self.ip_context = torch.cat(
                    [ip_context, ip_context if uncond_ip_context is None else uncond_ip_context])
            if vector is not None:
                self.vector = torch.cat([vector, uncond_vector])
        else:
            self.context, self.conds = context, list(conds or [])
        self.kv_tables = pipe.xattn_kv_tables(self.context, self.conds)

    def __call__(self, x: torch.Tensor, t: int, emb_rows: Optional[dict] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
        b = x.shape[0]
        n = 2 * b if self.use_cfg else b
        tvec = torch.full((n,), int(t), dtype=torch.int32, device=x.device)
        x_in = torch.cat([x, x]) if self.use_cfg else x
        out = self.pipe.apply_model(x_in, tvec, self.context, self.conds, emb_rows=emb_rows,
                                    control_scales=self.control_scales,
                                    control_batch_mask=self.cmask, ip_context=self.ip_context,
                                    kv_rows=self.kv_tables, vector=self.vector)
        if not self.use_cfg:
            return out
        s = self.guidance_scale if scale is None else scale
        return out[b:] + float(s) * (out[:b] - out[b:])


def make_guided_eps_fn(pipe: CtrLoraPipeline, context: torch.Tensor,
                       uncond_context: Optional[torch.Tensor],
                       conds: Optional[Sequence[Conditioning]], guidance_scale: float,
                       control_scales: Optional[Sequence[float]] = None,
                       guess_mode: bool = False, ip_context: Optional[torch.Tensor] = None,
                       uncond_ip_context: Optional[torch.Tensor] = None,
                       vector: Optional[torch.Tensor] = None,
                       uncond_vector: Optional[torch.Tensor] = None) -> "_GuidedEps":
    """The guided model call every sampler makes (see ``_GuidedEps``)."""
    return _GuidedEps(pipe, context, uncond_context, conds, guidance_scale, control_scales,
                      guess_mode, ip_context, uncond_ip_context, vector, uncond_vector)


def make_emb_row_tables(pipe: CtrLoraPipeline, conds: Optional[Sequence[Conditioning]],
                        timesteps: torch.Tensor, vector: Optional[torch.Tensor] = None
                        ) -> Tuple[Sequence, Callable[[Optional[torch.Tensor]], Optional[dict]]]:
    """Packs every branch's emb_proj table (the UNet's, then each
    condition's own) into one [S, n, Cmax] tensor and returns (packed,
    rows_of): rows_of(packed[i]) rebuilds step i's per-branch rows dict for
    ``pipe.apply_model`` with ONE kernel-D launch. Where the pipeline has
    no tables (ControlNet-Lite) packed is S Nones and rows_of(None) is
    None: the samplers thread it the same way, and no D launch happens.
    A model that takes y has a row per model-call row (`vector`, as the
    calls stack it): its [S, N, C] tables are not packed, packed is the
    steps' indices and rows_of(i) gives views of step i's [N, C] rows, with
    no launch."""
    conds = list(conds or [])
    n_conds = len(conds)
    tables = pipe.emb_proj_tables(timesteps, conds, vector)
    if tables is None:
        return [None] * len(timesteps), lambda block: None
    if vector is not None:
        def step_rows(i: int) -> dict:
            return {"unet": {k: v[i] for k, v in tables["unet"].items()},
                    "control": tuple({k: v[i] for k, v in d.items()}
                                     for d in tables["control"])}

        return range(len(timesteps)), step_rows
    flat = {f"u.{k}": v for k, v in tables["unet"].items()}
    for j, d in enumerate(tables["control"]):
        flat.update({f"c{j}.{k}": v for k, v in d.items()})
    packed, names, sizes = unpack_ops.pack_row_tables(flat)
    # where each row goes, worked out once: (branch, key), branch -1 the UNet
    # and j >= 0 condition j's control
    places = tuple((-1, name[2:]) if name.startswith("u.") else
                   (int(name[1:name.index(".")]), name[name.index(".") + 1:]) for name in names)

    def rows_of(block: torch.Tensor) -> dict:
        rows = unpack_ops.unpack_rows(block, sizes)
        unet, control = {}, tuple({} for _ in range(n_conds))
        for (j, key), row in zip(places, rows):
            (unet if j < 0 else control[j])[key] = row
        return {"unet": unet, "control": control}

    return packed, rows_of
