#!/usr/bin/env python3
"""Drive the PyTorch port's three paths once on one NVIDIA GPU: controlled
sampling, the rank-128 LoRA finetune step, and the switchable two-LoRA
CtrLoRA API from reference-format checkpoints.

    python3 chip_smoke.py

Phases, each printing its results on its own line; any failure raises and
the script exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ctrlora_tpu_torch/csrc (nvcc, sm_90a);
3. each hand-written kernel against its plain PyTorch version at the
   paths' shapes, in bf16: max error (relative L2 for gradients) and
   median time of both (for A2 and B6 also of the kernel each stands
   beside: A, and B's BSHD and fused-qkv entries; for C also its two
   launches alone, up_ms and down_ms; for B4/B5 also the time per call
   of 20 calls queued back to back, b2b_ms, and two launches bit-equal);
4. the sampling slice at SD1.5 width: ctrlora_inference_config(1, 128) with
   seeded random weights, one rank-128 LoRA fused, bf16; 4 prompts of 77
   token ids, a 512x512 hint, DDIM at CFG 7.5 and eta 0, decode; counts the
   kernel launches of that run and compares one UNet+ControlNet evaluation
   with the kernels against the same evaluation with the plain versions;
   then one fp32 copy of the VAE decodes a 64x64 latent through the plain
   attention (the dispatch rules admit bf16 only) within relative L2 5e-2
   of the bf16 VAE's decode, which launches the kernel;
5. the tiny test configuration sampled on the GPU against the same run on
   the CPU; then the tiny two-LoRA API path from tiny reference-format
   files, GPU against CPU;
6. the training slice at SD1.5 width: ctrlora_finetune_config(128) with
   seeded random weights (bf16 compute over fp32 parameters, rematerialised
   blocks), Trainer(trainable='lora') on seeded synthetic 512x512 batches of
   4: 2 warm-up and 5 timed AdamW steps, the launch counts of the timed
   steps, frozen weights bit-identical, trainable ones changed; then one
   step's loss and trainable gradients with the kernels against the plain
   versions, with the same t, noise and posterior draws;
7. one tiny training step (fp32) on the GPU against the CPU;
8. the two-LoRA API path at SD1.5 width: seeded random weights written as
   reference-format .ckpt files (SD1.5 and Base ControlNet in fp16, two
   rank-128 LoRAs) through the port's exporters;
   CtrLoRA(num_loras=2).create_model on them, every loaded tensor checked
   against the file; two 512^2 hints (one 576x512, centre-cropped), a prompt
   pair through the tokenizer, batch 4, 50 DDIM steps at CFG 7.5, lora
   weights (1.0, 0.8): a warm-up and a timed run under the default kernels,
   then under CTRLORA_KERNELS-equivalent gn1=1,hpack=2,qkvpack=0 (kernels A2
   and B6); one UNet + two-ControlNet evaluation with the flagged kernels
   against the plain versions; lora weights (1, 0) against (0, 1) must
   differ. The files are deleted at the end.

The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.

Phase 3 holds each kernel against yardsticks as well: bound_ms, the least
time the card could take for the same work (the larger of its flops at the
H100's 989 TFLOP/s bf16 and its bytes, each input read once and each output
written once, at 3.35 TB/s; bound_by says which), pct_of_bound, and
library_ms, the time of one PyTorch call that computes the same function
(F.scaled_dot_product_attention for the flash forwards, its autograd
backward for dQ and dK/dV together, F.group_norm where there is no row or
SiLU; null where no call does: GEGLU, the row unpack). The port never calls
these.

    python3 chip_smoke.py --profile N

also profiles N DDIM steps of phase 4 and one finetune step of phase 6
with torch.profiler (device ms per step by kernel, launches, device busy
share, and the flash backward's share of the step).
"""

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch import api as api_mod
from ctrlora_tpu_torch import configs, lora_fuse
from ctrlora_tpu_torch.models.layers import GroupNorm32, LayerNorm32
from ctrlora_tpu_torch.models.unet import decoder_plan, encoder_plan
from ctrlora_tpu_torch.models.vae import AutoencoderKL
from ctrlora_tpu_torch.ops import _build
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import geglu_ffn as geglu_ops
from ctrlora_tpu_torch.ops import group_norm as gn_ops
from ctrlora_tpu_torch.ops import kernel_flags
from ctrlora_tpu_torch.ops import unpack_rows as unpack_ops
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import make_emb_row_tables
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.training import train_state
from ctrlora_tpu_torch.training.step import loss_for_batch
from ctrlora_tpu_torch.training.trainer import Trainer
from ctrlora_tpu_torch.utils import ckpt_torch
from ctrlora_tpu_torch.utils.loading import check_key

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
STEPS = 50
BATCH, SIZE = 4, 512
WARMUP_STEPS, TRAIN_STEPS = 2, 5
# bf16 outputs: one bf16 ulp is 2^-8 relative, and kernel and plain version
# round at different points (fp32 accumulation order, the bf16-rounded
# probabilities and gate), so a few ulps apart is agreement
RTOL, ATOL = 2e-2, 2e-2
# relative L2 error bound of one full UNet+ControlNet evaluation, kernels vs
# plain versions: bf16 rounding differences through ~50 blocks
MODEL_REL_TOL = 5e-2
# relative L2 bound of a flash-attention gradient, kernel vs plain: the
# kernels round P and dS to bf16 before the dV/dK/dQ products, and the
# rounding errors sum over up to 4096 keys (or queries)
GRAD_REL_TOL = 2e-2
# one training step, kernels vs plain: relative loss bound, and the
# relative L2 bound of the concatenated trainable gradient (the forward's
# bound, since the gradient inherits its bf16 rounding through ~50 blocks)
LOSS_REL_TOL = 1e-2
ZERO_INIT = ("conv_out", "out_conv", "proj_out")
# the H100 SXM's published dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take for this work, in ms, and what
    bounds it: the larger of flops at the bf16 peak and bytes at the memory
    rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


KERNELS = {  # wrapper -> (route, source, TPU kernel it replaces)
    "group_norm": ("triton", "ctrlora_tpu_torch/ops/group_norm.py",
                   "ctrlora_tpu/ops/group_norm.py:30 _stats_kernel + :47 _apply_kernel"),
    "group_norm_onepass": ("cuda", "ctrlora_tpu_torch/csrc/group_norm_onepass.cu",
                           "ctrlora_tpu/ops/group_norm.py:55 _onepass_kernel"),
    "flash_attention": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention.cu",
                        "ctrlora_tpu/ops/flash_attention.py:58 _fwd_kernel"),
    "flash_attention_bshd": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention.cu",
                             "ctrlora_tpu/ops/flash_attention.py:138 _fwd_kernel_packed"),
    "flash_attention_hpack2": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention_hpack2.cu",
                               "ctrlora_tpu/ops/flash_attention.py:224 _fwd_kernel_hpack2"),
    "flash_attention_qkv": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention.cu",
                            "ctrlora_tpu/ops/flash_attention.py:304 _fwd_kernel_packed_qkv"),
    "flash_attention_bwd_dq": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention_bwd.cu",
                               "ctrlora_tpu/ops/flash_attention.py:622 _bwd_dq_kernel"),
    "flash_attention_bwd_dkv": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention_bwd.cu",
                                "ctrlora_tpu/ops/flash_attention.py:651 _bwd_dkv_kernel"),
    "geglu_ffn": ("cuda", "ctrlora_tpu_torch/csrc/geglu_ffn.cu",
                  "ctrlora_tpu/ops/geglu_ffn.py:59 _geglu_kernel + :120 _geglu_kernel_blocked"),
    "unpack_rows": ("triton", "ctrlora_tpu_torch/ops/unpack_rows.py",
                    "ctrlora_tpu/ops/unpack_rows.py:32 _unpack_kernel"),
}


def wrappers():
    return {"group_norm": gn_ops.group_norm, "group_norm_onepass": gn_ops.group_norm_onepass,
            "flash_attention_qkv": fa_ops.flash_attention_qkv,
            "flash_attention": fa_ops.flash_attention,
            "flash_attention_bshd": fa_ops.flash_attention_bshd,
            "flash_attention_hpack2": fa_ops.flash_attention_hpack2,
            "flash_attention_bwd_dq": fa_ops.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa_ops.flash_attention_bwd_dkv,
            "geglu_ffn": geglu_ops.geglu_ffn, "unpack_rows": unpack_ops.unpack_rows}


# the kernels each path must launch
SAMPLING_KERNELS = ("group_norm", "flash_attention_qkv", "flash_attention", "geglu_ffn",
                    "unpack_rows")
TRAINING_KERNELS = ("group_norm", "flash_attention_qkv", "flash_attention",
                    "flash_attention_bshd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                    "geglu_ffn")
# the two-LoRA API path under the default kernels, and under the flags that
# switch on kernels A2 and B6 (CTRLORA_KERNELS=gn1=1,hpack=2,qkvpack=0)
API_KERNELS = ("group_norm", "flash_attention_qkv", "flash_attention", "geglu_ffn",
               "unpack_rows")
FLAGS = {"gn_onepass": True, "head_pack": 2, "attn_qkv_packed": False}
API_FLAGGED_KERNELS = ("group_norm", "group_norm_onepass", "flash_attention",
                       "flash_attention_bshd", "flash_attention_hpack2", "geglu_ffn",
                       "unpack_rows")


@contextlib.contextmanager
def counted(path: str, required):
    """Zero every launch count, run the block, read the counts into the
    yielded dict, and fail unless each kernel in `required` launched."""
    counters = wrappers()
    for w in counters.values():
        w.launches = 0
    launches = {}
    yield launches
    launches.update({name: w.launches for name, w in counters.items()})
    missing = [n for n in required if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain version (for comparisons)."""
    with contextlib.ExitStack() as stack:
        for mod, name, plain in (
                (gn_ops, "group_norm", gn_ops.group_norm_plain),
                (gn_ops, "group_norm_onepass", gn_ops.group_norm_plain),
                (fa_ops, "flash_attention_qkv", fa_ops.flash_attention_qkv_plain),
                (fa_ops, "flash_attention", fa_ops.attention_plain),
                (fa_ops, "flash_attention_bshd", fa_ops.flash_attention_bshd_plain),
                (fa_ops, "flash_attention_hpack2", fa_ops.flash_attention_hpack2_plain),
                (geglu_ops, "geglu_ffn", geglu_ops.geglu_ffn_plain),
                (unpack_ops, "unpack_rows", unpack_ops.unpack_rows_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        yield


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, iters=10):
    """Median device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def time_b2b(fn, calls=20):
    """Device ms per call of fn(), `calls` calls queued behind a sleep kernel
    between one pair of CUDA events: the launches queue up while the card
    sleeps, so the host's time to issue them (which per-call events read
    for kernels under ~0.15 ms) stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / calls


def host_us(fn, calls=200):
    """Host microseconds per call of fn() at a shape whose device work is
    shorter than its launch: the time to enqueue, not to run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def compare(got, want, rtol=RTOL, atol=ATOL):
    """Max abs error; raises unless |got - want| <= atol + rtol |want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} of {err.numel()} elements outside "
                             f"rtol={rtol} atol={atol}; max abs err {err.max().item()}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def emb_row_sizes(cfg):
    """Widths of the per-step emb_proj rows (UNet + one ControlNet)."""
    enc = [s.out_ch for s in encoder_plan(cfg.unet)[0] if s.kind == "res"]
    mid = [encoder_plan(cfg.unet)[2]] * 2
    dec = [s.out_ch for s in decoder_plan(cfg.unet)]
    return enc + mid + dec + enc + mid


def group_norm_library(x, scale, bias, eps):
    """F.group_norm on the same channels-last x (a [B, C, H, W] view) with
    the affine in x's dtype: the yardstick where there is no row or SiLU."""
    xc = x.permute(0, 3, 1, 2)
    sc, bi = scale.to(x.dtype), bias.to(x.dtype)
    return "F.group_norm", lambda: F.group_norm(xc, 32, sc, bi, eps)


def kernel_checks(dev, cfg):
    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *s, dt=torch.bfloat16, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    results = {}

    def yardsticks(work, library, ms):
        """The least time for `work` (flops, bytes) on the card, and the
        time of `library` = (name, fn), one PyTorch call that computes the
        same function, or None where there is none."""
        bms, by = bound_ms(*work)
        return {"bound_ms": bms, "bound_by": by, "pct_of_bound": 100.0 * bms / ms,
                "library": library[0] if library else "—",
                "library_ms": time_ms(library[1]) if library else None}

    def keep(name, row, err_keys):
        r = results.setdefault(name, {k: 0.0 for k in err_keys})
        for key in err_keys:
            r[key] = max(r[key], row[key])
        for key, val in row.items():  # the first shape listed is the dominant one
            r.setdefault(key, val)

    def record(name, label, got, want, fn_k, fn_p, work, library=None, extra=None, **beside):
        """`work`: (flops, bytes) at this shape; `library`: (name, fn) or None;
        `beside`: ms of the kernels this one stands beside, same inputs."""
        err = compare(got, want)
        if extra is not None:
            err = max(err, compare(*extra))
        ms, pms = time_ms(fn_k), time_ms(fn_p)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **yardsticks(work, library, ms)}
        log("kernels", kernel=name, shape=label, **row, **beside)
        keep(name, {**row, **beside}, ("max_abs_err",))

    def record_grad(name, label, got, want, fn_k, fn_p, work, library=None, **beside):
        """Gradients: relative L2 per output <= GRAD_REL_TOL, and within
        RTOL/ATOL elementwise, finite."""
        rels, err = [], 0.0
        for g_, w_ in zip(got, want):
            g_, w_ = g_.float(), w_.float()
            if not torch.isfinite(g_).all():
                raise AssertionError(f"{name} {label}: gradient is not finite")
            rels.append(((g_ - w_).norm() / w_.norm()).item())
            err = max(err, compare(g_, w_))
        if max(rels) > GRAD_REL_TOL:
            raise AssertionError(f"{name} {label}: relative L2 {rels} > {GRAD_REL_TOL}")
        ms, pms = time_ms(fn_k), time_ms(fn_p)
        row = {"max_abs_err": err, "rel_l2": max(rels), "ms": ms, "plain_ms": pms,
               **yardsticks(work, library, ms)}
        log("kernels", kernel=name, shape=label, **{**row, "rel_l2": rels}, bound=GRAD_REL_TOL,
            **beside)
        keep(name, {**row, **beside}, ("max_abs_err", "rel_l2"))

    sdpa = lambda *qkv: ("F.scaled_dot_product_attention",
                         lambda: F.scaled_dot_product_attention(*qkv))

    for shape, eps, silu, row in (
            ((8, 64, 64, 320), 1e-5, True, True), ((8, 32, 32, 640), 1e-5, True, True),
            ((8, 16, 16, 1280), 1e-5, True, True), ((8, 8, 8, 1280), 1e-5, True, True),
            ((8, 64, 64, 320), 1e-6, False, False), ((4, 512, 512, 128), 1e-6, True, False),
            ((4, 64, 64, 512), 1e-6, False, False)):
        c = shape[-1]
        x = rn(*shape, std=2.0) + 0.5
        sc, bi = rn(c, dt=torch.float32, std=0.1) + 1, rn(c, dt=torch.float32, std=0.1)
        add = rn(1, c, std=0.5) if row else None
        args = (x, sc, bi, 32, eps, silu, add)
        record("group_norm", f"{list(shape)} eps={eps} silu={silu} add_row={row}",
               gn_ops.group_norm(*args), gn_ops.group_norm_plain(*args),
               lambda: gn_ops.group_norm(*args), lambda: gn_ops.group_norm_plain(*args),
               gn_ops.group_norm_work(shape[0], shape[1] * shape[2], c, 2, 1 if row else 0),
               library=None if silu or row else group_norm_library(x, sc, bi, eps))

    # A2: the one-pass GroupNorm at the five shapes gn1=1 admits on the
    # sampling path (the last: the UNet decoder's 16x16 in_norms over the
    # concatenated skip), with and without row and SiLU, beside kernel A
    for shape in ((8, 64, 64, 320), (8, 32, 32, 640), (8, 32, 32, 960), (8, 32, 32, 1280),
                  (8, 16, 16, 2560)):
        c = shape[-1]
        x = rn(*shape, std=2.0) + 0.5
        sc, bi = rn(c, dt=torch.float32, std=0.1) + 1, rn(c, dt=torch.float32, std=0.1)
        for silu, row in ((True, rn(1, c, std=0.5)), (False, None),
                          (True, rn(shape[0], c, std=0.5))):
            args = (x, sc, bi, 32, 1e-5, silu, row)
            record("group_norm_onepass", f"{list(shape)} silu={silu} add_row="
                   f"{None if row is None else list(row.shape)}",
                   gn_ops.group_norm_onepass(*args), gn_ops.group_norm_plain(*args),
                   lambda: gn_ops.group_norm_onepass(*args),
                   lambda: gn_ops.group_norm_plain(*args),
                   gn_ops.group_norm_work(shape[0], shape[1] * shape[2], c, 2,
                                          0 if row is None else row.shape[0]),
                   library=None if silu or row is not None else group_norm_library(x, sc, bi,
                                                                                   1e-5),
                   kernel_a_ms=time_ms(lambda: gn_ops.group_norm(*args)))

    # B6: the head-pair forward at the 64x64 sites, contiguous and as split
    # views of the fused projection, beside B's BSHD and fused-qkv entries
    qkv = rn(8, 4096, 3 * 320)
    views = [t.unflatten(-1, (8, 40)) for t in qkv.split(320, dim=-1)]
    for label, ops, beside in (
            ("[8, 4096, 8, 40]", [t.contiguous() for t in views],
             lambda q, k, v: {"bshd_ms": time_ms(lambda: fa_ops.flash_attention_bshd(q, k, v))}),
            ("views of [8, 4096, 3*8*40]", views,
             lambda *_: {"qkv_ms": time_ms(lambda: fa_ops.flash_attention_qkv(qkv, 8, 40))})):
        out, lse = fa_ops.flash_attention_hpack2(*ops)
        pout, plse = fa_ops.flash_attention_hpack2_plain(*ops)
        record("flash_attention_hpack2", label, out, pout,
               lambda: fa_ops.flash_attention_hpack2(*ops),
               lambda: fa_ops.flash_attention_hpack2_plain(*ops),
               fa_ops.flash_forward_work(8, 8, 4096, 4096, 40),
               library=sdpa(*(t.transpose(1, 2) for t in ops)), extra=(lse, plse),
               **beside(*ops))
        del out, lse, pout, plse

    for s, h, d in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        qkv = rn(8, s, 3 * h * d)
        out, lse = fa_ops.flash_attention_qkv(qkv, h, d)
        pout, plse = fa_ops.flash_attention_qkv_plain(qkv, h, d)
        record("flash_attention_qkv", f"[8, {s}, 3*{h}*{d}]", out, pout,
               lambda: fa_ops.flash_attention_qkv(qkv, h, d),
               lambda: fa_ops.flash_attention_qkv_plain(qkv, h, d),
               fa_ops.flash_forward_work(8, h, s, s, d),
               library=sdpa(*(t.unflatten(-1, (h, d)).transpose(1, 2)
                              for t in qkv.split(h * d, dim=-1))), extra=(lse, plse))

    q, k, v = (rn(4, 1, 4096, 512) for _ in range(3))
    out, lse = fa_ops.flash_attention(q, k, v)
    pout, plse = fa_ops.attention_plain(q, k, v)
    record("flash_attention", "[4, 1, 4096, 512]", out, pout,
           lambda: fa_ops.flash_attention(q, k, v), lambda: fa_ops.attention_plain(q, k, v),
           fa_ops.flash_forward_work(4, 1, 4096, 4096, 512), library=sdpa(q, k, v),
           extra=(lse, plse))

    # B2: the LoRA control branch's self-attention, q, k, v [B, S, H, D]
    for s, h, d in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        q, k, v = (rn(4, s, h, d) for _ in range(3))
        out, lse = fa_ops.flash_attention_bshd(q, k, v)
        pout, plse = fa_ops.flash_attention_bshd_plain(q, k, v)
        record("flash_attention_bshd", f"[4, {s}, {h}, {d}]", out, pout,
               lambda: fa_ops.flash_attention_bshd(q, k, v),
               lambda: fa_ops.flash_attention_bshd_plain(q, k, v),
               fa_ops.flash_forward_work(4, h, s, s, d),
               library=sdpa(*(t.transpose(1, 2) for t in (q, k, v))), extra=(lse, plse))

    # B4/B5: the backward at [B*H = 32, S, D], BHSD; then the BSHD and
    # fused-qkv layouts (strided views) at the dominant shape
    def bwd_case(label, q, k, v, dout):
        out, lse = fa_ops.flash_attention(q, k, v)  # [4, 8, S, D] views in, contiguous out
        delta = (out.float() * dout.float()).sum(-1)
        sc = q.shape[-1] ** -0.5
        args = (q, k, v, lse, dout, delta, sc)
        dq = fa_ops.flash_attention_bwd_dq(*args)
        dk, dv = fa_ops.flash_attention_bwd_dkv(*args)
        # no atomics: a second launch gives the same bits
        again = (fa_ops.flash_attention_bwd_dq(*args), *fa_ops.flash_attention_bwd_dkv(*args))
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            raise AssertionError(f"B4/B5 {label}: two launches differ")
        del again
        pdq = fa_ops.flash_attention_bwd_dq_plain(*args)
        pdk, pdv = fa_ops.flash_attention_bwd_dkv_plain(*args)
        # the yardstick of both kernels: SDPA's backward (dq, dk and dv in
        # one call) of one SDPA output, its graph built outside the timing
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        library = ("autograd.grad of F.scaled_dot_product_attention (dq, dk, dv)",
                   lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True))
        b, h, s, d = q.shape
        for name, got, want, work in (
                ("flash_attention_bwd_dq", [dq], [pdq], fa_ops.flash_bwd_dq_work),
                ("flash_attention_bwd_dkv", [dk, dv], [pdk, pdv], fa_ops.flash_bwd_dkv_work)):
            wrapper = getattr(fa_ops, name)
            record_grad(name, label, got, want, lambda: wrapper(*args),
                        lambda: getattr(fa_ops, name + "_plain")(*args), work(b, h, s, s, d),
                        library, bit_equal_runs=True, b2b_ms=time_b2b(lambda: wrapper(*args)))
        del lib_out, leaves

    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        bwd_case(f"bhsd [4, 8, {s}, {d}]", *(rn(4, 8, s, d) for _ in range(4)))
    s, h, d = 4096, 8, 40
    bshd = [rn(4, s, h, d).transpose(1, 2) for _ in range(4)]
    bwd_case(f"bshd [4, {s}, {h}, {d}]", *bshd)
    qkv = rn(4, s, 3 * h * d)
    views = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
    bwd_case(f"qkv [4, {s}, 3*{h}*{d}]", *views, rn(4, s, h, d).transpose(1, 2))

    # C at the four sampling sites (the CFG batch of 8), then the finetune
    # step's 64^2 site (batch 4); beside each, its two launches alone
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, c in ((8 * 4096, 320), (8 * 1024, 640), (8 * 256, 1280), (8 * 64, 1280),
                    (4 * 4096, 320)):
        f = 4 * c
        x, w1, b1, w2, b2 = args = (rn(rows, c), rn(2 * f, c, std=c ** -0.5), rn(2 * f, std=0.1),
                                    rn(c, f, std=f ** -0.5), rn(c, std=0.1))
        plan = geglu_ops.geglu_plan(rows, c, f, sms)
        h, y = torch.empty((rows, f), dtype=torch.bfloat16, device=dev), torch.empty_like(x)
        record("geglu_ffn", f"rows={rows} C={c} F={f}", geglu_ops.geglu_ffn(*args),
               geglu_ops.geglu_ffn_plain(*args), lambda: geglu_ops.geglu_ffn(*args),
               lambda: geglu_ops.geglu_ffn_plain(*args), geglu_ops.geglu_ffn_work(rows, c, f),
               up_ms=time_ms(lambda: geglu_ops.launch_up(x, w1, b1, h, plan)),
               down_ms=time_ms(lambda: geglu_ops.launch_down(h, w2, b2, y, plan)),
               plan=dataclasses.asdict(plan))
        del x, w1, b1, w2, b2, args, h, y
    # the wrapper's host time per call (128 rows: the launches take longer
    # to issue than to run), kernels and plain version
    args = (rn(128, 320), rn(2560, 320, std=320 ** -0.5), rn(2560, std=0.1),
            rn(320, 1280, std=1280 ** -0.5), rn(320, std=0.1))
    log("kernels", kernel="geglu_ffn", shape="rows=128 C=320 F=1280, host time",
        host_us_per_call=host_us(lambda: geglu_ops.geglu_ffn(*args)),
        plain_host_us_per_call=host_us(lambda: geglu_ops.geglu_ffn_plain(*args)))

    sizes = emb_row_sizes(cfg)
    block = rn(len(sizes), max(sizes))
    rows = unpack_ops.unpack_rows(block, sizes)
    prows = unpack_ops.unpack_rows_plain(block, sizes)
    for a, b in zip(rows, prows):
        if not torch.equal(a, b):
            raise AssertionError("unpack_rows differs from its plain version")
    record("unpack_rows", f"[{len(sizes)}, {max(sizes)}]", torch.cat(rows, 1),
           torch.cat(prows, 1), lambda: unpack_ops.unpack_rows(block, sizes),
           lambda: unpack_ops.unpack_rows_plain(block, sizes),
           unpack_ops.unpack_rows_work(sizes))
    return results


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def random_init_(module: nn.Module, gen: torch.Generator) -> None:
    """Lecun-normal Dense/Conv weights, zero biases, N(0, 0.02) embeddings;
    the layers a fresh model zero-initialises get N(0, 0.05) instead, so
    every branch carries signal as in a trained checkpoint. LoRA adapters:
    lora_down N(0, 1/r), lora_up N(0, 0.05), so every LoRA tensor gets a
    gradient."""
    dev = next(module.parameters()).device
    randn = lambda p, std: p.data.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    for name, m in module.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bumped = leaf in ZERO_INIT or leaf.startswith("zero_")
            randn(m.weight, 0.05 if bumped else m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.data.zero_()
            if getattr(m, "lora", None) is not None:
                randn(m.lora_down, 1.0 / m.lora_down.shape[-1])
                randn(m.lora_up, 0.05)
        for pname in ("token_embedding", "position_embedding"):
            p = getattr(m, pname, None)
            if isinstance(p, nn.Parameter):
                p.data.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)


def unfused_control_state(control: nn.Module, lora: configs.LoRAConfig,
                          gen: torch.Generator) -> dict:
    """A control state dict as the LoRA-trained model holds it: a
    rank-r adapter on every Linear (down N(0, 1/r), up N(0, 0.05)) and
    [n]-banked zero convs and transformer norms."""
    dev = next(control.parameters()).device
    state = dict(control.state_dict())
    n, r = lora.n_loras, lora.rank
    for name, m in control.named_modules():
        if isinstance(m, nn.Linear):
            state[f"{name}.lora_down"] = torch.randn(
                (n, m.in_features, r), generator=gen, device=dev) / r
            state[f"{name}.lora_up"] = torch.randn(
                (n, r, m.out_features), generator=gen, device=dev) * 0.05
        banked = (name.startswith("zero_") or
                  (isinstance(m, (GroupNorm32, LayerNorm32)) and "_attn" in name))
        if banked:
            for pname, p in m.named_parameters(recurse=False):
                state[f"{name}.{pname}"] = p.detach()[None].expand(n, *p.shape).clone()
    return state


def build_pipeline(cfg, dev, gen) -> CtrLoraPipeline:
    pipe = CtrLoraPipeline(cfg, dev)
    for m in pipe.modules():
        random_init_(m, gen)
    state = unfused_control_state(pipe.control, cfg.control.lora, gen)
    pipe.control.load_state_dict(
        lora_fuse.fuse_control_tree(pipe.control, state, 0, cfg.control.lora), strict=True)
    pipe.cast_for_inference()
    return pipe


def sample(pipe, ids, uncond, hint, x_T, steps):
    """The serving path: CLIP pair, VAE encode, DDIM with CFG, VAE decode.
    Returns (image, per-phase seconds)."""
    t = [time.perf_counter()]
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    hz = pipe.encode_first_stage(hint)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    z = ddim_sample(pipe, ctx, unc, [Conditioning(hz)], x_T.shape,
                    DDIMConfig(steps=steps, guidance_scale=7.5), x_T=x_T)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    img = pipe.decode_first_stage(z)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return img, {"prep_s": t[1] - t[0], "ddim_s": t[2] - t[1], "decode_s": t[3] - t[2]}


def profile_window(path, run, steps):
    """torch.profiler over run(), which takes `steps` steps of `path`: device
    time per step by kernel (top 15), launches, the flash backward's device
    ms and launches (B4/B5 kernels, `flash_bwd` in their names), and the
    device's busy share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in events) / 1e3
    bwd = [e for e in events if "flash_bwd" in e.key]
    top = sorted(events, key=dev_us, reverse=True)[:15]
    log("profile", path=path, steps=steps, wall_ms_per_step=wall * 1e3 / steps,
        device_ms_per_step=busy / steps, device_busy_share=busy / (wall * 1e3),
        launches_per_step=sum(e.count for e in events) / steps,
        flash_bwd_ms_per_step=sum(dev_us(e) for e in bwd) / 1e3 / steps,
        flash_bwd_launches_per_step=sum(e.count for e in bwd) / steps,
        flash_bwd=[{"kernel": e.key[:60], "calls_per_step": e.count / steps,
                    "ms_per_step": dev_us(e) / 1e3 / steps} for e in bwd],
        top=[{"kernel": e.key[:90], "calls_per_step": e.count / steps,
              "ms_per_step": dev_us(e) / 1e3 / steps} for e in top])


def profile_ddim(pipe, ids, uncond, hint, x_T, steps):
    """`steps` DDIM steps of the sampling slice under the profiler."""
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    hz = pipe.encode_first_stage(hint)
    run = lambda: ddim_sample(pipe, ctx, unc, [Conditioning(hz)], x_T.shape,
                              DDIMConfig(steps=steps, guidance_scale=7.5), x_T=x_T)
    run()
    torch.cuda.synchronize()
    profile_window("ddim", run, steps)


def fp32_vae_decode(pipe, cfg, z):
    """An fp32 copy of the pipeline's VAE decodes latent z: the dispatch
    rules send its 64^2 mid-block attention (S = 4096, D = 512) to the plain
    version, where the bf16 VAE launches the kernel. Finite, and within
    relative L2 MODEL_REL_TOL of the bf16 decode (bf16 rounding through the
    decoder's ~30 blocks)."""
    vae32 = AutoencoderKL(dataclasses.replace(cfg.vae, dtype="float32")).to(z.device).eval()
    vae32.load_state_dict({k: v.float() for k, v in pipe.vae.state_dict().items()}, strict=True)
    z = z / cfg.diffusion.scale_factor
    with torch.no_grad(), counted("fp32 VAE decode", ()) as fp32_launches:
        img32 = vae32.decode(z)
    with torch.no_grad(), counted("bf16 VAE decode", ("flash_attention",)) as bf16_launches:
        img16 = pipe.vae.decode(z)
    rel = ((img32 - img16).norm() / img32.norm()).item()
    log("slice", fp32_vae_decode_shape=list(img32.shape), fp32_vs_bf16_rel_l2=rel,
        bound=MODEL_REL_TOL, fp32_flash_launches=fp32_launches["flash_attention"],
        bf16_flash_launches=bf16_launches["flash_attention"])
    if not torch.isfinite(img32).all() or not rel <= MODEL_REL_TOL:
        raise AssertionError(f"fp32 VAE decode: finite {bool(torch.isfinite(img32).all())}, "
                             f"rel L2 to bf16 {rel}")
    if fp32_launches["flash_attention"]:
        raise AssertionError("the fp32 VAE's attention reached the bf16 kernel")
    del vae32


def slice_run(dev, cfg, profile_steps=0):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, dev, gen)
    torch.cuda.synchronize()
    log("slice", setup_s=time.perf_counter() - t0,
        params=sum(p.numel() for m in pipe.modules() for p in m.parameters()))
    lat = SIZE // 8
    ids = torch.randint(1, cfg.clip.vocab_size, (BATCH, cfg.clip.max_length),
                        generator=gen, device=dev)
    uncond = torch.zeros_like(ids)
    hint = torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev) * 2 - 1
    x_T = torch.randn((BATCH, lat, lat, 4), generator=gen, device=dev)

    t0 = time.perf_counter()
    sample(pipe, ids, uncond, hint, x_T, steps=2)  # warm-up: Triton compiles here
    log("slice", warmup_s=time.perf_counter() - t0, steps=2)

    torch.cuda.reset_peak_memory_stats(dev)
    with counted("sampling", SAMPLING_KERNELS) as launches:
        t0 = time.perf_counter()
        img, phases = sample(pipe, ids, uncond, hint, x_T, steps=STEPS)
        total = time.perf_counter() - t0
    log("slice", steps=STEPS, batch=BATCH, size=SIZE, s_per_batch=total,
        s_per_step=phases["ddim_s"] / STEPS, **phases, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if tuple(img.shape) != (BATCH, SIZE, SIZE, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"bad image: shape {tuple(img.shape)}")
    log("slice", image_mean=img.mean().item(), image_std=img.std().item())
    if profile_steps:
        profile_ddim(pipe, ids, uncond, hint, x_T, profile_steps)

    # one UNet+ControlNet evaluation: kernels vs plain versions
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    hz = pipe.encode_first_stage(hint)
    full_ctx = torch.cat([ctx, unc])
    conds = [Conditioning(torch.cat([hz, hz]))]
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)
    x2 = torch.cat([x_T, x_T])

    def evaluate():
        packed, rows_of = make_emb_row_tables(pipe, conds, ts)
        return pipe.apply_model(x2, tvec, full_ctx, conds, emb_rows=rows_of(packed[0]))

    out_k = evaluate()
    with plain_versions():
        out_p = evaluate()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    log("slice", unet_controlnet_rel_l2_kernels_vs_plain=rel,
        max_abs=(out_k - out_p).abs().max().item(), bound=MODEL_REL_TOL)
    if not math.isfinite(rel) or rel > MODEL_REL_TOL:
        raise AssertionError(f"kernel path departs from the plain path: rel {rel}")
    fp32_vae_decode(pipe, cfg, x_T[:1])
    return launches, total, phases


def tiny_gpu_vs_cpu(dev):
    """The tiny configuration on the GPU (fp32: the GroupNorm and row-unpack
    kernels run, the rest is plain at these widths) against the CPU."""
    cfg = configs.tiny_test_config(n_loras=1, switchable_banks=True)
    gen = torch.Generator().manual_seed(SEED)
    cpu = build_pipeline(cfg, "cpu", gen)
    gpu = CtrLoraPipeline(cfg, dev)
    for a, b in zip(gpu.modules(), cpu.modules()):
        a.load_state_dict(b.state_dict(), strict=True)
    gpu.cast_for_inference()
    ids = torch.randint(1, cfg.clip.vocab_size, (1, cfg.clip.max_length), generator=gen)
    hint = torch.rand((1, 16, 16, 3), generator=gen) * 2 - 1
    x_T = torch.randn((1, 8, 8, 4), generator=gen)
    outs = []
    for pipe, d in ((cpu, "cpu"), (gpu, dev)):
        ctx, unc = pipe.encode_text_cond_uncond(ids.to(d), torch.zeros_like(ids).to(d))
        z = ddim_sample(pipe, ctx, unc, [Conditioning(pipe.encode_first_stage(hint.to(d)))],
                        x_T.shape, DDIMConfig(steps=3, guidance_scale=7.5), x_T=x_T.to(d))
        outs.append(pipe.decode_first_stage(z).cpu())
    err = compare(outs[1], outs[0], rtol=2e-3, atol=2e-4)
    log("tiny", gpu_vs_cpu_max_abs_err=err, tol="rtol=2e-3 atol=2e-4")


# ---------------------------------------------------------------------------
# phases 6 and 7: the training slice
# ---------------------------------------------------------------------------

def synthetic_batch(gen, dev, n, size, max_length, vocab):
    """jpg uniform in [-1, 1], hint uniform in [0, 1], random token ids."""
    return {"jpg": torch.rand((n, size, size, 3), generator=gen, device=dev) * 2 - 1,
            "hint": torch.rand((n, size, size, 3), generator=gen, device=dev),
            "token_ids": torch.randint(1, vocab, (n, max_length), generator=gen, device=dev)}


def fixed_draws(gen, dev, n, lat):
    """Explicit posterior noise, t and diffusion noise, so two runs of one
    step share every random draw."""
    rn = lambda: torch.randn((n, lat, lat, 4), generator=gen, device=dev)
    return {"z_eps": rn(), "hint_eps": rn(),
            "t": torch.randint(0, 1000, (n,), generator=gen, device=dev), "noise": rn()}


def step_grads(pipe, params, batch, draws):
    """One step's loss and its concatenated trainable gradient (fp32)."""
    for p in params:
        p.grad = None
    loss, _ = loss_for_batch(pipe, batch, draws=draws)
    loss.backward()
    return loss.item(), torch.cat([p.grad.float().flatten() for p in params])


def train_slice(dev, profile=False):
    cfg = configs.ctrlora_finetune_config(lora_rank=128)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    pipe = CtrLoraPipeline(cfg, dev, fuse_lora=False)
    for m in pipe.modules():
        random_init_(m, gen)
    workdir = os.path.join(ROOT, "runs", "chip_smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = Trainer(pipe, configs.TrainConfig(trainable="lora", log_every=1), workdir)
    named = {f"{b}.{n}": p for b, m in train_state.branches(pipe).items()
             for n, p in m.named_parameters()}
    trainable = train_state.trainable_parameters(pipe, trainer.mask)
    before = {k: p.detach().clone() for k, p in named.items()}
    batches = [synthetic_batch(gen, dev, BATCH, SIZE, cfg.clip.max_length, cfg.clip.vocab_size)
               for _ in range(WARMUP_STEPS + TRAIN_STEPS)]
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in trainable.values())
    log("train", setup_s=time.perf_counter() - t0, trainable_params_m=n_train / 1e6,
        params=sum(p.numel() for p in named.values()))

    t0 = time.perf_counter()
    trainer.fit(batches[:WARMUP_STEPS], max_steps=WARMUP_STEPS)  # Triton compiles here
    torch.cuda.synchronize()
    log("train", warmup_s=time.perf_counter() - t0, steps=WARMUP_STEPS)

    torch.cuda.reset_peak_memory_stats(dev)
    with counted("training", TRAINING_KERNELS) as launches:
        t0 = time.perf_counter()
        trainer.fit(batches[WARMUP_STEPS:], max_steps=WARMUP_STEPS + TRAIN_STEPS)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if '"train"' in ln][-TRAIN_STEPS:]
    s_step = total / TRAIN_STEPS
    log("train", steps=TRAIN_STEPS, batch=BATCH, size=SIZE, s_per_step=s_step,
        steps_per_s=1 / s_step, images_per_s=BATCH / s_step,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        trainable_params_m=n_train / 1e6, loss=[ln["loss"] for ln in lines],
        grad_norm=[ln["grad_norm"] for ln in lines], launches=launches)
    if not all(math.isfinite(ln["loss"]) and ln["grad_norm"] > 0 for ln in lines):
        raise AssertionError(f"bad training metrics: {lines}")
    changed_frozen = [k for k, p in named.items() if k not in trainable
                      and not torch.equal(p, before[k])]
    unchanged = [k for k in trainable if torch.equal(named[k], before[k])]
    log("train", frozen_bit_identical=not changed_frozen, trainable_all_changed=not unchanged,
        n_frozen=len(named) - len(trainable), n_trainable=len(trainable))
    if changed_frozen or unchanged:
        raise AssertionError(f"frozen changed {changed_frozen[:5]}, trainable unchanged "
                             f"{unchanged[:5]}")
    del before
    if profile:  # one more step, under the profiler
        profile_window("train", lambda: trainer.fit(batches[:1],
                                                    max_steps=trainer.state.step + 1), 1)

    # one step's loss and trainable gradients: kernels vs plain versions
    batch = batches[0]
    draws = fixed_draws(gen, dev, BATCH, SIZE // 2 ** (len(cfg.vae.ch_mult) - 1))
    params = list(trainable.values())
    loss_k, grad_k = step_grads(pipe, params, batch, draws)
    with plain_versions():
        loss_p, grad_p = step_grads(pipe, params, batch, draws)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    log("train", loss_kernels=loss_k, loss_plain=loss_p, loss_rel=loss_rel,
        loss_bound=LOSS_REL_TOL, grad_rel_l2_kernels_vs_plain=grad_rel,
        grad_bound=MODEL_REL_TOL, grads_finite=bool(torch.isfinite(grad_k).all()))
    if not (math.isfinite(loss_rel) and loss_rel <= LOSS_REL_TOL and grad_rel <= MODEL_REL_TOL
            and torch.isfinite(grad_k).all()):
        raise AssertionError(f"training step departs from the plain path: loss {loss_rel}, "
                             f"grad {grad_rel}")
    return launches, s_step


def tiny_train_gpu_vs_cpu(dev):
    """One tiny training step (fp32: the GroupNorm kernel runs, the rest is
    plain at these widths) on the GPU against the CPU, same draws."""
    cfg = configs.tiny_test_config(n_loras=1)
    gen = torch.Generator().manual_seed(SEED)
    cpu = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    for m in cpu.modules():
        random_init_(m, gen)
    gpu = CtrLoraPipeline(cfg, dev, fuse_lora=False)
    for a, b in zip(gpu.modules(), cpu.modules()):
        a.load_state_dict(b.state_dict(), strict=True)
    batch = synthetic_batch(gen, "cpu", 2, 16, cfg.clip.max_length, cfg.clip.vocab_size)
    draws = fixed_draws(gen, "cpu", 2, 8)
    out = []
    for pipe, d in ((cpu, "cpu"), (gpu, dev)):
        tcfg = configs.TrainConfig(trainable="lora")
        mask = train_state.trainable_mask(pipe, tcfg)
        train_state.make_optimizer(pipe, tcfg, mask)
        params = list(train_state.trainable_parameters(pipe, mask).values())
        loss, grad = step_grads(pipe, params, {k: v.to(d) for k, v in batch.items()},
                                {k: v.to(d) for k, v in draws.items()})
        out.append((torch.tensor([loss]), grad.cpu()))
    err = max(compare(out[1][0], out[0][0], rtol=2e-3, atol=2e-4),
              compare(out[1][1], out[0][1], rtol=2e-3, atol=2e-4))
    log("tiny_train", gpu_vs_cpu_max_abs_err=err, loss_gpu=out[1][0].item(),
        loss_cpu=out[0][0].item(), tol="rtol=2e-3 atol=2e-4")


# ---------------------------------------------------------------------------
# phases 5 (tiny) and 8: the two-LoRA API path from reference-format files
# ---------------------------------------------------------------------------

PROMPT = "a photo of a modern house by a lake at sunset, highly detailed, 8k"
N_PROMPT = "lowres, blurry, bad anatomy, worst quality"
LORA_WEIGHTS = (1.0, 0.8)


def two_lora_state(control: nn.Module, lora: configs.LoRAConfig, gen: torch.Generator) -> dict:
    """An unfused control state of `lora.n_loras` trained LoRAs: the
    adapters of ``unfused_control_state``, and zero convs and transformer
    norms that differ per slot (each slot's copy plus its own noise)."""
    state = unfused_control_state(control, lora, gen)
    target = control.state_dict()
    for key, value in state.items():
        if key in target and value.ndim == target[key].ndim + 1:
            noise = torch.randn(value.shape, generator=gen, device=value.device)
            state[key] = value + (0.05 if key.startswith("zero_") else 0.1) * noise
    return state


def write_reference_files(src: CtrLoraPipeline, control_state: dict, cfg, outdir: str,
                          dtype: torch.dtype):
    """The SD checkpoint (UNet, VAE, CLIP under the reference prefixes), the
    Base ControlNet and one file per LoRA slot, in `dtype`, through the
    port's exporters. Returns (paths, the written state dicts)."""
    os.makedirs(outdir, exist_ok=True)
    as_file = lambda d: {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}
    sd = {}
    for prefix, module, entries in (
            ("model.diffusion_model.", src.unet, ckpt_torch.unet_entries(cfg.unet)),
            ("first_stage_model.", src.vae, ckpt_torch.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", src.clip,
             ckpt_torch.clip_entries(cfg.clip))):
        sd.update(as_file(ckpt_torch.export_tree(module.state_dict(), entries, prefix)))
    written = {"sd": sd, "basecn": as_file(ckpt_torch.export_control_base(control_state,
                                                                         cfg.control)),
               "loras": [as_file(ckpt_torch.export_lora_slot(control_state, cfg.control, i))
                         for i in range(cfg.control.lora.n_loras)]}
    paths = {"sd": os.path.join(outdir, "sd15.ckpt"), "basecn": os.path.join(outdir, "basecn.ckpt"),
             "loras": [os.path.join(outdir, f"lora{i}.ckpt") for i in range(len(written["loras"]))]}
    torch.save({"state_dict": sd}, paths["sd"])
    torch.save(written["basecn"], paths["basecn"])
    for path, lsd in zip(paths["loras"], written["loras"]):
        torch.save(lsd, path)
    return paths, written


def loaded_matches_written(states, written, cfg) -> int:
    """Every tensor the loader produced equals the file's (fp16 widened to
    fp32 exactly), read back through the exporters; returns the count."""
    pairs = []
    for prefix, sd, entries in (
            ("model.diffusion_model.", states.unet, ckpt_torch.unet_entries(cfg.unet)),
            ("first_stage_model.", states.vae, ckpt_torch.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", states.clip,
             ckpt_torch.clip_entries(cfg.clip))):
        pairs += [(k, v, written["sd"][k]) for k, v in
                  ckpt_torch.export_tree(sd, entries, prefix).items()]
    pfx = "control_model."
    pairs += [(k, v, written["basecn"][k]) for k, v in
              ckpt_torch.export_control_base(states.control, cfg.control).items()
              if not check_key(k[len(pfx):])]
    for i, lsd in enumerate(written["loras"]):
        pairs += [(k, v, lsd[k]) for k, v in
                  ckpt_torch.export_lora_slot(states.control, cfg.control, i).items()]
    bad = [k for k, got, want in pairs if not np.array_equal(got, want.float().numpy())]
    if bad or len(pairs) != len(written["sd"]) + sum(map(len, written["loras"])) + sum(
            not check_key(k[len(pfx):]) for k in written["basecn"]):
        raise AssertionError(f"loaded tensors differ from the files: {bad[:5]} "
                             f"({len(pairs)} compared)")
    return len(pairs)


def create_checked(api: api_mod.CtrLoRA, paths, written, cfg):
    """``api.create_model`` on the files, with the loader's output caught
    on its way and held against what was written. Returns (seconds, n)."""
    caught, load = {}, api_mod.load_ctrlora

    def spy(*args, **kw):
        caught["states"] = load(*args, **kw)
        return caught["states"]

    t0 = time.perf_counter()
    with mock.patch.object(api_mod, "load_ctrlora", spy):
        api.create_model(paths["sd"], paths["basecn"], paths["loras"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, loaded_matches_written(caught.pop("states"), written, cfg)


def tiny_api_gpu_vs_cpu(dev):
    """The tiny two-LoRA API path (the tiny configuration with the real CLIP
    vocabulary, so the tokenizer's ids embed) from tiny reference-format
    files, fp32, on the GPU against the CPU: same files, same seed."""
    cfg = configs.tiny_test_config(n_loras=2, switchable_banks=True)
    cfg = dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vocab_size=49408))
    gen = torch.Generator().manual_seed(SEED)
    src = CtrLoraPipeline(cfg, "cpu")
    for m in src.modules():
        random_init_(m, gen)
    outdir = os.path.join(ROOT, "runs", "chip_smoke_tiny_api")
    shutil.rmtree(outdir, ignore_errors=True)
    paths, _ = write_reference_files(src, two_lora_state(src.control, cfg.control.lora, gen),
                                     cfg, outdir, torch.float32)
    rng = np.random.default_rng(SEED)
    hints = (rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8))
    outs = []
    for d in ("cpu", dev):
        api = api_mod.CtrLoRA(num_loras=2, cfg=cfg, device=d)
        api.create_model(paths["sd"], paths["basecn"], paths["loras"])
        outs.append(api._sample_float(api.prepare_images(hints), PROMPT, N_PROMPT, 2, 3, 7.5,
                                      LORA_WEIGHTS, SEED).cpu())
    shutil.rmtree(outdir, ignore_errors=True)
    err = compare(outs[1], outs[0], rtol=2e-3, atol=2e-4)
    log("tiny_api", gpu_vs_cpu_max_abs_err=err, shape=list(outs[0].shape),
        tol="rtol=2e-3 atol=2e-4")


def api_slice(dev):
    """Phase 8: the two-LoRA API path at SD1.5 width under both kernel
    settings. Returns the launches of each timed run."""
    cfg = configs.ctrlora_inference_config(lora_num=2, lora_rank=128)
    outdir = os.path.join(ROOT, "runs", "chip_smoke_ckpts")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    log("api_2lora", disk_free_gb=shutil.disk_usage(outdir).free / 2 ** 30)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t0 = time.perf_counter()
    src = CtrLoraPipeline(cfg, dev)
    for m in src.modules():
        random_init_(m, gen)
    paths, written = write_reference_files(
        src, two_lora_state(src.control, cfg.control.lora, gen), cfg, outdir, torch.float16)
    del src
    log("api_2lora", write_s=time.perf_counter() - t0,
        file_gb={k: os.path.getsize(p) / 2 ** 30 for k, p in
                 (("sd", paths["sd"]), ("basecn", paths["basecn"]), ("lora0", paths["loras"][0]))})

    api = api_mod.CtrLoRA(num_loras=2, lora_rank=128, device=dev)
    load_s, n_checked = create_checked(api, paths, written, cfg)
    del written
    shutil.rmtree(outdir, ignore_errors=True)
    log("api_2lora", create_model_s=load_s, loaded_tensors_equal_written=n_checked)

    rng = np.random.default_rng(SEED)
    images = api.prepare_images((rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8),
                                 rng.integers(0, 256, (SIZE + 64, SIZE, 3), dtype=np.uint8)))
    if any(img.shape != (SIZE, SIZE, 3) for img in images):
        raise AssertionError(f"centre crop gave {[img.shape for img in images]}")
    run = lambda steps, timings=None: api._sample_images(
        images, PROMPT, N_PROMPT, BATCH, steps, 7.5, LORA_WEIGHTS, SEED, timings=timings)
    launches, outs = {}, {}
    for setting, flags, required in (("default", {}, API_KERNELS),
                                     ("flagged", FLAGS, API_FLAGGED_KERNELS)):
        with kernel_flags.override(**flags):
            t0 = time.perf_counter()
            run(2)  # warm-up
            warm = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(dev)
            with counted(f"api_2lora {setting}", required) as launches[setting]:
                timings = {}
                t0 = time.perf_counter()
                outs[setting] = run(STEPS, timings)
                total = time.perf_counter() - t0
        out = outs[setting]
        log("api_2lora", setting=setting, flags=flags, steps=STEPS, batch=BATCH, size=SIZE,
            warmup_s=warm, s_per_batch=total, s_per_step=timings["ddim_s"] / STEPS, **timings,
            launches=launches[setting], peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            image_mean=float(out.mean()), image_std=float(out.std()))
        if out.shape != (BATCH, SIZE, SIZE, 3) or out.dtype != np.uint8:
            raise AssertionError(f"bad images: {out.shape} {out.dtype}")
    stray = {n: launches["default"][n] for n in ("group_norm_onepass", "flash_attention_hpack2")
             if launches["default"][n]}
    if stray:
        raise AssertionError(f"kernels A2/B6 launched under the default flags: {stray}")
    log("api_2lora", mean_abs_uint8_diff_default_vs_flagged=float(
        np.abs(outs["default"].astype(np.int16) - outs["flagged"].astype(np.int16)).mean()))

    # one UNet + two-ControlNet evaluation: flagged kernels vs plain versions
    pipe = api.pipe
    ctx, unc = pipe.encode_text_cond_uncond(api.token_ids(PROMPT, BATCH),
                                            api.token_ids(N_PROMPT, BATCH))
    conds = [dataclasses.replace(c, hint=torch.cat([c.hint, c.hint]))
             for c in api.conditions(images, BATCH, LORA_WEIGHTS)]
    full_ctx = torch.cat([ctx, unc])
    lat = SIZE // 2 ** (len(cfg.vae.ch_mult) - 1)
    x = torch.randn((BATCH, lat, lat, 4), generator=gen, device=dev)
    x2 = torch.cat([x, x])
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)

    def evaluate(cs):
        packed, rows_of = make_emb_row_tables(pipe, cs, ts)
        return pipe.apply_model(x2, tvec, full_ctx, cs, emb_rows=rows_of(packed[0]))

    with kernel_flags.override(**FLAGS):
        out_k = evaluate(conds)
    with plain_versions():
        out_p = evaluate(conds)
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    log("api_2lora", unet_2controlnet_rel_l2_flagged_vs_plain=rel, bound=MODEL_REL_TOL)
    if not math.isfinite(rel) or rel > MODEL_REL_TOL:
        raise AssertionError(f"flagged kernel path departs from the plain path: rel {rel}")
    # the switching is real: all of LoRA 0 against all of LoRA 1
    one, two = (evaluate([dataclasses.replace(c, weight=w) for c, w in zip(conds, ws)])
                for ws in ((1.0, 0.0), (0.0, 1.0)))
    swap = ((one - two).norm() / one.norm()).item()
    log("api_2lora", rel_l2_lora_weights_10_vs_01=swap)
    if not swap > 1e-3:
        raise AssertionError(f"lora_weights (1, 0) and (0, 1) give the same output: {swap}")
    return launches


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.cuda_lib()
    spills = [ln.strip() for ln in _build.ptxas_report().splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    log("build", cuda_library_s=time.perf_counter() - t0, nvcc_flags=" ".join(_build.NVCC_FLAGS),
        ptxas_spills=spills, note="Triton kernels compile at their first launch (phase 3)")
    # kernel C's and B4/B5's instantiations run on wgmma (HGMMA) and nothing
    # older (HMMA); B4/B5 spill nothing and tile as flash_bwd_plan says
    for what, name in (("geglu", "geglu"), ("flash_bwd", "flash_bwd")):
        sass = _build.sass_opcodes(("HGMMA", "HMMA"), name)
        log("build", **{f"{what}_sass": sass})
        if not sass or any(n["HGMMA"] == 0 or n["HMMA"] for n in sass.values()):
            raise AssertionError(f"{what} kernels without HGMMA or with HMMA: {sass}")
    bwd_spills = _build.spilling_kernels("flash_bwd")
    # ptxas serialises a kernel's wgmmas (every note logged) when, among other
    # causes, a plain instruction touches an accumulator inside a batch
    # (C7514/C7515): B4/B5 must have none of those
    serialized = _build.serialized_kernels()
    log("build", wgmma_serialized=serialized)
    touched = {n: c for n, c in serialized.items()
               if "flash_bwd" in n and {"C7514", "C7515"} & set(c)}
    if touched:
        raise AssertionError(f"B4/B5 wgmmas serialised by accumulator accesses: {touched}")
    configs_c = {}
    for d in fa_ops.BWD_HEAD_DIMS:
        for dkv in (True, False):
            out = (ctypes.c_int * 5)()
            _build.check(_build.cuda_lib().ctrlora_flash_bwd_config(d, int(dkv), out),
                         "ctrlora_flash_bwd_config")
            plan = fa_ops.flash_bwd_plan(d, dkv)
            configs_c[f"{'dkv' if dkv else 'dq'} D={d}"] = got = list(out)
            if got != [plan.rows, plan.tile, plan.stages, plan.smem_bytes, int(plan.split)]:
                raise AssertionError(f"flash_bwd_plan({d}, {dkv}) = {plan}, the kernel: {got}")
    log("build", flash_bwd_config=configs_c, flash_bwd_spills=bwd_spills)
    if bwd_spills:
        raise AssertionError(f"B4/B5 spill registers: {bwd_spills}")

    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    results = kernel_checks(dev, cfg)
    profile_steps = int(argv[argv.index("--profile") + 1]) if "--profile" in argv else 0
    sampling, _, _ = slice_run(dev, cfg, profile_steps)
    tiny_gpu_vs_cpu(dev)
    tiny_api_gpu_vs_cpu(dev)
    training, _ = train_slice(dev, profile=bool(profile_steps))
    tiny_train_gpu_vs_cpu(dev)
    api_runs = api_slice(dev)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        by_path = {"sampling": sampling[name], "training": training[name],
                   "api_2lora": sum(r[name] for r in api_runs.values())}
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        **results[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
