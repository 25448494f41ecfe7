#!/usr/bin/env python3
"""Drive the PyTorch port's two paths once on one NVIDIA GPU: controlled
sampling and the rank-128 LoRA finetune step.

    python3 chip_smoke.py

Phases, each printing its results on its own line; any failure raises and
the script exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ctrlora_tpu_torch/csrc (nvcc, sm_90a);
3. each hand-written kernel against its plain PyTorch version at the two
   paths' shapes, in bf16: max error (relative L2 for gradients) and
   median time of both;
4. the sampling slice at SD1.5 width: ctrlora_inference_config(1, 128) with
   seeded random weights, one rank-128 LoRA fused, bf16; 4 prompts of 77
   token ids, a 512x512 hint, DDIM at CFG 7.5 and eta 0, decode; counts the
   kernel launches of that run and compares one UNet+ControlNet evaluation
   with the kernels against the same evaluation with the plain versions;
5. the tiny test configuration sampled on the GPU against the same run on
   the CPU;
6. the training slice at SD1.5 width: ctrlora_finetune_config(128) with
   seeded random weights (bf16 compute over fp32 parameters, rematerialised
   blocks), Trainer(trainable='lora') on seeded synthetic 512x512 batches of
   4: 2 warm-up and 5 timed AdamW steps, the launch counts of the timed
   steps, frozen weights bit-identical, trainable ones changed; then one
   step's loss and trainable gradients with the kernels against the plain
   versions, with the same t, noise and posterior draws;
7. one tiny training step (fp32) on the GPU against the CPU.

The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import torch
from torch import nn

from ctrlora_tpu_torch import configs, lora_fuse
from ctrlora_tpu_torch.models.layers import GroupNorm32, LayerNorm32
from ctrlora_tpu_torch.models.unet import decoder_plan, encoder_plan
from ctrlora_tpu_torch.ops import _build
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import geglu_ffn as geglu_ops
from ctrlora_tpu_torch.ops import group_norm as gn_ops
from ctrlora_tpu_torch.ops import unpack_rows as unpack_ops
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.common import make_emb_row_tables
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.training import train_state
from ctrlora_tpu_torch.training.step import loss_for_batch
from ctrlora_tpu_torch.training.trainer import Trainer

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

KERNELS = {  # wrapper -> (route, source, TPU kernel it replaces)
    "group_norm": ("triton", "ctrlora_tpu_torch/ops/group_norm.py",
                   "ctrlora_tpu/ops/group_norm.py:30 _stats_kernel + :47 _apply_kernel"),
    "flash_attention_qkv": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention.cu",
                            "ctrlora_tpu/ops/flash_attention.py:304 _fwd_kernel_packed_qkv"),
    "flash_attention": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention.cu",
                        "ctrlora_tpu/ops/flash_attention.py:58 _fwd_kernel"),
    "flash_attention_bshd": ("cuda", "ctrlora_tpu_torch/csrc/flash_attention.cu",
                             "ctrlora_tpu/ops/flash_attention.py:138 _fwd_kernel_packed"),
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
    return {"group_norm": gn_ops.group_norm, "flash_attention_qkv": fa_ops.flash_attention_qkv,
            "flash_attention": fa_ops.flash_attention,
            "flash_attention_bshd": fa_ops.flash_attention_bshd,
            "flash_attention_bwd_dq": fa_ops.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa_ops.flash_attention_bwd_dkv,
            "geglu_ffn": geglu_ops.geglu_ffn, "unpack_rows": unpack_ops.unpack_rows}


# the kernels each path must launch
SAMPLING_KERNELS = ("group_norm", "flash_attention_qkv", "flash_attention", "geglu_ffn",
                    "unpack_rows")
TRAINING_KERNELS = ("group_norm", "flash_attention_qkv", "flash_attention",
                    "flash_attention_bshd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                    "geglu_ffn")


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
                (fa_ops, "flash_attention_qkv", fa_ops.flash_attention_qkv_plain),
                (fa_ops, "flash_attention", fa_ops.attention_plain),
                (fa_ops, "flash_attention_bshd", fa_ops.flash_attention_bshd_plain),
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


def kernel_checks(dev, cfg):
    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *s, dt=torch.bfloat16, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    results = {}

    def record(name, label, got, want, fn_k, fn_p, extra=None):
        err = compare(got, want)
        if extra is not None:
            err = max(err, compare(*extra))
        ms, pms = time_ms(fn_k), time_ms(fn_p)
        log("kernels", kernel=name, shape=label, max_abs_err=err, ms=ms, plain_ms=pms)
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("ms", ms)  # the first shape listed is the dominant one
        r.setdefault("plain_ms", pms)

    def record_grad(name, label, got, want, fn_k, fn_p):
        """Gradients: relative L2 per output <= GRAD_REL_TOL, finite."""
        rels, err = [], 0.0
        for g_, w_ in zip(got, want):
            g_, w_ = g_.float(), w_.float()
            if not torch.isfinite(g_).all():
                raise AssertionError(f"{name} {label}: gradient is not finite")
            rels.append(((g_ - w_).norm() / w_.norm()).item())
            err = max(err, (g_ - w_).abs().max().item())
        if max(rels) > GRAD_REL_TOL:
            raise AssertionError(f"{name} {label}: relative L2 {rels} > {GRAD_REL_TOL}")
        ms, pms = time_ms(fn_k), time_ms(fn_p)
        log("kernels", kernel=name, shape=label, rel_l2=rels, max_abs_err=err, ms=ms,
            plain_ms=pms, bound=GRAD_REL_TOL)
        r = results.setdefault(name, {"max_abs_err": 0.0, "rel_l2": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["rel_l2"] = max(r["rel_l2"], max(rels))
        r.setdefault("ms", ms)
        r.setdefault("plain_ms", pms)

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
               lambda: gn_ops.group_norm(*args), lambda: gn_ops.group_norm_plain(*args))

    for s, h, d in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        qkv = rn(8, s, 3 * h * d)
        out, lse = fa_ops.flash_attention_qkv(qkv, h, d)
        pout, plse = fa_ops.flash_attention_qkv_plain(qkv, h, d)
        record("flash_attention_qkv", f"[8, {s}, 3*{h}*{d}]", out, pout,
               lambda: fa_ops.flash_attention_qkv(qkv, h, d),
               lambda: fa_ops.flash_attention_qkv_plain(qkv, h, d), extra=(lse, plse))

    q, k, v = (rn(4, 1, 4096, 512) for _ in range(3))
    out, lse = fa_ops.flash_attention(q, k, v)
    pout, plse = fa_ops.attention_plain(q, k, v)
    record("flash_attention", "[4, 1, 4096, 512]", out, pout,
           lambda: fa_ops.flash_attention(q, k, v), lambda: fa_ops.attention_plain(q, k, v),
           extra=(lse, plse))

    # B2: the LoRA control branch's self-attention, q, k, v [B, S, H, D]
    for s, h, d in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        q, k, v = (rn(4, s, h, d) for _ in range(3))
        out, lse = fa_ops.flash_attention_bshd(q, k, v)
        pout, plse = fa_ops.flash_attention_bshd_plain(q, k, v)
        record("flash_attention_bshd", f"[4, {s}, {h}, {d}]", out, pout,
               lambda: fa_ops.flash_attention_bshd(q, k, v),
               lambda: fa_ops.flash_attention_bshd_plain(q, k, v), extra=(lse, plse))

    # B4/B5: the backward at [B*H = 32, S, D], BHSD; then the BSHD and
    # fused-qkv layouts (strided views) at the dominant shape
    def bwd_case(label, q, k, v, dout):
        out, lse = fa_ops.flash_attention(q, k, v)  # [4, 8, S, D] views in, contiguous out
        delta = (out.float() * dout.float()).sum(-1)
        sc = q.shape[-1] ** -0.5
        args = (q, k, v, lse, dout, delta, sc)
        dq = fa_ops.flash_attention_bwd_dq(*args)
        dk, dv = fa_ops.flash_attention_bwd_dkv(*args)
        pdq = fa_ops.flash_attention_bwd_dq_plain(*args)
        pdk, pdv = fa_ops.flash_attention_bwd_dkv_plain(*args)
        record_grad("flash_attention_bwd_dq", label, [dq], [pdq],
                    lambda: fa_ops.flash_attention_bwd_dq(*args),
                    lambda: fa_ops.flash_attention_bwd_dq_plain(*args))
        record_grad("flash_attention_bwd_dkv", label, [dk, dv], [pdk, pdv],
                    lambda: fa_ops.flash_attention_bwd_dkv(*args),
                    lambda: fa_ops.flash_attention_bwd_dkv_plain(*args))

    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        bwd_case(f"bhsd [4, 8, {s}, {d}]", *(rn(4, 8, s, d) for _ in range(4)))
    s, h, d = 4096, 8, 40
    bshd = [rn(4, s, h, d).transpose(1, 2) for _ in range(4)]
    bwd_case(f"bshd [4, {s}, {h}, {d}]", *bshd)
    qkv = rn(4, s, 3 * h * d)
    views = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
    bwd_case(f"qkv [4, {s}, 3*{h}*{d}]", *views, rn(4, s, h, d).transpose(1, 2))

    for rows, c in ((8 * 4096, 320), (8 * 1024, 640), (8 * 256, 1280), (8 * 64, 1280)):
        f = 4 * c
        args = (rn(8, rows // 8, c), rn(2 * f, c, std=c ** -0.5), rn(2 * f, std=0.1),
                rn(c, f, std=f ** -0.5), rn(c, std=0.1))
        record("geglu_ffn", f"rows={rows} C={c} F={f}", geglu_ops.geglu_ffn(*args),
               geglu_ops.geglu_ffn_plain(*args), lambda: geglu_ops.geglu_ffn(*args),
               lambda: geglu_ops.geglu_ffn_plain(*args))

    sizes = emb_row_sizes(cfg)
    block = rn(len(sizes), max(sizes))
    rows = unpack_ops.unpack_rows(block, sizes)
    prows = unpack_ops.unpack_rows_plain(block, sizes)
    for a, b in zip(rows, prows):
        if not torch.equal(a, b):
            raise AssertionError("unpack_rows differs from its plain version")
    record("unpack_rows", f"[{len(sizes)}, {max(sizes)}]", torch.cat(rows, 1),
           torch.cat(prows, 1), lambda: unpack_ops.unpack_rows(block, sizes),
           lambda: unpack_ops.unpack_rows_plain(block, sizes))
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


def slice_run(dev, cfg):
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

    # one UNet+ControlNet evaluation: kernels vs plain versions
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    hz = pipe.encode_first_stage(hint)
    full_ctx = torch.cat([ctx, unc])
    conds = [Conditioning(torch.cat([hz, hz]))]
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)
    x2 = torch.cat([x_T, x_T])

    def evaluate():
        packed, rows_of = make_emb_row_tables(pipe, 1, ts)
        return pipe.apply_model(x2, tvec, full_ctx, conds, emb_rows=rows_of(packed[0]))

    out_k = evaluate()
    with plain_versions():
        out_p = evaluate()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    log("slice", unet_controlnet_rel_l2_kernels_vs_plain=rel,
        max_abs=(out_k - out_p).abs().max().item(), bound=MODEL_REL_TOL)
    if not math.isfinite(rel) or rel > MODEL_REL_TOL:
        raise AssertionError(f"kernel path departs from the plain path: rel {rel}")
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


def train_slice(dev):
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


def main() -> int:
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

    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    results = kernel_checks(dev, cfg)
    sampling, _, _ = slice_run(dev, cfg)
    tiny_gpu_vs_cpu(dev)
    training, _ = train_slice(dev)
    tiny_train_gpu_vs_cpu(dev)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": sampling[name] + training[name],
                        "launches_by_path": {"sampling": sampling[name],
                                             "training": training[name]},
                        **results[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
