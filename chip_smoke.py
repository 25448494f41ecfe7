#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: controlled
sampling, the sampler family (DDIM with eta, guess mode, ucg schedule and
mask; PLMS; DPM-Solver; img2img; DDIM inversion; the sample CLI's batch),
the rank-128 LoRA finetune step, the switchable two-LoRA CtrLoRA API from
reference-format checkpoints, the finetune and pretrain CLIs training
from dataset files, the ControlNet baselines (vanilla image-hint
ControlNet and ControlNet-Lite) sampling and training through train_cn,
ControlNet-XS sampling from configs/cnxs_sd15.yaml and training
through train_cn --variant xs, and style transfer with IP-Adapter
(StyleCtrLoRA) from the style config file.

    python3 chip_smoke.py

Phases, each printing its results on its own line; any failure raises and
the script exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ctrlora_tpu_torch/csrc (nvcc, sm_90a) and
   gate them: C, B6 and B4/B5 on wgmma (HGMMA, no HMMA in the SASS), B6
   and B4/B5 without spills or wgmma serialised by accumulator accesses,
   A (and A2, the same kernel) and D without spills, the tilings of A, A2,
   B6 and B4/B5 as their Python mirrors (group_norm_plan,
   group_norm_onepass_plan, hpack2_plan, flash_bwd_plan) say, with the
   waves A2's plan makes, and D's layout capacity as UNPACK_MAX_ROWS;
3. each hand-written kernel against its plain PyTorch version at the
   paths' shapes (ControlNet-XS's control stream's among them: A at
   64-1536 channels, B's fused-qkv entry and B4/B5 at D = 8/16/32, C at
   C = 64/128/256), in bf16 (A and A2 also in fp32): max error (relative L2
   for gradients) and median time of both (for A2 and B6 also of the
   kernel each stands beside: A, and B's BSHD and fused-qkv entries; for C
   also its two launches alone, up_ms and down_ms; for A, A2, B6, B4/B5
   and D also the time per call of 20 calls queued back to back, b2b_ms,
   beside the library call's, and two launches bit-equal (D: equal to its
   plain version); for A and A2 one device kernel per call, counted by
   torch.profiler; for C and D the wrapper's host time per call);
4. the sampling slice at SD1.5 width: ctrlora_inference_config(1, 128) with
   seeded random weights, one rank-128 LoRA fused, bf16; 4 prompts of 77
   token ids, a 512x512 hint, DDIM at CFG 7.5 and eta 0, decode; counts the
   kernel launches of that run and compares one UNet+ControlNet evaluation
   with the kernels against the same evaluation with the plain versions;
   then one fp32 copy of the VAE decodes a 64x64 latent through the plain
   attention (the dispatch rules admit bf16 only) within relative L2 5e-2
   of the bf16 VAE's decode, which launches the kernel;
9. (run right after phase 4, on its pipeline) the sampler family at SD1.5
   width: batch 4, 512^2, CFG 7.5, 20 steps (the API's default), each run
   timed (prep, sampler, decode) with its model evaluations, kernel
   launches per evaluation and the calls in the sampler that made the host
   wait for the card (sync debug mode), its image finite and [4, 512, 512,
   3]: DDIM at eta 0.5 twice (the same seed gives the same bits) and at
   eta 0 (they differ, relative L2 > 1e-3); DDIM in guess mode with the gradio app's
   decayed scales, against the same scales without guess mode (they
   differ); DDIM with a ucg_schedule; DDIM with a half-image mask and x0
   the hint's latent; PLMS; DPM-Solver++ multistep order 2 with dynamic
   thresholding; DPM-Solver multistep order 3; DPM-Solver++ singlestep
   order 3; img2img (ddim_stochastic_encode to step 10, ddim_decode_from);
   ddim_encode for 10 rungs and back. Then one UNet+ControlNet evaluation
   in guess mode (control_batch_mask, decayed scales) with the kernels
   against the plain versions (relative L2 <= 5e-2); then the sample CLI's
   per-batch function (sample_batch) through its loader on
   reference-format files (SD and Base ControlNet in fp16, one rank-128
   LoRA, from a seeded ctrlora_finetune_config(128) model), DPM-Solver at
   20 steps on 4 items; the files are deleted at the end;
5. the tiny test configuration sampled on the GPU against the same run on
   the CPU; then every run of phase 9's sampler family on the tiny
   configuration (batch 2, 6 steps), GPU against CPU with the noise passed
   in; then the tiny two-LoRA API path from tiny reference-format files,
   GPU against CPU (all within rtol 2e-3 / atol 2e-4);
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
   differ. The files are deleted at the end;
10. the training CLIs at SD1.5 width from reference-format files (SD and
   Base ControlNet in fp16 from a seeded ctrlora_finetune_config(128)
   model) and PNG datasets of random pixels, with CTRLORA_NATIVE_DATA=1
   (the C++ image prep, built with g++): (a) the finetune CLI's main on 16
   pairs at 512^2, 640x480 and 480x640, batch 4 at 512^2, 2 warm-up and 6
   timed steps with --use_ema, a checkpoint and the image log at the last
   step: load s, the loader's wait, s/step beside phase 6's, the
   launches a step, peak memory, the hook's s; frozen weights
   bit-identical, every trainable one changed, the EMA shadow behind the
   live weights and swapped in and out bit for bit, the image log's PNG
   [48 + 3*512, 1024, 3] with finite rows; then --resume for 2 more steps
   (the step count and the loader go on from step 8) and a
   --cache_latents run of 8 steps (the pre-pass's s and images/s, cached
   s/step); (b) the pretrain CLI's main with ctrlora_pretrain_config's nine
   LoRA banks from the same files, MultiGen-20M over the nine tasks (4
   items each, non-square both ways), batch 4, 2 warm-up and 9 timed
   steps: trainable parameters, s/step, peak memory, the task of each
   step; losses finite, after step 1 only that step's bank of each
   lora_up non-zero, the UNet bit-identical. The files are deleted at the
   end;
11. the ControlNet baselines at SD1.5 width, seeded random weights (zero-init
   layers too): (a) sd15_config (cldm_v15: image-hint ControlNet with its
   HintBlock) and (b) cnlite_config (ControlNet-Lite, encoder-side taps),
   each cast for inference, batch 4, 512^2, a seeded pixel hint in [0, 1],
   token ids of ones against uncond zeros, 50 DDIM steps at CFG 7.5, eta 0:
   s/batch with the prep / DDIM / decode split, launches per evaluation
   by kernel (Lite: no row unpack), the HintBlock's ms a step (20 calls
   queued back to back; beside it torch.profiler's device ms and per-call
   events), finite [4, 512, 512, 3] images, one
   UNet+control evaluation with the kernels within relative L2 5e-2 of
   the plain versions; (c) train_cn.main --variant controlnet on 16 PNG
   pairs (phase 10's writer) from an fp16 SD file of seeded weights (a
   fresh UNet outputs 0) and an fp16 reference-format control file
   with input_hint_block.* keys, --bs 2 --gradacc 2, --use_ema, 2 warm-up
   and 4 timed steps, a checkpoint and the image log at the last step:
   s/step, peak memory, launches a step by kernel; loaded tensors equal
   to the file's, finite loss and grad_norm > 0, the frozen UNet
   bit-identical, every control weight changed, one step's loss and
   gradients with the kernels within 1e-2 / L2 5e-2 of plain; (d) the same
   for --variant lite at --bs 4, its branch from the seeded init (its unused
   time_embed alone stays as it was); (e) each baseline's tiny
   configuration: one evaluation and one train step, fp32, GPU against
   CPU within rtol 2e-3 / atol 2e-4 (and ControlNet-XS's at control ratio
   0.5). The files are deleted at the end;
12. ControlNet-XS at SD1.5 width, its config read from
   configs/cnxs_sd15.yaml by the port's YAML reader: (a) seeded random
   weights, the base stream (and VAE, CLIP) written as an fp16 SD-format
   file and loaded back through the SD loader (every loaded tensor equal
   to the file's), cast for inference, batch 4, 512^2, a pixel hint in
   [0, 1], ids of ones against zeros, 50 DDIM steps at CFG 7.5: s/batch
   with the prep / DDIM / decode split beside phase 4's, launches per
   evaluation by kernel and by the width each launch ran at (A, B's
   fused-qkv entry and C must run at the control stream's widths: D =
   8/16/32, C = 64/128/256 and the GroupNorms at 64-1536 channels; D not
   at all), finite [4, 512, 512, 3] images, one XS evaluation with the
   kernels within relative L2 5e-2 of the plain versions; (b)
   train_cn.main --variant xs --config configs/cnxs_sd15.yaml from that SD
   file and an fp16 XS control file (TwoStreamControlNet's keys) on phase
   10's PNG pairs, --bs 4, --use_ema, 2 warm-up and 4 timed steps, a
   checkpoint and the image log at the last step: s/step beside phase
   6's, peak memory, launches a step by kernel and by width (B4/B5 at D =
   8/16/32 too); loaded tensors equal to the files', the frozen base
   stream bit-identical, every trainable weight changed, one step's loss
   and gradients with the kernels within 1e-2 / L2 5e-2 of plain. The
   files are deleted at the end;
13. style transfer at SD1.5 width, its config read from
   configs/inference/ctrlora_style_sd15_rank128_1lora.yaml (equal to
   style.style_config(1, 128, 4): 4 image-prompt tokens at every attn2
   of the UNet): seeded random weights written as fp16 files (SD, Base
   ControlNet, one rank-128 LoRA; the IP-Adapter file in its published
   nested form, 16 sites x to_{k,v}_ip and the image projection; the HF
   ViT-H/14 vision tower; the HF ViT-H text tower with its projection);
   StyleCtrLoRA(1).create_model and load_ip_adapter(target='style_blocks'):
   every loaded tensor equal to the files' (the UNet's image-prompt
   projections as their bf16 parameters hold them), ip_scale 1 at the
   out_3/4/5 sites and 0 at the other 13; reloaded on every site;
   embed_style of a 640x480 image and embed_neg_content (ms, [1, 4, 768],
   finite, the negative content moving the tokens); sample_with_style's
   sampling call on a 512^2 condition image, batch 4, 50 DDIM steps at CFG
   7.5 (s/batch with the prep / DDIM / decode split beside phase 4's,
   launches, peak memory, finite [4, 512, 512, 3] images) and img2img at
   strength 0.8 over 20 steps; one UNet + ControlNet evaluation with the
   image tokens: its launches by kernel, the kernels within relative L2
   5e-2 of the plain versions, other style tokens and image_proj(zeros)
   against the cond tokens in the uncond half each moving the output
   (> 1e-3), the image-prompt branch's device ms and kernels a step (its
   calls replayed under torch.profiler, and back to back); ip_scale 0 at
   every site within relative L2 5e-2 of a UNet
   without image tokens on the text alone; then a tiny style
   configuration on the GPU against the CPU (rtol 2e-3 / atol 2e-4). The
   files are deleted at the end.

The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.

Phase 3 holds each kernel against yardsticks as well: bound_ms, the least
time the card could take for the same work (the larger of its flops at the
H100's 989 TFLOP/s bf16 and its bytes, each input read once and each output
written once, at 3.35 TB/s; bound_by says which), pct_of_bound, and
library_ms, the time of one PyTorch call that computes the same function
(F.scaled_dot_product_attention for the flash forwards, its autograd
backward for dQ and dK/dV together, F.group_norm where there is no row or
SiLU, torch.take with a cached flat index for the row unpack; null where no
call does: GEGLU). The port never calls these.

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
import warnings
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch import api as api_mod
from ctrlora_tpu_torch import configs, lora_fuse
from ctrlora_tpu_torch import style as style_mod
from ctrlora_tpu_torch.models import ip_adapter
from ctrlora_tpu_torch.models.attention import CrossAttention
from ctrlora_tpu_torch.models.clip import CLIPTextModel
from ctrlora_tpu_torch.models.layers import GroupNorm32, LayerNorm32, to_channels_last
from ctrlora_tpu_torch.models.unet import UNet, decoder_plan, encoder_plan
from ctrlora_tpu_torch.models.vae import AutoencoderKL
from ctrlora_tpu_torch.ops import _build
from ctrlora_tpu_torch.ops import flash_attention as fa_ops
from ctrlora_tpu_torch.ops import geglu_ffn as geglu_ops
from ctrlora_tpu_torch.ops import group_norm as gn_ops
from ctrlora_tpu_torch.ops import kernel_flags
from ctrlora_tpu_torch.ops import unpack_rows as unpack_ops
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline, build_control
from ctrlora_tpu_torch.sampling.common import make_emb_row_tables, make_guided_eps_fn
from ctrlora_tpu_torch.sampling.ddim import (
    DDIMConfig, ddim_decode_from, ddim_encode, ddim_sample, ddim_stochastic_encode,
)
from ctrlora_tpu_torch.sampling.dpm_solver import (
    dpm_solver_sample, dpm_solver_singlestep_sample,
)
from ctrlora_tpu_torch.sampling.plms import plms_sample
from ctrlora_tpu_torch.data import native as native_data
from ctrlora_tpu_torch.scripts import sample as sample_cli
from ctrlora_tpu_torch.scripts import train_cn as train_cn_mod
from ctrlora_tpu_torch.scripts import train_common
from ctrlora_tpu_torch.scripts import train_ctrlora_finetune as finetune_cli_mod
from ctrlora_tpu_torch.scripts import train_ctrlora_pretrain as pretrain_cli_mod
from ctrlora_tpu_torch.training import train_state
from ctrlora_tpu_torch.training import trainer as trainer_mod
from ctrlora_tpu_torch.training.step import loss_for_batch
from ctrlora_tpu_torch.training.trainer import Trainer
from ctrlora_tpu_torch.utils import ckpt_torch
from ctrlora_tpu_torch.utils.image import png_writer, write_png
from ctrlora_tpu_torch.utils.loading import check_key, load_ctrlora

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
    "group_norm": ("cuda", "ctrlora_tpu_torch/csrc/group_norm.cu",
                   "ctrlora_tpu/ops/group_norm.py:30 _stats_kernel + :47 _apply_kernel"),
    "group_norm_onepass": ("cuda", "ctrlora_tpu_torch/csrc/group_norm.cu",
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
    "unpack_rows": ("cuda", "ctrlora_tpu_torch/csrc/unpack_rows.cu",
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


# kernel A's rows in phase 3: (shape, dtype, eps, SiLU, add_row): the
# sampling path's sites at the CFG batch of 8 (the ResBlocks' out_norm with
# its row and SiLU, a transformer norm without either), the decoder's
# in_norms over the concatenated skips, the finetune step's batch of 4, and
# the VAE at 512^2 in bf16 and fp32 (phase 4's fp32 decode); the build phase
# holds the kernel's plan against group_norm_plan at each
GN_CASES = (
    ((8, 64, 64, 320), torch.bfloat16, 1e-5, True, True),
    ((8, 32, 32, 640), torch.bfloat16, 1e-5, True, True),
    ((8, 16, 16, 1280), torch.bfloat16, 1e-5, True, True),
    ((8, 8, 8, 1280), torch.bfloat16, 1e-5, True, True),
    ((8, 64, 64, 320), torch.bfloat16, 1e-6, False, False),
    ((8, 64, 64, 640), torch.bfloat16, 1e-5, True, False),
    ((8, 64, 64, 960), torch.bfloat16, 1e-5, True, False),
    ((8, 32, 32, 1920), torch.bfloat16, 1e-5, True, False),
    ((8, 16, 16, 2560), torch.bfloat16, 1e-5, True, False),
    ((4, 64, 64, 320), torch.bfloat16, 1e-5, True, True),
    ((4, 32, 32, 640), torch.bfloat16, 1e-5, True, True),
    ((4, 16, 16, 1280), torch.bfloat16, 1e-5, True, True),
    ((4, 8, 8, 1280), torch.bfloat16, 1e-5, True, True),
    ((4, 512, 512, 128), torch.bfloat16, 1e-6, True, False),
    ((4, 64, 64, 512), torch.bfloat16, 1e-6, False, False),
    ((4, 512, 512, 128), torch.float32, 1e-6, True, False),
) + (
    # ControlNet-XS's control stream at the CFG batch of 8: its ResBlocks'
    # out_norms (row, SiLU) at 64/128/256 channels, the in_norms over the
    # `cat` infusion's 64 + 320, 128 + 640 and 256 + 1280 channels, a
    # transformer norm; and the training batch of 4 at 64^2
    ((8, 64, 64, 64), torch.bfloat16, 1e-5, True, True),
    ((8, 64, 64, 384), torch.bfloat16, 1e-5, True, False),
    ((8, 64, 64, 64), torch.bfloat16, 1e-6, False, False),
    ((8, 32, 32, 128), torch.bfloat16, 1e-5, True, True),
    ((8, 32, 32, 384), torch.bfloat16, 1e-5, True, False),
    ((8, 32, 32, 768), torch.bfloat16, 1e-5, True, False),
    ((8, 16, 16, 256), torch.bfloat16, 1e-5, True, True),
    ((8, 16, 16, 1536), torch.bfloat16, 1e-5, True, False),
    ((8, 8, 8, 256), torch.bfloat16, 1e-5, True, True),
    ((8, 8, 8, 1536), torch.bfloat16, 1e-5, True, False),
    ((4, 64, 64, 64), torch.bfloat16, 1e-5, True, True),
    ((4, 64, 64, 384), torch.bfloat16, 1e-5, True, False),
)
# ControlNet-XS's self-attention sites: (S, heads, D) at 64^2, 32^2, 16^2
XS_ATTN_SITES = ((4096, 8, 8), (1024, 8, 16), (256, 8, 32))
# ... and its GEGLU sites: (rows, C) at the CFG batch of 8 (the 8^2 mid block
# too) and the training batch of 4 at 64^2
XS_GEGLU_SITES = ((8 * 4096, 64), (8 * 1024, 128), (8 * 256, 256), (8 * 64, 256),
                  (4 * 4096, 64))
# kernel A2's [HW, C] samples (batch 8 in phase 3): the five sampling-path
# shapes gn1=1 admits in bf16, and the two of them it admits in fp32
ONEPASS_SHAPES = ((64 * 64, 320), (32 * 32, 640), (32 * 32, 960), (32 * 32, 1280),
                  (16 * 16, 2560))
ONEPASS_FP32_SHAPES = ((32 * 32, 640), (16 * 16, 2560))
# kernel B6's rows: (label, B, S, H, D, as views of the fused projection)
HPACK2_CASES = (("[8, 4096, 8, 40]", 8, 4096, 8, 40, False),
                ("views of [8, 4096, 3*8*40]", 8, 4096, 8, 40, True),
                ("[8, 1024, 8, 64]", 8, 1024, 8, 64, False))


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


def counts_now():
    return {n: w.launches for n, w in wrappers().items()}


def counts_since(before):
    """Each kernel's launches since `before` (a ``counts_now()``)."""
    return {n: w.launches - before[n] for n, w in wrappers().items()}


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


def device_kernels(fn) -> int:
    """Device kernels that fn() launches, counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def kernel_checks(dev, cfg):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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

    # A: one launch per call (one device kernel in a profiler window over a
    # call at each shape), the same bits from two launches, and each row
    # against its plain version with its back-to-back time beside the
    # library call's
    gn_args = []
    for shape, dt, eps, silu, row in GN_CASES:
        c = shape[-1]
        x = rn(*shape, std=2.0, dt=dt) + 0.5
        sc, bi = rn(c, dt=torch.float32, std=0.1) + 1, rn(c, dt=torch.float32, std=0.1)
        gn_args.append((x, sc, bi, 32, eps, silu, rn(1, c, std=0.5, dt=dt) if row else None))
    kernels_per_call = device_kernels(lambda: [gn_ops.group_norm(*a) for a in gn_args]) \
        / len(gn_args)
    if kernels_per_call != 1:
        raise AssertionError(f"group_norm: {kernels_per_call} device kernels per call, not 1")
    for (shape, dt, eps, silu, row), args in zip(GN_CASES, gn_args):
        x, sc, bi = args[:3]
        y = gn_ops.group_norm(*args)
        if not torch.equal(y, gn_ops.group_norm(*args)):
            raise AssertionError(f"group_norm {list(shape)}: two launches differ")
        library = None if silu or row else group_norm_library(x, sc, bi, eps)
        fn = lambda: gn_ops.group_norm(*args)
        record("group_norm", f"{list(shape)} {str(dt)[6:]} eps={eps} silu={silu} add_row={row}",
               y, gn_ops.group_norm_plain(*args), fn, lambda: gn_ops.group_norm_plain(*args),
               gn_ops.group_norm_work(shape[0], shape[1] * shape[2], shape[-1], x.element_size(),
                                      1 if row else 0),
               library=library, b2b_ms=time_b2b(fn), bit_equal_runs=True,
               device_kernels_per_call=kernels_per_call,
               library_b2b_ms=time_b2b(library[1]) if library else None,
               plan=dataclasses.asdict(gn_ops.group_norm_plan(
                   shape[0], shape[1] * shape[2], shape[-1], 32, x.element_size(), sms)))
        del y
    del gn_args, x, sc, bi, args

    # A2: the one-pass GroupNorm at the five shapes gn1=1 admits on the
    # sampling path (the last: the UNet decoder's 16x16 in_norms over the
    # concatenated skip), with and without row and SiLU, and at two fp32
    # shapes gn1=1 admits; one device kernel a call, the same bits from two
    # launches, its back-to-back time beside kernel A's and (no row, no
    # SiLU) the library call's at the same inputs
    a2_args = []
    for (hw, c), dt in [(s_, torch.bfloat16) for s_ in ONEPASS_SHAPES] + \
            [(s_, torch.float32) for s_ in ONEPASS_FP32_SHAPES]:
        side = math.isqrt(hw)
        x = rn(8, side, side, c, std=2.0, dt=dt) + 0.5
        sc, bi = rn(c, dt=torch.float32, std=0.1) + 1, rn(c, dt=torch.float32, std=0.1)
        rows_ = ((True, rn(1, c, std=0.5, dt=dt)), (False, None),
                 (True, rn(8, c, std=0.5, dt=torch.float32)))
        a2_args += [(x, sc, bi, 32, 1e-5, silu, row) for silu, row in
                    (rows_ if dt == torch.bfloat16 else rows_[:2])]
    kernels_per_call = device_kernels(lambda: [gn_ops.group_norm_onepass(*a) for a in a2_args]) \
        / len(a2_args)
    if kernels_per_call != 1:
        raise AssertionError(f"group_norm_onepass: {kernels_per_call} device kernels per call")
    for args in a2_args:
        x, sc, bi, _, _, silu, row = args
        b, c = x.shape[0], x.shape[-1]
        y = gn_ops.group_norm_onepass(*args)
        if not torch.equal(y, gn_ops.group_norm_onepass(*args)):
            raise AssertionError(f"group_norm_onepass {list(x.shape)}: two launches differ")
        library = None if silu or row is not None else group_norm_library(x, sc, bi, 1e-5)
        fn = lambda: gn_ops.group_norm_onepass(*args)
        record("group_norm_onepass", f"{list(x.shape)} {str(x.dtype)[6:]} silu={silu} add_row="
               f"{None if row is None else [list(row.shape), str(row.dtype)[6:]]}",
               y, gn_ops.group_norm_plain(*args), fn, lambda: gn_ops.group_norm_plain(*args),
               gn_ops.group_norm_work(b, x.shape[1] * x.shape[2], c, x.element_size(),
                                      0 if row is None else row.shape[0]),
               library=library, b2b_ms=time_b2b(fn), bit_equal_runs=True,
               device_kernels_per_call=kernels_per_call,
               library_b2b_ms=time_b2b(library[1]) if library else None,
               kernel_a_ms=time_ms(lambda: gn_ops.group_norm(*args)),
               kernel_a_b2b_ms=time_b2b(lambda: gn_ops.group_norm(*args)),
               plan=dataclasses.asdict(gn_ops.group_norm_onepass_plan(
                   b, x.shape[1] * x.shape[2], c, 32, x.element_size(), sms)))
        del y
    del a2_args, x, sc, bi, args

    # B6: the head-pair forward at the 64x64 sites, contiguous and as split
    # views of the fused projection, and at D = 64; beside B's BSHD and
    # fused-qkv entries, each also back to back, and the same bits twice
    for label, b, s, h, d, fused in HPACK2_CASES:
        qkv = rn(b, s, 3 * h * d)
        views = [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1)]
        ops = views if fused else [t.contiguous() for t in views]
        out, lse = fa_ops.flash_attention_hpack2(*ops)
        again = fa_ops.flash_attention_hpack2(*ops)
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"B6 {label}: two launches differ")
        del again
        pout, plse = fa_ops.flash_attention_hpack2_plain(*ops)
        fn = lambda: fa_ops.flash_attention_hpack2(*ops)
        library = sdpa(*(t.transpose(1, 2) for t in ops))
        beside = ({"qkv_ms": time_ms(lambda: fa_ops.flash_attention_qkv(qkv, h, d)),
                   "qkv_b2b_ms": time_b2b(lambda: fa_ops.flash_attention_qkv(qkv, h, d))}
                  if fused else
                  {"bshd_ms": time_ms(lambda: fa_ops.flash_attention_bshd(*ops)),
                   "bshd_b2b_ms": time_b2b(lambda: fa_ops.flash_attention_bshd(*ops))})
        record("flash_attention_hpack2", label, out, pout, fn,
               lambda: fa_ops.flash_attention_hpack2_plain(*ops),
               fa_ops.flash_forward_work(b, h, s, s, d), library=library, extra=(lse, plse),
               b2b_ms=time_b2b(fn), library_b2b_ms=time_b2b(library[1]), bit_equal_runs=True,
               plan=dataclasses.asdict(fa_ops.hpack2_plan(d)), **beside)
        del out, lse, pout, plse, qkv, views, ops

    for s, h, d in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160)) + XS_ATTN_SITES:
        qkv = rn(8, s, 3 * h * d)
        out, lse = fa_ops.flash_attention_qkv(qkv, h, d)
        pout, plse = fa_ops.flash_attention_qkv_plain(qkv, h, d)
        # the XS sites take a few µs: their back-to-back times, beside SDPA's
        fn = lambda: fa_ops.flash_attention_qkv(qkv, h, d)
        library = sdpa(*(t.unflatten(-1, (h, d)).transpose(1, 2)
                         for t in qkv.split(h * d, dim=-1)))
        b2b = ({"b2b_ms": time_b2b(fn), "library_b2b_ms": time_b2b(library[1])}
               if d < 40 else {})
        record("flash_attention_qkv", f"[8, {s}, 3*{h}*{d}]", out, pout, fn,
               lambda: fa_ops.flash_attention_qkv_plain(qkv, h, d),
               fa_ops.flash_forward_work(8, h, s, s, d), library=library, extra=(lse, plse),
               **b2b)

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
        library_b2b = time_b2b(library[1])
        b, h, s, d = q.shape
        for name, got, want, work in (
                ("flash_attention_bwd_dq", [dq], [pdq], fa_ops.flash_bwd_dq_work),
                ("flash_attention_bwd_dkv", [dk, dv], [pdk, pdv], fa_ops.flash_bwd_dkv_work)):
            wrapper = getattr(fa_ops, name)
            record_grad(name, label, got, want, lambda: wrapper(*args),
                        lambda: getattr(fa_ops, name + "_plain")(*args), work(b, h, s, s, d),
                        library, bit_equal_runs=True, b2b_ms=time_b2b(lambda: wrapper(*args)),
                        library_b2b_ms=library_b2b)
        del lib_out, leaves

    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        bwd_case(f"bhsd [4, 8, {s}, {d}]", *(rn(4, 8, s, d) for _ in range(4)))
    s, h, d = 4096, 8, 40
    bshd = [rn(4, s, h, d).transpose(1, 2) for _ in range(4)]
    bwd_case(f"bshd [4, {s}, {h}, {d}]", *bshd)
    qkv = rn(4, s, 3 * h * d)
    views = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
    bwd_case(f"qkv [4, {s}, 3*{h}*{d}]", *views, rn(4, s, h, d).transpose(1, 2))
    # ControlNet-XS's control stream trains through the fused-qkv entry: its
    # gradients are written into the [4, S, 3*8*D] projection's gradient
    for s, h, d in XS_ATTN_SITES:
        qkv = rn(4, s, 3 * h * d)
        views = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
        bwd_case(f"qkv [4, {s}, 3*{h}*{d}]", *views, rn(4, s, h, d).transpose(1, 2))

    # C at the four sampling sites (the CFG batch of 8), then the finetune
    # step's 64^2 site (batch 4); beside each, its two launches alone
    for rows, c in ((8 * 4096, 320), (8 * 1024, 640), (8 * 256, 1280), (8 * 64, 1280),
                    (4 * 4096, 320)) + XS_GEGLU_SITES:
        f = 4 * c
        x, w1, b1, w2, b2 = args = (rn(rows, c), rn(2 * f, c, std=c ** -0.5), rn(2 * f, std=0.1),
                                    rn(c, f, std=f ** -0.5), rn(c, std=0.1))
        plan = geglu_ops.geglu_plan(rows, c, f, sms)
        h, y = torch.empty((rows, f), dtype=torch.bfloat16, device=dev), torch.empty_like(x)
        fn = lambda: geglu_ops.geglu_ffn(*args)
        record("geglu_ffn", f"rows={rows} C={c} F={f}", geglu_ops.geglu_ffn(*args),
               geglu_ops.geglu_ffn_plain(*args), fn,
               lambda: geglu_ops.geglu_ffn_plain(*args), geglu_ops.geglu_ffn_work(rows, c, f),
               up_ms=time_ms(lambda: geglu_ops.launch_up(x, w1, b1, h, plan)),
               down_ms=time_ms(lambda: geglu_ops.launch_down(h, w2, b2, y, plan)),
               b2b_ms=time_b2b(fn), plan=dataclasses.asdict(plan))
        del x, w1, b1, w2, b2, args, h, y
    # the wrapper's host time per call (128 rows: the launches take longer
    # to issue than to run), kernels and plain version
    args = (rn(128, 320), rn(2560, 320, std=320 ** -0.5), rn(2560, std=0.1),
            rn(320, 1280, std=1280 ** -0.5), rn(320, std=0.1))
    log("kernels", kernel="geglu_ffn", shape="rows=128 C=320 F=1280, host time",
        host_us_per_call=host_us(lambda: geglu_ops.geglu_ffn(*args)),
        plain_host_us_per_call=host_us(lambda: geglu_ops.geglu_ffn_plain(*args)))

    # D at one step's block of one-LoRA sampling: bit-equal to its plain
    # version; beside its time, its host time per call (the step is
    # host-bound) and the library call: torch.take with a cached flat index
    # gives the concatenation of every block[i, :C_i]
    sizes = emb_row_sizes(cfg)
    block = rn(len(sizes), max(sizes))
    rows = unpack_ops.unpack_rows(block, sizes)
    prows = unpack_ops.unpack_rows_plain(block, sizes)
    for a, b in zip(rows, prows):
        if not torch.equal(a, b):
            raise AssertionError("unpack_rows differs from its plain version")
    index = torch.cat([torch.arange(c, device=dev) + i * block.stride(0)
                       for i, c in enumerate(sizes)])
    library = ("torch.take (cached flat index)", lambda: torch.take(block, index))
    if not torch.equal(library[1](), torch.cat(rows, 1)[0]):
        raise AssertionError("torch.take of the cached index differs from unpack_rows")
    fn = lambda: unpack_ops.unpack_rows(block, sizes)
    plain = lambda: unpack_ops.unpack_rows_plain(block, sizes)
    record("unpack_rows", f"[{len(sizes)}, {max(sizes)}]", torch.cat(rows, 1),
           torch.cat(prows, 1), fn, plain, unpack_ops.unpack_rows_work(sizes),
           library=library, b2b_ms=time_b2b(fn), library_b2b_ms=time_b2b(library[1]),
           bit_equal=True, host_us_per_call=host_us(fn), plain_host_us_per_call=host_us(plain),
           library_host_us_per_call=host_us(library[1]))
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
            bumped = leaf in ZERO_INIT or "zero_" in leaf  # XS: {enc,dec,mid}_zero_*
            randn(m.weight, 0.05 if bumped else m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.data.zero_()
            if getattr(m, "lora", None) is not None:
                randn(m.lora_down, 1.0 / m.lora_down.shape[-1])
                randn(m.lora_up, 0.05)
        for pname in ("token_embedding", "position_embedding", "class_embedding"):
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
    sample(pipe, ids, uncond, hint, x_T, steps=2)  # warm-up
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
    return launches, pipe, (ids, uncond, hint), total


def tiny_gpu_vs_cpu(dev):
    """The tiny configuration on the GPU (fp32: the GroupNorm and row-unpack
    kernels run, the rest is plain at these widths) against the CPU: the
    DDIM slice, then every run of phase 9's sampler family."""
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

    # every run of phase 9's sampler family (batch 2, 6 steps), the noise
    # drawn once on the CPU and passed in
    steps, shape = 6, (2, 8, 8, 4)
    ids = torch.randint(1, cfg.clip.vocab_size, (2, cfg.clip.max_length), generator=gen)
    hint = torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1
    x_T = torch.randn(shape, generator=gen)
    noise = {"eta": {"noise": torch.randn((steps, *shape), generator=gen)},
             "mask": {"mask_noise": torch.randn((steps, *shape), generator=gen)},
             "encode": {"noise": torch.randn(shape, generator=gen)}}
    outs = {}
    for pipe, d in ((cpu, "cpu"), (gpu, dev)):
        ctx, unc = pipe.encode_text_cond_uncond(ids.to(d), torch.zeros_like(ids).to(d))
        hz = pipe.encode_first_stage(hint.to(d))
        for name, fn in family_cases(pipe, x_T.to(d), steps, noise.get).items():
            outs.setdefault(name, []).append(fn(ctx, unc, hz).cpu())
    errs = {name: compare(got, want, rtol=2e-3, atol=2e-4) for name, (want, got) in outs.items()}
    log("tiny_samplers", gpu_vs_cpu_max_abs_err=errs, steps=steps, shape=list(shape),
        tol="rtol=2e-3 atol=2e-4")


# ---------------------------------------------------------------------------
# phases 5 (tiny) and 9: the sampler family
# ---------------------------------------------------------------------------

FAMILY_STEPS = 20  # the API's default ddim_steps
# the decayed control scales of guess mode (apps/logic.py: strength * 0.825**(taps-1-i))
GUESS_DECAY = 0.825


def family_cases(pipe, x_T, steps, draws):
    """The sampler family's runs on one pipeline, in order: name -> fn(ctx,
    unc, hz) -> final latents. `draws(kind)` gives a stochastic run's draws
    as keyword arguments (kind 'eta', 'mask' or 'encode'): a generator
    seeded with SEED (phase 9, the API's way) or the noise itself (phase 5).
    The mask keeps the left half of the latent; img2img noises the hint
    latent to step steps//2 and decodes from there; ddim_encode inverts it
    for steps//2 rungs and ddim_decode_from takes it back."""
    taps = len(encoder_plan(pipe.cfg.control.unet)[0]) + 1
    decayed = [GUESS_DECAY ** float(taps - 1 - i) for i in range(taps)]
    shape = tuple(x_T.shape)
    mask = torch.zeros(shape, device=x_T.device)
    mask[:, :, : shape[2] // 2] = 1.0
    half = steps // 2
    ucg = tuple(float(v) for v in np.linspace(9.0, 3.0, steps))
    cfg = lambda **kw: DDIMConfig(steps=steps, guidance_scale=7.5, **kw)

    def base(ctx, unc, hz):
        return pipe, ctx, unc, [Conditioning(hz)], shape

    def img2img(ctx, unc, hz):
        xt = ddim_stochastic_encode(pipe, hz, half, steps, **draws("encode"))
        return ddim_decode_from(pipe, xt, half, ctx, unc, [Conditioning(hz)], cfg())

    def encode(ctx, unc, hz):
        xe = ddim_encode(pipe, hz, half, ctx, None, [Conditioning(hz)], steps=steps)
        return ddim_decode_from(pipe, xe, half, ctx, None, [Conditioning(hz)], cfg())

    return {
        "ddim_eta0.5": lambda *a: ddim_sample(*base(*a), cfg(eta=0.5), x_T=x_T, **draws("eta")),
        "ddim_eta0": lambda *a: ddim_sample(*base(*a), cfg(), x_T=x_T),
        "ddim_guess_mode": lambda *a: ddim_sample(*base(*a), cfg(guess_mode=True), x_T=x_T,
                                                  control_scales=decayed),
        "ddim_decayed_scales": lambda *a: ddim_sample(*base(*a), cfg(), x_T=x_T,
                                                      control_scales=decayed),
        "ddim_ucg_schedule": lambda *a: ddim_sample(*base(*a), cfg(ucg_schedule=ucg), x_T=x_T),
        "ddim_mask_x0": lambda ctx, unc, hz: ddim_sample(
            *base(ctx, unc, hz), cfg(), x_T=x_T, mask=mask, x0=hz, **draws("mask")),
        "plms": lambda *a: plms_sample(*base(*a), cfg(), x_T=x_T),
        "dpmsolver++_multistep_2_thresholding": lambda *a: dpm_solver_sample(
            *base(*a), cfg(), x_T=x_T, order=2, algorithm="dpmsolver++", thresholding=True),
        "dpmsolver_multistep_3": lambda *a: dpm_solver_sample(
            *base(*a), cfg(), x_T=x_T, order=3, algorithm="dpmsolver"),
        "dpmsolver++_singlestep_3": lambda *a: dpm_solver_singlestep_sample(
            *base(*a), cfg(), x_T=x_T, order=3, algorithm="dpmsolver++"),
        "img2img_stochastic_encode_decode_from": img2img,
        "ddim_encode_then_decode_from": encode,
    }


def host_syncs(fn):
    """fn() under torch.cuda's sync debug mode: (its result, the number of
    calls in it that made the host wait for the card)."""
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def sampler_family(dev, pipe, ids, uncond, hint):
    """Phase 9: the sampler family at SD1.5 width on phase 4's pipeline
    (batch 4, 512^2, CFG 7.5, FAMILY_STEPS steps). Each run: prep (CLIP
    pair, hint encode), the sampler, decode, timed apart; the model
    evaluations, and the kernel launches per evaluation of the sampler
    alone. Returns the launches of all runs."""
    evals = [0]
    apply_model = pipe.apply_model

    def counting_apply(*a, **kw):
        evals[0] += 1
        return apply_model(*a, **kw)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    lat = SIZE // 2 ** (len(pipe.cfg.vae.ch_mult) - 1)
    x_T = torch.randn((BATCH, lat, lat, 4), generator=gen, device=dev)
    seeded = lambda kind: {"generator": torch.Generator().manual_seed(SEED)}
    cases = family_cases(pipe, x_T, FAMILY_STEPS, seeded)
    # the eta-0.5 run twice: the same seed must give the same bits
    order = ["ddim_eta0.5", "ddim_eta0.5", *list(cases)[1:]]
    counters = wrappers()
    totals, images = {}, {}
    for run, name in enumerate(order):
        # singlestep DPM passes no hoisted rows, as in JAX: no row unpack
        required = tuple(k for k in SAMPLING_KERNELS
                         if not (k == "unpack_rows" and "singlestep" in name))
        with mock.patch.object(pipe, "apply_model", counting_apply), \
                counted(f"samplers {name}", required) as launches:
            t0 = time.perf_counter()
            ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
            hz = pipe.encode_first_stage(hint)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            before = {k: w.launches for k, w in counters.items()}
            evals[0] = 0
            z, syncs = host_syncs(lambda: cases[name](ctx, unc, hz))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            in_sampler = {k: w.launches - before[k] for k, w in counters.items()}
            img = pipe.decode_first_stage(z)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        n = evals[0]
        log("samplers", run=name, steps=FAMILY_STEPS, batch=BATCH, size=SIZE,
            s_per_batch=t3 - t0, prep_s=t1 - t0, sampler_s=t2 - t1, decode_s=t3 - t2,
            model_evaluations=n, sampler_s_per_evaluation=(t2 - t1) / n, host_syncs=syncs,
            launches_per_evaluation={k: v / n for k, v in in_sampler.items() if v},
            launches=launches, shape=list(img.shape), finite=bool(torch.isfinite(img).all()),
            image_mean=img.float().mean().item(), image_std=img.float().std().item())
        if tuple(img.shape) != (BATCH, SIZE, SIZE, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"{name}: bad image, shape {tuple(img.shape)}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        key = f"{name}#{run}" if name in images else name
        images[key] = img
    repeat = rel_l2(images["ddim_eta0.5#1"], images["ddim_eta0.5"])
    checks = {"eta0.5_bit_equal_across_runs": torch.equal(images["ddim_eta0.5#1"],
                                                          images["ddim_eta0.5"]),
              "eta0.5_vs_eta0_rel_l2": rel_l2(images["ddim_eta0.5"], images["ddim_eta0"]),
              "guess_vs_no_guess_rel_l2": rel_l2(images["ddim_guess_mode"],
                                                 images["ddim_decayed_scales"])}
    log("samplers", eta0_5_repeat_rel_l2=repeat, **checks, bound_differ=1e-3)
    if not checks["eta0.5_bit_equal_across_runs"]:
        raise AssertionError(f"eta 0.5 DDIM is not bit-equal across two runs (rel {repeat})")
    for key in ("eta0.5_vs_eta0_rel_l2", "guess_vs_no_guess_rel_l2"):
        if not checks[key] > 1e-3:
            raise AssertionError(f"{key} = {checks[key]}: the runs do not differ")
    del images

    # one UNet + ControlNet evaluation in guess mode: kernels vs plain
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    hz = pipe.encode_first_stage(hint)
    conds = [Conditioning(torch.cat([hz, hz]))]
    taps = len(encoder_plan(pipe.cfg.control.unet)[0]) + 1
    decayed = [GUESS_DECAY ** float(taps - 1 - i) for i in range(taps)]
    cmask = torch.cat([torch.ones(BATCH), torch.zeros(BATCH)]).to(dev)
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)

    def evaluate():
        packed, rows_of = make_emb_row_tables(pipe, conds, ts)
        return pipe.apply_model(torch.cat([x_T, x_T]), tvec, torch.cat([ctx, unc]), conds,
                                emb_rows=rows_of(packed[0]), control_scales=decayed,
                                control_batch_mask=cmask)

    out_k = evaluate()
    with plain_versions():
        out_p = evaluate()
    rel = rel_l2(out_k, out_p)
    log("samplers", guess_mode_unet_controlnet_rel_l2_kernels_vs_plain=rel, bound=MODEL_REL_TOL)
    if not math.isfinite(rel) or rel > MODEL_REL_TOL:
        raise AssertionError(f"guess-mode evaluation departs from the plain path: rel {rel}")
    cli_launches = sample_cli_batch(dev)
    for k, v in cli_launches.items():
        totals[k] = totals.get(k, 0) + v
    return totals


def sample_cli_batch(dev):
    """The sample CLI's per-batch function at SD1.5 width on
    reference-format files written as phase 8 writes them (SD and Base
    ControlNet in fp16, one rank-128 LoRA) from a seeded unfused
    ctrlora_finetune_config(128) pipeline, the CLI's default model: the
    pipeline through ``load_pipeline``, 4 items through ``sample_batch``
    with --sampler dpm_solver at 20 steps. The files are deleted at the
    end."""
    cfg = configs.ctrlora_finetune_config(lora_rank=128)
    outdir = os.path.join(ROOT, "runs", "chip_smoke_cli_ckpts")
    shutil.rmtree(outdir, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    t0 = time.perf_counter()
    src = CtrLoraPipeline(cfg, dev, fuse_lora=False)
    for m in src.modules():
        random_init_(m, gen)
    paths, _ = write_reference_files(src, src.control.state_dict(), cfg, outdir, torch.float16)
    del src
    write_s = time.perf_counter() - t0
    args = sample_cli.build_parser().parse_args([
        "--dataroot", "unused", "--save_dir", "unused", "--sd_ckpt", paths["sd"],
        "--cn_ckpt", paths["basecn"], "--lora_ckpt", paths["loras"][0],
        "--sampler", "dpm_solver", "--ddim_steps", str(FAMILY_STEPS), "--bs", str(BATCH)])
    t0 = time.perf_counter()
    pipe = sample_cli.load_pipeline(cfg, dev, args.sd_ckpt, args.cn_ckpt, args.lora_ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(outdir, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    hint = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8).astype(np.float32) / 255
    tok = sample_cli.default_tokenizer()
    ids = tok([PROMPT] * BATCH, max_length=cfg.clip.max_length)
    nids = tok([""] * BATCH, max_length=cfg.clip.max_length)
    opts = sample_cli.SampleOptions.from_args(args)
    sample_cli.sample_batch(pipe, hint, ids, nids, opts, args.seed)  # warm-up
    with counted("sample CLI batch", SAMPLING_KERNELS) as launches:
        t0 = time.perf_counter()
        out = sample_cli.sample_batch(pipe, hint, ids, nids, opts, args.seed)
        total = time.perf_counter() - t0
    log("sample_cli", sampler=opts.sampler, dpm_order=opts.dpm_order,
        dpm_method=opts.dpm_method, steps=opts.steps, batch=BATCH, size=SIZE, write_s=write_s,
        load_pipeline_s=load_s, s_per_batch=total, launches=launches, shape=list(out.shape),
        dtype=str(out.dtype), image_mean=float(out.mean()), image_std=float(out.std()))
    if out.shape != (BATCH, SIZE, SIZE, 3) or out.dtype != np.uint8 or not out.std() > 0:
        raise AssertionError(f"sample CLI batch: {out.shape} {out.dtype} std {out.std()}")
    del pipe
    return launches


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
    """One step's loss and its concatenated trainable gradient (fp32); a
    parameter the loss does not reach (Lite's time_embed) counts zeros."""
    for p in params:
        p.grad = None
    loss, _ = loss_for_batch(pipe, batch, draws=draws)
    loss.backward()
    return loss.item(), torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                   .float().flatten() for p in params])


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
    trainer.fit(batches[:WARMUP_STEPS], max_steps=WARMUP_STEPS)  # warm-up
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


def as_file(arrays: dict, dtype: torch.dtype = torch.float16) -> dict:
    """Exported numpy arrays as the tensors a reference file holds."""
    return {k: torch.from_numpy(v).to(dtype) for k, v in arrays.items()}


def sd_parts(cfg):
    """(key prefix, pipeline module name, key table) of each part of an SD
    file; an XS pipeline's UNet exports its base stream."""
    return (("model.diffusion_model.", "unet", ckpt_torch.unet_entries(cfg.unet)),
            ("first_stage_model.", "vae", ckpt_torch.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", "clip",
             ckpt_torch.clip_entries(cfg.clip)))


def write_sd_file(cfg, pipe, path, dtype: torch.dtype = torch.float16) -> dict:
    """The pipeline's UNet, VAE and CLIP as an SD-format file in `dtype`;
    returns what was written."""
    sd = {}
    for prefix, name, entries in sd_parts(cfg):
        sd.update(as_file(ckpt_torch.export_tree(getattr(pipe, name).state_dict(), entries,
                                                 prefix), dtype))
    torch.save({"state_dict": sd}, path)
    return sd


def sd_pairs(trees: dict, sd: dict, cfg) -> list:
    """(key, loaded array, file tensor) for every SD-file tensor of the parts
    in `trees` ({module name: loaded state dict})."""
    return [(k, v, sd[k]) for prefix, name, entries in sd_parts(cfg) if name in trees
            for k, v in ckpt_torch.export_tree(trees[name], entries, prefix).items()]


def differing(pairs) -> list:
    """The keys of `pairs` whose loaded array is not the file's tensor (fp16
    widened to fp32 exactly)."""
    return [k for k, got, want in pairs if not np.array_equal(got, want.float().numpy())]


def write_reference_files(src: CtrLoraPipeline, control_state: dict, cfg, outdir: str,
                          dtype: torch.dtype):
    """The SD checkpoint (UNet, VAE, CLIP under the reference prefixes), the
    Base ControlNet and one file per LoRA slot, in `dtype`, through the
    port's exporters. Returns (paths, the written state dicts)."""
    os.makedirs(outdir, exist_ok=True)
    paths = {"sd": os.path.join(outdir, "sd15.ckpt"), "basecn": os.path.join(outdir, "basecn.ckpt"),
             "loras": [os.path.join(outdir, f"lora{i}.ckpt")
                       for i in range(cfg.control.lora.n_loras)]}
    written = {"sd": write_sd_file(cfg, src, paths["sd"], dtype),
               "basecn": as_file(ckpt_torch.export_control_base(control_state, cfg.control),
                                 dtype),
               "loras": [as_file(ckpt_torch.export_lora_slot(control_state, cfg.control, i),
                                 dtype) for i in range(cfg.control.lora.n_loras)]}
    torch.save(written["basecn"], paths["basecn"])
    for path, lsd in zip(paths["loras"], written["loras"]):
        torch.save(lsd, path)
    return paths, written


def loaded_matches_written(states, written, cfg) -> int:
    """Every tensor the loader produced equals the file's (fp16 widened to
    fp32 exactly), read back through the exporters; returns the count."""
    pairs = sd_pairs({"unet": states.unet, "vae": states.vae, "clip": states.clip},
                     written["sd"], cfg)
    pfx = "control_model."
    pairs += [(k, v, written["basecn"][k]) for k, v in
              ckpt_torch.export_control_base(states.control, cfg.control).items()
              if not check_key(k[len(pfx):])]
    for i, lsd in enumerate(written["loras"]):
        pairs += [(k, v, lsd[k]) for k, v in
                  ckpt_torch.export_lora_slot(states.control, cfg.control, i).items()]
    bad = differing(pairs)
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


# ---------------------------------------------------------------------------
# phase 10: the training CLIs from files
# ---------------------------------------------------------------------------

CLI_SHAPES = ((512, 512), (480, 640), (640, 480))  # the datasets' image (h, w)
CLI_PAIRS, CLI_WARMUP, CLI_TIMED, CLI_RESUMED = 16, 2, 6, 2
PRETRAIN_ITEMS, PRETRAIN_TIMED = 4, 9  # a task; one round of the nine tasks
# the finetune run's kernels: the training steps', and D in the hook's DDIM
FINETUNE_CLI_KERNELS = TRAINING_KERNELS + ("unpack_rows",)


@contextlib.contextmanager
def cli_spies(initial_branches):
    """Watch a CLI run from outside: each train step's kernel launches and
    task (and ``rec['after_first'](state)`` after the first step), a CPU
    copy of `initial_branches`' weights as the CLI loaded them, and the
    image log's arrays before their uint8 cast."""
    rec = {"steps": [], "initial": {}, "rows": [], "after_first": None}
    real_make, real_load = trainer_mod.make_train_step, train_common.load_training_pipeline
    real_rows = trainer_mod.image_log_rows

    def make(*args, **kw):
        fn = real_make(*args, **kw)

        def step(state, batch, *a, **k):
            before = counts_now()
            out = fn(state, batch, *a, **k)
            rec["steps"].append({"task": int(batch["task_idx"].reshape(-1)[0]),
                                 "launches": counts_since(before)})
            if len(rec["steps"]) == 1 and rec["after_first"] is not None:
                rec["after_first"](state)
            return out

        return step

    def load(*args, **kw):
        pipe = real_load(*args, **kw)
        rec["initial"] = {f"{b}.{n}": p.detach().to("cpu", copy=True)
                          for b, m in train_state.branches(pipe).items() if b in initial_branches
                          for n, p in m.named_parameters()}
        return pipe

    def rows(*args, **kw):
        rec["rows"].append(real_rows(*args, **kw))
        return rec["rows"][-1]

    with mock.patch.object(trainer_mod, "make_train_step", make), \
            mock.patch.object(train_common, "load_training_pipeline", load), \
            mock.patch.object(trainer_mod, "image_log_rows", rows):
        yield rec


def png_shape(path):
    """[height, width, channels] of an 8-bit PNG, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(26)
    width, height = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
    return [height, width, {0: 1, 2: 3, 4: 2, 6: 4}[head[25]]]


def cli_metrics(workdir, event):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [ln for ln in map(json.loads, f) if ln["event"] == event]


def timed_steps(workdir, skip):
    """Seconds a step of the train lines after the first `skip` (each
    line's window is one step at --log_every 1: loader, copy, step and the
    metrics read, which waits for the card)."""
    lines = cli_metrics(workdir, "train")[skip:]
    return sum(1 / ln["steps_per_sec"] for ln in lines) / len(lines), lines


def per_step_launches(steps, names=TRAINING_KERNELS):
    return {n: sum(s["launches"][n] for s in steps) / len(steps) for n in names}


def write_cli_datasets(root, rng):
    """A CustomDataset directory of CLI_PAIRS pairs and a MultiGen-20M
    directory of PRETRAIN_ITEMS items for each of the nine tasks, PNG files
    of random pixels at CLI_SHAPES, both orientations."""
    img = lambda i: rng.integers(0, 256, (*CLI_SHAPES[i % len(CLI_SHAPES)], 3), dtype=np.uint8)
    custom = os.path.join(root, "custom")
    for sub in ("source", "target"):
        os.makedirs(os.path.join(custom, sub))
    with open(os.path.join(custom, "prompt.json"), "w") as f:
        for i in range(CLI_PAIRS):
            for sub in ("source", "target"):
                write_png(os.path.join(custom, sub, f"{i}.png"), img(i))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"{PROMPT}, item {i}"}) + "\n")
    mg = os.path.join(root, "multigen")
    for sub in ("json_files", "images", "conditions"):
        os.makedirs(os.path.join(mg, sub))
    for t in configs.MULTIGEN_TASKS:
        with open(os.path.join(mg, "json_files", f"aesthetics_plus_all_group_{t}_all.json"),
                  "w") as f:
            for i in range(PRETRAIN_ITEMS):
                write_png(os.path.join(mg, "images", f"{t}{i}.png"), img(i + 1))
                write_png(os.path.join(mg, "conditions", f"{t}{i}.png"), img(i + 1))
                f.write(json.dumps({"source": f"./{t}{i}.png", f"control_{t}": f"{t}{i}.png",
                                    "prompt": f"a {t} map of a house, item {i}"}) + "\n")
    return custom, mg


def check_weights(pipe, trainer, initial, frozen_only=False):
    """(frozen weights that changed, trainable weights that did not) against
    the CPU copies of the weights as loaded."""
    named = {f"{b}.{n}": p for b, m in train_state.branches(pipe).items()
             for n, p in m.named_parameters() if f"{b}.{n}" in initial}
    trainable = trainer.state.trainable
    changed = [k for k, p in named.items() if k not in trainable
               and not torch.equal(p.detach().cpu(), initial[k])]
    unchanged = [] if frozen_only else [k for k, p in trainable.items()
                                        if torch.equal(p.detach().cpu(), initial[k])]
    return changed, unchanged


def finetune_cli(dev, paths, custom, root, phase6_s_step):
    """Phase 10 (a): the finetune CLI from the files with the native image
    prep, --use_ema, the image log and a checkpoint at the last step; then
    --resume for two more steps, and a --cache_latents run. Returns the
    launches of the three runs."""
    base = ["--dataroot", custom, "--sd_ckpt", paths["sd"], "--cn_ckpt", paths["basecn"],
            "--bs", str(BATCH), "--resolution", str(SIZE), "--log_every", "1",
            "--num_workers", "8", "--device", str(dev)]
    steps = CLI_WARMUP + CLI_TIMED
    ft_dir = os.path.join(root, "finetune")
    launches = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with cli_spies(("unet", "vae", "clip", "control")) as rec, \
            counted("finetune CLI", FINETUNE_CLI_KERNELS) as launches["finetune"]:
        t0 = time.perf_counter()
        run = finetune_cli_mod.main(base + [
            "--max_steps", str(steps), "--use_ema", "--ckpt_logger_freq", str(steps),
            "--img_logger_freq", str(steps), "--name", ft_dir])
        total = time.perf_counter() - t0
    s_step, lines = timed_steps(run.workdir, CLI_WARMUP)
    hook = cli_metrics(run.workdir, "image_log")
    log("train_cli", run="finetune", images="png files", native_image_prep=True, batch=BATCH,
        size=SIZE, pairs=CLI_PAIRS, steps=steps, total_s=total, load_s=run.seconds["load"],
        loader_wait_s=run.loader.wait_s, loader_wait_s_per_step=run.loader.wait_s / steps,
        s_per_step=s_step, phase6_synthetic_s_per_step=phase6_s_step,
        launches_per_step=per_step_launches(rec["steps"][CLI_WARMUP:]),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        hook_s=hook[0]["seconds"] if hook else None, loss=[ln["loss"] for ln in lines],
        grad_norm=[ln["grad_norm"] for ln in lines], launches=launches["finetune"])
    train = cli_metrics(run.workdir, "train")
    if len(train) != steps or not all(math.isfinite(ln["loss"]) and ln["grad_norm"] > 0
                                      for ln in train):
        raise AssertionError(f"bad finetune CLI metrics: {train}")
    trainer, pipe = run.trainer, run.trainer.pipe
    changed, unchanged = check_weights(pipe, trainer, rec["initial"])
    live = {k: p.detach().clone() for k, p in trainer.state.trainable.items()}
    shadow = trainer.state.ema.params
    lagging = all(not torch.equal(live[k], shadow[k]) for k in live)
    with trainer.eval_params():
        swapped = all(torch.equal(p, shadow[k]) for k, p in trainer.state.trainable.items())
    restored = all(torch.equal(p, live[k]) for k, p in trainer.state.trainable.items())
    png = png_shape(hook[0]["path"]) if hook else None
    rows_finite = bool(rec["rows"]) and all(np.isfinite(r).all() for r in rec["rows"][-1].values())
    log("train_cli", run="finetune", frozen_bit_identical=not changed,
        trainable_all_changed=not unchanged, n_trainable=len(live), ema_differs=lagging,
        ema_swap_in=swapped, ema_swap_restores_bits=restored,
        image_log_shape=png, image_log_rows_finite=rows_finite)
    if changed or unchanged or not (lagging and swapped and restored) \
            or png != [48 + 3 * SIZE, 2 * SIZE, 3] or not rows_finite:
        raise AssertionError(f"finetune CLI: frozen changed {changed[:5]}, trainable unchanged "
                             f"{unchanged[:5]}, ema {lagging}/{swapped}/{restored}, image log "
                             f"{png} finite {rows_finite}")
    ckpt = os.path.join(run.workdir, f"ckpt_{steps:08d}.pt")
    del run, trainer, pipe, live, rec
    torch.cuda.empty_cache()

    # --resume: the step count and the loader's schedule go on from the checkpoint
    with counted("finetune CLI --resume", TRAINING_KERNELS) as launches["resume"]:
        run = finetune_cli_mod.main(base + [
            "--max_steps", str(steps + CLI_RESUMED), "--use_ema", "--resume", ckpt,
            "--ckpt_logger_freq", str(steps), "--name", os.path.join(root, "resumed")])
    got = [ln["step"] for ln in cli_metrics(run.workdir, "train")]
    log("train_cli", run="resume", from_step=steps, train_steps=got,
        loader_last_step=run.loader.last_step, ema_updates=run.trainer.state.ema.updates,
        launches=launches["resume"])
    if got != list(range(steps + 1, steps + CLI_RESUMED + 1)) or \
            run.loader.last_step != steps + CLI_RESUMED - 1 or \
            run.trainer.state.ema.updates != steps + CLI_RESUMED:
        raise AssertionError(f"resume: steps {got}, loader at {run.loader.last_step}")
    del run
    torch.cuda.empty_cache()

    # --cache_latents: the pre-pass, then steps on the moments
    with counted("finetune CLI --cache_latents", TRAINING_KERNELS) as launches["cached"]:
        run = finetune_cli_mod.main(base + [
            "--max_steps", str(steps), "--cache_latents", "--ckpt_logger_freq", str(steps),
            "--name", os.path.join(root, "cached")])
    s_cached, lines = timed_steps(run.workdir, CLI_WARMUP)
    pre = run.seconds["precompute"]
    log("train_cli", run="cache_latents", precompute_s=pre, precompute_pairs=CLI_PAIRS,
        precompute_images_per_s=2 * CLI_PAIRS / pre, cached_s_per_step=s_cached,
        pixel_s_per_step=s_step, loss=[ln["loss"] for ln in lines],
        launches=launches["cached"])
    if not all(math.isfinite(ln["loss"]) and ln["grad_norm"] > 0
               for ln in cli_metrics(run.workdir, "train")):
        raise AssertionError("cached finetune: bad metrics")
    del run
    torch.cuda.empty_cache()
    return launches


def pretrain_cli(dev, paths, mg, root):
    """Phase 10 (b): the pretrain CLI, nine LoRA banks from the same SD and
    Base ControlNet files, MultiGen-20M over the nine tasks: 2 warm-up steps
    and 9 timed ones (the first nine steps are one round of the tasks). The
    last checkpoint (the AdamW moments of ~0.7B parameters) is not
    written."""
    n_tasks = len(configs.MULTIGEN_TASKS)
    steps = CLI_WARMUP + PRETRAIN_TIMED
    banks = {}

    def after_first(state):  # the banks of each lora_up holding non-zeros
        for k, p in state.trainable.items():
            if k.endswith("lora_up"):
                banks[k] = p.detach().flatten(1).any(1).tolist()

    torch.cuda.reset_peak_memory_stats(dev)
    with cli_spies(("unet",)) as rec, counted("pretrain CLI", TRAINING_KERNELS) as launches, \
            mock.patch.object(Trainer, "save", lambda self, step: None):
        rec["after_first"] = after_first
        t0 = time.perf_counter()
        run = pretrain_cli_mod.main([
            "--json_dir", os.path.join(mg, "json_files"), "--meta_dir", mg,
            "--sd_ckpt", paths["sd"], "--cn_ckpt", paths["basecn"], "--bs", str(BATCH),
            "--resolution", str(SIZE), "--max_steps", str(steps), "--log_every", "1",
            "--img_logger_freq", "1000", "--num_workers", "8", "--device", str(dev),
            "--name", os.path.join(root, "pretrain")])
        total = time.perf_counter() - t0
    s_step, lines = timed_steps(run.workdir, CLI_WARMUP)
    trainer = run.trainer
    first = rec["steps"][0]["task"]
    wrong = [k for k, nz in banks.items() if nz != [i == first for i in range(n_tasks)]]
    changed, _ = check_weights(trainer.pipe, trainer, rec["initial"], frozen_only=True)
    n_train = sum(p.numel() for p in trainer.state.trainable.values())
    log("train_cli", run="pretrain", images="png files", tasks=list(trainer.pipe.cfg.tasks),
        n_loras=trainer.pipe.cfg.control.lora.n_loras, batch=BATCH, size=SIZE, steps=steps,
        total_s=total, load_s=run.seconds["load"], loader_wait_s=run.loader.wait_s,
        trainable_params_m=n_train / 1e6, s_per_step=s_step,
        task_of_step=[s["task"] for s in rec["steps"]],
        launches_per_step=per_step_launches(rec["steps"][CLI_WARMUP:]),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        loss=[ln["loss"] for ln in lines], lora_up_checked=len(banks),
        only_first_bank_nonzero_after_step_1=not wrong, unet_bit_identical=not changed,
        launches=launches)
    losses = [ln["loss"] for ln in cli_metrics(run.workdir, "train")]
    if len(losses) != steps or not all(map(math.isfinite, losses)) or not banks or wrong \
            or changed or sorted({s["task"] for s in rec["steps"]}) != list(range(n_tasks)):
        raise AssertionError(f"pretrain CLI: losses {losses}, banks wrong {wrong[:3]}, unet "
                             f"changed {changed[:3]}")
    del run, trainer, rec
    torch.cuda.empty_cache()
    return launches


def train_cli_slice(dev, phase6_s_step):
    """Phase 10: the finetune and pretrain CLIs at SD1.5 width from
    reference-format files (SD and Base ControlNet in fp16, written from a
    seeded ctrlora_finetune_config(128) model) and PNG datasets, with
    CTRLORA_NATIVE_DATA=1. The files are deleted at the end. Returns the
    launches of each run."""
    root = os.path.join(ROOT, "runs", "chip_smoke_train_cli")
    shutil.rmtree(root, ignore_errors=True)
    cfg = configs.ctrlora_finetune_config(lora_rank=128)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    t0 = time.perf_counter()
    src = CtrLoraPipeline(cfg, dev, fuse_lora=False)
    for m in src.modules():
        random_init_(m, gen)
    paths, _ = write_reference_files(src, src.control.state_dict(), cfg,
                                     os.path.join(root, "ckpts"), torch.float16)
    del src
    custom, mg = write_cli_datasets(root, np.random.default_rng(SEED))
    log("train_cli", write_s=time.perf_counter() - t0, png_writer=png_writer(),
        native_library=os.path.relpath(str(native_data.library_path()), ROOT))
    try:
        with mock.patch.dict(os.environ, {"CTRLORA_NATIVE_DATA": "1"}):
            launches = finetune_cli(dev, paths, custom, root, phase6_s_step)
            launches["pretrain"] = pretrain_cli(dev, paths, mg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the ControlNet baselines (vanilla image-hint ControlNet, Lite)
# ---------------------------------------------------------------------------

BASELINES = {"controlnet": configs.sd15_config, "lite": configs.cnlite_config}
# the kernels each baseline's sampling launches: Lite builds no row tables (no D)
BASELINE_SAMPLING_KERNELS = {
    "controlnet": SAMPLING_KERNELS,
    "lite": ("group_norm", "flash_attention_qkv", "flash_attention", "geglu_ffn")}
# the baselines' training: no LoRA, so every transformer runs B's fused-qkv
# entry (the BSHD entry serves the LoRA trees' separate projections)
BASELINE_TRAINING_KERNELS = tuple(k for k in TRAINING_KERNELS if k != "flash_attention_bshd")
CN_WARMUP, CN_TIMED = 2, 4
CN_MICRO_BATCH, CN_GRADACC, LITE_BATCH = 2, 2, 4


def device_ms(fn) -> float:
    """Device ms of the kernels fn() launches, by torch.profiler (after a
    warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return sum(dev_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3


def baseline_sample(pipe, ids, uncond, hint, x_T, steps):
    """The baselines' serving path: CLIP pair, DDIM with CFG on the pixel
    hint (no hint encode), VAE decode. Returns (image, per-phase seconds,
    the launches of the DDIM loop)."""
    t = [time.perf_counter()]
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    before = counts_now()
    z = ddim_sample(pipe, ctx, unc, [Conditioning(hint)], x_T.shape,
                    DDIMConfig(steps=steps, guidance_scale=7.5), x_T=x_T)
    torch.cuda.synchronize()
    ddim_launches = counts_since(before)
    t.append(time.perf_counter())
    img = pipe.decode_first_stage(z)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return img, {"prep_s": t[1] - t[0], "ddim_s": t[2] - t[1], "decode_s": t[3] - t[2]}, \
        ddim_launches


def baseline_sampling(dev, variant):
    """Phase 11a/11b: one baseline at SD1.5 width, seeded random weights
    (zero-init layers included), cast for inference; batch 4, 512^2, a
    seeded pixel hint in [0, 1], token ids of ones against uncond zeros, 50
    DDIM steps at CFG 7.5, eta 0. Returns the launches of the run."""
    cfg = BASELINES[variant]()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    t0 = time.perf_counter()
    pipe = CtrLoraPipeline(cfg, dev)
    for m in pipe.modules():
        random_init_(m, gen)
    pipe.cast_for_inference()
    torch.cuda.synchronize()
    phase = f"baseline_{variant}"
    log(phase, setup_s=time.perf_counter() - t0, control=type(pipe.control).__name__,
        control_params_m=sum(p.numel() for p in pipe.control.parameters()) / 1e6,
        hint_block_params=sum(p.numel() for p in pipe.control.hint_block.parameters()))
    lat = SIZE // 8
    ids = torch.ones((BATCH, cfg.clip.max_length), dtype=torch.long, device=dev)
    uncond = torch.zeros_like(ids)
    hint = torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
    x_T = torch.randn((BATCH, lat, lat, 4), generator=gen, device=dev)
    baseline_sample(pipe, ids, uncond, hint, x_T, steps=2)  # warm-up

    torch.cuda.reset_peak_memory_stats(dev)
    with counted(f"{variant} sampling", BASELINE_SAMPLING_KERNELS[variant]) as launches:
        t0 = time.perf_counter()
        img, phases, ddim_launches = baseline_sample(pipe, ids, uncond, hint, x_T, STEPS)
        total = time.perf_counter() - t0
    per_eval = {n: ddim_launches[n] / STEPS for n in wrappers()}
    hint2 = torch.cat([hint, hint])  # the CFG batch the control call takes
    dt = cfg.control.unet.compute_dtype
    hint_block = lambda: pipe.control.hint_block(hint2, dt)
    hint_ms = time_b2b(hint_block)  # once a step: the device's time, not the host's
    log(phase, steps=STEPS, batch=BATCH, size=SIZE, s_per_batch=total,
        s_per_step=phases["ddim_s"] / STEPS, **phases, launches=launches,
        launches_per_evaluation=per_eval, hint_block_b2b_ms_per_step=hint_ms,
        hint_block_profiler_device_ms=device_ms(hint_block),
        hint_block_events_ms=time_ms(hint_block),
        hint_block_share_of_step=hint_ms / (phases["ddim_s"] / STEPS * 1e3),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if tuple(img.shape) != (BATCH, SIZE, SIZE, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"{variant}: bad image, shape {tuple(img.shape)}")
    if variant == "lite" and launches["unpack_rows"]:
        raise AssertionError(f"Lite launched the row unpack {launches['unpack_rows']} times")

    # one UNet+control evaluation: kernels vs plain versions
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    full_ctx, conds = torch.cat([ctx, unc]), [Conditioning(hint2)]
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)
    x2 = torch.cat([x_T, x_T])

    def evaluate():
        packed, rows_of = make_emb_row_tables(pipe, conds, ts)
        return pipe.apply_model(x2, tvec, full_ctx, conds, emb_rows=rows_of(packed[0]))

    out_k = evaluate()
    with plain_versions():
        out_p = evaluate()
    rel = rel_l2(out_k, out_p)
    log(phase, image_mean=img.mean().item(), image_std=img.std().item(),
        unet_control_rel_l2_kernels_vs_plain=rel, bound=MODEL_REL_TOL)
    if not math.isfinite(rel) or rel > MODEL_REL_TOL:
        raise AssertionError(f"{variant}: kernel path departs from the plain path: rel {rel}")
    del pipe
    torch.cuda.empty_cache()
    return launches


def write_control_file(cfg, dev, path, gen):
    """The control model of a seeded `cfg` (zero-init layers included) as a
    reference-format fp16 file; returns the written arrays."""
    with torch.device(dev):
        control = build_control(cfg.control, fuse_lora=False)
    random_init_(control, gen)
    written = as_file(ckpt_torch.export_control_base(control.state_dict(), cfg.control))
    torch.save(written, path)
    return written


def baseline_train(dev, variant, custom, root, sd_file, cn_file=None, written=None):
    """Phase 11c/11d: train_cn.main on the PNG pairs, the UNet from the fp16
    SD file `sd_file` (a fresh UNet outputs 0, so a run from the seeded init
    alone would have no gradient): 2 warm-up and 4 timed steps with
    --use_ema, a checkpoint and the image log at the last step; then one
    step's loss and gradients with the kernels against the plain versions.
    Returns the run's launches."""
    phase = f"train_cn_{variant}"
    steps = CN_WARMUP + CN_TIMED
    bs, gradacc = (CN_MICRO_BATCH, CN_GRADACC) if variant == "controlnet" else (LITE_BATCH, 1)
    argv = ["--variant", variant, "--dataroot", custom, "--bs", str(bs), "--gradacc",
            str(gradacc), "--max_steps", str(steps), "--use_ema", "--log_every", "1",
            "--ckpt_logger_freq", str(steps), "--img_logger_freq", str(steps),
            "--num_workers", "8", "--device", str(dev), "-n", os.path.join(root, variant),
            "--sd_ckpt", sd_file]
    if cn_file:
        argv += ["--cn_ckpt", cn_file]
    torch.cuda.reset_peak_memory_stats(dev)
    with cli_spies(("unet", "control")) as rec, \
            counted(f"train_cn {variant}", BASELINE_TRAINING_KERNELS) as launches:
        t0 = time.perf_counter()
        run = train_cn_mod.main(argv)
        total = time.perf_counter() - t0
    s_step, lines = timed_steps(run.workdir, CN_WARMUP)
    trainer, pipe = run.trainer, run.trainer.pipe
    hook = cli_metrics(run.workdir, "image_log")
    log(phase, batch=bs * gradacc, micro_batch=bs, gradacc=gradacc, size=SIZE, steps=steps,
        total_s=total, load_s=run.seconds["load"], loader_wait_s=run.loader.wait_s,
        trainable_params_m=sum(p.numel() for p in trainer.state.trainable.values()) / 1e6,
        s_per_step=s_step, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        launches_per_step=per_step_launches(rec["steps"][CN_WARMUP:], wrappers()),
        hook_s=hook[0]["seconds"] if hook else None, loss=[ln["loss"] for ln in lines],
        grad_norm=[ln["grad_norm"] for ln in lines], launches=launches)
    train = cli_metrics(run.workdir, "train")
    if len(train) != steps or not all(math.isfinite(ln["loss"]) and ln["grad_norm"] > 0
                                      for ln in train):
        raise AssertionError(f"{phase}: bad metrics {train}")
    loaded = None
    if written is not None:  # every control tensor as the file holds it
        initial = {k[len("control."):]: v for k, v in rec["initial"].items()
                   if k.startswith("control.")}
        got = ckpt_torch.export_control_base(initial, pipe.cfg.control)
        bad = [k for k in written if not np.array_equal(got[k], written[k].float().numpy())]
        if bad or sorted(got) != sorted(written):
            raise AssertionError(f"{phase}: loaded tensors differ from the file: {bad[:5]}")
        loaded = len(written)
    changed, unchanged = check_weights(pipe, trainer, rec["initial"])
    # Lite's time_embed is read by no block: no gradient, and AdamW skips it
    idle = [k for k in unchanged if not k.startswith("control.time_embed.")]
    png = png_shape(hook[0]["path"]) if hook else None
    log(phase, loaded_tensors_equal_file=loaded, frozen_bit_identical=not changed,
        trainable_changed=len(trainer.state.trainable) - len(unchanged),
        trainable_unchanged=unchanged, image_log_shape=png)
    if changed or idle or png != [48 + 3 * SIZE, 2 * SIZE, 3]:
        raise AssertionError(f"{phase}: frozen changed {changed[:5]}, trainable unchanged "
                             f"{idle[:5]}, image log {png}")
    del rec
    shutil.rmtree(os.path.join(root, variant), ignore_errors=True)  # the checkpoint

    # one step's loss and gradients: kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    batch = synthetic_batch(gen, dev, bs, SIZE, pipe.cfg.clip.max_length,
                            pipe.cfg.clip.vocab_size)
    draws = fixed_draws(gen, dev, bs, SIZE // 8)
    params = [p for p in trainer.state.trainable.values()]
    loss_k, grad_k = step_grads(pipe, params, batch, draws)
    with plain_versions():
        loss_p, grad_p = step_grads(pipe, params, batch, draws)
    loss_rel, grad_rel = abs(loss_k - loss_p) / abs(loss_p), rel_l2(grad_k, grad_p)
    log(phase, loss_kernels=loss_k, loss_plain=loss_p, loss_rel=loss_rel,
        loss_bound=LOSS_REL_TOL, grad_rel_l2_kernels_vs_plain=grad_rel,
        grad_bound=MODEL_REL_TOL)
    if not (math.isfinite(loss_rel) and loss_rel <= LOSS_REL_TOL and grad_rel <= MODEL_REL_TOL
            and torch.isfinite(grad_k).all()):
        raise AssertionError(f"{phase}: step departs from the plain path: loss {loss_rel}, "
                             f"grad {grad_rel}")
    del run, trainer, pipe, params
    torch.cuda.empty_cache()
    return launches


def tiny_baselines_gpu_vs_cpu(dev):
    """Phase 11e: each baseline's tiny configuration (image hint, 4x the
    target's size; ControlNet-XS at control ratio 0.5) in fp32: one
    evaluation and one train step's loss and gradients on the GPU against
    the CPU, same weights and draws."""
    errs = {}
    for variant in (*BASELINES, "xs"):
        base = configs.tiny_test_config(hint_mode="image")
        ratio = {"control_model_ratio": 0.5} if variant == "xs" else {}  # 16 channels, D = 8
        cfg = dataclasses.replace(base, control=dataclasses.replace(base.control,
                                                                    variant=variant, **ratio))
        gen = torch.Generator().manual_seed(SEED)
        cpu = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
        for m in cpu.modules():
            random_init_(m, gen)
        gpu = CtrLoraPipeline(cfg, dev, fuse_lora=False)
        for a, b in zip(gpu.modules(), cpu.modules()):
            a.load_state_dict(b.state_dict(), strict=True)
        x = torch.randn((2, 8, 8, 4), generator=gen)
        ctx = torch.randn((2, cfg.clip.max_length, cfg.clip.hidden_size), generator=gen)
        hint = torch.rand((2, 64, 64, 3), generator=gen)
        t = torch.tensor([17, 901])
        batch = {"jpg": torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1, "hint": hint,
                 "token_ids": torch.randint(1, cfg.clip.vocab_size, (2, cfg.clip.max_length),
                                            generator=gen)}
        draws = fixed_draws(gen, "cpu", 2, 8)
        outs = []
        for pipe, d in ((cpu, "cpu"), (gpu, dev)):
            with torch.no_grad():
                out = pipe.apply_model(x.to(d), t.to(d), ctx.to(d), [Conditioning(hint.to(d))])
            tcfg = configs.TrainConfig(trainable="all")
            mask = train_state.trainable_mask(pipe, tcfg)
            train_state.make_optimizer(pipe, tcfg, mask)
            params = list(train_state.trainable_parameters(pipe, mask).values())
            loss, grad = step_grads(pipe, params, {k: v.to(d) for k, v in batch.items()},
                                        {k: v.to(d) for k, v in draws.items()})
            outs.append((out.cpu(), torch.tensor([loss]), grad.cpu()))
        errs[variant] = max(compare(g, c, rtol=2e-3, atol=2e-4) for g, c in zip(outs[1], outs[0]))
    log("tiny_baselines", gpu_vs_cpu_max_abs_err=errs, tol="rtol=2e-3 atol=2e-4")


def baselines_slice(dev):
    """Phase 11: vanilla and Lite sampling (11a, 11b), train_cn for both
    from PNG files (11c from an fp16 control file, 11d from the seeded
    init), and the tiny GPU-vs-CPU checks (11e). The files are deleted at
    the end. Returns the launches of each run."""
    launches = {f"sample_{v}": baseline_sampling(dev, v) for v in BASELINES}
    root = os.path.join(ROOT, "runs", "chip_smoke_baselines")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        custom, _ = write_cli_datasets(root, np.random.default_rng(SEED + 11))
        cn_file = os.path.join(root, "control_sd15.ckpt")
        written = write_control_file(configs.sd15_config(), dev, cn_file,
                                     torch.Generator(device=dev).manual_seed(SEED + 13))
        sd_file = os.path.join(root, "sd15.ckpt")
        src = CtrLoraPipeline(configs.sd15_config(), dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 14)
        for m in (src.unet, src.vae, src.clip):
            random_init_(m, gen)
        sd_keys = len(write_sd_file(configs.sd15_config(), src, sd_file))
        del src
        log("train_cn", write_s=time.perf_counter() - t0, control_file_keys=len(written),
            hint_block_keys=sum(".input_hint_block." in k for k in written), sd_file_keys=sd_keys)
        launches["train_controlnet"] = baseline_train(dev, "controlnet", custom, root, sd_file,
                                                      cn_file, written)
        launches["train_lite"] = baseline_train(dev, "lite", custom, root, sd_file)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tiny_baselines_gpu_vs_cpu(dev)
    return launches


# ---------------------------------------------------------------------------
# phase 12: ControlNet-XS (sampling, train_cn --variant xs)
# ---------------------------------------------------------------------------

XS_CONFIG = os.path.join("configs", "cnxs_sd15.yaml")
XS_SAMPLING_KERNELS = ("group_norm", "flash_attention_qkv", "flash_attention", "geglu_ffn")
# the widths each kernel must run at on the XS path: the control stream's
# (0.2x: 64/128/256 channels, 8 heads of 8/16/32, and the `cat` infusion's
# 384/768/1536-channel GroupNorms)
XS_WIDTHS = {"group_norm": {64, 128, 256, 384, 768, 1536},
             "flash_attention_qkv": {8, 16, 32}, "geglu_ffn": {64, 128, 256}}
XS_TRAIN_WIDTHS = {**XS_WIDTHS, "flash_attention_bwd_dq": {8, 16, 32},
                   "flash_attention_bwd_dkv": {8, 16, 32}}


@contextlib.contextmanager
def launch_widths():
    """Count the kernel launches of the block by kernel and the width each
    ran at (A: channels, B and B4/B5: head dim, C: C), read off the
    wrappers' launch helpers (which run only where a kernel launches);
    yields {kernel: {width: launches}}."""
    seen: dict = {}

    def note(name, width):
        seen.setdefault(name, {}).setdefault(int(width), 0)
        seen[name][int(width)] += 1

    real_gn, real_fwd = gn_ops._launch, fa_ops._launch_forward
    real_bwd, real_up = fa_ops._check_bwd, geglu_ops.launch_up

    def gn_launch(entry, plan_fn, what, x, *a):
        note(what, x.shape[-1])
        return real_gn(entry, plan_fn, what, x, *a)

    def fwd_launch(what, ptrs, shape, *a):
        note(what, shape[4])
        return real_fwd(what, ptrs, shape, *a)

    def bwd_check(what, tensors, *a):
        note(what, tensors[0].shape[-1])
        return real_bwd(what, tensors, *a)

    def up_launch(x, *a):
        note("geglu_ffn", x.shape[-1])
        return real_up(x, *a)

    with mock.patch.object(gn_ops, "_launch", gn_launch), \
            mock.patch.object(fa_ops, "_launch_forward", fwd_launch), \
            mock.patch.object(fa_ops, "_check_bwd", bwd_check), \
            mock.patch.object(geglu_ops, "launch_up", up_launch):
        yield seen


def missing_widths(seen, required) -> dict:
    """{kernel: widths of `required` that `seen` (``launch_widths``) lacks}."""
    out = {k: sorted(ws - set(seen.get(k, {}))) for k, ws in required.items()}
    return {k: ws for k, ws in out.items() if ws}


def write_xs_files(cfg, pipe, root):
    """The XS pipeline's base stream, VAE and CLIP as an fp16 SD-format file,
    and its control stream, zero convs and hint encoder as an fp16 control
    file (TwoStreamControlNet's keys). Returns (paths, written)."""
    paths = {"sd": os.path.join(root, "sd15.ckpt"), "cn": os.path.join(root, "cnxs_sd15.ckpt")}
    sd = write_sd_file(cfg, pipe, paths["sd"])
    cn = as_file(ckpt_torch.export_tree(pipe.unet.state_dict(),
                                        ckpt_torch.xs_control_entries(cfg)))
    torch.save(cn, paths["cn"])
    return paths, {"sd": sd, "cn": cn}


def xs_loaded_equal(unet_state, written, cfg) -> int:
    """Every base and control tensor of an XS UNet state equals the files'
    (fp16 widened exactly); returns the count, or raises."""
    pairs = sd_pairs({"unet": unet_state}, written["sd"], cfg)
    if written.get("cn") is not None:
        pairs += [(k, v, written["cn"][k]) for k, v in ckpt_torch.export_tree(
            unet_state, ckpt_torch.xs_control_entries(cfg)).items()]
    bad = differing(pairs)
    if bad:
        raise AssertionError(f"XS: loaded tensors differ from the files: {bad[:5]}")
    return len(pairs)


def xs_sampling(dev, root, phase4_s_batch):
    """Phase 12a. Returns (launches, the config, the files' paths and
    contents)."""
    cfg = configs.load_model_config(os.path.join(ROOT, XS_CONFIG))
    if cfg != configs.cnxs_config():
        raise AssertionError(f"{XS_CONFIG} reads as {cfg}, not the cnxs_sd15 preset")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    t0 = time.perf_counter()
    pipe = CtrLoraPipeline(cfg, dev)
    for m in pipe.modules():
        random_init_(m, gen)
    paths, written = write_xs_files(cfg, pipe, root)
    written_s = time.perf_counter() - t0
    states = load_ctrlora(pipe, paths["sd"])  # the base stream, VAE and CLIP from the file
    loaded = xs_loaded_equal(states.unet, {"sd": written["sd"]}, cfg)
    pipe.load_state_dicts(*states)
    pipe.cast_for_inference()
    torch.cuda.synchronize()
    n_ctrl = sum(p.numel() for n, p in pipe.unet.named_parameters()
                 if n.split(".")[0].startswith(train_state.XS_TRAINABLE_PREFIXES))
    log("xs_sampling", config=XS_CONFIG, config_equals_preset=True, setup_s=time.perf_counter()
        - t0, files_written_s=written_s, sd_tensors_loaded_equal_file=loaded,
        xs_unet_params_m=sum(p.numel() for p in pipe.unet.parameters()) / 1e6,
        control_stream_params_m=n_ctrl / 1e6)
    lat = SIZE // 8
    ids = torch.ones((BATCH, cfg.clip.max_length), dtype=torch.long, device=dev)
    uncond = torch.zeros_like(ids)
    hint = torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
    x_T = torch.randn((BATCH, lat, lat, 4), generator=gen, device=dev)
    baseline_sample(pipe, ids, uncond, hint, x_T, steps=2)  # warm-up

    torch.cuda.reset_peak_memory_stats(dev)
    with counted("XS sampling", XS_SAMPLING_KERNELS) as launches, launch_widths() as widths:
        t0 = time.perf_counter()
        img, phases, ddim_launches = baseline_sample(pipe, ids, uncond, hint, x_T, STEPS)
        total = time.perf_counter() - t0
    lacking = missing_widths(widths, XS_WIDTHS)
    log("xs_sampling", steps=STEPS, batch=BATCH, size=SIZE, s_per_batch=total,
        phase4_s_per_batch=phase4_s_batch, ratio_to_phase4=total / phase4_s_batch,
        s_per_step=phases["ddim_s"] / STEPS, **phases, launches=launches,
        launches_per_evaluation={n: ddim_launches[n] / STEPS for n in wrappers()},
        launches_by_width=widths, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if lacking or launches["unpack_rows"]:
        raise AssertionError(f"XS sampling: no launch at widths {lacking}; row unpack "
                             f"{launches['unpack_rows']} times (none expected)")
    if tuple(img.shape) != (BATCH, SIZE, SIZE, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"XS: bad image, shape {tuple(img.shape)}")

    # one XS evaluation (the CFG batch): kernels vs plain versions
    ctx, unc = pipe.encode_text_cond_uncond(ids, uncond)
    full_ctx, conds = torch.cat([ctx, unc]), [Conditioning(torch.cat([hint, hint]))]
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)
    x2 = torch.cat([x_T, x_T])
    with launch_widths() as per_eval:
        out_k = pipe.apply_model(x2, tvec, full_ctx, conds)
    with plain_versions():
        out_p = pipe.apply_model(x2, tvec, full_ctx, conds)
    rel = rel_l2(out_k, out_p)
    log("xs_sampling", image_mean=img.mean().item(), image_std=img.std().item(),
        launches_by_width_per_evaluation=per_eval, xs_rel_l2_kernels_vs_plain=rel,
        bound=MODEL_REL_TOL)
    if not math.isfinite(rel) or rel > MODEL_REL_TOL:
        raise AssertionError(f"XS: kernel path departs from the plain path: rel {rel}")
    del pipe, states
    torch.cuda.empty_cache()
    return launches, cfg, paths, written


def xs_train(dev, cfg, custom, root, paths, written, phase6_s_step):
    """Phase 12b: train_cn --variant xs from the SD and XS control files.
    Returns the run's launches."""
    phase = "train_cn_xs"
    steps = CN_WARMUP + CN_TIMED
    argv = ["--variant", "xs", "--config", os.path.join(ROOT, XS_CONFIG), "--dataroot", custom,
            "--sd_ckpt", paths["sd"], "--cn_ckpt", paths["cn"], "--bs", str(BATCH),
            "--max_steps", str(steps), "--use_ema", "--log_every", "1", "--ckpt_logger_freq",
            str(steps), "--img_logger_freq", str(steps), "--num_workers", "8", "--device",
            str(dev), "-n", os.path.join(root, "xs")]
    torch.cuda.reset_peak_memory_stats(dev)
    with cli_spies(("unet",)) as rec, \
            counted("train_cn xs", BASELINE_TRAINING_KERNELS) as launches, \
            launch_widths() as widths:
        t0 = time.perf_counter()
        run = train_cn_mod.main(argv)
        total = time.perf_counter() - t0
    s_step, lines = timed_steps(run.workdir, CN_WARMUP)
    trainer, pipe = run.trainer, run.trainer.pipe
    hook = cli_metrics(run.workdir, "image_log")
    bwd = {k: {d: n / steps for d, n in widths.get(k, {}).items()}
           for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    initial = {k[len("unet."):]: v for k, v in rec["initial"].items()}
    loaded = xs_loaded_equal(initial, written, pipe.cfg)
    log(phase, batch=BATCH, size=SIZE, steps=steps, total_s=total, load_s=run.seconds["load"],
        loader_wait_s=run.loader.wait_s,
        trainable_params_m=sum(p.numel() for p in trainer.state.trainable.values()) / 1e6,
        s_per_step=s_step, phase6_s_per_step=phase6_s_step, ratio_to_phase6=s_step / phase6_s_step,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        launches_per_step=per_step_launches(rec["steps"][CN_WARMUP:], wrappers()),
        flash_bwd_launches_per_step_by_head_dim=bwd, launches_by_width=widths,
        hook_s=hook[0]["seconds"] if hook else None, loss=[ln["loss"] for ln in lines],
        grad_norm=[ln["grad_norm"] for ln in lines], launches=launches)
    train = cli_metrics(run.workdir, "train")
    lacking = missing_widths(widths, XS_TRAIN_WIDTHS)
    if len(train) != steps or not all(math.isfinite(ln["loss"]) and ln["grad_norm"] > 0
                                      for ln in train) or lacking:
        raise AssertionError(f"{phase}: bad metrics {train}, no launch at widths {lacking}")
    changed, unchanged = check_weights(pipe, trainer, rec["initial"])
    png = png_shape(hook[0]["path"]) if hook else None
    log(phase, loaded_tensors_equal_files=loaded, frozen_base_bit_identical=not changed,
        trainable_changed=len(trainer.state.trainable) - len(unchanged),
        trainable_unchanged=unchanged, image_log_shape=png)
    if changed or unchanged or png != [48 + 3 * SIZE, 2 * SIZE, 3]:
        raise AssertionError(f"{phase}: frozen changed {changed[:5]}, trainable unchanged "
                             f"{unchanged[:5]}, image log {png}")
    del rec
    shutil.rmtree(os.path.join(root, "xs"), ignore_errors=True)  # the checkpoint

    # one step's loss and gradients: kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    batch = synthetic_batch(gen, dev, BATCH, SIZE, pipe.cfg.clip.max_length,
                            pipe.cfg.clip.vocab_size)
    draws = fixed_draws(gen, dev, BATCH, SIZE // 8)
    params = list(trainer.state.trainable.values())
    loss_k, grad_k = step_grads(pipe, params, batch, draws)
    with plain_versions():
        loss_p, grad_p = step_grads(pipe, params, batch, draws)
    loss_rel, grad_rel = abs(loss_k - loss_p) / abs(loss_p), rel_l2(grad_k, grad_p)
    log(phase, loss_kernels=loss_k, loss_plain=loss_p, loss_rel=loss_rel,
        loss_bound=LOSS_REL_TOL, grad_rel_l2_kernels_vs_plain=grad_rel,
        grad_bound=MODEL_REL_TOL)
    if not (math.isfinite(loss_rel) and loss_rel <= LOSS_REL_TOL and grad_rel <= MODEL_REL_TOL
            and torch.isfinite(grad_k).all()):
        raise AssertionError(f"{phase}: step departs from the plain path: loss {loss_rel}, "
                             f"grad {grad_rel}")
    del run, trainer, pipe, params
    torch.cuda.empty_cache()
    return launches


def xs_slice(dev, phase4_s_batch, phase6_s_step):
    """Phase 12: XS sampling (12a) and train_cn --variant xs (12b) from the
    files 12a writes. The files are deleted at the end. Returns the
    launches of each run."""
    root = os.path.join(ROOT, "runs", "chip_smoke_xs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        launches, cfg, paths, written = xs_sampling(dev, root, phase4_s_batch)
        runs = {"sample_xs": launches}
        custom, _ = write_cli_datasets(root, np.random.default_rng(SEED + 20))
        runs["train_xs"] = xs_train(dev, cfg, custom, root, paths, written, phase6_s_step)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs


# ---------------------------------------------------------------------------
# phase 13: style transfer with IP-Adapter
# ---------------------------------------------------------------------------

STYLE_CONFIG = os.path.join("configs", "inference", "ctrlora_style_sd15_rank128_1lora.yaml")
STYLE_VISION = ip_adapter.CLIPVisionConfig()  # ViT-H/14, the IP-Adapter's image encoder
STYLE_TEXT = style_mod.VITH_TEXT_PROJECTED  # the negative-content text tower
STYLE_IMAGE_HW = (480, 640)  # the style image: 640 x 480
STYLE_I2I_STEPS, STYLE_STRENGTH = 20, 0.8
NEG_CONTENT = "a photo of a house"
STYLE_KERNELS = SAMPLING_KERNELS
# the tiny style configuration of the GPU-against-CPU check
TINY_VISION = ip_adapter.CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                          intermediate_size=64, num_layers=2, num_heads=2,
                                          projection_dim=16)


def is_ip_key(key: str) -> bool:
    return "_ip." in key or key.endswith("ip_scale")


def write_style_files(cfg, dev, root, gen, vision_cfg, text_cfg, dtype=torch.float16):
    """Seeded random weights as the style path's files in `dtype`: SD, Base
    ControlNet and one LoRA (``write_reference_files``; the SD file has no
    image-prompt keys), the IP-Adapter file in its published nested form
    ({'image_proj': ..., 'ip_adapter': {'{2j+1}.to_{k,v}_ip.weight'}}), the
    HF-named vision tower and, with `text_cfg`, the HF-named text tower with
    its projection. Returns (paths, written)."""
    src = CtrLoraPipeline(cfg, dev)
    for m in src.modules():
        random_init_(m, gen)
    paths, written = write_reference_files(
        src, unfused_control_state(src.control, cfg.control.lora, gen), cfg, root, dtype)
    randn = lambda shape, std: (torch.randn(shape, generator=gen, device=dev) * std).to(
        "cpu", dtype)
    ip_sd = {}
    for j, site in enumerate(ip_adapter.ip_attn_sites(cfg.unet)):
        for name in ("to_k_ip", "to_v_ip"):
            shape = getattr(src.unet.get_submodule(".".join(site)), name).weight.shape
            ip_sd[f"{2 * j + 1}.{name}.weight"] = randn(shape, shape[1] ** -0.5)
    del src
    d, n, e = cfg.unet.context_dim, cfg.unet.ip_tokens, vision_cfg.projection_dim
    proj_sd = {"proj.weight": randn((n * d, e), e ** -0.5), "proj.bias": randn((n * d,), 0.02),
               "norm.weight": 1 + randn((d,), 0.1), "norm.bias": randn((d,), 0.02)}
    written["ip"] = {"image_proj": proj_sd, "ip_adapter": ip_sd}
    paths["ip"] = os.path.join(root, "ip-adapter_sd15.bin")
    torch.save(written["ip"], paths["ip"])
    with torch.device(dev):
        vision = ip_adapter.CLIPVisionModel(vision_cfg)
    random_init_(vision, gen)
    vstate = vision.state_dict()
    written["vision"] = {hf: vstate[k].detach().to("cpu", dtype)
                         for k, hf in ip_adapter.clip_vision_keys(vision_cfg).items()}
    paths["vision"] = os.path.join(root, "image_encoder.bin")
    torch.save(written["vision"], paths["vision"])
    del vision, vstate
    if text_cfg is not None:
        with torch.device(dev):
            text = CLIPTextModel(text_cfg)
        random_init_(text, gen)
        tsd = as_file(ckpt_torch.export_tree(text.state_dict(), ckpt_torch.clip_entries(text_cfg),
                                             "text_model."), dtype)
        tsd["text_projection.weight"] = text.text_projection.weight.detach().to("cpu", dtype)
        paths["text"] = os.path.join(root, "text_encoder.bin")
        torch.save(tsd, paths["text"])
        del text, tsd
    return paths, written


def style_loaded_equal(st, written, cfg, vision_cfg) -> int:
    """The UNet's image-prompt projections equal the file's as their (bf16)
    parameters hold it, the image projection and the vision tower the
    file's fp16 widened exactly; returns the count, or raises."""
    pairs = []
    for j, site in enumerate(ip_adapter.ip_attn_sites(cfg.unet)):
        attn = st.pipe.unet.get_submodule(".".join(site))
        for name in ("to_k_ip", "to_v_ip"):
            w = getattr(attn, name).weight
            pairs.append((f"{'.'.join(site)}.{name}", w,
                          written["ip"]["ip_adapter"][f"{2 * j + 1}.{name}.weight"].to(w.dtype)))
    proj = st.image_proj.state_dict()
    pairs += [(f"image_proj.{k}", proj[k], v.float()) for k, v in written["ip"]["image_proj"].items()]
    vstate = st.vision.state_dict()
    pairs += [(k, vstate[k], written["vision"][hf].float())
              for k, hf in ip_adapter.clip_vision_keys(vision_cfg).items()]
    bad = [k for k, got, want in pairs if not torch.equal(got.cpu(), want)]
    if bad or len(vstate) != len(written["vision"]):
        raise AssertionError(f"style: loaded tensors differ from the files: {bad[:5]}")
    return len(pairs)


def ip_scales(st, cfg) -> dict:
    """{site: its ip_scale}, sites in ip_layers order."""
    return {".".join(s): st.pipe.unet.get_submodule(".".join(s)).ip_scale.item()
            for s in ip_adapter.ip_attn_sites(cfg.unet)}


def timed(fn, dev):
    """(fn(), its wall ms, ended by a synchronise)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def ip_branch_ms(evaluate):
    """The image-prompt branch of one evaluation (every attn2's to_k_ip /
    to_v_ip, plain attention over the image tokens and the scaled add), its
    calls captured from `evaluate()` and replayed: the device ms and device
    kernels of one replay (torch.profiler), the ms a replay of 20 queued
    back to back behind a sleep kernel (the host's launch time where it
    exceeds the device's), and the captured query shapes."""
    calls, real = [], CrossAttention._add_ip

    def spy(self, out, q, ip_ctx):
        if ip_ctx is not None:
            calls.append((self, torch.zeros_like(out), q, ip_ctx))
        return real(self, out, q, ip_ctx)

    with mock.patch.object(CrossAttention, "_add_ip", spy):
        evaluate()
    replay = lambda: [real(a, o, q, c) for a, o, q, c in calls]
    return {"device_ms": device_ms(replay), "device_kernels": device_kernels(replay),
            "b2b_ms": time_b2b(replay), "query_shapes": [list(q.shape) for _, _, q, _ in calls]}


def tiny_style_gpu_vs_cpu(dev):
    """The tiny configuration with 4 image-prompt tokens (and the real CLIP
    vocabulary) as a StyleCtrLoRA from tiny fp32 files: the style tokens and
    a guided 3-step txt2img sample, fp32 on the GPU against the CPU."""
    cfg = configs.tiny_test_config(n_loras=1, switchable_banks=True)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, ip_tokens=4),
                              clip=dataclasses.replace(cfg.clip, vocab_size=49408))
    root = os.path.join(ROOT, "runs", "chip_smoke_tiny_style")
    shutil.rmtree(root, ignore_errors=True)
    paths, _ = write_style_files(cfg, torch.device("cpu"), root,
                                 torch.Generator().manual_seed(SEED), TINY_VISION, None,
                                 torch.float32)
    rng = np.random.default_rng(SEED)
    hint = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    style = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
    outs = []
    for d in (torch.device("cpu"), dev):
        st = style_mod.StyleCtrLoRA(1, cfg=cfg, vision_cfg=TINY_VISION, device=d)
        st.create_model(paths["sd"], paths["basecn"], paths["loras"])
        st.load_ip_adapter(paths["ip"], image_encoder_ckpt=paths["vision"])
        tokens = st.embed_style(style)
        outs.append((tokens.cpu(), st._sample_style_float((hint,), tokens, PROMPT, N_PROMPT, 2, 3,
                                                          7.5, (1.0,), SEED).cpu()))
    shutil.rmtree(root, ignore_errors=True)
    tok_err = compare(outs[1][0], outs[0][0], rtol=2e-3, atol=2e-4)
    err = compare(outs[1][1], outs[0][1], rtol=2e-3, atol=2e-4)
    log("tiny_style", tokens_gpu_vs_cpu_max_abs_err=tok_err, gpu_vs_cpu_max_abs_err=err,
        shape=list(outs[0][1].shape), tol="rtol=2e-3 atol=2e-4")


def style_slice(dev, phase4_s_batch):
    """Phase 13: StyleCtrLoRA at SD1.5 width from fp16 files of seeded
    weights. Returns the launches of the timed txt2img run."""
    cfg = configs.load_model_config(os.path.join(ROOT, STYLE_CONFIG))
    if cfg != style_mod.style_config(1, 128, 4):
        raise AssertionError(f"{STYLE_CONFIG} reads as {cfg}, not style_config(1, 128, 4)")
    root = os.path.join(ROOT, "runs", "chip_smoke_style")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        return _style_slice(dev, cfg, root, phase4_s_batch)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _style_slice(dev, cfg, root, phase4_s_batch):
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    t0 = time.perf_counter()
    paths, written = write_style_files(cfg, dev, root, gen, STYLE_VISION, STYLE_TEXT)
    log("style", config=STYLE_CONFIG, config_equals_style_config=True,
        write_s=time.perf_counter() - t0,
        file_gb={k: os.path.getsize(paths[k]) / 2 ** 30 for k in ("sd", "ip", "vision", "text")})

    # loading: the style blocks only, then every site
    st = style_mod.StyleCtrLoRA(1, cfg=cfg, vision_cfg=STYLE_VISION, neg_text_cfg=STYLE_TEXT,
                                device=dev)
    create_s, n_ref = create_checked(st, paths, written, cfg)
    _, ip_load_ms = timed(lambda: st.load_ip_adapter(
        paths["ip"], ip_scale=1.0, target="style_blocks", image_encoder_ckpt=paths["vision"]), dev)
    n_style = style_loaded_equal(st, written, cfg, STYLE_VISION)
    targets = ip_adapter.IP_SCALE_TARGETS["style_blocks"]
    scales = ip_scales(st, cfg)
    on = [k for k in scales if any(k.startswith(t[0] + ".") for t in targets)]
    wrong = {k: v for k, v in scales.items() if v != (1.0 if k in on else 0.0)}
    log("style", create_model_s=create_s, load_ip_adapter_s=ip_load_ms / 1e3,
        loaded_tensors_equal_files=n_ref + n_style,
        ip_scale_on=len(on), ip_scale_off=len(scales) - len(on), ip_scale_wrong=wrong)
    if wrong or not on:
        raise AssertionError(f"style_blocks: ip_scale wrong at {wrong}")
    st.load_ip_adapter(paths["ip"], ip_scale=1.0, target="all")
    if set(ip_scales(st, cfg).values()) != {1.0}:
        raise AssertionError("target='all' left a site's ip_scale other than 1")

    # the style embedding, with and without the negative content
    rng = np.random.default_rng(SEED + 13)
    style = rng.integers(0, 256, (*STYLE_IMAGE_HW, 3), dtype=np.uint8)
    _, first_ms = timed(lambda: st.embed_style(style), dev)
    tokens, embed_ms = timed(lambda: st.embed_style(style), dev)
    neg, neg_ms = timed(lambda: st.embed_neg_content(NEG_CONTENT, paths["text"], 1.0), dev)
    tokens_neg = st.embed_style(style, neg, 1.0)
    rel_neg = rel_l2(tokens_neg, tokens)
    finite = all(bool(torch.isfinite(t).all()) for t in (tokens, neg, tokens_neg))
    log("style", embed_style_ms=embed_ms, embed_style_first_ms=first_ms,
        embed_neg_content_ms_with_file_read=neg_ms, neg_content_shape=list(neg.shape),
        tokens_shape=list(tokens.shape),
        tokens_neg_shape=list(tokens_neg.shape), finite=finite,
        rel_l2_tokens_neg_vs_plain=rel_neg)
    want = [1, cfg.unet.ip_tokens, cfg.unet.context_dim]
    if list(tokens.shape) != want or list(tokens_neg.shape) != want or not finite \
            or not rel_neg > 1e-3:
        raise AssertionError(f"style tokens: {list(tokens.shape)}, finite {finite}, "
                             f"negative content moved them {rel_neg}")
    del neg, tokens_neg

    # txt2img at batch 4 and 512^2, 50 steps, then img2img
    hint = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    run = lambda steps, timings=None, **kw: st._sample_style_float(
        (hint,), tokens, PROMPT, N_PROMPT, BATCH, steps, 7.5, (1.0,), SEED, timings=timings, **kw)
    t0 = time.perf_counter()
    run(2)  # warm-up
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    with counted("style", STYLE_KERNELS) as launches:
        timings = {}
        t0 = time.perf_counter()
        img = run(STEPS, timings)
        total = time.perf_counter() - t0
    step_ms = timings["ddim_s"] / STEPS * 1e3
    log("style", steps=STEPS, batch=BATCH, size=SIZE, warmup_s=warm, s_per_batch=total,
        phase4_s_per_batch=phase4_s_batch, ratio_to_phase4=total / phase4_s_batch,
        s_per_step=timings["ddim_s"] / STEPS, **timings, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        image_shape=list(img.shape), image_finite=bool(torch.isfinite(img).all()),
        image_mean=img.float().mean().item(), image_std=img.float().std().item())
    if tuple(img.shape) != (BATCH, SIZE, SIZE, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"style: bad image, shape {tuple(img.shape)}")
    content = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    timings = {}
    t0 = time.perf_counter()
    img2 = run(STYLE_I2I_STEPS, timings, img2img_image=content,
               img2img_strength=STYLE_STRENGTH)
    log("style", img2img_steps=STYLE_I2I_STEPS, strength=STYLE_STRENGTH,
        denoising_steps=int(STYLE_I2I_STEPS * STYLE_STRENGTH),
        s_per_batch=time.perf_counter() - t0, **timings, image_shape=list(img2.shape),
        image_finite=bool(torch.isfinite(img2).all()))
    if tuple(img2.shape) != (BATCH, SIZE, SIZE, 3) or not torch.isfinite(img2).all():
        raise AssertionError(f"style img2img: bad image, shape {tuple(img2.shape)}")
    del img, img2

    # one UNet + ControlNet evaluation of the guidance batch with image tokens
    pipe = st.pipe
    ctx, unc = pipe.encode_text_cond_uncond(st.token_ids(PROMPT, BATCH),
                                            st.token_ids(N_PROMPT, BATCH))
    conds = st.conditions([hint], BATCH, (1.0,))
    conds2 = [dataclasses.replace(c, hint=torch.cat([c.hint, c.hint])) for c in conds]
    full_ctx = torch.cat([ctx, unc])
    lat = SIZE // 2 ** (len(cfg.vae.ch_mult) - 1)
    x = torch.randn((BATCH, lat, lat, 4), generator=gen, device=dev)
    x2 = torch.cat([x, x])
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * BATCH,), 981, dtype=torch.int32, device=dev)
    zero = st.embed_style_tokens_zero(BATCH)
    cond_ip = tokens.repeat_interleave(BATCH, dim=0)
    ip_of = lambda tok: torch.cat([tok.repeat_interleave(BATCH, dim=0), zero])

    def evaluate(tok=tokens):
        packed, rows_of = make_emb_row_tables(pipe, conds2, ts)
        return pipe.apply_model(x2, tvec, full_ctx, conds2, emb_rows=rows_of(packed[0]),
                                ip_context=ip_of(tok))

    before = counts_now()
    out_k = evaluate()
    torch.cuda.synchronize(dev)
    per_eval = counts_since(before)
    with plain_versions():
        out_p = evaluate()
    rel = rel_l2(out_k, out_p)
    other = st.embed_style(rng.integers(0, 256, (*STYLE_IMAGE_HW, 3), dtype=np.uint8))
    rel_style = rel_l2(evaluate(other), out_k)
    eps = lambda u: make_guided_eps_fn(pipe, ctx, unc, conds, 7.5, ip_context=cond_ip,
                                       uncond_ip_context=u)(x, 981)
    rel_uncond = rel_l2(eps(zero), eps(None))
    ip = ip_branch_ms(evaluate)
    log("style", launches_per_evaluation=per_eval, rel_l2_kernels_vs_plain=rel,
        bound=MODEL_REL_TOL, rel_l2_other_style_tokens=rel_style,
        rel_l2_uncond_tokens_zero_proj_vs_cond=rel_uncond,
        ip_branch_per_step={k: v for k, v in ip.items() if k != "query_shapes"},
        ip_branch_device_share_of_step_wall=ip["device_ms"] / step_ms,
        ip_branch_query_shapes=ip["query_shapes"])
    if not math.isfinite(rel) or rel > MODEL_REL_TOL or not rel_style > 1e-3 \
            or not rel_uncond > 1e-3:
        raise AssertionError(f"style evaluation: kernels vs plain {rel}, other tokens "
                             f"{rel_style}, uncond tokens {rel_uncond}")

    # ip_scale 0 everywhere against a UNet without image tokens on the text alone
    for s in ip_adapter.ip_attn_sites(cfg.unet):
        pipe.unet.get_submodule(".".join(s)).ip_scale.data.fill_(0.0)
    with dev:
        unet0 = UNet(dataclasses.replace(cfg.unet, ip_tokens=0))
    unet0.load_state_dict({k: v for k, v in pipe.unet.state_dict().items()
                           if not is_ip_key(k)}, strict=True)
    lora_fuse.cast_params_for_inference(unet0, cfg.unet.compute_dtype)
    to_channels_last(unet0.eval().requires_grad_(False))
    with torch.no_grad():
        packed, rows_of = make_emb_row_tables(pipe, conds2, ts)
        rows = rows_of(packed[0])
        taps = pipe.apply_control(x2, tvec, full_ctx, conds2, emb_rows=rows["control"])
        with_ip = pipe.unet(x2, tvec, torch.cat([full_ctx, ip_of(tokens)], dim=1),
                            control=taps, emb_rows=rows["unet"])
        text_only = unet0(x2, tvec, full_ctx, control=taps, emb_rows=rows["unet"])
    rel0 = rel_l2(with_ip, text_only)
    log("style", rel_l2_ip_scale0_vs_text_only_unet=rel0, bound=MODEL_REL_TOL)
    if not math.isfinite(rel0) or rel0 > MODEL_REL_TOL:
        raise AssertionError(f"ip_scale 0 departs from the text-only UNet: rel {rel0}")
    del st, pipe, unet0, written
    torch.cuda.empty_cache()
    tiny_style_gpu_vs_cpu(dev)
    return launches


def build_gates(dev) -> None:
    """The build phase's gates on the kernels just built: C, B6 and B4/B5
    run on wgmma (HGMMA) and nothing older (HMMA); B6 and B4/B5 spill
    nothing and ptxas serialises none of their wgmmas for accumulator
    accesses (C7514/C7515: a plain instruction touching an accumulator
    inside a batch); A (and so A2, the same kernel) and D spill nothing;
    A's, A2's, B6's and B4/B5's tilings are what their Python mirrors say,
    with the waves A2's plan makes; and D's layout holds as many rows as
    its Python mirror says."""
    for what, name in (("geglu", "geglu"), ("flash_bwd", "flash_bwd"),
                       ("flash_hpack2", "flash_hpack2")):
        sass = _build.sass_opcodes(("HGMMA", "HMMA"), name)
        log("build", **{f"{what}_sass": sass})
        if not sass or any(n["HGMMA"] == 0 or n["HMMA"] for n in sass.values()):
            raise AssertionError(f"{what} kernels without HGMMA or with HMMA: {sass}")
    serialized = _build.serialized_kernels()
    log("build", wgmma_serialized=serialized)
    touched = {n: c for n, c in serialized.items()
               if ("flash_bwd" in n or "flash_hpack2" in n) and {"C7514", "C7515"} & set(c)}
    if touched:
        raise AssertionError(f"B4/B5/B6 wgmmas serialised by accumulator accesses: {touched}")
    spilled = {name: _build.spilling_kernels(name)
               for name in ("flash_bwd", "flash_hpack2", "gn_cluster", "unpack_rows")}
    log("build", spills=spilled)
    if any(spilled.values()):
        raise AssertionError(f"B4/B5, B6, A/A2 or D spill registers: {spilled}")

    lib = _build.cuda_lib()
    configs_c = {}
    for d in fa_ops.BWD_HEAD_DIMS:
        for dkv in (True, False):
            out = (ctypes.c_int * 5)()
            _build.check(lib.ctrlora_flash_bwd_config(d, int(dkv), out), "ctrlora_flash_bwd_config")
            plan = fa_ops.flash_bwd_plan(d, dkv)
            configs_c[f"{'dkv' if dkv else 'dq'} D={d}"] = got = list(out)
            if got != [plan.rows, plan.tile, plan.stages, plan.smem_bytes, int(plan.split)]:
                raise AssertionError(f"flash_bwd_plan({d}, {dkv}) = {plan}, the kernel: {got}")
    for d in fa_ops.HPACK2_HEAD_DIMS:
        out = (ctypes.c_int * 5)()
        _build.check(lib.ctrlora_flash_hpack2_config(d, out), "ctrlora_flash_hpack2_config")
        plan = fa_ops.hpack2_plan(d)
        configs_c[f"hpack2 D={d}"] = got = list(out)
        if got != plan.as_list():
            raise AssertionError(f"hpack2_plan({d}) = {plan}, the kernel: {got}")
    log("build", flash_bwd_hpack2_config=configs_c)
    # A: the kernel's plan at every shape phase 3 runs, beside how many of
    # its clusters the card holds at once (cudaOccupancyMaxActiveClusters)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gn_plans = []
    for shape, dt, *_ in GN_CASES:
        b, hw, c = shape[0], shape[1] * shape[2], shape[-1]
        item = torch.empty((), dtype=dt).element_size()
        out = (ctypes.c_int * 9)()
        _build.check(lib.ctrlora_group_norm_config(b, hw, c, 32, item, sms, out),
                     "ctrlora_group_norm_config")
        plan = gn_ops.group_norm_plan(b, hw, c, 32, item, sms)
        if list(out)[:8] != plan.as_list():
            raise AssertionError(f"group_norm_plan{(b, hw, c, 32, item, sms)} = {plan}, "
                                 f"the kernel: {list(out)[:8]}")
        gn_plans.append({"shape": list(shape), "dtype": str(dt)[6:], "blocks": plan.blocks(b),
                         "clusters": plan.blocks(b) // plan.cluster,
                         "max_active_clusters": out[8], **dataclasses.asdict(plan)})
    log("build", group_norm_plans=gn_plans)
    # A2: its plan at the shapes gn1=1 admits, at both batches, in bf16 and
    # in fp32 where admitted, and the waves it makes there
    onepass_plans = []
    for (hw, c), b, dt in ((s, b, dt) for s in ONEPASS_SHAPES for b in (8, 4)
                           for dt in (torch.bfloat16, torch.float32)):
        with kernel_flags.override(gn_onepass=True):
            if not gn_ops._onepass_ok(hw, c, dt, 32):
                continue
        item = torch.empty((), dtype=dt).element_size()
        out = (ctypes.c_int * 9)()
        _build.check(lib.ctrlora_group_norm_onepass_config(b, hw, c, 32, item, sms, out),
                     "ctrlora_group_norm_onepass_config")
        plan = gn_ops.group_norm_onepass_plan(b, hw, c, 32, item, sms)
        if list(out)[:8] != plan.as_list():
            raise AssertionError(f"group_norm_onepass_plan{(b, hw, c, 32, item, sms)} = {plan}, "
                                 f"the kernel: {list(out)[:8]}")
        clusters = plan.blocks(b) // plan.cluster
        onepass_plans.append({"shape": [b, hw, c], "dtype": str(dt)[6:], "clusters": clusters,
                              "max_active_clusters": out[8],
                              "waves": -(-clusters // out[8]) if out[8] else None,
                              **dataclasses.asdict(plan)})
    log("build", group_norm_onepass_plans=onepass_plans)
    if len({(p["shape"][1], p["shape"][2]) for p in onepass_plans}) != len(ONEPASS_SHAPES):
        raise AssertionError("gn1=1 does not admit every A2 shape in bf16")
    capacity = lib.ctrlora_unpack_rows_capacity()
    log("build", unpack_rows_capacity=capacity)
    if capacity != unpack_ops.UNPACK_MAX_ROWS:
        raise AssertionError(f"D's layout holds {capacity} rows, UNPACK_MAX_ROWS says "
                             f"{unpack_ops.UNPACK_MAX_ROWS}")


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
        ptxas_spills=spills)
    build_gates(dev)

    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    results = kernel_checks(dev, cfg)
    profile_steps = int(argv[argv.index("--profile") + 1]) if "--profile" in argv else 0
    sampling, pipe, inputs, phase4_s_batch = slice_run(dev, cfg, profile_steps)
    samplers = sampler_family(dev, pipe, *inputs)  # phase 9, on phase 4's pipeline
    del pipe, inputs
    torch.cuda.empty_cache()
    tiny_gpu_vs_cpu(dev)
    tiny_api_gpu_vs_cpu(dev)
    training, phase6_s_step = train_slice(dev, profile=bool(profile_steps))
    tiny_train_gpu_vs_cpu(dev)
    api_runs = api_slice(dev)
    torch.cuda.empty_cache()
    cli_runs = train_cli_slice(dev, phase6_s_step)
    baseline_runs = baselines_slice(dev)
    xs_runs = xs_slice(dev, phase4_s_batch, phase6_s_step)
    style_launches = style_slice(dev, phase4_s_batch)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        by_path = {"sampling": sampling[name], "samplers": samplers[name],
                   "training": training[name],
                   "api_2lora": sum(r[name] for r in api_runs.values()),
                   "train_cli": sum(r[name] for r in cli_runs.values()),
                   "baselines": sum(r[name] for r in baseline_runs.values()),
                   "xs": sum(r[name] for r in xs_runs.values()),
                   "style": style_launches[name]}
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
