#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: controlled
sampling, the sampler family (DDIM with eta, guess mode, ucg schedule and
mask; PLMS; DPM-Solver; img2img; DDIM inversion; the sample CLI's batch),
the rank-128 LoRA finetune step, the switchable two-LoRA CtrLoRA API from
reference-format checkpoints, the finetune and pretrain CLIs training
from dataset files, the ControlNet baselines (vanilla image-hint
ControlNet and ControlNet-Lite) sampling and training through train_cn,
ControlNet-XS sampling from configs/cnxs_sd15.yaml and training
through train_cn --variant xs, style transfer with IP-Adapter
(StyleCtrLoRA) from the style config file, the evaluation protocol:
the sample CLI's output scored by the evaluate_{control,restore,fid} CLIs,
and the apps' logic at their one-sample defaults, the CNN detectors and
the tools.

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
   differ. The files stay for phase 15;
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
   0.5). The datasets are deleted at the end, the SD and control files
   stay for phase 15;
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
   files stay for phase 15;
14. (after phase 13) evaluation: (a) the sample CLI's main at its defaults
   (DDIM 50, CFG 7.5, --bs 4, 512^2) on fp16 reference-format files and a
   CustomDataset of 8 seeded items: s/batch, files written, its launches
   per model evaluation in the sampler and per batch outside it, equal to
   phase 9's sample CLI batch; (b) seeded files in the published layouts
   at the published widths (pt_inception with BN buffers; VGG16 features +
   lpips lin heads; an HF CLIPModel at clip-vit-large-patch14's widths)
   and evaluate_control --detector canny, evaluate_restore (both with
   LPIPS and CLIPScore) and evaluate_fid on sample/ against img/: the
   printed metrics (finite, LPIPS >= 0, CLIPScore in [0, 100]), seconds,
   images/s, peak memory, and no hand-written kernel launched; (c) LPIPS
   at [64, 512, 512, 3] pairs, Inception at [32, 299, 299, 3], CLIP's
   towers and the CLIPScorer call at 64 images, SSIM at [64, 512, 512, 3]
   and a T5 v1.1-large encode of [4, 77] ids, back to back: ms, images/s,
   fp32 FLOPs (torch.utils.flop_counter) and the share of the H100's 67
   TFLOP/s fp32 peak (TF32 off); (d) those models on the card against
   copies on the CPU on small seeded inputs (rtol 1e-4 / atol 1e-5, CLIP
   scores atol 1e-3), and the TF32 guard restoring the caller's flags; (e)
   lpips(a, a) and ssim(a, a) at full width (within 1e-6 of 0 and 1), the
   FID of the samples against themselves (within 1e-3 of tr(C), timed on
   the host) below their FID against img/. The files are deleted at the
   end;
15. (last) the apps, the tools and the CNN detectors: (a) kernels A, B
   (fused qkv at D = 40/80/160, the VAE's BHSD D = 512), C at its four
   sites and D at the one- and two-LoRA step tables, at the app's
   one-sample shapes (CFG batch 2, the VAE at one sample), each against its
   plain version as in phase 3; (b) apps/logic at the app's defaults (one
   sample, 20 DDIM steps, CFG 7.5, 512^2, detector canny) from the files
   phases 8, 11 and 13 leave: AppState.process with guess mode off and on
   (s a call, launches, the decoded image against the plain versions',
   one evaluation within relative L2 5e-2 of plain), process2 with two
   LoRAs, process_controlnet on phase 11's SD and control files and
   process_style on phase 13's files, each timed with its launches; (c)
   each ported CNN detector (hed, hedsketch, lineart fine and coarse,
   lineart_anime, its colour prompt, mlsd, midas with depth and normal on
   DPT-Large, seg on UniFormer-S + UPerNet, openpose, pidinet, bbox on a
   darknet YOLO cfg of every section kind with three heads at strides
   8/16/32, densepose on R_101_FPN_DL) through the registry on the card at
   512^2 from seeded files in the published layouts and widths (YOLO's
   objectness and DensePose's person bias tuned to the image on the card,
   so that a few boxes pass): ms an image, fp32 GFLOP and share of the
   fp32 peak, the map against the same detector on the CPU (seg's logits,
   OpenPose's heatmaps and PAFs, the raw yolo maps within rtol 1e-4, the
   same boxes; DensePose stage by stage on the CPU's inputs, FPN, RPN, box
   head, decoder, ROIAlign and chart head within rtol 1e-4, the proposals
   differing counted, 1-10 persons, and the card alone at MAX_DET
   persons), OpenPose's body net alone, its hand net at its four scales
   and face net at 384^2 against the CPU, the detector with hands and
   faces, on the seeded body's maps and on a drawn person's,
   apps_logic.detect for depth, normal, seg, openpose, bbox and densepose,
   no hand-written kernel launched; (d) the tools at
   SD1.5 width: tool_make_control_init -> tool_combine_weights ->
   tool_extract_weights (-t control, -t lora) with the round trip
   bit-equal, tool_make_cond_images over 4 PNGs with hed and lineart, then
   evaluate_lineart_is_coarse (it must find the coarse items) and
   evaluate_lineart over 8 samples. Every file is deleted at the end.

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
import copy
import ctypes
import dataclasses
import gc
import importlib.metadata
import io
import json
import math
import os
import pickle
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
from ctrlora_tpu_torch.annotators import bbox as bbox_mod
from ctrlora_tpu_torch.annotators import densepose as densepose_mod
from ctrlora_tpu_torch.annotators import download as annot_download
from ctrlora_tpu_torch.annotators import hed as hed_mod
from ctrlora_tpu_torch.annotators import lineart as lineart_mod
from ctrlora_tpu_torch.annotators import midas as midas_mod
from ctrlora_tpu_torch.annotators import mlsd as mlsd_mod
from ctrlora_tpu_torch.annotators import nets as annot_nets
from ctrlora_tpu_torch.annotators import openpose as openpose_mod
from ctrlora_tpu_torch.annotators import pidinet as pidinet_mod
from ctrlora_tpu_torch.annotators import uniformer as uniformer_mod
from ctrlora_tpu_torch.annotators.openpose import models as openpose_models
from ctrlora_tpu_torch.annotators import registry as annot_registry
from ctrlora_tpu_torch.apps import logic as apps_logic
from ctrlora_tpu_torch import configs, evaluation, lora_fuse
from ctrlora_tpu_torch import style as style_mod
from ctrlora_tpu_torch.models import inception as inception_mod
from ctrlora_tpu_torch.models import ip_adapter
from ctrlora_tpu_torch.models import lpips as lpips_mod
from ctrlora_tpu_torch.models import t5 as t5_mod
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
from ctrlora_tpu_torch.scripts import evaluate_control, evaluate_fid, evaluate_restore
from ctrlora_tpu_torch.scripts import evaluate_lineart, evaluate_lineart_is_coarse
from ctrlora_tpu_torch.scripts import (
    tool_combine_weights, tool_extract_weights, tool_make_cond_images, tool_make_control_init,
)
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
from ctrlora_tpu_torch.utils.image import HWC3, png_writer, write_png
from ctrlora_tpu_torch.utils.loading import check_key, load_ctrlora
from ctrlora_tpu_torch.utils.precision import fp32_exact

ROOT = os.path.dirname(os.path.abspath(__file__))
# the files phases 8, 11 and 13 write and phase 15 reads again
KEPT = os.path.join(ROOT, "runs", "chip_smoke_kept")
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

def emb_row_sizes(cfg, controls: int = 1):
    """Widths of the per-step emb_proj rows (the UNet's, then each
    ControlNet's)."""
    enc = [s.out_ch for s in encoder_plan(cfg.unet)[0] if s.kind == "res"]
    mid = [encoder_plan(cfg.unet)[2]] * 2
    dec = [s.out_ch for s in decoder_plan(cfg.unet)]
    return enc + mid + dec + (enc + mid) * controls


def group_norm_library(x, scale, bias, eps):
    """F.group_norm on the same channels-last x (a [B, C, H, W] view) with
    the affine in x's dtype: the yardstick where there is no row or SiLU."""
    xc = x.permute(0, 3, 1, 2)
    sc, bi = scale.to(x.dtype), bias.to(x.dtype)
    return "F.group_norm", lambda: F.group_norm(xc, 32, sc, bi, eps)


def device_kernels(fn, at_least: int = 0, windows: int = 3) -> int:
    """Device kernels that fn() launches, counted by torch.profiler. The
    profiler can lose records (one window read 8 of 19 launches) but never
    counts a kernel that did not run, so a window that counts fewer than
    `at_least` is taken again, up to `windows` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        count = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if count >= at_least:
            break
    return count


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
    kernels_per_call = device_kernels(lambda: [gn_ops.group_norm(*a) for a in gn_args],
                                      at_least=len(gn_args)) \
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
    kernels_per_call = device_kernels(lambda: [gn_ops.group_norm_onepass(*a) for a in a2_args],
                                      at_least=len(a2_args)) \
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
    alone. Returns the launches of all runs and the sample CLI batch's
    launch rates (``launch_rates``)."""
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
    cli_launches, cli_rates = sample_cli_batch(dev)
    for k, v in cli_launches.items():
        totals[k] = totals.get(k, 0) + v
    return totals, cli_rates


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
    with counted("sample CLI batch", SAMPLING_KERNELS) as launches, cli_launch_split() as split:
        t0 = time.perf_counter()
        out = sample_cli.sample_batch(pipe, hint, ids, nids, opts, args.seed)
        total = time.perf_counter() - t0
    rates = launch_rates(launches, split, batches=1)
    log("sample_cli", sampler=opts.sampler, dpm_order=opts.dpm_order,
        dpm_method=opts.dpm_method, steps=opts.steps, batch=BATCH, size=SIZE, write_s=write_s,
        load_pipeline_s=load_s, s_per_batch=total, launches=launches, **rates,
        shape=list(out.shape), dtype=str(out.dtype), image_mean=float(out.mean()),
        image_std=float(out.std()))
    if out.shape != (BATCH, SIZE, SIZE, 3) or out.dtype != np.uint8 or not out.std() > 0:
        raise AssertionError(f"sample CLI batch: {out.shape} {out.dtype} std {out.std()}")
    del pipe
    return launches, rates


@contextlib.contextmanager
def cli_launch_split():
    """Count, while the block runs, the model evaluations (calls of
    CtrLoraPipeline.apply_model), the sample CLI's sampler calls and the
    kernel launches inside them; yields the dict it fills."""
    split = {"evaluations": 0, "sampler_calls": 0, "in_sampler": {n: 0 for n in wrappers()}}
    apply_model = CtrLoraPipeline.apply_model

    def counting_apply(self, *a, **kw):
        split["evaluations"] += 1
        return apply_model(self, *a, **kw)

    def counting_sampler(fn):
        def run(*a, **kw):
            before = counts_now()
            out = fn(*a, **kw)
            for n, v in counts_since(before).items():
                split["in_sampler"][n] += v
            split["sampler_calls"] += 1
            return out
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(CtrLoraPipeline, "apply_model", counting_apply))
        for name in ("ddim_sample", "plms_sample", "dpm_solver_sample",
                     "dpm_solver_singlestep_sample"):
            stack.enter_context(mock.patch.object(
                sample_cli, name, counting_sampler(getattr(sample_cli, name))))
        yield split


def launch_rates(launches, split, batches: int) -> dict:
    """The sample CLI's launches as rates that do not depend on the sampler
    or its steps: per model evaluation inside the sampler, and per batch
    outside it (the text and hint encodes, the decode)."""
    n = split["evaluations"]
    return {"model_evaluations": n, "sampler_calls": split["sampler_calls"],
            "launches_per_evaluation": {k: v / n for k, v in split["in_sampler"].items() if v},
            "launches_per_batch_outside_sampler": {
                k: (launches[k] - split["in_sampler"][k]) / batches for k in launches
                if launches[k] - split["in_sampler"][k]}}


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
    settings. Its files stay under KEPT for phase 15. Returns (the launches
    of each timed run, the files' paths)."""
    cfg = configs.ctrlora_inference_config(lora_num=2, lora_rank=128)
    outdir = os.path.join(KEPT, "api")
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
    return launches, paths


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
    init), and the tiny GPU-vs-CPU checks (11e). The datasets are deleted
    at the end; the SD and control files stay under KEPT for phase 15.
    Returns (the launches of each run, {'sd': path, 'control': path})."""
    launches = {f"sample_{v}": baseline_sampling(dev, v) for v in BASELINES}
    root = os.path.join(ROOT, "runs", "chip_smoke_baselines")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        custom, _ = write_cli_datasets(root, np.random.default_rng(SEED + 11))
        kept = os.path.join(KEPT, "baselines")
        os.makedirs(kept, exist_ok=True)
        cn_file = os.path.join(kept, "control_sd15.ckpt")
        written = write_control_file(configs.sd15_config(), dev, cn_file,
                                     torch.Generator(device=dev).manual_seed(SEED + 13))
        sd_file = os.path.join(kept, "sd15.ckpt")
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
    return launches, {"sd": sd_file, "control": cn_file}


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
    weights, which stay under KEPT for phase 15. Returns (the launches of
    the timed txt2img run, the files' paths)."""
    cfg = configs.load_model_config(os.path.join(ROOT, STYLE_CONFIG))
    if cfg != style_mod.style_config(1, 128, 4):
        raise AssertionError(f"{STYLE_CONFIG} reads as {cfg}, not style_config(1, 128, 4)")
    root = os.path.join(KEPT, "style")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return _style_slice(dev, cfg, root, phase4_s_batch)


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
    return launches, paths


# ---------------------------------------------------------------------------
# phase 14: evaluation -- the sample CLI's output scored by the evaluate CLIs
# ---------------------------------------------------------------------------

EVAL_ITEMS = 8
EVAL_KERNELS = SAMPLING_KERNELS
# the H100 SXM's published float32 rate outside the tensor cores: with TF32
# off the metrics' convolutions and matmuls run there
FP32_PEAK_FLOPS = 67e12
# openai/clip-vit-large-patch14, the reference's CLIPScore model
CLIP_L = {"text_width": 768, "text_layers": 12, "vision_width": 1024, "vision_layers": 24,
          "patch": 14, "image": 224, "projection": 768}
# full-width throughput inputs: the CLIs' default batches (--bs 64 for
# control/restore, 32 for fid) and a T5 encode of 4 x 77 ids
EVAL_SHAPES = {"lpips": (64, 512, 512, 3), "inception": (32, 299, 299, 3), "clip": 64,
               "ssim": (64, 512, 512, 3), "t5": (4, 77)}
GPU_CPU_RTOL, GPU_CPU_ATOL, CLIP_SCORE_ATOL = 1e-4, 1e-5, 1e-3
# FID of a set against itself, relative to the trace of its covariance
SELF_FID_REL_TOL = 1e-3


def normal_(gen, shape, std, dev, mean=0.0):
    return torch.randn(shape, generator=gen, device=dev) * std + mean


def lpips_file_state(gen, dev) -> dict:
    """torchvision VGG16 ``features.{i}`` + lpips ``lin{k}.model.1.weight``
    of seeded weights (a gain under 1 a conv)."""
    sd, cin = {}, 3
    for (cout, _), idxs in zip(lpips_mod.VGG16_PLAN, lpips_mod.CONV_IDX):
        for i in idxs:
            sd[f"features.{i}.weight"] = normal_(gen, (cout, cin, 3, 3), (1 / (9 * cin)) ** 0.5, dev)
            sd[f"features.{i}.bias"] = normal_(gen, (cout,), 0.01, dev)
            cin = cout
    for k, (cout, _) in enumerate(lpips_mod.VGG16_PLAN):
        sd[f"lin{k}.model.1.weight"] = torch.rand((1, cout, 1, 1), generator=gen, device=dev) * 0.1
    return sd


def inception_file_state(gen, dev) -> dict:
    """pt_inception-2015-12-05's torchvision names and shapes with BN
    buffers: He-normal convs, BN near identity, an fc of unit gain."""
    sd = {}
    for name, p in inception_mod.FIDInceptionV3().state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        shape = tuple(p.shape)
        if prefix == "fc":
            sd[name] = normal_(gen, shape, shape[-1] ** -0.5 if leaf == "weight" else 0.01, dev)
        elif leaf == "weight":
            fan_in = shape[1] * shape[2] * shape[3]
            sd[f"{prefix}.conv.weight"] = normal_(gen, shape, (2 / fan_in) ** 0.5, dev)
        elif leaf == "scale":
            c = shape[0]
            sd[f"{prefix}.bn.weight"] = normal_(gen, (c,), 0.02, dev, 1.0)
            sd[f"{prefix}.bn.bias"] = normal_(gen, (c,), 0.02, dev)
            sd[f"{prefix}.bn.running_mean"] = normal_(gen, (c,), 0.1, dev)
            sd[f"{prefix}.bn.running_var"] = torch.rand((c,), generator=gen, device=dev) + 0.5
            sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0, device=dev)
    return sd


def clip_file_state(gen, dev, text_width, text_layers, vision_width, vision_layers, patch,
                    image, projection) -> dict:
    """An HF CLIPModel state dict (text_model.*, vision_model.*, the two
    projections) of seeded weights at the given widths."""
    sd = {}

    def tower(pre, d, layers):
        for i in range(layers):
            t = f"{pre}.encoder.layers.{i}"
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{t}.self_attn.{n}.weight"] = normal_(gen, (d, d), 0.02, dev)
                sd[f"{t}.self_attn.{n}.bias"] = normal_(gen, (d,), 0.01, dev)
            for n in ("layer_norm1", "layer_norm2"):
                sd[f"{t}.{n}.weight"] = normal_(gen, (d,), 0.02, dev, 1.0)
                sd[f"{t}.{n}.bias"] = normal_(gen, (d,), 0.01, dev)
            sd[f"{t}.mlp.fc1.weight"] = normal_(gen, (4 * d, d), 0.02, dev)
            sd[f"{t}.mlp.fc1.bias"] = normal_(gen, (4 * d,), 0.01, dev)
            sd[f"{t}.mlp.fc2.weight"] = normal_(gen, (d, 4 * d), 0.02, dev)
            sd[f"{t}.mlp.fc2.bias"] = normal_(gen, (d,), 0.01, dev)

    dt, dv = text_width, vision_width
    sd["text_model.embeddings.token_embedding.weight"] = normal_(gen, (49408, dt), 0.02, dev)
    sd["text_model.embeddings.position_embedding.weight"] = normal_(gen, (77, dt), 0.01, dev)
    tower("text_model", dt, text_layers)
    sd["text_model.final_layer_norm.weight"] = normal_(gen, (dt,), 0.02, dev, 1.0)
    sd["text_model.final_layer_norm.bias"] = normal_(gen, (dt,), 0.01, dev)
    sd["text_projection.weight"] = normal_(gen, (projection, dt), dt ** -0.5, dev)
    sd["vision_model.embeddings.class_embedding"] = normal_(gen, (dv,), 0.02, dev)
    sd["vision_model.embeddings.patch_embedding.weight"] = normal_(gen, (dv, 3, patch, patch),
                                                                   0.02, dev)
    sd["vision_model.embeddings.position_embedding.weight"] = normal_(
        gen, ((image // patch) ** 2 + 1, dv), 0.01, dev)
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"vision_model.{ln}.weight"] = normal_(gen, (dv,), 0.02, dev, 1.0)
        sd[f"vision_model.{ln}.bias"] = normal_(gen, (dv,), 0.01, dev)
    tower("vision_model", dv, vision_layers)
    sd["visual_projection.weight"] = normal_(gen, (projection, dv), dv ** -0.5, dev)
    return sd


def smooth_image(rng, h, w):
    """A seeded uint8 RGB image with edges and gradients (a blurred random
    field), so canny finds structure in it."""
    import cv2

    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 4.0)


def write_eval_dataset(root, rng):
    """A CustomDataset of EVAL_ITEMS pairs (source: the condition, target:
    the image) of 512^2 PNGs and their prompts."""
    data = os.path.join(root, "data")
    for sub in ("source", "target"):
        os.makedirs(os.path.join(data, sub))
    with open(os.path.join(data, "prompt.json"), "w") as f:
        for i in range(EVAL_ITEMS):
            for sub in ("source", "target"):
                write_png(os.path.join(data, sub, f"{i}.png"), smooth_image(rng, SIZE, SIZE))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"{PROMPT}, item {i}"}) + "\n")
    return data


def eval_sample(dev, root, phase9_rates):
    """(a) The sample CLI's main at its defaults (DDIM 50, CFG 7.5, --bs 4,
    512^2) on fp16 reference-format files and a dataset of EVAL_ITEMS
    seeded items. Returns the launches and the output directory."""
    cfg = configs.ctrlora_finetune_config(lora_rank=128)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    t0 = time.perf_counter()
    src = CtrLoraPipeline(cfg, dev, fuse_lora=False)
    for m in src.modules():
        random_init_(m, gen)
    paths, _ = write_reference_files(src, src.control.state_dict(), cfg,
                                     os.path.join(root, "ckpts"), torch.float16)
    del src
    torch.cuda.empty_cache()
    data = write_eval_dataset(root, np.random.default_rng(SEED + 14))
    write_s = time.perf_counter() - t0
    out = os.path.join(root, "out")
    batch_s = []
    sample_batch = sample_cli.sample_batch

    def timed_batch(*a, **kw):
        t = time.perf_counter()
        images = sample_batch(*a, **kw)  # numpy: the card is done
        batch_s.append(time.perf_counter() - t)
        return images

    torch.cuda.reset_peak_memory_stats(dev)
    with counted("evaluation sample CLI", EVAL_KERNELS) as launches, cli_launch_split() as split, \
            mock.patch.object(sample_cli, "sample_batch", timed_batch), \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        sample_cli.main(["--dataroot", data, "--save_dir", out, "--sd_ckpt", paths["sd"],
                         "--cn_ckpt", paths["basecn"], "--lora_ckpt", paths["loras"][0],
                         "--bs", str(BATCH), "--resolution", str(SIZE), "--device", dev.type])
        total = time.perf_counter() - t0
    shutil.rmtree(os.path.join(root, "ckpts"))
    rates = launch_rates(launches, split, len(batch_s))
    written = {sub: sorted(os.listdir(os.path.join(out, sub))) for sub in ("sample", "control", "img")}
    with open(os.path.join(out, "prompt.txt")) as f:
        prompt_lines = f.read().splitlines()
    shapes = {png_shape(os.path.join(out, sub, n)) == [SIZE, SIZE, 3]
              for sub, names in written.items() for n in names}
    same = {k: rates[k] == phase9_rates[k]
            for k in ("launches_per_evaluation", "launches_per_batch_outside_sampler")}
    log("evaluation_sample", sampler="ddim", steps=STEPS, scale=7.5, batch=BATCH, size=SIZE,
        items=EVAL_ITEMS, write_s=write_s, cli_s=total, s_per_batch=batch_s,
        load_and_write_s=total - sum(batch_s), launches=launches, **rates,
        phase9_cli_rates=phase9_rates, rates_equal_phase9=same,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        files_written={k: len(v) for k, v in written.items()}, prompt_lines=len(prompt_lines),
        pngs_rgb_at_size=shapes == {True})
    if not all(same.values()) or shapes != {True} or len(prompt_lines) != EVAL_ITEMS \
            or any(len(v) != EVAL_ITEMS for v in written.values()):
        raise AssertionError(f"evaluation sample CLI: rates equal phase 9 {same}, files "
                             f"{ {k: len(v) for k, v in written.items()} }, "
                             f"{len(prompt_lines)} prompts, RGB at {SIZE}^2: {shapes}")
    return launches, out


def run_cli(dev, name, main, argv):
    """One evaluate CLI's main: (its results, its printed lines, seconds,
    peak GB above what was allocated before it), with no hand-written
    kernel launched."""
    buf = io.StringIO()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    with counted(f"evaluation {name}", ()) as launches, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        results = main(argv)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError(f"{name} launched hand-written kernels: {launches}")
    return results, buf.getvalue().splitlines(), seconds, \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30 - before


def eval_score(dev, root, out, files):
    """(b) evaluate_control --detector canny and evaluate_restore (LPIPS and
    CLIPScore files given), evaluate_fid on sample/ against img/: printed
    metrics, seconds, images/s, peak memory, 0 hand-kernel launches."""
    common = ["--sample_dir", out, "--lpips_ckpt", files["lpips"], "--clip_ckpt", files["clip"],
              "--device", dev.type]
    runs = {"evaluate_control": (evaluate_control.main, common + ["--detector", "canny"]),
            "evaluate_restore": (evaluate_restore.main, common),
            "evaluate_fid": (evaluate_fid.main, [
                "--dir_a", os.path.join(out, "sample"), "--dir_b", os.path.join(out, "img"),
                "--inception_ckpt", files["inception"], "--device", dev.type])}
    scores = {}
    for name, (main, argv) in runs.items():
        results, lines, seconds, peak = run_cli(dev, name, main, argv)
        images = EVAL_ITEMS * (2 if name == "evaluate_fid" else 1)
        log("evaluation_score", cli=name, printed=lines, results=results, seconds=seconds,
            images=images, images_per_s=images / seconds, peak_mem_gb_above_start=peak,
            hand_kernel_launches=0)
        finite = all(math.isfinite(v) for v in results.values())
        want = ({"mse", "psnr", "ssim", "lpips", "clip score"} if name != "evaluate_fid"
                else {"IS", "IS std", "FID"})
        ok = finite and set(results) == want and (
            name == "evaluate_fid" or (results["lpips"] >= 0 and 0 <= results["clip score"] <= 100
                                       and lines[1:] == [f"{k.upper()}: {v:.4f}"
                                                         for k, v in results.items()]))
        if not ok:
            raise AssertionError(f"{name}: {results}, printed {lines}")
        scores[name] = results
    return scores


def flops_of(fn) -> float:
    """The fp32 multiply-adds (x2) of fn's matmuls and convolutions, by
    torch.utils.flop_counter."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def eval_throughput(dev, lp, inc, scorer, t5):
    """(c) Each metric back to back at the CLIs' default batch, on seeded
    inputs: ms, images/s, fp32 FLOPs and the share of the fp32 peak. Returns
    the seeded LPIPS input (reused by the sanity checks)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 141)
    a = torch.rand(EVAL_SHAPES["lpips"], generator=gen, device=dev)
    b = torch.rand(EVAL_SHAPES["lpips"], generator=gen, device=dev)
    x = torch.rand(EVAL_SHAPES["inception"], generator=gen, device=dev) * 2 - 1
    n_clip = EVAL_SHAPES["clip"]
    rng = np.random.default_rng(SEED + 141)
    images = np.stack([smooth_image(rng, SIZE, SIZE) for _ in range(n_clip)])
    prompts = [f"{PROMPT}, item {i}" for i in range(n_clip)]
    pixels = torch.from_numpy(ip_adapter.clip_image_preprocess(images, scorer.image_size)).to(dev)
    ids = torch.randint(0, t5.cfg.vocab_size, EVAL_SHAPES["t5"], generator=gen, device=dev)
    def t5_encode():
        with fp32_exact(), torch.no_grad():
            return t5(ids)

    runs = {
        "lpips": (lambda: lpips_mod.lpips(lp, a, b), EVAL_SHAPES["lpips"][0], 3),
        "inception": (lambda: inception_mod.inception_features(inc, x),
                      EVAL_SHAPES["inception"][0], 10),
        "clip_towers": (lambda: scorer.embed_pixels(pixels, prompts), n_clip, 3),
        "ssim": (lambda: evaluation.ssim(a, b), EVAL_SHAPES["ssim"][0], 10),
        "t5_encode": (t5_encode, EVAL_SHAPES["t5"][0], 10),
    }
    out = {}
    for name, (fn, n, iters) in runs.items():
        flops = flops_of(fn)
        ms = time_ms(fn, iters=iters)
        out[name] = {"ms": ms, "images_per_s": n / ms * 1e3, "batch": n, "gflop": flops / 1e9,
                     "tflop_per_s": flops / ms / 1e9,
                     "share_of_fp32_peak": flops / (ms / 1e3) / FP32_PEAK_FLOPS}
    # the CLIPScorer call as a user makes it: CLIP's host preprocessing of
    # uint8 512^2 images, both towers, the cosine, back on the host
    scorer(images[:2], prompts[:2])
    t0 = time.perf_counter()
    scores = scorer(images, prompts)
    call_s = time.perf_counter() - t0
    out["clip_score_call"] = {"ms": call_s * 1e3, "images_per_s": n_clip / call_s,
                              "batch": n_clip, "host_preprocess_included": True,
                              "mean_score_unclamped": float(scores.mean())}
    log("evaluation_throughput", fp32_peak_tflop_per_s=FP32_PEAK_FLOPS / 1e12,
        tf32="off", shapes={k: list(v) if isinstance(v, tuple) else v
                            for k, v in EVAL_SHAPES.items()}, **out,
        clip_scores_finite=bool(np.isfinite(scores).all()))
    if not np.isfinite(scores).all():
        raise AssertionError("CLIP scores are not finite")
    return a


def eval_gpu_vs_cpu(dev, lp, inc, scorer, clip_sd, t5):
    """(d) The full-width models on the card against copies on the CPU, the
    same seeded small inputs, fp32 with TF32 off; and the TF32 guard's
    restore of the caller's flags."""
    rng = np.random.default_rng(SEED + 142)
    pair = [torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
            for _ in range(2)]
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32))
    u8 = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    images = np.stack([smooth_image(rng, 96, 80) for _ in range(2)])
    prompts = ["a photo of a cat", "a red house by a lake"]
    ids = torch.from_numpy(rng.integers(0, t5.cfg.vocab_size, (2, 16)))
    cpu = torch.device("cpu")
    lp_cpu = copy.deepcopy(lp).to(cpu)
    inc_cpu = copy.deepcopy(inc).to(cpu)
    t5_cpu = copy.deepcopy(t5).to(cpu)
    scorer_cpu = evaluation.CLIPScorer.from_torch_state(clip_sd, device="cpu")
    on = lambda t: t.to(dev)
    got = {
        "lpips": (lpips_mod.lpips(lp, *map(on, pair)), lpips_mod.lpips(lp_cpu, *pair)),
        "fid_preprocess": (inception_mod.fid_preprocess(u8, dev),
                           inception_mod.fid_preprocess(u8, cpu)),
        "ssim": (evaluation.ssim(*map(on, pair)), evaluation.ssim(*pair)),
    }
    (fg, lg), (fc, lc) = (inception_mod.inception_features(inc, on(x)),
                          inception_mod.inception_features(inc_cpu, x))
    got["inception_features"], got["inception_logits"] = (fg, fc), (lg, lc)
    with torch.no_grad(), fp32_exact():
        got["t5_last_hidden"] = (t5(on(ids)), t5_cpu(ids))
    errors = {k: compare(g.cpu(), w, GPU_CPU_RTOL, GPU_CPU_ATOL) for k, (g, w) in got.items()}
    clip_g, clip_c = scorer(images, prompts), scorer_cpu(images, prompts)
    errors["clip_scores"] = compare(torch.from_numpy(clip_g), torch.from_numpy(clip_c), 0.0,
                                    CLIP_SCORE_ATOL)
    del lp_cpu, inc_cpu, t5_cpu, scorer_cpu

    # the guard: 'highest' / TF32 off inside the call, the caller's flags after
    flags = lambda: (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    seen = []
    handle = lp.conv0.register_forward_pre_hook(lambda *_: seen.append(flags()))
    saved = flags()
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        lpips_mod.lpips(lp, *map(on, pair))
        after = flags()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
        handle.remove()
    log("evaluation_gpu_vs_cpu", max_abs_err=errors, rtol=GPU_CPU_RTOL, atol=GPU_CPU_ATOL,
        clip_atol=CLIP_SCORE_ATOL, tf32_inside_call=seen, flags_after_call=after,
        caller_flags=["high", True])
    if seen != [("highest", False)] or after != ("high", True):
        raise AssertionError(f"TF32 guard: inside {seen}, after {after}")


def eval_sanity(dev, lp, a, out, files, fid_vs_img):
    """(e) lpips(a, a), ssim(a, a) at [64, 512, 512, 3], and the FID of the
    samples against themselves (timed: frechet_distance on the host) beside
    their FID against img/."""
    same = lpips_mod.lpips(lp, a, a)
    ssim_aa = evaluation.ssim(a, a).item()
    fa, _ = evaluate_fid.inception_outputs(os.path.join(out, "sample"), files["inception"],
                                           device=dev)
    mu, cov = evaluate_fid.stats(fa)
    t0 = time.perf_counter()
    self_fid = evaluate_fid.frechet_distance(mu, cov, mu, cov)
    fd_s = time.perf_counter() - t0
    trace = float(np.trace(cov))
    checks = {"lpips_a_a_max": same.abs().max().item(), "lpips_a_a_exact_zero":
              bool((same == 0).all()), "ssim_a_a": ssim_aa, "fid_self": self_fid,
              "fid_self_over_trace": abs(self_fid) / trace, "fid_vs_img": fid_vs_img}
    log("evaluation_sanity", **checks, trace_cov=trace, frechet_distance_host_s=fd_s,
        feature_dim=int(fa.shape[1]), lpips_tol=1e-6, ssim_tol=1e-6,
        self_fid_rel_tol=SELF_FID_REL_TOL)
    if checks["lpips_a_a_max"] > 1e-6 or abs(ssim_aa - 1) > 1e-6 \
            or checks["fid_self_over_trace"] > SELF_FID_REL_TOL or not self_fid < fid_vs_img:
        raise AssertionError(f"evaluation sanity: {checks}")


def evaluation_slice(dev, phase9_rates):
    """Phase 14: the sample CLI writes sample/ control/ img/ prompt.txt, the
    three evaluate CLIs score them, then the metrics' full-width
    throughput, GPU against CPU, and sanity checks. Files under
    runs/chip_smoke_eval, deleted at the end. Returns the sample CLI's
    launches."""
    root = os.path.join(ROOT, "runs", "chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        return _evaluation_slice(dev, root, phase9_rates)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _evaluation_slice(dev, root, phase9_rates):
    t_phase = time.perf_counter()
    launches, out = eval_sample(dev, root, phase9_rates)
    gc.collect()  # the sample CLI's pipeline
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    t0 = time.perf_counter()
    states = {"lpips": lpips_file_state(gen, dev), "inception": inception_file_state(gen, dev),
              "clip": clip_file_state(gen, dev, **CLIP_L)}
    files = {}
    for name, sd in states.items():
        files[name] = os.path.join(root, f"{name}.pth")
        dtype = torch.float16 if name == "clip" else torch.float32
        torch.save({k: v.to(dtype).cpu() if v.is_floating_point() else v.cpu()
                    for k, v in sd.items()}, files[name])
    del states
    log("evaluation_files", write_s=time.perf_counter() - t0,
        file_gb={k: os.path.getsize(v) / 2 ** 30 for k, v in files.items()},
        clip_widths=CLIP_L, weights="seeded; the published files are not in the repository",
        scipy=importlib.metadata.version("scipy"))
    scores = eval_score(dev, root, out, files)

    lp, scorer = evaluation.load_eval_models(files["lpips"], files["clip"], dev)
    inc = inception_mod.FIDInceptionV3.from_state_dict(
        inception_mod.convert_inception(ckpt_torch.load_torch_state_dict(files["inception"])), dev)
    torch.manual_seed(SEED + 143)
    with dev:
        t5 = t5_mod.T5TextModel(t5_mod.T5Config()).eval().requires_grad_(False)
    with counted("evaluation metrics", ()) as metric_launches:
        a = eval_throughput(dev, lp, inc, scorer, t5)
        torch.cuda.empty_cache()
        clip_sd = ckpt_torch.load_torch_state_dict(files["clip"])
        eval_gpu_vs_cpu(dev, lp, inc, scorer, clip_sd, t5)
        del clip_sd
        eval_sanity(dev, lp, a, out, files, scores["evaluate_fid"]["FID"])
    if any(metric_launches.values()):
        raise AssertionError(f"the metrics launched hand-written kernels: {metric_launches}")
    del lp, scorer, inc, t5, a
    torch.cuda.empty_cache()
    log("evaluation", phase_s=time.perf_counter() - t_phase, hand_kernel_launches_scoring=0)
    return launches


# ---------------------------------------------------------------------------
# phase 15: the apps, the tools, the CNN detectors and the lineart CLIs
# ---------------------------------------------------------------------------

# the published detector files the port reads: file -> the network it holds
DETECTOR_FILES = {"ControlNetHED.pth": hed_mod.ControlNetHED,
                  "sk_model.pth": lineart_mod.LineartGenerator,
                  "sk_model2.pth": lineart_mod.LineartGenerator,
                  "netG.pth": lineart_mod.AnimeUNet,
                  "mlsd_large_512_fp32.pth": mlsd_mod.MobileV2MLSDLarge,
                  "dpt_large_384.pt": midas_mod.DPT,
                  "upernet_global_small.pth": uniformer_mod.UperNetUniFormer,
                  "body_pose_model.pth": openpose_models.BodyNet,
                  "hand_pose_model.pth": openpose_models.HandNet,
                  "facenet.pth": openpose_models.FaceNet}
# the body net's heatmap head is scaled by this much in its seeded file, so
# the maps of a 512^2 image cross the decode's threshold at tens to a
# hundred peaks, not thousands (the limb matching is quadratic in them, in
# Python)
BODY_HEATMAP_SCALE = ("Mconv7_stage6_L2.weight", 0.2)


def detector_file_state(name: str, gen: torch.Generator) -> dict:
    """Seeded weights of published detector file `name` in its published
    layout (CPU fp32): convs He-normal (MLSD's LeCun-normal: its residual
    sums would grow He's) with N(0, 0.05) biases, linear layers LeCun-normal,
    LayerNorms' scales 1 + N(0, 0.1); HED's `norm` near an image mean, its
    first conv scaled by 1/64 for the 0..255 input; every BatchNorm unfolded
    (weight, bias, running_mean, running_var, num_batches_tracked); netG's
    keys under 'module.', as a DataParallel file holds them; the body net's
heatmap head scaled by BODY_HEATMAP_SCALE; the DPT file
    with the ViT's final norm and classifier, which the detector leaves out;
    the UPerNet file as mmseg saves it, under 'state_dict' beside a 'meta'
    dict and with an auxiliary head. DPT and UniFormer take the widths of
    their modules' constants. Activations stay O(1), as a trained net's
    do."""
    module = DETECTOR_FILES[name]()
    randn = lambda shape, std=1.0: torch.randn(shape, generator=gen) * std
    gain = 1.0 if isinstance(module, mlsd_mod.MobileV2MLSDLarge) else 2.0
    sd = {}
    for prefix, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{prefix}.{pname}" if prefix else pname
            c = p.shape[0]
            if isinstance(m, mlsd_mod.FoldedBN):
                if pname == "weight":
                    sd[key] = 1 + randn(c, 0.1)
                    sd[f"{prefix}.running_mean"] = randn(c, 0.1)
                    sd[f"{prefix}.running_var"] = 0.5 + torch.rand(c, generator=gen)
                    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)
                else:
                    sd[key] = randn(c, 0.05)
            elif isinstance(m, nn.LayerNorm) and pname == "weight":
                sd[key] = 1 + randn(c, 0.1)
            elif pname == "norm":  # HED's input mean
                sd[key] = 110 + randn(p.shape, 10.0)
            elif p.ndim == 4:
                fan = p.shape[0] * p.shape[2] * p.shape[3] if isinstance(
                    m, nn.ConvTranspose2d) else p[0].numel()
                sd[key] = randn(p.shape, (gain / fan) ** 0.5)
            elif isinstance(m, nn.Linear) and pname == "weight":
                sd[key] = randn(p.shape, p.shape[1] ** -0.5)
            else:
                sd[key] = randn(p.shape, 0.05)
    if name == "ControlNetHED.pth":
        sd["block1.convs.0.weight"] /= 64.0
    if name == "netG.pth":
        sd = {f"module.{k}": v for k, v in sd.items()}
    if name == "body_pose_model.pth":
        sd[BODY_HEATMAP_SCALE[0]] *= BODY_HEATMAP_SCALE[1]
    if name == "dpt_large_384.pt":
        dim = module.pretrained.model.cls_token.shape[-1]
        sd.update({"pretrained.model.norm.weight": 1 + randn(dim, 0.1),
                   "pretrained.model.norm.bias": randn(dim, 0.05),
                   "pretrained.model.head.weight": randn((1000, dim), dim ** -0.5),
                   "pretrained.model.head.bias": randn(1000, 0.05)})
    if name == "upernet_global_small.pth":
        sd.update({"auxiliary_head.conv_seg.weight": randn((150, 256, 1, 1), 256 ** -0.5),
                   "auxiliary_head.conv_seg.bias": randn(150, 0.05)})
        sd = {"state_dict": sd, "meta": {"mmseg_version": "0.11.0", "iter": 160000}}
    return sd


PIDINET_RESIDUAL_STD = 0.25


def pidinet_file_state(gen: torch.Generator) -> dict:
    """Seeded table5_pidinet.pth as published: the pdc kernels unconverted
    ([c, 1, 3, 3] for rd too), every key under 'module.' in 'state_dict'.
    Convs He-normal, each block's 1x1 conv2 at PIDINET_RESIDUAL_STD of it
    (the residual sums of 15 blocks stay O(1)), biases N(0, 0.05)."""
    ops = pidinet_mod.block_ops()
    sd = {}
    for key, v in pidinet_mod.PiDiNet().state_dict().items():
        shape = (*v.shape[:2], 3, 3) if key in ops else tuple(v.shape)
        if len(shape) == 4:
            std = (2.0 / math.prod(shape[1:])) ** 0.5
            if key.endswith(".conv2.weight") and key.startswith("block"):
                std *= PIDINET_RESIDUAL_STD
            sd[key] = torch.randn(shape, generator=gen) * std
        else:
            sd[key] = torch.randn(shape, generator=gen) * 0.05
    return {"state_dict": {f"module.{k}": v for k, v in sd.items()}}


def _cfg_section(kind: str, **opts) -> str:
    return f"[{kind}]\n" + "".join(f"{k}={v}\n" for k, v in opts.items())


def _cfg_conv(filters: int, size: int, stride: int = 1, act: str = "leaky", bn: int = 1) -> str:
    return _cfg_section("convolutional", batch_normalize=bn, filters=filters, size=size,
                        stride=stride, pad=1, activation=act)


def _cfg_head(mask: str, scale_x_y: float) -> str:
    return _cfg_conv(255, 1, act="linear", bn=0) + _cfg_section(
        "yolo", mask=mask, anchors="12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, "
        "192,243, 459,401", classes=80, num=9, scale_x_y=scale_x_y)


# A darknet detection cfg with every section kind the port's YoloV4 builds
# (convolutional with and without BatchNorm, mish / leaky / linear, stride-2
# convs down to /32, a shortcut, SPP maxpools 5/9/13 at stride 1, one- and
# multi-layer routes, nearest upsamples) and three [yolo] heads of 255
# filters at strides 32, 16 and 8 on a 416^2 net, with YOLOv4's anchors and
# scale_x_y. It is not YOLOv4's 163-section net (yolov4.cfg is not in the
# repo); it stands in for it as yolov4.cfg beside a seeded yolov4.weights.
# Section indices (routes count them from 0): 8 is the /8 map, 11 the /16.
YOLO_CFG = "\n".join([
    _cfg_section("net", width=416, height=416, channels=3),
    _cfg_conv(32, 3, act="mish"), _cfg_conv(64, 3, 2, "mish"), _cfg_conv(32, 1, act="mish"),
    _cfg_conv(64, 3, act="mish"), _cfg_section("shortcut", **{"from": -3}, activation="linear"),
    _cfg_conv(128, 3, 2, "mish"), _cfg_conv(256, 3, 2), _cfg_conv(128, 1), _cfg_conv(256, 3),
    _cfg_conv(512, 3, 2), _cfg_conv(256, 1), _cfg_conv(512, 3),
    _cfg_conv(1024, 3, 2), _cfg_conv(512, 1),
    _cfg_section("maxpool", stride=1, size=5), _cfg_section("route", layers=-2),
    _cfg_section("maxpool", stride=1, size=9), _cfg_section("route", layers=-4),
    _cfg_section("maxpool", stride=1, size=13), _cfg_section("route", layers="-1,-3,-5,-6"),
    _cfg_conv(512, 1), _cfg_conv(1024, 3), _cfg_head("6,7,8", 1.05),
    _cfg_section("route", layers=-4), _cfg_conv(256, 1), _cfg_section("upsample", stride=2),
    _cfg_section("route", layers="-1,11"), _cfg_conv(256, 1), _cfg_conv(512, 3),
    _cfg_head("3,4,5", 1.1),
    _cfg_section("route", layers=-4), _cfg_conv(128, 1), _cfg_section("upsample", stride=2),
    _cfg_section("route", layers="-1,8"), _cfg_conv(128, 1), _cfg_conv(256, 3),
    _cfg_head("0,1,2", 1.2),
])
# the seeded yolo heads: their kernels at YOLO_HEAD_STD of LeCun's std, each
# anchor's objectness bias at YOLO_OBJECTNESS_BIAS until write_detector_files
# moves it for an image (a fixed bias lets through no box or hundreds)
YOLO_HEAD_STD, YOLO_OBJECTNESS_BIAS = 0.5, -3.0


def write_darknet_files(directory: str, gen: torch.Generator, cfg: str = YOLO_CFG,
                        objectness_bias: float = YOLO_OBJECTNESS_BIAS) -> np.ndarray:
    """`cfg` as yolov4.cfg and seeded yolov4.weights for it in darknet's
    format: the header of a version 0.2 file (major, minor, revision as
    int32, the images seen as int64), then each convolutional section's
    bias, its BatchNorm's scale / mean / var where it has one, and its
    kernel [f, cin, k, k], as float32. Kernels He-normal (the yolo heads'
    at YOLO_HEAD_STD of LeCun's), BatchNorms as detector_file_state's, the
    heads' biases N(0, 0.05) with each anchor's objectness at
    `objectness_bias`. Returns the floats written."""
    cfg_path = os.path.join(directory, bbox_mod.CFG_FILE)
    with open(cfg_path, "w") as f:
        f.write(cfg)
    with torch.device("meta"):
        net = bbox_mod.YoloV4(cfg_path)
    randn = lambda n, std: (torch.randn(n, generator=gen) * std).numpy()
    parts = []
    for spec in net.conv_specs:
        f, fan = spec["filters"], spec["in"] * spec["size"] ** 2
        bias = randn(f, 0.05)
        if spec["bn"]:
            parts += [bias, 1 + randn(f, 0.1), randn(f, 0.1),
                      0.5 + torch.rand(f, generator=gen).numpy()]
            parts.append(randn(f * fan, (2.0 / fan) ** 0.5))
        else:
            bias.reshape(-1, f // 3)[:, 4] = objectness_bias
            parts += [bias, randn(f * fan, YOLO_HEAD_STD * fan ** -0.5)]
    buf = np.concatenate(parts).astype(np.float32)
    with open(os.path.join(directory, bbox_mod.WEIGHTS_FILE), "wb") as f:
        np.asarray([0, 2, 5], np.int32).tofile(f)
        np.asarray([32013312], np.int64).tofile(f)
        buf.tofile(f)
    return buf


# the seeded box predictor's person logit bias (the background's is 0) until
# write_detector_files moves it for an image, so that a handful of the
# proposals pass SCORE_THRESH, not hundreds (each person runs the chart head,
# 32 GFLOP at the published widths)
DENSEPOSE_PERSON_BIAS = -4.0
# the seeded bottlenecks' last BatchNorm scale: 33 residual sums stay O(1)
DENSEPOSE_RESIDUAL_SCALE = 0.2
# the layers seeded as detectron2 initialises them: N(0, std) weights, zero biases
DENSEPOSE_DETECTRON2_INIT = {"proposal_generator.rpn_head.conv": 0.01,
                             "proposal_generator.rpn_head.objectness_logits": 0.01,
                             "proposal_generator.rpn_head.anchor_deltas": 0.01,
                             "roi_heads.box_predictor.cls_score": 0.01,
                             "roi_heads.box_predictor.bbox_pred": 0.001}


def densepose_file_state(gen: torch.Generator, person_bias: float = DENSEPOSE_PERSON_BIAS,
                         stages=densepose_mod.R101_STAGES) -> dict:
    """Seeded model_final_844d15.pkl as detectron2 saves it, {'model':
    {name: float32 ndarray}, '__author__': ...}, with the keys JAX's
    convert_densepose reads at the widths of the ``annotators.densepose``
    constants: every FrozenBN unfolded (weight, bias, running_mean,
    running_var; each bottleneck's conv3 norm scaled by
    DENSEPOSE_RESIDUAL_SCALE), GroupNorms' scales 1 + N(0, 0.1), convs
    He-normal (the stem's by 1/64 for the 0..255 input, as HED's),
    linear layers LeCun-normal, biases N(0, 0.05), the RPN head and the box
    predictor as detectron2 initialises them (DENSEPOSE_DETECTRON2_INIT),
    the person logit's bias at `person_bias`."""
    with torch.device("meta"):
        module = densepose_mod.DensePoseRCNN(stages)
    randn = lambda shape, std=1.0: (torch.randn(shape, generator=gen) * std).numpy()
    sd = {}
    for prefix, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key, shape, c = f"{prefix}.{pname}", tuple(p.shape), p.shape[0]
            if isinstance(m, mlsd_mod.FoldedBN):
                if pname == "weight":
                    scale = DENSEPOSE_RESIDUAL_SCALE if prefix.endswith("conv3.norm") else 1.0
                    sd[key] = scale * (1 + randn(c, 0.1))
                    sd[f"{prefix}.running_mean"] = randn(c, 0.1)
                    sd[f"{prefix}.running_var"] = 0.5 + torch.rand(c, generator=gen).numpy()
                else:
                    sd[key] = randn(c, 0.05)
            elif isinstance(m, nn.GroupNorm) and pname == "weight":
                sd[key] = 1 + randn(c, 0.1)
            elif len(shape) == 4:
                sd[key] = randn(shape, (2.0 / (shape[0 if isinstance(
                    m, nn.ConvTranspose2d) else 1] * shape[2] * shape[3])) ** 0.5)
            elif isinstance(m, nn.Linear) and pname == "weight":
                sd[key] = randn(shape, shape[1] ** -0.5)
            else:
                sd[key] = randn(shape, 0.05)
    sd["backbone.bottom_up.stem.conv1.weight"] /= 64.0  # mean-subtracted pixels, not O(1)
    for key, std in DENSEPOSE_DETECTRON2_INIT.items():  # else the boxes fly off the image
        sd[f"{key}.weight"] = randn(sd[f"{key}.weight"].shape, std)
        sd[f"{key}.bias"] = np.zeros_like(sd[f"{key}.bias"])
    sd["roi_heads.box_predictor.cls_score.bias"] = np.asarray([person_bias, 0.0], np.float32)
    return {"model": {k: v.astype(np.float32) for k, v in sd.items()},
            "__author__": "seeded"}


# the published detector files whose layout is not a port module's torch
# state dict (write_detector_files writes each its own way)
OTHER_DETECTOR_FILES = ("table5_pidinet.pth", "yolov4.weights", "model_final_844d15.pkl")


def pass_shift(need: np.ndarray, k_range=(3, 8)) -> float:
    """The shift of a logit that lets k of the items through, for the k in
    `k_range` whose neighbours in `need` (each item passes once the shift
    exceeds its entry) lie furthest apart: the midpoint of that gap, so no
    item sits near the threshold."""
    s = np.sort(need[np.isfinite(need)])
    if len(s) <= k_range[0]:
        raise AssertionError(f"only {len(s)} items can pass at any shift")
    k = max(range(k_range[0], min(k_range[1], len(s) - 1) + 1), key=lambda k: s[k] - s[k - 1])
    return float((s[k - 1] + s[k]) / 2)


def yolo_objectness_shift(det, image, confidence: float = 0.4) -> float:
    """How far the objectness biases of `det`'s file must move for 3-8 of
    the boxes of `image` to pass `confidence` (``pass_shift``)."""
    need = []
    for raw, meta in zip(det.raw_maps(image), det.yolo_meta):
        r = raw.reshape(*raw.shape[:2], len(meta["mask"]), 5 + meta["classes"])
        best = (1 / (1 + np.exp(-r[..., 5:].astype(np.float64)))).max(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = confidence / best
            need.append(np.where(q < 1, np.log(q) - np.log1p(-q), np.inf) - r[..., 4])
    return pass_shift(np.concatenate([n.ravel() for n in need]))


def densepose_person_shift(det, image) -> float:
    """How far the person logit's bias of `det`'s file must move for 3-8
    of the proposals of `image` to pass SCORE_THRESH (``pass_shift``)."""
    x, hw = det.prepare(image)
    ps, rpn = det.trunk(x)
    proposals, _ = densepose_mod.rpn_proposals(rpn, densepose_mod.STRIDES, hw)
    p = det.box_scores(ps, proposals)[0].astype(np.float64)
    t = densepose_mod.SCORE_THRESH
    return pass_shift(math.log(t / (1 - t)) - (np.log(p) - np.log1p(-p)))


def write_detector_files(directory: str, seed: int = SEED, names=None, image=None,
                         device="cpu") -> dict:
    """The published detector files `names` (default all of
    DETECTOR_FILES and OTHER_DETECTOR_FILES), seeded, under `directory`;
    returns {file: what was written}. DETECTOR_FILES and table5_pidinet.pth
    are torch files (``torch.save``); yolov4.weights is darknet's binary,
    written beside YOLO_CFG as yolov4.cfg (``write_darknet_files``: the
    floats); model_final_844d15.pkl is detectron2's pickle of numpy arrays
    (``densepose_file_state``, protocol 2). Given an `image`, the seeded
    objectness and person biases are moved (by the port's detectors on
    `device`) so that 3-8 boxes and proposals of that image pass the
    detectors' thresholds, and the two files are written again with the
    same draws. DPT, UniFormer and DensePose are written at the widths of
    the ``annotators.midas`` / ``annotators.uniformer`` /
    ``annotators.densepose`` constants (a CPU test patches them small):
    DPT-Large's published widths make a 1.37 GB file."""
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    written = {}
    for name in (*DETECTOR_FILES, *OTHER_DETECTOR_FILES) if names is None else names:
        path = os.path.join(directory, name)
        if name == "yolov4.weights":
            draws = gen.get_state()
            written[name] = write_darknet_files(directory, gen)
            if image is not None:
                shift = yolo_objectness_shift(bbox_mod.BBoxDetector(
                    device=device, ckpt_dir=directory), image)
                gen.set_state(draws)
                written[name] = write_darknet_files(
                    directory, gen, objectness_bias=YOLO_OBJECTNESS_BIAS + shift)
            continue
        if name == "model_final_844d15.pkl":
            written[name] = state = densepose_file_state(gen)
            with open(path, "wb") as f:
                pickle.dump(state, f, protocol=2)
            if image is not None:
                state["model"]["roi_heads.box_predictor.cls_score.bias"][0] += \
                    densepose_person_shift(densepose_mod.DenseposeDetector(
                        device=device, ckpt_dir=directory), image)
                with open(path, "wb") as f:
                    pickle.dump(state, f, protocol=2)
            continue
        written[name] = (pidinet_file_state(gen) if name == "table5_pidinet.pth"
                         else detector_file_state(name, gen))
        torch.save(written[name], path)
    return written


# the app's defaults (app/gradio_ctrlora.py:96-97): one sample, 20 DDIM steps, CFG 7.5
APP_SAMPLES, APP_STEPS, APP_SCALE = 1, 20, 7.5
APP_KERNELS = SAMPLING_KERNELS
APP_CONTROLNET_KERNELS = BASELINE_SAMPLING_KERNELS["controlnet"]
# kernel A at the app's sites: the UNet's at the CFG batch of 2 (the
# ResBlocks' out_norm with row and SiLU, a transformer norm, the decoder's
# 960-channel in_norm) and the VAE's at one sample (the hint's encode and
# the decode at 512^2); the build phase holds A's plan at each
APP_GN_CASES = (
    ((2, 64, 64, 320), torch.bfloat16, 1e-5, True, True),
    ((2, 32, 32, 640), torch.bfloat16, 1e-5, True, True),
    ((2, 16, 16, 1280), torch.bfloat16, 1e-5, True, True),
    ((2, 8, 8, 1280), torch.bfloat16, 1e-5, True, True),
    ((2, 64, 64, 320), torch.bfloat16, 1e-6, False, False),
    ((2, 64, 64, 960), torch.bfloat16, 1e-5, True, False),
    ((1, 512, 512, 128), torch.bfloat16, 1e-6, True, False),
    ((1, 64, 64, 512), torch.bfloat16, 1e-6, False, False),
)
APP_ATTN_SITES = ((4096, 8, 40), (1024, 8, 80), (256, 8, 160))  # (S, heads, D), CFG batch 2
APP_GEGLU_SITES = ((2 * 4096, 320), (2 * 1024, 640), (2 * 256, 1280), (2 * 64, 1280))
FP32_PEAK_FLOPS = 67e12  # the H100 SXM's fp32 (non-tensor) rate: the detectors run TF32 off
LINEART_ITEMS, COND_IMAGES = 8, 4
# the detectors that threshold a network's map: a pixel one level off at
# the threshold flips (hedsketch's binary map, blurred; the colour prompt's
# dark test), so only the share of differing pixels is bounded
THRESHOLDED = ("hedsketch", "lineart_anime_with_color_prompt")


def app_kernel_checks(dev) -> None:
    """Kernels A, B (fused-qkv at D = 40/80/160, the VAE's BHSD D = 512), C
    at its four sites and D at the one- and two-LoRA step tables, at the
    app's one-sample shapes, each against its plain version within phase
    3's tolerances: max error, ms and b2b ms (20 calls queued behind a
    sleep kernel: the one-sample sites run shorter than their launch) beside
    the plain version's, the bound and the library call's ms."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED + 150)
    rn = lambda *s, dt=torch.bfloat16, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(dt)

    def check(kernel, label, got, want, fn_k, fn_p, work, library=None, extra=None, **beside):
        err = compare(got, want)
        if extra is not None:
            err = max(err, compare(*extra))
        ms, pms = time_ms(fn_k), time_ms(fn_p)
        bms, by = bound_ms(*work)
        row = {"kernel": kernel, "shape": label, "max_abs_err": err, "ms": ms, "plain_ms": pms,
               "b2b_ms": time_b2b(fn_k), "plain_b2b_ms": time_b2b(fn_p), "bound_ms": bms,
               "bound_by": by,
               "pct_of_bound": 100.0 * bms / ms, "library": library[0] if library else "—",
               "library_ms": time_ms(library[1]) if library else None, **beside}
        log("apps_kernels", **row)

    for shape, dt, eps, silu, row in APP_GN_CASES:
        c = shape[-1]
        x = rn(*shape, std=2.0, dt=dt) + 0.5
        sc, bi = rn(c, dt=torch.float32, std=0.1) + 1, rn(c, dt=torch.float32, std=0.1)
        args = (x, sc, bi, 32, eps, silu, rn(1, c, std=0.5, dt=dt) if row else None)
        check("group_norm", f"{list(shape)} eps={eps} silu={silu} add_row={row}",
              gn_ops.group_norm(*args), gn_ops.group_norm_plain(*args),
              lambda: gn_ops.group_norm(*args), lambda: gn_ops.group_norm_plain(*args),
              gn_ops.group_norm_work(shape[0], shape[1] * shape[2], c, x.element_size(),
                                     1 if row else 0),
              library=None if silu or row else group_norm_library(x, sc, bi, eps),
              plan=dataclasses.asdict(gn_ops.group_norm_plan(
                  shape[0], shape[1] * shape[2], c, 32, x.element_size(), sms)))
    for s, h, d in APP_ATTN_SITES:
        qkv = rn(2, s, 3 * h * d)
        out, lse = fa_ops.flash_attention_qkv(qkv, h, d)
        pout, plse = fa_ops.flash_attention_qkv_plain(qkv, h, d)
        check("flash_attention_qkv", f"[2, {s}, 3*{h}*{d}]", out, pout,
              lambda: fa_ops.flash_attention_qkv(qkv, h, d),
              lambda: fa_ops.flash_attention_qkv_plain(qkv, h, d),
              fa_ops.flash_forward_work(2, h, s, s, d),
              library=("F.scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(
                  *(t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, -1)))),
              extra=(lse, plse))
    q, k, v = (rn(1, 1, 4096, 512) for _ in range(3))
    out, lse = fa_ops.flash_attention(q, k, v)
    pout, plse = fa_ops.attention_plain(q, k, v)
    check("flash_attention", "[1, 1, 4096, 512]", out, pout,
          lambda: fa_ops.flash_attention(q, k, v), lambda: fa_ops.attention_plain(q, k, v),
          fa_ops.flash_forward_work(1, 1, 4096, 4096, 512),
          library=("F.scaled_dot_product_attention",
                   lambda: F.scaled_dot_product_attention(q, k, v)), extra=(lse, plse))
    for rows_, c in APP_GEGLU_SITES:
        f = 4 * c
        args = (rn(rows_, c), rn(2 * f, c, std=c ** -0.5), rn(2 * f, std=0.1),
                rn(c, f, std=f ** -0.5), rn(c, std=0.1))
        check("geglu_ffn", f"rows={rows_} C={c} F={f}", geglu_ops.geglu_ffn(*args),
              geglu_ops.geglu_ffn_plain(*args), lambda: geglu_ops.geglu_ffn(*args),
              lambda: geglu_ops.geglu_ffn_plain(*args), geglu_ops.geglu_ffn_work(rows_, c, f),
              plan=dataclasses.asdict(geglu_ops.geglu_plan(rows_, c, f, sms)))
    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    for controls in (1, 2):
        sizes = emb_row_sizes(cfg, controls)
        block = rn(len(sizes), max(sizes))
        got = torch.cat(unpack_ops.unpack_rows(block, sizes), 1)
        want = torch.cat(unpack_ops.unpack_rows_plain(block, sizes), 1)
        if not torch.equal(got, want):
            raise AssertionError(f"unpack_rows at {len(sizes)} rows differs from plain")
        index = torch.cat([torch.arange(c, device=dev) + i * block.stride(0)
                           for i, c in enumerate(sizes)])
        check("unpack_rows", f"[{len(sizes)}, {max(sizes)}] ({controls} LoRA)", got, want,
              lambda: unpack_ops.unpack_rows(block, sizes),
              lambda: unpack_ops.unpack_rows_plain(block, sizes),
              unpack_ops.unpack_rows_work(sizes),
              library=("torch.take (cached flat index)", lambda: torch.take(block, index)),
              bit_equal=True)


def one_evaluation_rel(model: api_mod.CtrLoRA, images, weights, gen) -> float:
    """One UNet + ControlNet(s) evaluation at the app's CFG batch of 2 (t =
    981) with the kernels against the plain versions: relative L2."""
    pipe, dev = model.pipe, model.device
    ctx, unc = pipe.encode_text_cond_uncond(model.token_ids(PROMPT, APP_SAMPLES),
                                            model.token_ids(N_PROMPT, APP_SAMPLES))
    conds = [dataclasses.replace(c, hint=torch.cat([c.hint, c.hint]))
             for c in model.conditions(images, APP_SAMPLES, weights)]
    lat = images[0].shape[0] // 2 ** (len(model.cfg.vae.ch_mult) - 1)
    x = torch.randn((APP_SAMPLES, lat, images[0].shape[1] * lat // images[0].shape[0], 4),
                    generator=gen, device=dev)
    ts = torch.tensor([981], dtype=torch.int32, device=dev)
    tvec = torch.full((2 * APP_SAMPLES,), 981, dtype=torch.int32, device=dev)

    def evaluate():
        packed, rows_of = make_emb_row_tables(pipe, conds, ts)
        return pipe.apply_model(torch.cat([x, x]), tvec, torch.cat([ctx, unc]), conds,
                                emb_rows=rows_of(packed[0]))

    out_k = evaluate()
    with plain_versions():
        out_p = evaluate()
    return rel_l2(out_k, out_p)


def app_call(path: str, required, call) -> tuple:
    """call() with every launch count zeroed before and read after: (its
    result, seconds, launches)."""
    with counted(f"apps {path}", required) as launches:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, seconds, launches


def check_samples(path, out, n_conditions, size):
    """The app's output: its condition image(s), then APP_SAMPLES uint8
    samples at `size`, not constant."""
    samples = out[n_conditions:]
    ok = len(samples) == APP_SAMPLES and all(
        o.shape == (*size, 3) and o.dtype == np.uint8 and o.std() > 0 for o in samples)
    if not ok:
        raise AssertionError(f"apps {path}: {[(o.shape, o.dtype) for o in out]}")


def app_ctrlora(dev, api_paths, image, image2):
    """AppState.process (guess mode off and on) and process2 at the app's
    defaults on phase 8's files, through `detect` (canny). Returns the
    launches of each timed call."""
    state = apps_logic.AppState(device=dev)
    sd, cn, loras = api_paths["sd"], api_paths["basecn"], api_paths["loras"]
    detected, detect_ms = timed(lambda: apps_logic.detect("canny", image, device=dev), dev)
    detected2 = apps_logic.detect("canny", image2, device=dev)
    model, create_ms = timed(lambda: state.build_model(sd, cn, [loras[0]]), dev)
    call = lambda guess, steps=APP_STEPS: state.process(
        "canny", detected, PROMPT, N_PROMPT, APP_SAMPLES, steps, guess, 1.0, APP_SCALE, SEED,
        0.0, sd, cn, loras[0])
    _, warm_ms = timed(lambda: call(False, 2), dev)
    runs, images = {}, {}
    for guess in (False, True):
        out, seconds, runs[f"process_guess_{guess}"] = app_call(
            f"process guess_mode={guess}", APP_KERNELS, lambda: call(guess))
        check_samples("process", out, 1, detected.shape[:2])
        images[guess] = out[1]
        log("apps", path="process", guess_mode=guess, samples=APP_SAMPLES, steps=APP_STEPS,
            scale=APP_SCALE, size=list(detected.shape[:2]), s_per_call=seconds,
            launches=runs[f"process_guess_{guess}"],
            launches_per_step={k: v / APP_STEPS for k, v in
                               runs[f"process_guess_{guess}"].items()},
            image_mean=float(out[1].mean()), image_std=float(out[1].std()))
    with plain_versions():
        plain = call(False)[1]
    rel_image = rel_l2(torch.from_numpy(images[False]), torch.from_numpy(plain))
    rel_guess = rel_l2(torch.from_numpy(images[True]), torch.from_numpy(images[False]))
    rel_eval = one_evaluation_rel(model, [detected], (1.0,),
                                  torch.Generator(device=dev).manual_seed(SEED + 151))
    log("apps", path="process", detect_canny_ms=detect_ms, create_model_s=create_ms / 1e3,
        warmup_2_steps_ms=warm_ms, rel_l2_decoded_image_kernels_vs_plain=rel_image,
        rel_l2_guess_vs_not=rel_guess, rel_l2_one_evaluation_kernels_vs_plain=rel_eval,
        bound=MODEL_REL_TOL)
    if not rel_eval <= MODEL_REL_TOL or not rel_guess > 1e-3:
        raise AssertionError(f"apps process: one evaluation {rel_eval} from plain, guess mode "
                             f"moved the image {rel_guess}")

    model2, create2_ms = timed(lambda: state.build_model(sd, cn, loras), dev)
    del model
    call2 = lambda steps=APP_STEPS: state.process2(
        detected, detected2, PROMPT, N_PROMPT, APP_SAMPLES, steps, 1.0, APP_SCALE, SEED, 0.0,
        sd, cn, loras[0], loras[1], *LORA_WEIGHTS)
    call2(2)
    out, seconds, runs["process2"] = app_call("process2", APP_KERNELS, call2)
    check_samples("process2", out, 2, out[0].shape[:2])
    rel_eval2 = one_evaluation_rel(model2, out[:2], LORA_WEIGHTS,
                                   torch.Generator(device=dev).manual_seed(SEED + 152))
    log("apps", path="process2", samples=APP_SAMPLES, steps=APP_STEPS, scale=APP_SCALE,
        sizes=[list(o.shape) for o in out[:2]], create_model_s=create2_ms / 1e3,
        s_per_call=seconds, launches=runs["process2"],
        launches_per_step={k: v / APP_STEPS for k, v in runs["process2"].items()},
        rel_l2_one_evaluation_kernels_vs_plain=rel_eval2, bound=MODEL_REL_TOL,
        image_mean=float(out[2].mean()), image_std=float(out[2].std()))
    if not rel_eval2 <= MODEL_REL_TOL or out[0].shape != out[1].shape:
        raise AssertionError(f"apps process2: one evaluation {rel_eval2} from plain, crops "
                             f"{out[0].shape} {out[1].shape}")
    return runs


def app_controlnet(dev, files, image):
    """process_controlnet at the app's defaults on phase 11's SD and
    control files. Returns the launches of the timed call."""
    cache = apps_logic.ModelCache()
    _, create_ms = timed(lambda: apps_logic.build_controlnet(
        files["sd"], files["control"], dev, cache), dev)
    call = lambda steps=APP_STEPS: apps_logic.process_controlnet(
        "canny", image, PROMPT, N_PROMPT, APP_SAMPLES, steps, 1.0, APP_SCALE, SEED,
        files["sd"], files["control"], dev, cache)
    call(2)
    out, seconds, launches = app_call("process_controlnet", APP_CONTROLNET_KERNELS, call)
    check_samples("process_controlnet", out, 1, out[0].shape[:2])
    log("apps", path="process_controlnet", samples=APP_SAMPLES, steps=APP_STEPS,
        scale=APP_SCALE, size=list(out[0].shape[:2]), create_s=create_ms / 1e3,
        s_per_call=seconds, launches=launches,
        launches_per_step={k: v / APP_STEPS for k, v in launches.items()},
        image_mean=float(out[1].mean()), image_std=float(out[1].std()))
    return launches


def app_style(dev, paths, image, style_image):
    """process_style at the app's defaults ('Load only style blocks', IP
    scale 1) on phase 13's files. Returns the launches of the timed call."""
    cache = apps_logic.ModelCache()
    args = (paths["sd"], paths["basecn"], paths["loras"][0], paths["ip"], 1.0,
            apps_logic.STYLE_TARGETS["Load only style blocks"])
    _, create_ms = timed(lambda: apps_logic.build_style(
        *args, image_encoder_ckpt=paths["vision"], device=dev, cache=cache), dev)
    call = lambda steps=APP_STEPS: apps_logic.process_style(
        "canny", image, style_image, PROMPT, N_PROMPT, APP_SAMPLES, steps, APP_SCALE, SEED,
        *args, image_encoder_ckpt=paths["vision"], device=dev, cache=cache)
    call(2)
    out, seconds, launches = app_call("process_style", STYLE_KERNELS, call)
    check_samples("process_style", out, 2, out[0].shape[:2])
    log("apps", path="process_style", samples=APP_SAMPLES, steps=APP_STEPS, scale=APP_SCALE,
        size=list(out[0].shape[:2]), style_image=list(style_image.shape),
        create_s=create_ms / 1e3, s_per_call=seconds, launches=launches,
        launches_per_step={k: v / APP_STEPS for k, v in launches.items()},
        image_mean=float(out[2].mean()), image_std=float(out[2].std()))
    return launches


def uint8_diff(got, want) -> tuple:
    """(largest level difference, share of pixels that differ)."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff > 0).mean())


def median_ms(fn, dev, reps: int = 3) -> tuple:
    """(fn()'s last result, its median wall ms over `reps` calls after a
    first call, the first call's ms); each call ended by a synchronise."""
    _, first_ms = timed(fn, dev)
    times = []
    for _ in range(reps):
        out, ms = timed(fn, dev)
        times.append(ms)
    return out, sorted(times)[len(times) // 2], first_ms


def gflop_row(fn, ms) -> dict:
    """fn()'s fp32 GFLOP (its networks' convolutions and matmuls) and
    their share of the fp32 peak at `ms` a call."""
    gflop = flops_of(fn) / 1e9
    return {"gflop": gflop, "pct_fp32_peak": 100 * gflop * 1e9 / FP32_PEAK_FLOPS / (ms / 1e3)}


def net_inputs(net, fn) -> list:
    """The NHWC float32 inputs that fn() gives `net`, a call each, so the
    detector's own resizes set the shapes."""
    seen = []
    hook = net.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        fn()
    finally:
        hook.remove()
    return [x.permute(0, 2, 3, 1).cpu().numpy() for x in seen]


def maps_close(got, want, rtol=1e-4) -> tuple:
    """(largest difference over the largest |want|, within rtol of it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    return err, err <= rtol


def pose_close(got, want, hw) -> bool:
    """As many people and candidates, each candidate within 1 px of an
    image of size `hw` (the pose holds them as fractions of it)."""
    g, w = np.asarray(got["bodies"]["candidate"]), np.asarray(want["bodies"]["candidate"])
    return len(got["bodies"]["subset"]) == len(want["bodies"]["subset"]) and \
        g.shape == w.shape and (not len(w) or (np.abs(g - w) * hw[::-1]).max() <= 1.0)


def detector_check(name, det, cpu, image, got, want, dev) -> tuple:
    """(the row's extra fields, ok) of the card's output `got` against the
    CPU's `want`, by the tolerance of detector `name`."""
    if name == "midas":
        (level, share), (n_level, n_share) = uint8_diff(got[0], want[0]), \
            normal_diff(got[1], want[1])
        return ({"gpu_vs_cpu_max_levels": level, "gpu_vs_cpu_pixels_differing": share,
                 "normal_pixels_over_1_level": n_level, "normal_pixels_differing": n_share},
                level <= 1 and share <= 1e-3 and n_level <= 1e-3 and n_share <= 1e-3)
    level, share = uint8_diff(got, want)
    row = {"gpu_vs_cpu_max_levels": level, "gpu_vs_cpu_pixels_differing": share}
    if name == "mlsd":
        tp, tp_cpu = det.tp_map(image), cpu.tp_map(image)
        row["tp_map_max_abs_err"] = float(np.abs(tp - tp_cpu).max())
        return row, np.allclose(tp, tp_cpu, rtol=1e-4, atol=1e-5) and (got == want).mean() >= 0.99
    if name in THRESHOLDED:  # a level across the threshold flips a pixel
        return row, share <= 1e-3
    if name == "normal":  # the bg_th mask flips a pixel; truncation moves a level
        row["pixels_over_1_level"], row["pixels_differing"] = normal_diff(got, want)
        return row, row["pixels_over_1_level"] <= 1e-3 and row["pixels_differing"] <= 1e-3
    if name == "seg":  # an argmax near a tie flips a pixel
        row["logits_rel_err"], ok = maps_close(det.logits(image).cpu(), cpu.logits(image))
        return row, ok and share <= 1e-3
    if name == "openpose":
        # the body net alone, timed as the hand and face nets are; the
        # detector's fp32 share is the net's, the rest of its image is host time
        bgr = image[:, :, ::-1].copy()
        net = det.body.model
        x, = net_inputs(net, lambda: det.body.maps(bgr))
        _, net_ms, _ = median_ms(lambda: annot_nets.forward(net, x), dev)
        row.update(body_net_input=list(x.shape[1:3]), body_net_ms=net_ms,
                   **gflop_row(lambda: annot_nets.forward(net, x), net_ms))
        maps, maps_cpu = det.body.maps(bgr), cpu.body.maps(bgr)
        errs = [maps_close(g, w) for g, w in zip(maps, maps_cpu)]
        row["heatmap_rel_err"], row["paf_rel_err"] = errs[0][0], errs[1][0]
        pose, pose_cpu = det(image, return_is_index=True), cpu(image, return_is_index=True)
        peaks = sum(len(p) for p in openpose_mod.decode.find_peaks(maps[0]))
        t0 = time.perf_counter()
        people = openpose_mod.decode.body_decode(*maps)[1]
        row.update(peaks=peaks, people=len(people), decode_ms=(time.perf_counter() - t0) * 1e3,
                   candidates=len(pose["bodies"]["candidate"]))
        return row, (errs[0][1] and errs[1][1] and share <= 1e-3
                     and pose_close(pose, pose_cpu, image.shape[:2]))
    if name == "bbox":
        errs = [maps_close(g, w)[0] for g, w in zip(det.raw_maps(image), cpu.raw_maps(image))]
        (boxes, labels, _), (boxes_cpu, labels_cpu, _) = det.detect(image), cpu.detect(image)
        row.update(yolo_maps_rel_err=max(errs), boxes=len(boxes), labels=labels,
                   same_boxes_and_labels=boxes == boxes_cpu and labels == labels_cpu)
        return row, (max(errs) <= 1e-4 and row["same_boxes_and_labels"] and len(boxes) >= 1
                     and share <= 1e-3)
    if name == "densepose":
        row.update(densepose_stages(det, cpu, image, dev))
        return row, (row["fpn_rel_err"] <= 1e-4 and row["rpn_rel_err"] <= 1e-4
                     and row["proposals_differing"] <= 0.01 * row["proposals"]
                     and row["box_head_rel_err"] <= 1e-4 and row["decoder_rel_err"] <= 1e-4
                     and row["roi_align_rel_err"] <= 1e-4 and row["chart_head_rel_err"] <= 1e-4
                     and 1 <= row["persons"] <= 10 and row["part_labels_drawn"]
                     and share <= 1e-3)
    if name == "lineart":  # the coarse weights too
        row["coarse_levels_share"] = uint8_diff(det(image, coarse=True),
                                                cpu(image, coarse=True))
        return row, level <= 1 and share <= 1e-3 and row["coarse_levels_share"][0] <= 1 and \
            row["coarse_levels_share"][1] <= 1e-3
    return row, level <= 1 and share <= 1e-3


def rows_differing(got, want, atol: float = 1e-2) -> int:
    """How many rows of `got` [N, 4] have no row of `want` within `atol`,
    plus the difference in count."""
    if not len(got) or not len(want):
        return max(len(got), len(want))
    near = np.abs(got[:, None, :] - want[None, :, :]).max(-1).min(1) <= atol
    return int((~near).sum()) + max(len(want) - len(got), 0)


def densepose_stages(det, cpu, image, dev) -> dict:
    """DensePose on the card against the CPU stage by stage, each stage fed
    the CPU's input: the FPN levels and RPN maps of the same image (rtol
    1e-4); the proposal sets of each device's own maps (how many differ, by
    more than 0.01 px); the box head on the CPU's 7x7 ROIAlign of the CPU's
    proposals; the decoder on the CPU's FPN levels; ROIAlign 28x28 of the
    CPU's decoder map at the CPU's person boxes; the chart head on the
    CPU's pooled features (each rtol 1e-4). Then the persons the CPU finds,
    its part labels drawn, and the card alone at MAX_DET persons (every
    proposal passing: SCORE_THRESH 0)."""
    x, hw = det.prepare(image)
    ps, rpn = det.trunk(x)
    ps_cpu, rpn_cpu = cpu.trunk(x)
    out = {"fpn_rel_err": max(maps_close(g.cpu(), w)[0] for g, w in zip(ps, ps_cpu)),
           "rpn_rel_err": max(maps_close(g, w)[0] for a, b in zip(rpn, rpn_cpu)
                              for g, w in zip(a, b))}
    props = densepose_mod.rpn_proposals(rpn, densepose_mod.STRIDES, hw)[0]
    props_cpu = densepose_mod.rpn_proposals(rpn_cpu, densepose_mod.STRIDES, hw)[0]
    out.update(proposals=len(props_cpu), proposals_card=len(props),
               proposals_differing=rows_differing(props, props_cpu))
    boxes_cpu = torch.from_numpy(props_cpu.astype(np.float32))
    levels = densepose_mod.assign_levels(props_cpu)
    with torch.inference_mode(), fp32_exact():
        pooled = torch.zeros((len(props_cpu), ps_cpu[0].shape[1], densepose_mod.POOL_BOX,
                              densepose_mod.POOL_BOX))
        for lv in np.unique(levels):
            sel = torch.from_numpy(np.where(levels == lv)[0])
            pooled[sel] = densepose_mod.roi_align(ps_cpu[lv - 2], boxes_cpu[sel],
                                                  1.0 / densepose_mod.STRIDES[lv - 2],
                                                  densepose_mod.POOL_BOX, 2)
        got, want = det.model.box_head(pooled.to(dev)), cpu.model.box_head(pooled)
        out["box_head_rel_err"] = max(maps_close(g.cpu(), w)[0] for g, w in zip(got, want))
        scores, deltas = (t.numpy() for t in want)
        persons = cpu.select(props_cpu, scores, deltas, hw)
        dec_cpu = cpu.model.roi_heads.decoder(ps_cpu)
        dec = det.model.roi_heads.decoder([p.to(dev) for p in ps_cpu])
        out["decoder_rel_err"] = maps_close(dec.cpu(), dec_cpu)[0]
        b = torch.from_numpy(persons.astype(np.float32))
        pooled = densepose_mod.roi_align(dec_cpu, b, 0.25, densepose_mod.POOL_CHART, 2)
        out["roi_align_rel_err"] = maps_close(densepose_mod.roi_align(
            dec_cpu.to(dev), b.to(dev), 0.25, densepose_mod.POOL_CHART, 2).cpu(), pooled)[0]
        got, want = det.model.chart_head(pooled.to(dev)), cpu.model.chart_head(pooled)
        out["chart_head_rel_err"] = max(maps_close(got[k].cpu(), want[k])[0] for k in want)
        out["persons"] = len(persons)
        out["part_labels_drawn"] = bool(len(persons) and cpu.part_labels(want).max() > 0)
    with mock.patch.object(densepose_mod, "SCORE_THRESH", 0.0):
        boxes, _, _ = det.detect(image)
        _, out["max_det_ms"], _ = median_ms(lambda: det(image), dev)
    out["max_det_persons"] = len(boxes)
    return out


def normal_diff(got, want) -> tuple:
    """(share of pixels more than 1 level apart, share of pixels differing)."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    return float((diff > 1).mean()), float((diff > 0).mean())


# a person on a 128 x 128 image: (x, y) of the 18 COCO parts
PERSON = [(64, 20), (64, 34), (50, 34), (44, 50), (40, 66), (78, 34), (84, 50), (88, 66),
          (56, 70), (54, 90), (54, 110), (72, 70), (74, 90), (74, 110), (60, 16), (68, 16),
          (56, 18), (72, 18)]


def person_maps(size: int = 128) -> tuple:
    """Body maps of PERSON scaled to a `size` x `size` image: heatmaps
    [size, size, 19] with a Gaussian at each part, PAFs [size, size, 38] of
    unit vectors along each limb, 2 px wide at 128 (decode's layout)."""
    k = size / 128
    person = [(x * k, y * k) for x, y in PERSON]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    hm = np.zeros((size, size, 19), np.float32)
    for p, (x, y) in enumerate(person):
        hm[:, :, p] = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (8.0 * k * k))
    paf = np.zeros((size, size, 38), np.float32)
    for (a, b), (cx, cy) in zip(openpose_mod.decode.LIMB_SEQ, openpose_mod.decode.MAP_IDX):
        (xa, ya), (xb, yb) = person[a - 1], person[b - 1]
        n = math.hypot(xb - xa, yb - ya)
        ux, uy = (xb - xa) / n, (yb - ya) / n
        t = np.clip(((xx - xa) * ux + (yy - ya) * uy) / n, 0, 1)
        near = np.hypot(xx - (xa + t * (xb - xa)), yy - (ya + t * (yb - ya))) <= 2 * k
        paf[near, cx - 19] = ux
        paf[near, cy - 19] = uy
    return hm, paf


def peaks_px(parts, hw) -> np.ndarray:
    """Hand or face peaks (fractions of the image, -1 where none) in pixels."""
    return np.asarray(parts, np.float64).reshape(-1, 2) * hw[::-1]


def openpose_person(det, cpu, dev, image) -> None:
    """OpenposeDetector(hand_and_face=True) on the card and the CPU with the
    body's maps replaced by PERSON's at the image's size (the seeded body
    net finds no one): the people assembled from them, the hand and face
    crops through their seeded nets on each device and the pose drawn. Held:
    one person of 18 parts on both, two hands and a face, their peaks within
    1 px of the CPU's, the canvas at most 0.1% of pixels differing."""
    hw = image.shape[:2]
    maps = person_maps(hw[0])
    run = lambda d: d(image, hand_and_face=True, return_is_index=True)
    with mock.patch.object(det.body, "maps", lambda img: maps):
        pose, ms = timed(lambda: run(det), dev)
    with mock.patch.object(cpu.body, "maps", lambda img: maps):
        pose_cpu = run(cpu)
    canvas, canvas_cpu = openpose_mod.draw_pose(pose, *hw), openpose_mod.draw_pose(pose_cpu, *hw)
    subsets = [np.asarray(p["bodies"]["subset"]) for p in (pose, pose_cpu)]
    parts = [(pose[k], pose_cpu[k]) for k in ("hands", "faces")]
    shift = max([float(np.abs(peaks_px(g, hw) - peaks_px(w, hw)).max())
                 for gs, ws in parts for g, w in zip(gs, ws)], default=0.0)
    row = {"people": len(subsets[0]), "parts": int(subsets[0][0][-1]) if len(subsets[0]) else 0,
           "hands": len(pose["hands"]), "faces": len(pose["faces"]), "peaks_max_px": shift,
           "pixels_differing": uint8_diff(canvas, canvas_cpu)[1]}
    log("apps_detectors", detector="openpose person", size=list(hw), ms_per_image=ms, **row,
        tol="1 person of 18 parts, 2 hands and a face, peaks within 1 px, 0.1% of pixels")
    if not (row["people"] == len(subsets[1]) == 1 and row["parts"] == 18
            and np.array_equal(*subsets) and pose_close(pose, pose_cpu, hw)
            and row["hands"] == len(pose_cpu["hands"]) == 2
            and row["faces"] == len(pose_cpu["faces"]) == 1 and shift <= 1.0
            and canvas.any() and row["pixels_differing"] <= 1e-3):
        raise AssertionError(f"openpose on a person departs from the CPU: {row}")


def openpose_parts(dev, image) -> None:
    """(c) OpenPose's hand net at its four padded scales and its face net at
    384^2, on the inputs the detector makes of a 256^2 crop of `image` (a
    seeded body may find no person, whose crops would call them): each
    timed, its GFLOP and share of the fp32 peak, its heatmaps card against
    CPU within rtol 1e-4; then the detector once with hand_and_face=True,
    and once on a person (``openpose_person``)."""
    det, cpu = annot_registry.get("openpose", dev), annot_registry.get("openpose", "cpu")
    crop = image[:256, :256, ::-1].copy()
    cases = [("hand", det.hand.model, cpu.hand.model, x)
             for x in net_inputs(det.hand.model, lambda: det.hand.heatmap(crop))]
    cases += [("face", det.face.model, cpu.face.model, x)
              for x in net_inputs(det.face.model, lambda: det.face(crop))]
    for part, net, net_cpu, x in cases:
        got, ms, first_ms = median_ms(lambda: annot_nets.forward(net, x), dev)
        t0 = time.perf_counter()
        want = annot_nets.forward(net_cpu, x)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err, ok = maps_close(got, want)
        log("apps_detectors", detector=f"openpose {part}", size=list(x.shape[1:3]),
            ms_per_image=ms, first_ms=first_ms, cpu_ms=cpu_ms,
            **gflop_row(lambda: annot_nets.forward(net, x), ms),
            heatmap_rel_err=err, tol="heatmaps rtol 1e-4")
        if not ok:
            raise AssertionError(f"openpose {part} at {x.shape[1:3]}: heatmaps {err}")
    (out, ms), want = timed(lambda: det(image, hand_and_face=True), dev), \
        cpu(image, hand_and_face=True)
    log("apps_detectors", detector="openpose hand_and_face", size=list(image.shape[:2]),
        ms_per_image=ms, pixels_differing=uint8_diff(out, want)[1])
    if out.shape != image.shape or uint8_diff(out, want)[1] > 1e-3:
        raise AssertionError(f"openpose hand_and_face: {uint8_diff(out, want)}")
    openpose_person(det, cpu, dev, image)


# the card against the CPU, where a detector's row is not held to 1 level on 0.1% of pixels
DETECTOR_TOL = {
    "bbox": "yolo maps rtol 1e-4, the same boxes and labels, 0.1% of pixels",
    "densepose": "FPN, RPN, box head, decoder, ROIAlign, chart head rtol 1e-4 on the CPU's "
                 "inputs; proposals 1% differing; 1-10 persons; 0.1% of pixels",
}


def app_detectors(dev, image):
    """Each ported CNN detector through the registry on the card at 512^2
    from seeded published-layout files: ms an image (median of 3 after a
    first call), the fp32 GFLOP of its call and their share of the fp32
    peak (OpenPose's: its body net's, timed alone), and its map against the
    same detector on the CPU (``detector_check``: within 1 level on 0.1% of
    pixels; the THRESHOLDED ones: 0.1% of pixels differing; MLSD: its
    network map within rtol 1e-4 / atol 1e-5 and 99% of the drawn pixels;
    normal: 1 level but on 0.1% of pixels (the bg_th mask), 0.1% differing;
    seg: its logits within rtol 1e-4, 0.1% of pixels differing; openpose:
    heatmaps and PAFs within rtol 1e-4, as many people and candidates each
    within 1 px, 0.1% of pixels differing; pidinet: 1 level on 0.1%; bbox:
    the raw yolo maps within rtol 1e-4, the same boxes and labels (at least
    one), 0.1% of the mask's pixels differing; densepose: stage by stage,
    ``densepose_stages``, 1-10 persons, 0.1% of the canvas's pixels
    differing); then OpenPose's hand and face nets and a person
    (``openpose_parts``) and ``detect`` for depth, normal, seg, openpose,
    bbox and densepose; no hand-written kernel launched. The files' YOLO
    objectness and DensePose person biases were tuned to `image`
    (``write_detector_files``)."""
    with counted("apps detectors", ()) as launches:
        for name in annot_registry.CNN:
            det, cpu = annot_registry.get(name, dev), annot_registry.get(name, "cpu")
            kw = lambda: {"rng": np.random.default_rng(SEED)} if name in (
                "hedsketch", "lineart_anime_with_color_prompt") else {}
            got, ms, first_ms = median_ms(lambda: det(image, **kw()), dev)
            t0 = time.perf_counter()
            want = cpu(image, **kw())
            cpu_ms = (time.perf_counter() - t0) * 1e3
            extra, ok = detector_check(name, det, cpu, image, got, want, dev)
            row = {"detector": name, "size": list(image.shape[:2]), "ms_per_image": ms,
                   "first_ms": first_ms, "cpu_ms": cpu_ms,
                   **gflop_row(lambda: det(image, **kw()), ms), **extra}
            log("apps_detectors", **row, tol=DETECTOR_TOL.get(name, "1 level on 0.1% of pixels"))
            outs = got if name == "midas" else (got,)
            # a seeded body net finds peaks but no person: its canvas stays black
            drawn = row["peaks"] > 0 if name == "openpose" else all(o.any() for o in outs)
            if not ok or not drawn or any(o.dtype != np.uint8 for o in outs):
                raise AssertionError(f"detector {name} on the card departs from the CPU: {row}")
        openpose_parts(dev, image)
        for name in ("depth", "normal", "seg", "openpose", "bbox", "densepose"):
            out, ms = timed(lambda: apps_logic.detect(name, image, SIZE, SIZE, device=dev), dev)
            log("apps_detectors", detect=name, ms=ms, shape=list(out.shape))
            if out.shape != (SIZE, SIZE, 3) or out.dtype != np.uint8:
                raise AssertionError(f"detect({name!r}): {out.shape} {out.dtype}")
    if any(launches.values()):
        raise AssertionError(f"the detectors launched hand-written kernels: {launches}")


def quiet(fn, *args):
    """fn(*args) with its prints captured: (result, printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def app_tools(dev, root, api_paths, rng):
    """The tools at SD1.5 width on phase 8's files: tool_make_control_init
    from the SD file, tool_combine_weights of it with the SD file and LoRA 0,
    tool_extract_weights -t control and -t lora from the combined file (the
    round trip bit-equal: the LoRA file back, the control init back with
    LoRA 0's zero convs and norms); tool_make_cond_images over
    COND_IMAGES PNGs with hed and lineart on the card; then
    evaluate_lineart_is_coarse and evaluate_lineart over LINEART_ITEMS
    samples whose conditions are the card's lineart, coarse for odd items
    (the flags must find them)."""
    p = {k: os.path.join(root, f"{k}.ckpt") for k in ("init", "combined", "control", "lora")}
    sd, lora0 = api_paths["sd"], api_paths["loras"][0]
    t = {}
    t0 = time.perf_counter()
    init, printed = quiet(tool_make_control_init.main, ["--sd_ckpt", sd, "--output_path",
                                                        p["init"]])
    t["make_control_init_s"] = time.perf_counter() - t0
    sd_file = ckpt_torch.load_torch_state_dict(sd)
    new = [ln for ln in printed if "newly added" in ln]
    copied = [k for k in init if "model.diffusion_model." + k[len("control_model."):] in sd_file]
    zero = [k for k in init if k.startswith(("control_model.zero_convs",
                                             "control_model.middle_block_out"))]
    bad = [k for k in copied if not np.array_equal(
        init[k], sd_file["model.diffusion_model." + k[len("control_model."):]])]
    bad += [k for k in zero if init[k].any()]
    del sd_file
    t0 = time.perf_counter()
    combined, _ = quiet(tool_combine_weights.main, ["--sd_ckpt", sd, "--base_ckpt", p["init"],
                                                    "--lora_ckpt", lora0, "--save_path",
                                                    p["combined"]])
    t["combine_s"] = time.perf_counter() - t0
    n_combined = len(combined)
    del combined
    extracted = {}
    for kind in ("control", "lora"):
        t0 = time.perf_counter()
        out, _ = quiet(tool_extract_weights.main, ["-t", kind, "--ckpt", p["combined"],
                                                   "--save_path", p[kind]])
        t[f"extract_{kind}_s"] = time.perf_counter() - t0
        extracted[kind] = out[p[kind]]
    lora_file = ckpt_torch.load_torch_state_dict(lora0)
    want_control = {k: lora_file.get(k, v) for k, v in init.items()}
    round_trip = {kind: sorted(got) == sorted(want) and all(
        np.array_equal(got[k], want[k]) for k in want)
        for kind, got, want in (("lora", extracted["lora"], lora_file),
                                ("control", extracted["control"], want_control))}
    log("apps_tools", **t, file_gb={k: os.path.getsize(v) / 2 ** 30 for k, v in p.items()},
        init_keys=len(init), copied_from_sd=len(copied), newly_added=len(new),
        zero_conv_keys=len(zero), combined_keys=n_combined, lora_keys=len(lora_file),
        mismatched=bad[:5], round_trip_bit_equal=round_trip)
    if bad or not copied or not zero or not all(round_trip.values()) or \
            len(copied) + len(new) != len(init):
        raise AssertionError(f"tools: mismatched {bad[:5]}, round trip {round_trip}")
    del init, extracted, lora_file, want_control
    for f in p.values():
        os.remove(f)

    import cv2

    src = os.path.join(root, "images")
    os.makedirs(src)
    for i in range(COND_IMAGES):
        cv2.imwrite(os.path.join(src, f"{i}.jpg"), smooth_image(rng, 480, 640)[..., ::-1])
    for det in ("hed", "lineart"):
        out_dir = os.path.join(root, f"cond_{det}")
        t0 = time.perf_counter()
        results, _ = quiet(tool_make_cond_images.main, ["--input_dir", src, "--output_dir",
                                                        out_dir, "--detector", det,
                                                        "--device", dev.type])
        seconds = time.perf_counter() - t0
        shapes = {png_shape(os.path.join(out_dir, f"{i}.png")) == [512, 704, 3]
                  for i in range(COND_IMAGES)}
        log("apps_tools", tool="tool_make_cond_images", detector=det, images=COND_IMAGES,
            seconds=seconds, written=sum(ok for _, ok in results), pngs_512x704=shapes == {True})
        if sum(ok for _, ok in results) != COND_IMAGES or shapes != {True}:
            raise AssertionError(f"tool_make_cond_images {det}: {results}, shapes {shapes}")

    sample_dir = os.path.join(root, "lineart_eval")
    for sub in ("img", "control", "sample"):
        os.makedirs(os.path.join(sample_dir, sub))
    det = annot_registry.get("lineart", dev)
    for i in range(LINEART_ITEMS):
        img = smooth_image(rng, SIZE, SIZE)
        write_png(os.path.join(sample_dir, "img", f"{i:06d}.png"), img)
        write_png(os.path.join(sample_dir, "control", f"{i:06d}.png"),
                  HWC3(det(img, coarse=i % 2 == 1)))
        noisy = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        write_png(os.path.join(sample_dir, "sample", f"{i:06d}.png"), noisy)
    flags_file = os.path.join(root, "is_coarse.txt")
    t0 = time.perf_counter()
    flags, _ = quiet(evaluate_lineart_is_coarse.main, ["--sample_dir", sample_dir, "--out",
                                                       flags_file, "--device", dev.type])
    coarse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results, printed = quiet(evaluate_lineart.main, ["--sample_dir", sample_dir, "--is_coarse",
                                                     flags_file, "--device", dev.type])
    lineart_s = time.perf_counter() - t0
    want_flags = [i % 2 == 1 for i in range(LINEART_ITEMS)]
    log("apps_tools", tool="evaluate_lineart", items=LINEART_ITEMS, is_coarse_s=coarse_s,
        evaluate_s=lineart_s, flags=flags, flags_found_the_coarse_items=flags == want_flags,
        printed=printed, results=results)
    if flags != want_flags or set(results) != {"mse", "psnr", "ssim"} or not all(
            math.isfinite(v) for v in results.values()):
        raise AssertionError(f"lineart CLIs: flags {flags}, results {results}")


def apps_slice(dev, api_paths, baseline_files, style_paths):
    """Phase 15: the app logic's paths at the app's defaults (one sample,
    20 steps, CFG 7.5, 512^2) after kernels A, B, C and D at their shapes,
    then the detectors and the tools. Deletes every file phases 8, 11, 13
    and 15 left. Returns the launches of each app call."""
    root = os.path.join(ROOT, "runs", "chip_smoke_apps")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved = os.environ.get(annot_download.CKPT_ENV)
    try:
        t_phase = time.perf_counter()
        with counted("apps kernel checks", ()):
            app_kernel_checks(dev)
        rng = np.random.default_rng(SEED + 15)
        image, image2 = smooth_image(rng, SIZE, SIZE), smooth_image(rng, SIZE + 64, SIZE)
        launches = app_ctrlora(dev, api_paths, image, image2)
        gc.collect()
        torch.cuda.empty_cache()
        launches["process_controlnet"] = app_controlnet(dev, baseline_files, image)
        gc.collect()
        torch.cuda.empty_cache()
        launches["process_style"] = app_style(dev, style_paths, image,
                                              smooth_image(rng, *STYLE_IMAGE_HW))
        gc.collect()
        torch.cuda.empty_cache()
        ckpt_dir = os.path.join(root, "detector_ckpts")
        write_detector_files(ckpt_dir, SEED + 15, image=image, device=dev)
        os.environ[annot_download.CKPT_ENV] = ckpt_dir
        app_detectors(dev, image)
        app_tools(dev, root, api_paths, rng)
        log("apps", phase_s=time.perf_counter() - t_phase)
        return launches
    finally:
        if saved is None:
            os.environ.pop(annot_download.CKPT_ENV, None)
        else:
            os.environ[annot_download.CKPT_ENV] = saved
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(KEPT, ignore_errors=True)


def build_gates(dev) -> None:
    """The build phase's gates on the kernels just built: C, B6 and B4/B5
    run on wgmma (HGMMA) and nothing older (HMMA); B6 and B4/B5 spill
    nothing and ptxas serialises none of their wgmmas for accumulator
    accesses (C7514/C7515: a plain instruction touching an accumulator
    inside a batch); A (and so A2, the same kernel) and D spill nothing;
    A's (at phase 3's and phase 15's shapes), A2's, B6's and B4/B5's
    tilings are what their Python mirrors say,
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
    for shape, dt, *_ in GN_CASES + APP_GN_CASES:
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
    samplers, cli_rates = sampler_family(dev, pipe, *inputs)  # phase 9, on phase 4's pipeline
    del pipe, inputs
    torch.cuda.empty_cache()
    tiny_gpu_vs_cpu(dev)
    tiny_api_gpu_vs_cpu(dev)
    training, phase6_s_step = train_slice(dev, profile=bool(profile_steps))
    tiny_train_gpu_vs_cpu(dev)
    shutil.rmtree(KEPT, ignore_errors=True)
    try:
        api_runs, api_paths = api_slice(dev)
        torch.cuda.empty_cache()
        cli_runs = train_cli_slice(dev, phase6_s_step)
        baseline_runs, baseline_files = baselines_slice(dev)
        xs_runs = xs_slice(dev, phase4_s_batch, phase6_s_step)
        style_launches, style_paths = style_slice(dev, phase4_s_batch)
        eval_launches = evaluation_slice(dev, cli_rates)
        app_runs = apps_slice(dev, api_paths, baseline_files, style_paths)
    finally:
        shutil.rmtree(KEPT, ignore_errors=True)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        by_path = {"sampling": sampling[name], "samplers": samplers[name],
                   "training": training[name],
                   "api_2lora": sum(r[name] for r in api_runs.values()),
                   "train_cli": sum(r[name] for r in cli_runs.values()),
                   "baselines": sum(r[name] for r in baseline_runs.values()),
                   "xs": sum(r[name] for r in xs_runs.values()),
                   "style": style_launches[name], "evaluation": eval_launches[name],
                   "apps": sum(r[name] for r in app_runs.values())}
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
