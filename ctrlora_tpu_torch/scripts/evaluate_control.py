"""Controllability evaluation with the PyTorch port (counterpart of
``scripts/evaluate_control.py``; reference scripts/evaluate_control.py):
re-detect the condition from each sample and compare it with the
ground-truth condition map by MSE / LPIPS / PSNR / SSIM, plus the CLIPScore
of each sample against its prompt (reference lines 65-69):

  python -m ctrlora_tpu_torch.scripts.evaluate_control --sample_dir out \\
      --detector canny [--lpips_ckpt vgg_lpips.pth] \\
      [--clip_ckpt clip-vit-large-patch14.ckpt]

--sample_dir is the sample CLI's --save_dir (sample/, control/,
prompt.txt). --detector is a name of ``annotators.registry``; a CNN
detector runs on --device too, and one the port does not have yet raises.
LPIPS and CLIPScore print when their pretrained checkpoints are given.
--device defaults to cuda; the script never falls back to the CPU, ask for
it with --device cpu.
"""

from __future__ import annotations

import argparse
import os
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np

from ctrlora_tpu_torch.annotators import registry
from ctrlora_tpu_torch.annotators.util import HWC3, resize_image
from ctrlora_tpu_torch.data.datasets import imread_rgb
from ctrlora_tpu_torch.evaluation import (
    MetricAccumulator, cli_device, load_eval_models, read_prompts,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sample_dir", required=True)
    p.add_argument("--detector", required=True)
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--lpips_ckpt", default=None, help="VGG16+lin-head weights")
    p.add_argument("--clip_ckpt", default=None, help="HF CLIPModel state dict")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (no fallback to the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Prints each metric as 'NAME: value' and returns them."""
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)
    det = registry.get(args.detector, device)
    if args.detector == "canny":
        det = partial(det, low_threshold=100, high_threshold=200)

    sample_dir = os.path.join(args.sample_dir, "sample")
    control_dir = os.path.join(args.sample_dir, "control")
    names = sorted(os.listdir(sample_dir))
    print("Dataset size:", len(names))
    prompts = read_prompts(args.sample_dir)

    lpips_model, scorer = load_eval_models(args.lpips_ckpt, args.clip_ckpt, device)
    acc = MetricAccumulator(lpips_model, scorer, device)
    batch_c, batch_g, batch_s, batch_p = [], [], [], []

    def flush():
        samples = np.stack(batch_s) if scorer is not None and batch_p else None
        acc.update(np.stack(batch_c), np.stack(batch_g), sample=samples,
                   prompts=batch_p or None)
        for batch in (batch_c, batch_g, batch_s, batch_p):
            batch.clear()

    for name in names:
        sample = imread_rgb(os.path.join(sample_dir, name))
        gt = imread_rgb(os.path.join(control_dir, name))
        gt = resize_image(HWC3(gt), 512).astype(np.float32) / 255.0
        c = det(sample)
        c = resize_image(HWC3(np.asarray(c, np.uint8)), 512).astype(np.float32) / 255.0
        batch_c.append(c)
        batch_g.append(gt)
        stem = os.path.splitext(name)[0]
        if scorer is not None and stem in prompts:
            batch_s.append(sample)
            batch_p.append(prompts[stem])
        if len(batch_c) >= args.bs:
            flush()
    if batch_c:
        flush()

    results = acc.compute()
    for k, v in results.items():
        print(f"{k.upper()}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
