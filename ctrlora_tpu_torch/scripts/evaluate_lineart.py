"""Lineart controllability evaluation (counterpart of
``scripts/evaluate_lineart.py``; reference scripts/evaluate_lineart.py):
lineart re-detected from each sample, fine or coarse by the flags that
``evaluate_lineart_is_coarse`` wrote (fine for all without that file), is
compared with the ground-truth condition by MSE / PSNR / SSIM at 512.

  python -m ctrlora_tpu_torch.scripts.evaluate_lineart --sample_dir out \\
      [--is_coarse evaluate_lineart_is_coarse.txt] [--bs 64] [--device cpu]

--sample_dir holds sample/ and control/ (the sample CLI's --save_dir). The
detector and the metrics run on --device (default cuda; no fallback to the
CPU), the detector with sk_model.pth / sk_model2.pth from
$CTRLORA_ANNOTATOR_CKPTS.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ctrlora_tpu_torch.annotators.lineart import LineartDetector
from ctrlora_tpu_torch.annotators.util import HWC3, resize_image
from ctrlora_tpu_torch.data.datasets import imread_rgb
from ctrlora_tpu_torch.evaluation import MetricAccumulator, cli_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sample_dir", required=True)
    p.add_argument("--is_coarse", default="./evaluate_lineart_is_coarse.txt")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector and metrics (no fallback to the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Prints each metric as 'NAME: value' and returns them."""
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)
    det = LineartDetector(device=device)
    sample_dir = os.path.join(args.sample_dir, "sample")
    ctl_dir = os.path.join(args.sample_dir, "control")
    names = sorted(os.listdir(sample_dir))
    if os.path.isfile(args.is_coarse):
        with open(args.is_coarse) as f:
            flags = [line.strip() == "True" for line in f]
        if len(flags) != len(names):
            raise ValueError(f"{args.is_coarse} has {len(flags)} flags for {len(names)} "
                             f"samples; run evaluate_lineart_is_coarse first")
    else:
        flags = [False] * len(names)
    acc = MetricAccumulator(device=device)
    bc, bg = [], []
    for name, coarse in zip(names, flags):
        s = imread_rgb(os.path.join(sample_dir, name))
        g = resize_image(HWC3(imread_rgb(os.path.join(ctl_dir, name))), 512)
        c = resize_image(HWC3(det(s, coarse=coarse)), 512)
        bc.append(c.astype(np.float32) / 255.0)
        bg.append(g.astype(np.float32) / 255.0)
        if len(bc) >= args.bs:
            acc.update(np.stack(bc), np.stack(bg))
            bc, bg = [], []
    if bc:
        acc.update(np.stack(bc), np.stack(bg))
    results = acc.compute()
    for k, v in results.items():
        print(f"{k.upper()}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
