"""Per-sample coarse flags for the lineart evaluation (counterpart of
``scripts/evaluate_lineart_is_coarse.py``; reference
scripts/evaluate_lineart_is_coarse.py): each ground-truth image under
<sample_dir>/img is re-detected with the fine and the coarse lineart
weights, and the flag says whether the coarse map is nearer (MSE at 512)
to the ground-truth condition under <sample_dir>/control.

  python -m ctrlora_tpu_torch.scripts.evaluate_lineart_is_coarse \\
      --sample_dir out [--out evaluate_lineart_is_coarse.txt] [--device cpu]

The detector runs on --device (default cuda; no fallback to the CPU) with
sk_model.pth / sk_model2.pth from $CTRLORA_ANNOTATOR_CKPTS.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from ctrlora_tpu_torch.annotators.lineart import LineartDetector
from ctrlora_tpu_torch.annotators.util import HWC3, resize_image
from ctrlora_tpu_torch.data.datasets import imread_rgb
from ctrlora_tpu_torch.evaluation import cli_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sample_dir", required=True)
    p.add_argument("--out", default="./evaluate_lineart_is_coarse.txt")
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector (no fallback to the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[bool]:
    """Writes one 'True'/'False' line per image to --out; returns the flags."""
    args = build_parser().parse_args(argv)
    det = LineartDetector(device=cli_device(args.device))
    img_dir = os.path.join(args.sample_dir, "img")
    ctl_dir = os.path.join(args.sample_dir, "control")
    flags = []
    for name in sorted(os.listdir(img_dir)):
        im = imread_rgb(os.path.join(img_dir, name))
        gc = resize_image(HWC3(imread_rgb(os.path.join(ctl_dir, name))), 512)
        gc = gc.astype(np.float32) / 255.0
        diffs = {}
        for coarse in (False, True):
            c = resize_image(HWC3(det(im, coarse=coarse)), 512).astype(np.float32) / 255.0
            diffs[coarse] = float(np.mean((c - gc) ** 2))
        flags.append(diffs[True] < diffs[False])
    with open(args.out, "w") as f:
        f.write("\n".join(str(x) for x in flags))
    print(f"Wrote {len(flags)} flags to {args.out}")
    return flags


if __name__ == "__main__":
    main()
