"""Make a dataset's condition images with any detector (counterpart of
``scripts/tool_make_cond_images.py``; reference
scripts/tool_make_cond_images.py): each image of --input_dir, resized to
512 on its short side, through the detector with parameters drawn from a
generator seeded by the file's name, written as PNG under --output_dir.

  python -m ctrlora_tpu_torch.scripts.tool_make_cond_images --input_dir imgs \\
      --output_dir source --detector hed [--n_processes 4] [--device cpu]

Every detector of CHOICES runs in the port, bbox and densepose included
(the CNN ones read their published files from $CTRLORA_ANNOTATOR_CKPTS).
A CNN detector runs on --device (default cuda; no fallback to the CPU).
--n_processes > 1 starts a 'spawn' pool (a fork after CUDA's
initialisation breaks), each worker building its own detector.
"""

from __future__ import annotations

import argparse
import hashlib
import multiprocessing as mp
import os
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

CHOICES = [
    "canny", "hed", "seg", "depth", "normal", "openpose", "hedsketch",
    "bbox", "outpainting", "blur", "grayscale", "inpainting",
    "lineart", "lineart_anime", "shuffle", "mlsd",
    "jpeg", "palette", "pixel", "illusion", "densepose",
    "lineart_anime_with_color_prompt", "inpainting_brush",
]


def rng_by_hash(obj_id) -> np.random.Generator:
    """Per-file deterministic rng (reference: set_seed_by_hash, :38-42)."""
    h = hashlib.sha256(str(obj_id).encode())
    return np.random.default_rng(int(h.hexdigest(), 16) % 2**32)


def discrete_normal(rng, a, b):
    x = rng.standard_normal() * 0.5 + 0.5
    return int(x * (b - a)) + a


def random_params(detector: str, rng: np.random.Generator) -> dict:
    """Per-detector randomized params (reference: :49-100)."""
    if detector == "canny":
        return dict(low_threshold=100, high_threshold=200)
    if detector == "outpainting":
        return dict(rand_h=int(rng.integers(20, 80)), rand_w=int(rng.integers(20, 80)))
    if detector == "inpainting":
        return dict(
            rand_h=int(rng.integers(30, 60)), rand_h_1=int(rng.integers(30, 60)),
            rand_w=int(rng.integers(30, 60)), rand_w_1=int(rng.integers(30, 60)),
        )
    if detector == "blur":
        return dict(ksize=discrete_normal(rng, 24, 100) // 2 * 2 + 1)
    if detector == "jpeg":
        return dict(jpeg_quality=discrete_normal(rng, 1, 30))
    if detector == "pad":
        r = rng.uniform(0.1, 0.4, 4)
        return dict(top_ratio=r[0], bottom_ratio=r[1], left_ratio=r[2], right_ratio=r[3])
    if detector == "lineart":
        return dict(coarse=bool(rng.random() < 0.5))
    return {}


def process_file(task) -> Tuple[str, bool]:
    fname, input_dir, output_dir, detector_name, device = task
    from ctrlora_tpu_torch.annotators import registry
    from ctrlora_tpu_torch.annotators.util import HWC3, resize_image

    rng = rng_by_hash(fname)
    img = cv2.imread(os.path.join(input_dir, fname))
    if img is None:
        return fname, False
    img = resize_image(HWC3(img[..., ::-1].copy()), 512)
    det = registry.get(detector_name, device)
    params = random_params(detector_name, rng)
    try:
        out = det(img, rng=rng, **params)
    except TypeError:
        out = det(img, **params)
    out = HWC3(np.asarray(out, np.uint8))
    cv2.imwrite(os.path.join(output_dir, os.path.splitext(fname)[0] + ".png"), out[..., ::-1])
    return fname, True


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--detector", choices=CHOICES, required=True)
    p.add_argument("--n_processes", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device of a CNN detector (no fallback to the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[str, bool]]:
    """Returns (file name, written) for each input file."""
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(os.listdir(args.input_dir))
    tasks = [(f, args.input_dir, args.output_dir, args.detector, args.device) for f in files]
    if args.n_processes <= 1:
        results = [process_file(t) for t in tasks]
    else:
        with mp.get_context("spawn").Pool(args.n_processes) as pool:
            results = list(pool.imap(process_file, tasks))
    ok = sum(1 for _, s in results if s)
    print(f"Done: {ok}/{len(files)} condition images -> {args.output_dir}")
    return results


if __name__ == "__main__":
    main()
