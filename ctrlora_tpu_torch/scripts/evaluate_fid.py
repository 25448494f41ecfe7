"""Frechet distance and Inception Score between a sample set and a
reference set with the PyTorch port (counterpart of
``scripts/evaluate_fid.py``).

The reference points users at the torch-fidelity CLI for FID/IS
(README-traineval.md:317-321). Here --inception_ckpt runs the port's FID
InceptionV3 (``models/inception.py``, the pytorch-fid protocol, comparable
with published numbers) and --image_encoder runs CLIP-FID (Kynkaanniemi et
al. 2022) over the CLIP ViT-H/14 image tower:

  python -m ctrlora_tpu_torch.scripts.evaluate_fid --dir_a out/sample \\
      --dir_b data/val --inception_ckpt pt_inception-2015-12-05-6726825d.pth
  python -m ctrlora_tpu_torch.scripts.evaluate_fid --dir_a out/sample \\
      --dir_b data/val --image_encoder ip-adapter/image_encoder.bin

--device defaults to cuda; the script never falls back to the CPU, ask for
it with --device cpu.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch.data.datasets import imread_rgb
from ctrlora_tpu_torch.evaluation import cli_device
from ctrlora_tpu_torch.models.inception import (
    FIDInceptionV3, convert_inception, fid_preprocess, inception_features, inception_score,
)
from ctrlora_tpu_torch.models.ip_adapter import (
    CLIPVisionConfig, CLIPVisionModel, clip_image_preprocess, convert_clip_vision,
)
from ctrlora_tpu_torch.utils.ckpt_torch import load_torch_state_dict
from ctrlora_tpu_torch.utils.precision import fp32_exact


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^{1/2}). JAX's script passes
    sqrtm disp=False, which SciPy 1.18 removed; the square root is the
    same without it."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def stats(feats: np.ndarray):
    return feats.mean(0), np.cov(feats, rowvar=False)


def _batches(image_dir: str, bs: int):
    """uint8 [n, H, W, 3] batches of the readable images of a directory, in
    name order."""
    names = sorted(os.listdir(image_dir))
    for i in range(0, len(names), bs):
        imgs = [imread_rgb(os.path.join(image_dir, n)) for n in names[i:i + bs]]
        imgs = [im for im in imgs if im is not None]
        if imgs:
            yield np.stack(imgs)


def clip_features(image_dir: str, encoder_ckpt: str, bs: int = 32, device="cuda") -> np.ndarray:
    """CLIP ViT-H/14 image embeds [n, 1024] of a directory (CLIP-FID)."""
    cfg = CLIPVisionConfig()
    model = CLIPVisionModel(cfg)
    model.load_state_dict(convert_clip_vision(load_torch_state_dict(encoder_ckpt), cfg))
    model.to(device).eval().requires_grad_(False)
    feats = []
    for imgs in _batches(image_dir, bs):
        px = torch.from_numpy(clip_image_preprocess(imgs)).to(device)
        with fp32_exact(), torch.no_grad():
            feats.append(model(px).cpu().numpy())
    return np.concatenate(feats)


def inception_outputs(image_dir: str, ckpt: str, bs: int = 32, device="cuda"):
    """pool3 features [n, 2048] and fc logits [n, 1008] of a directory
    through the FID InceptionV3 (pt_inception-2015-12-05 weights)."""
    model = FIDInceptionV3.from_state_dict(convert_inception(load_torch_state_dict(ckpt)), device)
    feats, logits = [], []
    for imgs in _batches(image_dir, bs):
        f, l = inception_features(model, fid_preprocess(imgs, device))
        feats.append(f.cpu().numpy())
        logits.append(l.cpu().numpy())
    return np.concatenate(feats), np.concatenate(logits)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir_a", required=True)
    p.add_argument("--dir_b", default=None, help="reference set (omit for IS-only)")
    p.add_argument("--image_encoder", default=None, help="CLIP vision ckpt (CLIP-FID)")
    p.add_argument("--inception_ckpt", default=None,
                   help="pt_inception-2015-12-05 ckpt (Inception-FID + IS)")
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (no fallback to the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Prints IS, FID and CLIP-FID as JAX's script does and returns them
    ('IS', 'IS std', 'FID', 'CLIP-FID', as computed)."""
    args = build_parser().parse_args(argv)
    if not (args.image_encoder or args.inception_ckpt):
        raise SystemExit("provide --image_encoder (CLIP-FID) and/or --inception_ckpt")
    if args.image_encoder and not args.dir_b:
        raise SystemExit("CLIP-FID needs --dir_b")
    device = cli_device(args.device)
    out: Dict[str, float] = {}
    if args.inception_ckpt:
        fa, la = inception_outputs(args.dir_a, args.inception_ckpt, args.bs, device)
        out["IS"], out["IS std"] = inception_score(la)
        print(f"IS: {out['IS']:.4f} +/- {out['IS std']:.4f}")
        if args.dir_b:
            fb, _ = inception_outputs(args.dir_b, args.inception_ckpt, args.bs, device)
            print(f"features: {fa.shape[0]} vs {fb.shape[0]} ({fa.shape[1]}-d)")
            out["FID"] = frechet_distance(*stats(fa), *stats(fb))
            print(f"FID: {out['FID']:.4f}")
    if args.image_encoder:
        fa = clip_features(args.dir_a, args.image_encoder, args.bs, device)
        fb = clip_features(args.dir_b, args.image_encoder, args.bs, device)
        print(f"features: {fa.shape[0]} vs {fb.shape[0]} ({fa.shape[1]}-d)")
        out["CLIP-FID"] = frechet_distance(*stats(fa), *stats(fb))
        print(f"CLIP-FID: {out['CLIP-FID']:.4f}")
    return out


if __name__ == "__main__":
    main()
