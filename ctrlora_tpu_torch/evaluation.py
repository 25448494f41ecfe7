"""Evaluation metrics of the port (counterpart of
``ctrlora_tpu/evaluation.py``).

The reference takes them from torchmetrics (scripts/evaluate_control.py:
65-69): MSE / PSNR / SSIM / LPIPS on condition maps and CLIPScore on
images. MSE, PSNR and SSIM are plain torch; LPIPS (``models/lpips.py``)
and CLIPScore (``CLIPScorer`` below, over the port's CLIP towers) need
pretrained weights: pass the torch checkpoints to ``load_eval_models``, as
``scripts/evaluate_control.py`` does with ``--lpips_ckpt`` /
``--clip_ckpt``. No TPU kernel runs here, so no hand-written kernel either:
the port uses cuDNN convolutions, ``F.linear`` and its plain attention, in
full fp32 (``utils/precision.fp32_exact``).

Images are NHWC at the API. The tensors may lie on any device; the
accumulator moves numpy batches to its own (``cuda`` unless told).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ctrlora_tpu_torch.configs import CLIPTextConfig
from ctrlora_tpu_torch.models.clip import CLIPTextModel
from ctrlora_tpu_torch.models.ip_adapter import (
    CLIPVisionConfig, CLIPVisionModel, clip_image_preprocess, convert_clip_vision,
)
from ctrlora_tpu_torch.models.lpips import LPIPS, convert_lpips, lpips
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils.precision import fp32_exact
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer


def load_eval_models(lpips_ckpt: Optional[str], clip_ckpt: Optional[str], device="cuda"):
    """Load the learned-metric weights the eval scripts accept: lpips_ckpt,
    torchvision VGG16 + lpips lin heads (or the lpips package's combined
    dict); clip_ckpt, an HF openai/clip-vit-large-patch14 CLIPModel.
    Returns (LPIPS | None, CLIPScorer | None) on `device`."""
    model = scorer = None
    if lpips_ckpt:
        model = LPIPS.from_state_dict(convert_lpips(bridge.load_torch_state_dict(lpips_ckpt)),
                                      device)
    if clip_ckpt:
        scorer = CLIPScorer.from_torch_state(bridge.load_torch_state_dict(clip_ckpt),
                                             device=device)
    return model, scorer


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the whole batch (inputs [B,H,W,C] in [0,1])."""
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Batch PSNR as torchmetrics' default on one batch (one MSE over it)."""
    m = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(m, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity with an 11x11 sigma-1.5 gaussian window,
    depthwise and VALID (the Wang et al. formulation, torchmetrics'
    defaults), meaned over the batch; in full fp32."""
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    c = a.shape[-1]
    win = _gaussian_kernel().to(a.device)[None, None].repeat(c, 1, 1, 1)  # [C, 1, 11, 11]
    with fp32_exact():
        x = torch.cat([a, b]).float().permute(0, 3, 1, 2)  # [2B, C, H, W]
        filt = lambda t: F.conv2d(t, win, groups=c)
        mu = filt(x)
        sq = filt(x * x)
        n = a.shape[0]
        mu_a, mu_b = mu[:n], mu[n:]
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sig_a, sig_b = sq[:n] - mu_aa, sq[n:] - mu_bb
        sig_ab = filt(x[:n] * x[n:]) - mu_ab
        s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / ((mu_aa + mu_bb + c1) * (sig_a + sig_b + c2))
    return s.mean()


class CLIPScorer:
    """torchmetrics.CLIPScore over the port's CLIP towers: 100 *
    cos(image_embeds, text_embeds) per sample; the accumulator clamps the
    mean at 0, as torchmetrics does.

    Built from an HF openai/clip-vit-large-patch14 state dict (the model
    the reference evaluation uses, scripts/evaluate_control.py:69)."""

    def __init__(self, text: CLIPTextModel, vision: CLIPVisionModel, tokenizer=None,
                 image_size: int = 224):
        self.text = text
        self.vision = vision
        self.tokenizer = tokenizer or default_tokenizer()
        self.image_size = image_size
        self.device = next(vision.parameters()).device

    @classmethod
    def from_torch_state(cls, sd: Mapping[str, np.ndarray], tokenizer=None,
                         device="cuda") -> "CLIPScorer":
        """sd: a full HF CLIPModel state dict (text_model.* + vision_model.*
        + text_projection / visual_projection); the towers are sized from
        it as JAX's bridge sizes them."""
        layers = lambda pre: 1 + max(int(k.split(".")[3]) for k in sd
                                     if k.startswith(f"{pre}.encoder.layers."))
        hid = int(np.shape(sd["text_model.embeddings.token_embedding.weight"])[1])
        tcfg = CLIPTextConfig(
            hidden_size=hid, intermediate_size=4 * hid, num_layers=layers("text_model"),
            num_heads=hid // 64, layer="projected",
            projection_dim=int(np.shape(sd["text_projection.weight"])[0]))
        tstate = bridge.port_entries(sd, bridge.clip_entries(tcfg), prefix="text_model.")
        tstate["text_projection.weight"] = torch.from_numpy(
            np.array(sd["text_projection.weight"], np.float32))
        pw = np.shape(sd["vision_model.embeddings.patch_embedding.weight"])
        npos = np.shape(sd["vision_model.embeddings.position_embedding.weight"])[0]
        patch, vhid = pw[-1], pw[0]
        grid = int(round((npos - 1) ** 0.5))
        vcfg = CLIPVisionConfig(
            image_size=grid * patch, patch_size=patch, hidden_size=vhid,
            intermediate_size=4 * vhid, num_layers=layers("vision_model"),
            num_heads=vhid // 64, projection_dim=int(np.shape(sd["visual_projection.weight"])[0]),
            hidden_act="quick_gelu")
        text, vision = CLIPTextModel(tcfg), CLIPVisionModel(vcfg)
        text.load_state_dict(tstate, strict=True)
        vision.load_state_dict(convert_clip_vision(sd, vcfg), strict=True)
        for m in (text, vision):
            m.to(device).eval().requires_grad_(False)
        return cls(text, vision, tokenizer=tokenizer, image_size=vcfg.image_size)

    def embed_pixels(self, pixels, prompts: Sequence[str]):
        """Pre-normalised pixels [B, S, S, 3] and prompts -> (image embeds,
        text embeds), in full fp32."""
        ids = torch.from_numpy(self.tokenizer([p.strip() for p in prompts])).to(self.device)
        with fp32_exact(), torch.no_grad():
            img = self.vision(torch.as_tensor(pixels).to(self.device))
            txt = self.text(ids)
        return img, txt

    def embed(self, images_uint8: np.ndarray, prompts: Sequence[str]):
        """uint8 RGB images [B, H, W, 3] and prompts -> (image embeds, text
        embeds)."""
        pixels = clip_image_preprocess(np.asarray(images_uint8), self.image_size)
        return self.embed_pixels(torch.from_numpy(pixels), prompts)

    @staticmethod
    def scores(img: torch.Tensor, txt: torch.Tensor) -> np.ndarray:
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        return (100.0 * torch.sum(img * txt, dim=-1)).cpu().numpy()

    def __call__(self, images_uint8: np.ndarray, prompts: Sequence[str]) -> np.ndarray:
        """Per-sample (unclamped) 100*cosine scores [B]."""
        return self.scores(*self.embed(images_uint8, prompts))


class MetricAccumulator:
    """Streaming mean over batches of the reference's five metrics, each
    batch's value weighted by its size (as JAX's; PSNR is thereby the mean
    of per-batch PSNRs, which torchmetrics' pooled-MSE PSNR is not beyond
    one batch).

    MSE/PSNR/SSIM always; LPIPS when `lpips_model` is given; CLIPScore on
    (sample, prompt) pairs when `clip_scorer` is given. Numpy batches are
    moved to `device`."""

    def __init__(self, lpips_model: Optional[LPIPS] = None,
                 clip_scorer: Optional[CLIPScorer] = None, device="cuda"):
        self._sums: Dict[str, float] = {}
        self._count = 0
        self._clip_sum = 0.0
        self._clip_count = 0
        self.lpips_model = lpips_model
        self.clip_scorer = clip_scorer
        self.device = torch.device(device)

    def update(self, control, gt_control, sample: Optional[np.ndarray] = None,
               prompts: Optional[Sequence[str]] = None) -> None:
        a = torch.as_tensor(np.asarray(control, np.float32)).to(self.device)
        b = torch.as_tensor(np.asarray(gt_control, np.float32)).to(self.device)
        n = a.shape[0]
        vals = {"mse": float(mse(a, b)), "psnr": float(psnr(a, b)), "ssim": float(ssim(a, b))}
        if self.lpips_model is not None:
            vals["lpips"] = float(torch.mean(lpips(self.lpips_model, a, b)))
        for k, v in vals.items():
            self._sums[k] = self._sums.get(k, 0.0) + v * n
        self._count += n
        if self.clip_scorer is not None and sample is not None and prompts is not None:
            scores = self.clip_scorer(sample, prompts)
            self._clip_sum += float(np.sum(scores))
            self._clip_count += len(scores)

    def compute(self) -> Dict[str, float]:
        out = {k: v / max(self._count, 1) for k, v in self._sums.items()}
        if self._clip_count:
            # torchmetrics clamps the aggregated mean at 0
            out["clip score"] = max(self._clip_sum / self._clip_count, 0.0)
        return out


# ---------------------------------------------------------------------------
# what the evaluate CLIs share
# ---------------------------------------------------------------------------

def cli_device(name: str) -> torch.device:
    """The device an evaluate CLI runs on; no fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; pass --device cpu "
                         "to evaluate on the CPU")
    return device


def read_prompts(sample_dir: str) -> Dict[str, str]:
    """{file stem: prompt} from <sample_dir>/prompt.txt ({} without one).
    The sample CLI writes 'NNNNNN: prompt' lines, keyed by NNNNNN, the
    stem of its PNG files; a file of bare prompts is keyed by line index,
    as JAX's CLIs key every file."""
    path = os.path.join(sample_dir, "prompt.txt")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        lines = [line.rstrip("\n") for line in f]
    tagged = [re.match(r"(\d+): (.*)$", line) for line in lines]
    if lines and all(tagged):
        return {m.group(1): m.group(2) for m in tagged}
    return {str(i): line for i, line in enumerate(lines)}
