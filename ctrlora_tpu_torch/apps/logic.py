"""What the gradio apps do, without gradio (counterpart of
``ctrlora_tpu/apps/logic.py`` and of the non-UI halves of
``app/gradio_controlnet.py`` and ``app/gradio_ctrlora_style_transfer.py``;
reference app/gradio_ctrlora.py minus the UI).

* the preprocessor choices, their default parameters and ``detect``
  (every one of the 22 choices runs in the port, bbox and densepose
  included);
* the prompt preset library and ``reformat_prompt``;
* ``AppState``: the CtrLoRA model cached on its checkpoint paths, and the
  single- and two-condition ``process`` / ``process2``;
* ``build_controlnet`` / ``process_controlnet``: the vanilla image-hint
  ControlNet (``sd15_config``) from one combined checkpoint;
* ``build_style`` / ``process_style``: CtrLoRA with IP-Adapter style
  tokens (``style.StyleCtrLoRA``).

Everything runs on ``device``, the card unless the caller asks for the CPU;
there is no fallback. The gradio front ends in ``ctrlora_tpu_torch/app/``
call these functions, one call a callback.
"""

from __future__ import annotations

import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch.annotators import registry
from ctrlora_tpu_torch.annotators.util import HWC3, resize_image
from ctrlora_tpu_torch.api import CtrLoRA
from ctrlora_tpu_torch.configs import sd15_config
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.style import StyleCtrLoRA
from ctrlora_tpu_torch.utils.image import center_crop_to_common
from ctrlora_tpu_torch.utils.loading import load_ctrlora
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer

DET_CHOICES = [
    "none", "canny", "hed", "seg", "depth", "normal", "openpose", "hedsketch",
    "grayscale", "blur", "pad", "bbox",
    "lineart", "lineart_coarse", "lineart_anime", "shuffle", "mlsd",
    "palette", "pixel", "illusion", "densepose", "lineart_anime_with_color_prompt",
]

ADD_PROMPTS = {
    "General-short": "masterpiece, best quality",
    "General-long": "masterpiece, best quality, high quality, award winning, award-winning",
    "Realistic": "RAW photo, 8K UHD, DSLR, film grain, highres, high resolution, high detail, extremely detailed, soft lighting, award winning photography",
}

NEG_PROMPTS = {
    "General-short": "worst quality, low quality, NSFW",
    "General-long": "worst quality, low quality, bad quality, normal quality, lowres, low resolution, JPEG artifacts, blurry, bad composition, cropped, mutilated, out of frame, duplicate, multiple views, multiple_views, tiling, ugly, morbid, distorted, disgusting, watermark, signature, NSFW",
    "General-human": "bad anatomy, wrong anatomy, bad proportions, gross proportions, deformed, deformed iris, deformed pupils, inaccurate eyes, cross-eye, cloned face, bad hands, mutation, mutated hands, mutation hands, mutated fingers, mutation fingers, fused fingers, too many fingers, extra fingers, extra digit, missing fingers, fewer digits, malformed limbs, inaccurate limb, extra limbs, missing limbs, floating limbs, disconnected limbs, extra arms, extra legs, missing arms, missing legs, error, bad legs, error legs, bad feet, long neck, disfigured, amputation, dehydrated, nude, thighs, cleavage",
    "Realistic": "semi-realistic, CGI, 3D, render, sketch, drawing, comic, cartoon, anime, vector art",
    "2.5D": "sketch, drawing, comic, cartoon, anime, vector art",
    "Painting": "photorealistic, CGI, 3D, render",
}

# per-detector default params (reference detect() dispatch,
# app/gradio_ctrlora.py:137-259)
DET_PARAMS = {
    "canny": dict(low_threshold=100, high_threshold=200),
    "blur": dict(ksize=51),
    "pad": dict(top_ratio=0.25, bottom_ratio=0.25, left_ratio=0.25, right_ratio=0.25),
    "jpeg": dict(jpeg_quality=10),
    "inpainting": dict(rand_h=40, rand_h_1=40, rand_w=40, rand_w_1=40),
    "outpainting": dict(rand_h=60, rand_w=60),
    "lineart": dict(coarse=False),
    "lineart_coarse": dict(coarse=True),
}

_DET_ALIAS = {"lineart_coarse": "lineart"}

# the style app's IP-Adapter loading modes: label -> load_ip_adapter target
STYLE_TARGETS = {
    "Load original IP-Adapter": "all",
    "Load only style blocks": "style_blocks",
    "Load style+layout block": "style_layout",
}

GUESS_DECAY = 0.825


def detect(det: str, input_image: np.ndarray, detect_resolution: int = 512,
           image_resolution: int = 512, device="cuda") -> np.ndarray:
    """Run a preprocessor (a CNN one on `device`) and resize to the
    generation resolution (reference detect(), app/gradio_ctrlora.py:137-259)."""
    input_image = HWC3(np.asarray(input_image, np.uint8))
    if det == "none":
        return resize_image(input_image, image_resolution)
    detector = registry.get(_DET_ALIAS.get(det, det), device)
    resized = resize_image(input_image, detect_resolution)
    out = detector(resized, **DET_PARAMS.get(det, {}))
    return resize_image(HWC3(np.asarray(out, np.uint8)), image_resolution)


def reformat_prompt(prompt: str) -> str:
    return ", ".join([p.strip() for p in prompt.split(",") if p.strip()])


def control_scales(strength: float, taps: int, guess_mode: bool) -> List[float]:
    """`strength` at every tap, or in guess mode strength * 0.825**(taps-1-i)
    (reference app:313)."""
    if guess_mode:
        return [strength * (GUESS_DECAY ** float(taps - 1 - i)) for i in range(taps)]
    return [strength] * taps


class ModelCache:
    """One model kept, rebuilt when its key changes (the apps' lazy
    cache)."""

    def __init__(self):
        self.key = None
        self.model = None

    def get(self, key, build: Callable[[], object]):
        if key != self.key:
            self.model = None  # the old model's memory goes before the new one loads
            self.model = build()
            self.key = key
        return self.model


class AppState:
    """The CtrLoRA app's model, cached on (lora count, checkpoint paths)
    (reference build_model, app/gradio_ctrlora.py:112-134)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.cache = ModelCache()

    def build_model(self, sd_ckpt: str, cn_ckpt: str, lora_ckpts: Sequence[str]) -> CtrLoRA:
        def build():
            model = CtrLoRA(num_loras=len(lora_ckpts), device=self.device)
            model.create_model(sd_ckpt, cn_ckpt, list(lora_ckpts))
            return model

        return self.cache.get((len(lora_ckpts), sd_ckpt, cn_ckpt, tuple(lora_ckpts)), build)

    def process(
        self, det: str, detected_image: np.ndarray, prompt: str, n_prompt: str,
        num_samples: int, ddim_steps: int, guess_mode: bool, strength: float,
        scale: float, seed: int, eta: float,
        sd_ckpt: str, cn_ckpt: str, lora_ckpt: str,
    ) -> List[np.ndarray]:
        """One condition image (already detected) -> [it, sample, ...]."""
        model = self.build_model(sd_ckpt, cn_ckpt, [lora_ckpt])
        if seed == -1:
            seed = random.randint(0, 65535)
        prompt, n_prompt = reformat_prompt(prompt), reformat_prompt(n_prompt)
        detected_image = HWC3(np.asarray(detected_image, np.uint8))
        results = model._sample_images(
            [detected_image], prompt, n_prompt, num_samples, ddim_steps, scale, (1.0,), seed,
            eta=eta, guess_mode=guess_mode,
            control_scales=control_scales(strength, model.n_taps, guess_mode))
        return [detected_image] + [np.asarray(r) for r in results]

    def process2(
        self, detected_image: np.ndarray, detected_image2: np.ndarray,
        prompt: str, n_prompt: str, num_samples: int, ddim_steps: int,
        strength: float, scale: float, seed: int, eta: float,
        sd_ckpt: str, cn_ckpt: str, lora_ckpt: str, lora2_ckpt: str,
        lora_weight: float = 1.0, lora2_weight: float = 1.0,
        guess_mode: bool = False,
    ) -> List[np.ndarray]:
        """Two condition images, centre-cropped to their common size, one
        LoRA each -> [a, b, sample, ...]; guess mode decays the scales as
        the one-condition path does (reference app:377-384)."""
        model = self.build_model(sd_ckpt, cn_ckpt, [lora_ckpt, lora2_ckpt])
        if seed == -1:
            seed = random.randint(0, 65535)
        a = HWC3(np.asarray(detected_image, np.uint8))
        b = HWC3(np.asarray(detected_image2, np.uint8))
        a, b = center_crop_to_common(a, b)
        results = model._sample_images(
            [a, b], reformat_prompt(prompt), reformat_prompt(n_prompt), num_samples,
            ddim_steps, scale, (lora_weight, lora2_weight), seed, eta=eta,
            guess_mode=guess_mode,
            control_scales=control_scales(strength, model.n_taps, guess_mode))
        return [a, b] + [np.asarray(r) for r in results]


# ---------------------------------------------------------------------------
# the vanilla ControlNet app (app/gradio_controlnet.py)
# ---------------------------------------------------------------------------

def build_controlnet(ckpt: str, cn_ckpt: Optional[str] = None, device="cuda",
                     cache: Optional[ModelCache] = None) -> CtrLoraPipeline:
    """The image-hint ControlNet pipeline (``sd15_config``), cast for
    inference: SD from `ckpt`, the whole control model (all but LoRA keys)
    from `cn_ckpt`, by default the same combined file (JAX's ``_build``).
    With `cache`, built once per (ckpt, cn_ckpt)."""
    def build():
        pipe = CtrLoraPipeline(sd15_config(), device)
        pipe.load_state_dicts(*load_ctrlora(pipe, ckpt, cn_ckpt or ckpt, basecn_skip="lora"))
        pipe.cast_for_inference()
        return pipe

    return cache.get((ckpt, cn_ckpt), build) if cache is not None else build()


def process_controlnet(det: str, image: np.ndarray, prompt: str, n_prompt: str,
                       num_samples: int, ddim_steps: int, strength: float, scale: float,
                       seed: int, ckpt: str, cn_ckpt: Optional[str] = None, device="cuda",
                       cache: Optional[ModelCache] = None) -> List[np.ndarray]:
    """Detect, then DDIM with CFG on the pixel hint at `strength` on every
    tap -> [detected, sample, ...] (JAX ``app/gradio_controlnet.py``
    ``ui_process``; seed -1 is seed 0 there, and here). The starting noise
    comes from a CPU generator seeded with `seed`, as the API's."""
    pipe = build_controlnet(ckpt, cn_ckpt, device, cache)
    detected = detect(det, image, device=pipe.device)
    n = int(num_samples)
    hint = torch.from_numpy(detected.astype(np.float32) / 255.0).to(pipe.device)
    tok = default_tokenizer()
    ids = lambda p: torch.from_numpy(np.repeat(
        tok([reformat_prompt(p)], max_length=pipe.cfg.clip.max_length), n, 0)).to(pipe.device)
    ctx, unc = pipe.encode_text_cond_uncond(ids(prompt), ids(n_prompt))
    h, w = detected.shape[:2]
    f = 2 ** (len(pipe.cfg.vae.ch_mult) - 1)
    shape = (n, h // f, w // f, 4)
    gen = torch.Generator().manual_seed(int(seed) if seed != -1 else 0)
    taps = len(encoder_plan(pipe.cfg.control.unet)[0]) + 1
    z = ddim_sample(pipe, ctx, unc, [Conditioning(hint[None].expand(n, -1, -1, -1))], shape,
                    DDIMConfig(steps=int(ddim_steps), guidance_scale=float(scale)),
                    x_T=torch.randn(shape, generator=gen), generator=gen,
                    control_scales=[float(strength)] * taps)
    img = pipe.decode_first_stage(z)
    out = torch.clamp(img.float() * 127.5 + 127.5, 0, 255).to(torch.uint8).cpu().numpy()
    return [detected] + [out[i] for i in range(n)]


# ---------------------------------------------------------------------------
# the style-transfer app (app/gradio_ctrlora_style_transfer.py)
# ---------------------------------------------------------------------------

def build_style(sd_ckpt: str, cn_ckpt: str, lora_ckpt: str, ip_ckpt: str, ip_scale: float,
                target: str, image_encoder_ckpt: Optional[str] = None, device="cuda",
                cache: Optional[ModelCache] = None) -> StyleCtrLoRA:
    """StyleCtrLoRA with one LoRA and the IP-Adapter loaded at `ip_scale`
    on `target`'s sites ('all', 'style_blocks', 'style_layout'); with
    `cache`, built once per argument tuple."""
    def build():
        m = StyleCtrLoRA(num_loras=1, device=device)
        m.create_model(sd_ckpt, cn_ckpt, [lora_ckpt])
        m.load_ip_adapter(ip_ckpt, ip_scale=float(ip_scale), target=target,
                          image_encoder_ckpt=image_encoder_ckpt)
        return m

    key = (sd_ckpt, cn_ckpt, lora_ckpt, ip_ckpt, float(ip_scale), target, image_encoder_ckpt)
    return cache.get(key, build) if cache is not None else build()


def process_style(det: str, cond_image: np.ndarray, style_image: np.ndarray, prompt: str,
                  n_prompt: str, num_samples: int, ddim_steps: int, scale: float, seed: int,
                  sd_ckpt: str, cn_ckpt: str, lora_ckpt: str, ip_ckpt: str, ip_scale: float,
                  target: str, img2img: Optional[np.ndarray] = None,
                  img2img_strength: float = 0.8, image_encoder_ckpt: Optional[str] = None,
                  device="cuda", cache: Optional[ModelCache] = None) -> List[np.ndarray]:
    """Detect the condition, embed the style image, sample (txt2img, or
    img2img from `img2img`) -> [detected, style, sample, ...] (JAX's
    ``ui_process``)."""
    m = build_style(sd_ckpt, cn_ckpt, lora_ckpt, ip_ckpt, ip_scale, target,
                    image_encoder_ckpt, device, cache)
    detected = detect(det, cond_image, device=m.device)
    style = HWC3(np.asarray(style_image, np.uint8))
    results = m.sample_with_style(
        [detected], m.embed_style(style), reformat_prompt(prompt), reformat_prompt(n_prompt),
        int(num_samples), int(ddim_steps), float(scale), seed=int(seed),
        img2img_image=HWC3(np.asarray(img2img, np.uint8)) if img2img is not None else None,
        img2img_strength=float(img2img_strength))
    return [detected, style] + [np.asarray(r) for r in results]


def ckpt_choices(directory: str) -> List[str]:
    """The files of a checkpoint directory, sorted ([] without one)."""
    return sorted(os.listdir(directory)) if os.path.isdir(directory) else []
