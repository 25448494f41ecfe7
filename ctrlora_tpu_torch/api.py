"""Python API of the port (counterpart of ``ctrlora_tpu/api.py``): one or
more condition LoRAs switched into the Base ControlNet.

    from ctrlora_tpu_torch.api import CtrLoRA
    ct = CtrLoRA(num_loras=2, device="cuda")
    ct.create_model(sd_file, basecn_file, lora_files=(lora0, lora1))
    images = ct.sample((hint0, hint1), prompt, n_prompt, num_samples=4)

``create_model`` loads the three reference-format stages
(``utils.loading.load_ctrlora``), then folds each LoRA into a ControlNet of
its own (``lora_fuse``) and casts the towers to their compute dtype once.
``sample`` takes image paths or uint8 arrays; ``_sample_images`` below it
takes arrays and returns uint8 [B, H, W, 3]. One call: the prompt pair
through the tokenizer and one CLIP call, a VAE encode of each hint, DDIM
with CFG on the stacked 2B batch, where each step runs the UNet and every
condition's ControlNet and blends their taps by ``lora_weights`` and
``control_scales``, then a VAE decode.

Differences from the JAX API: there is no jit cache (PyTorch runs eagerly);
the starting noise, and then the eta draws, come from a CPU generator
seeded from ``seed`` (so the same seed gives the same image on any device,
not the JAX package's). PIL is imported only to open image paths in
``sample`` and to return PIL images from it; ``_sample_images`` needs numpy
only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch import lora_fuse
from ctrlora_tpu_torch.configs import ModelConfig, ctrlora_inference_config
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
from ctrlora_tpu_torch.utils import trace
from ctrlora_tpu_torch.utils.image import HWC3, center_crop_to_common
from ctrlora_tpu_torch.utils.loading import load_ctrlora
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer

# each key a sampling call's `timings` dict takes, and the span it is read from
TIMINGS = {"prep_s": "sample.prep", "ddim_s": "sample.sampler", "decode_s": "sample.decode"}


class CtrLoRA:
    """``fuse=True`` (the serving path) holds one fused ControlNet per LoRA
    and each condition runs its own; ``fuse=False`` holds the unfused tree
    and selects the LoRA by ``lora_idx``. ``bf16`` casts the UNet, the
    ControlNets and the VAE to their compute dtype once."""

    def __init__(self, num_loras: int = 1, lora_rank: int = 128,
                 cfg: Optional[ModelConfig] = None, fuse: bool = True, bf16: bool = True,
                 device="cuda"):
        self.num_loras = num_loras
        self.cfg = cfg or ctrlora_inference_config(lora_num=num_loras, lora_rank=lora_rank)
        self.fuse = fuse
        self.bf16 = bf16
        self.device = torch.device(device)
        self.pipe = CtrLoraPipeline(self.cfg, self.device, fuse_lora=fuse)
        self.controls: Optional[List[torch.nn.Module]] = None
        self.n_taps = len(encoder_plan(self.cfg.control.unet)[0]) + 1

    def create_model(self, sd_file: str = "ckpts/sd15/v1-5-pruned.ckpt",
                     basecn_file: str = "ckpts/ctrlora-basecn/ctrlora_sd15_basecn700k.ckpt",
                     lora_files: Sequence[str] = ()) -> None:
        if not isinstance(lora_files, (tuple, list)):
            lora_files = (lora_files,)
        for f in (sd_file, basecn_file, *lora_files):
            if not os.path.exists(f):
                raise FileNotFoundError(f"File not found: {f}")
        if len(lora_files) != self.num_loras:
            raise ValueError(f"expected {self.num_loras} lora files, got {len(lora_files)}")
        pipe = self.pipe
        states = load_ctrlora(pipe, sd_file, basecn_file, lora_files)
        for module, sd in ((pipe.unet, states.unet), (pipe.vae, states.vae),
                           (pipe.clip, states.clip)):
            module.load_state_dict(sd, strict=True)
        if self.fuse:
            self.controls = [pipe.control] + [pipe.new_control()
                                              for _ in range(self.num_loras - 1)]
            for i, module in enumerate(self.controls):
                module.load_state_dict(lora_fuse.fuse_control_tree(
                    module, states.control, i, self.cfg.control.lora), strict=True)
        else:
            pipe.control.load_state_dict(states.control, strict=True)
            self.controls = [pipe.control] * self.num_loras
        del states
        if self.bf16:
            pipe.cast_for_inference()
            for module in self.controls[1:] if self.fuse else ():
                lora_fuse.cast_params_for_inference(module, self.cfg.control.unet.compute_dtype)

    # ------------------------------------------------------------------
    def sample(self, cond_image_paths, prompt: str, n_prompt: str = "", num_samples: int = 1,
               ddim_steps: int = 20, scale: float = 7.5,
               lora_weights: Sequence[float] = (1.0, 1.0), seed: int = 0):
        """Condition images (paths or uint8 arrays, one per LoRA) -> a list of
        PIL images. Two images are centre-cropped to their common size."""
        from PIL import Image

        out = self._sample_images(self.prepare_images(cond_image_paths), prompt, n_prompt,
                                  num_samples, ddim_steps, scale, lora_weights, seed)
        return [Image.fromarray(img) for img in out]

    def prepare_images(self, cond_images) -> List[np.ndarray]:
        """Paths or uint8 arrays, one per LoRA -> uint8 [H, W, 3] arrays
        (``HWC3``); two are centre-cropped to their common size. PIL is
        imported only to open a path."""
        if not isinstance(cond_images, (tuple, list)):
            cond_images = (cond_images,)
        if len(cond_images) != self.num_loras:
            raise ValueError(f"Expected {self.num_loras} images, got {len(cond_images)}")
        images = []
        for p in cond_images:
            if not isinstance(p, np.ndarray):
                from PIL import Image

                p = np.array(Image.open(p))
            images.append(HWC3(p))
        if self.num_loras == 2:
            images = list(center_crop_to_common(images[0], images[1]))
        return images

    def token_ids(self, prompt: str, num_samples: int) -> torch.Tensor:
        """[num_samples, max_length] int64 ids of one prompt, on the device."""
        ids = default_tokenizer()([prompt], max_length=self.cfg.clip.max_length)
        if int(ids.max()) >= self.cfg.clip.vocab_size:
            raise ValueError(f"tokenizer produced id {int(ids.max())} >= model vocab "
                             f"{self.cfg.clip.vocab_size}; config/tokenizer mismatch")
        return torch.from_numpy(np.repeat(ids, num_samples, axis=0)).to(self.device)

    def conditions(self, images: Sequence[np.ndarray], num_samples: int,
                   lora_weights: Sequence[float]) -> List[Conditioning]:
        """One Conditioning per LoRA: its hint (uint8 [H, W, 3] / 255, VAE
        encoded), slot index, weight and control module."""
        if self.controls is None:
            raise RuntimeError("Model is not loaded. Call create_model() first.")
        conds = []
        for i, img in enumerate(images[:self.num_loras]):
            hint = torch.from_numpy(img.astype(np.float32) / 255.0).to(self.device)
            hz = self.pipe.encode_first_stage(hint[None].expand(num_samples, -1, -1, -1)
                                              .contiguous())
            conds.append(Conditioning(hz, lora_idx=i, weight=float(lora_weights[i]),
                                      control=self.controls[i] if self.fuse else None))
        return conds

    def _sample_float(self, images, prompt, n_prompt, num_samples, ddim_steps, scale,
                      lora_weights, seed, eta: float = 0.0, guess_mode: bool = False,
                      control_scales=None, timings: Optional[dict] = None) -> torch.Tensor:
        """The sampling call up to the decoded image [B, H, W, 3] in [-1, 1].
        `eta` > 0 adds DDIM's noise; `guess_mode` runs the uncond half of
        the guidance batch without control (pair it with decayed
        control_scales, as the gradio app does). With a `timings` dict, the
        device is synchronised at the phase boundaries and prep_s / ddim_s /
        decode_s, the host seconds of the call's spans (``TIMINGS``), are
        written into it."""
        pipe = self.pipe
        sync = self._timing_sync(timings)
        with trace.timings_into(timings, **TIMINGS), trace.span("sample.request"):
            with trace.span("sample.prep"):
                h, w = images[0].shape[:2]
                f = 2 ** (len(self.cfg.vae.ch_mult) - 1)
                ctx, unc = pipe.encode_text_cond_uncond(self.token_ids(prompt, num_samples),
                                                        self.token_ids(n_prompt, num_samples))
                conds = self.conditions(images, num_samples, lora_weights)
                if control_scales is not None and len(control_scales) != self.n_taps:
                    raise ValueError(f"control_scales needs {self.n_taps} values")
                shape = (num_samples, h // f, w // f, 4)
                gen = torch.Generator().manual_seed(seed)
                x_T = torch.randn(shape, generator=gen)
                sync()
            with trace.span("sample.sampler"):
                z = ddim_sample(pipe, ctx, unc, conds, shape,
                                DDIMConfig(steps=ddim_steps, guidance_scale=scale, eta=eta,
                                           guess_mode=guess_mode), x_T=x_T, generator=gen,
                                control_scales=control_scales)
                sync()
            with trace.span("sample.decode"):
                img = pipe.decode_first_stage(z)
                sync()
        return img

    def _timing_sync(self, timings: Optional[dict]):
        """What ends each phase of a sampling call: with `timings` asked for
        on the card, a synchronise, so each phase's span holds its device
        time; else nothing."""
        if timings is not None and self.device.type == "cuda":
            return lambda: torch.cuda.synchronize(self.device)
        return lambda: None

    def _sample_images(self, images, prompt, n_prompt, num_samples, ddim_steps, scale,
                       lora_weights, seed, eta: float = 0.0, guess_mode: bool = False,
                       control_scales=None, timings: Optional[dict] = None) -> np.ndarray:
        """uint8 condition images [H, W, 3] (one per LoRA, same size) ->
        uint8 samples [num_samples, H, W, 3], deterministic under `seed`."""
        img = self._sample_float(images, prompt, n_prompt, num_samples, ddim_steps, scale,
                                 lora_weights, seed, eta, guess_mode, control_scales, timings)
        return torch.clamp(img.float() * 127.5 + 127.5, 0, 255).to(torch.uint8).cpu().numpy()
