"""CtrLoRA pipeline of the port: the four towers and the denoiser call
(counterpart of ``ctrlora_tpu/pipeline.py`` on its fused-LoRA inference
path).

The control branch is the fused ControlNet (``lora_fuse``); text comes in as
token ids (the tokenizer is not ported yet). Images and latents are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import ModelConfig
from ctrlora_tpu_torch.lora_fuse import cast_params_for_inference, fused_control_config
from ctrlora_tpu_torch.models.clip import CLIPTextModel
from ctrlora_tpu_torch.models.layers import CL, ResBlock
from ctrlora_tpu_torch.models.unet import ControlNet, UNet
from ctrlora_tpu_torch.models.vae import AutoencoderKL
from ctrlora_tpu_torch.schedules import DiffusionSchedule, make_schedule


@dataclasses.dataclass(frozen=True)
class Conditioning:
    """One control condition: a VAE-encoded latent hint [B, h, w, 4] and its
    blend weight. The control weights are the pipeline's fused ControlNet."""

    hint: torch.Tensor
    weight: float = 1.0


class CtrLoraPipeline:
    """Module bundle + schedule. The modules are built on `device`, in eval
    mode, without gradients, in channels-last memory."""

    def __init__(self, cfg: ModelConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        with self.device:
            self.unet = UNet(cfg.unet)
            self.control = ControlNet(fused_control_config(cfg.control))
            self.vae = AutoencoderKL(cfg.vae)
            self.clip = CLIPTextModel(cfg.clip)
        for m in self.modules():
            m.eval().requires_grad_(False).to(memory_format=CL)
        d = cfg.diffusion
        self.schedule: DiffusionSchedule = make_schedule(
            d.timesteps, d.linear_start, d.linear_end)

    def modules(self) -> List[nn.Module]:
        return [self.unet, self.control, self.vae, self.clip]

    def load_state_dicts(self, unet, control, vae, clip) -> None:
        """Load the four state dicts (``convert.params_from_jax`` layout; the
        control dict fused) with strict=True."""
        for module, sd in zip(self.modules(), (unet, control, vae, clip)):
            module.load_state_dict(sd, strict=True)

    def cast_for_inference(self) -> None:
        """Cast the UNet, ControlNet and VAE weights to their compute dtypes
        once and derive the fused projections; CLIP stays fp32."""
        cast_params_for_inference(self.unet, self.cfg.unet.compute_dtype)
        cast_params_for_inference(self.control, self.cfg.control.unet.compute_dtype)
        cast_params_for_inference(self.vae, self.cfg.vae.compute_dtype)

    # ------------------------------------------------------------------
    # frozen towers
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_first_stage(self, img: torch.Tensor) -> torch.Tensor:
        """img [B, H, W, 3] in [-1, 1] -> scaled latent mean [B, h, w, 4]."""
        mean, _ = self.vae.encode(img)
        return self.cfg.diffusion.scale_factor * mean

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.cfg.diffusion.scale_factor)

    @torch.no_grad()
    def encode_text_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids [B, 77] -> context [B, 77, 768] fp32."""
        return self.clip(token_ids)

    def encode_text_cond_uncond(self, token_ids, uncond_ids):
        """The CFG pair as ONE batched CLIP call."""
        both = self.encode_text_tokens(torch.cat([token_ids, uncond_ids]))
        b = token_ids.shape[0]
        return both[:b], both[b:]

    # ------------------------------------------------------------------
    # the denoiser
    # ------------------------------------------------------------------
    @torch.no_grad()
    def emb_proj_tables(self, timesteps: torch.Tensor, n_conds: int = 0) -> dict:
        """Every t-dependent projection for the S sampling steps at once:
        {'unet': {res_block: [S, C]}, 'control': (same for each cond, ...)}.
        The timestep MLP and the per-ResBlock emb_proj Linears depend only on
        the step, so the sampler computes them once, not per step."""

        def branch(module, dtype):
            x = F.silu(module.time_embed(timesteps, dtype))
            return {name: block.emb_proj(x) for name, block in module.named_children()
                    if isinstance(block, ResBlock)}

        ctab = branch(self.control, self.cfg.control.unet.compute_dtype)
        return {"unet": branch(self.unet, self.cfg.unet.compute_dtype),
                "control": tuple(ctab for _ in range(n_conds))}

    @torch.no_grad()
    def apply_control(self, x_noisy, t, context, conds: Sequence[Conditioning],
                      emb_rows: Optional[Sequence[dict]] = None):
        """The control branch for each condition, blended."""
        total = None
        for j, cond in enumerate(conds):
            rows = emb_rows[j] if emb_rows is not None else None
            taps = self.control(cond.hint, t, context, emb_rows=rows)
            if len(conds) > 1 or cond.weight != 1.0:
                taps = [c.float() * cond.weight for c in taps]  # fp32 blend, as JAX
            total = list(taps) if total is None else [a + b for a, b in zip(total, taps)]
        return tuple(total)

    @torch.no_grad()
    def apply_model(self, x_noisy, t, context, conds: Optional[Sequence[Conditioning]] = None,
                    emb_rows: Optional[Dict] = None) -> torch.Tensor:
        """Predicted eps [B, h, w, 4] fp32 for noisy latents. emb_rows: one
        step's rows of ``emb_proj_tables`` (t batch-uniform)."""
        control = None
        if conds:
            control = self.apply_control(
                x_noisy, t, context, conds,
                emb_rows=emb_rows["control"] if emb_rows is not None else None)
        return self.unet(x_noisy, t, context, control=control,
                         emb_rows=emb_rows["unet"] if emb_rows is not None else None)
