"""Style transfer of the port: CtrLoRA with IP-Adapter image prompting
(counterpart of ``ctrlora_tpu/style.py``; reference
app/gradio_ctrlora_style_transfer.py, cldm/cldm_style.py and
cldm/cldm_ctrlora_style_inference.py).

    from ctrlora_tpu_torch.style import StyleCtrLoRA
    st = StyleCtrLoRA(num_loras=1, device="cuda")
    st.create_model(sd_file, basecn_file, lora_files=(lora0,))
    st.load_ip_adapter(ip_file, ip_scale=1.0, target="style_blocks",
                       image_encoder_ckpt=vit_h_file)
    tokens = st.embed_style(style_image)  # uint8 [H, W, 3] -> [1, 4, 768]
    images = st.sample_with_style((hint,), tokens, prompt, num_samples=4)

A style image is embedded by the CLIP ViT-H/14 vision tower, projected to 4
extra context tokens (``ImageProjModel``) and read by every attn2 of the
UNet through its own ``to_k_ip`` / ``to_v_ip``, scaled per site by
``ip_scale``; the control branch reads only the text context. An optional
negative-content prompt subtracts the ViT-H CLIP *text* projection of a
content description from the image embedding before the projection
(app:386-404). The uncond half of the guidance batch takes
``image_proj(zeros)`` as its style tokens (app:410).

Differences from the JAX package: the starting noise, and in img2img the
encode's noise, come from a CPU ``torch.Generator`` seeded by ``seed`` (the
same image for a seed on any device, not the JAX package's); the model,
vision and negative-content text configurations are arguments (JAX's by
default), and the image is preprocessed to the vision tower's own size.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ctrlora_tpu_torch.api import TIMINGS, CtrLoRA
from ctrlora_tpu_torch.configs import CLIPTextConfig, ModelConfig, ctrlora_inference_config
from ctrlora_tpu_torch.models.clip import CLIPTextModel
from ctrlora_tpu_torch.models.ip_adapter import (
    CLIPVisionConfig, CLIPVisionModel, ImageProjModel, clip_image_preprocess,
    convert_clip_vision, convert_image_proj, load_ip_adapter_into,
)
from ctrlora_tpu_torch.sampling.ddim import (
    DDIMConfig, ddim_decode_from, ddim_sample, ddim_stochastic_encode,
)
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import trace
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer

# the ViT-H CLIP text tower with its projection: the negative-content encoder
# (CLIPTextModelWithProjection of the IP-Adapter's image encoder's family)
VITH_TEXT_PROJECTED = CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_layers=24,
                                     num_heads=16, layer="projected", projection_dim=1024,
                                     hidden_act="gelu")


def style_config(lora_num: int = 1, lora_rank: int = 128, ip_tokens: int = 4) -> ModelConfig:
    """``ctrlora_inference_config`` with `ip_tokens` image-prompt tokens in
    the UNet (not in the control branch)."""
    cfg = ctrlora_inference_config(lora_num=lora_num, lora_rank=lora_rank)
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, ip_tokens=ip_tokens))


def _split_ip_file(path: str) -> Tuple[Mapping, Mapping]:
    """An IP-Adapter file -> its (ip_adapter, image_proj) sub-dicts: flat
    ``ip_adapter.`` / ``image_proj.`` keys (.bin, .safetensors), or the
    published nested ``{'image_proj': ..., 'ip_adapter': ...}`` torch file,
    a dict of tensors read with ``weights_only=True``."""
    sd = bridge.load_torch_state_dict(path)
    sub = lambda pfx: {k[len(pfx):]: v for k, v in sd.items() if k.startswith(pfx)}
    ip_sd, proj_sd = sub("ip_adapter."), sub("image_proj.")
    if not ip_sd:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        ip_sd, proj_sd = raw["ip_adapter"], raw["image_proj"]
    return ip_sd, proj_sd


class StyleCtrLoRA(CtrLoRA):
    """CtrLoRA with IP-Adapter style control (the reference's style-transfer
    app as a library). `cfg` defaults to ``style_config(num_loras,
    lora_rank, ip_tokens)``, `vision_cfg` to ViT-H/14 and `neg_text_cfg` to
    ``VITH_TEXT_PROJECTED``."""

    def __init__(self, num_loras: int = 1, lora_rank: int = 128, ip_tokens: int = 4,
                 cfg: Optional[ModelConfig] = None,
                 vision_cfg: Optional[CLIPVisionConfig] = None,
                 neg_text_cfg: Optional[CLIPTextConfig] = None, fuse: bool = True,
                 bf16: bool = True, device="cuda"):
        cfg = cfg or style_config(num_loras, lora_rank, ip_tokens)
        if not cfg.unet.ip_tokens:
            raise ValueError("a style model's UNet takes image-prompt tokens (ip_tokens > 0)")
        super().__init__(num_loras, lora_rank, cfg=cfg, fuse=fuse, bf16=bf16, device=device)
        self.ip_tokens = cfg.unet.ip_tokens
        self.vision_cfg = vision_cfg or CLIPVisionConfig()
        self.neg_text_cfg = neg_text_cfg or VITH_TEXT_PROJECTED
        self.vision: Optional[CLIPVisionModel] = None
        self.image_proj: Optional[ImageProjModel] = None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def load_ip_adapter(self, ip_ckpt: str, ip_scale: float = 1.0, target: str = "all",
                        image_encoder_ckpt: Optional[str] = None) -> None:
        """ip_ckpt: the IP-Adapter file (both forms, ``_split_ip_file``): its
        to_{k,v}_ip weights go into the loaded UNet in place and each site's
        ip_scale is set by `target` (``IP_SCALE_TARGETS``); its image_proj
        builds ``image_proj``. image_encoder_ckpt: the HF ViT-H/14 vision
        weights (CLIPVisionModelWithProjection keys), for ``embed_style``."""
        if self.controls is None:
            raise RuntimeError("Model is not loaded. Call create_model() first.")
        ip_sd, proj_sd = _split_ip_file(ip_ckpt)
        load_ip_adapter_into(self.pipe.unet, ip_sd, self.cfg.unet, ip_scale, target)
        state = convert_image_proj(proj_sd)
        with self.device:
            proj = ImageProjModel(self.cfg.unet.context_dim or 768, self.ip_tokens,
                                  state["proj.weight"].shape[1])
        proj.load_state_dict(state, strict=True)
        self.image_proj = proj.eval()
        if image_encoder_ckpt:
            with self.device:
                vision = CLIPVisionModel(self.vision_cfg)
            vision.load_state_dict(convert_clip_vision(
                bridge.load_torch_state_dict(image_encoder_ckpt), self.vision_cfg), strict=True)
            self.vision = vision.eval()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def embed_style(self, style_image: np.ndarray,
                    neg_content_embeds: Optional[torch.Tensor] = None,
                    neg_content_scale: float = 1.0) -> torch.Tensor:
        """A uint8 RGB [H, W, 3] style image -> [1, ip_tokens, context_dim]
        fp32 tokens, the negative content's embedding (``embed_neg_content``)
        subtracted from the image's first, times `neg_content_scale`."""
        if self.vision is None or self.image_proj is None:
            raise RuntimeError("call load_ip_adapter(..., image_encoder_ckpt=...) first")
        px = clip_image_preprocess(style_image[None], self.vision_cfg.image_size)
        embeds = self.vision(torch.from_numpy(px).to(self.device))
        if neg_content_embeds is not None:
            embeds = embeds - neg_content_scale * neg_content_embeds.to(embeds)
        return self.image_proj(embeds)

    @torch.no_grad()
    def embed_style_tokens_zero(self, batch: int = 1) -> torch.Tensor:
        """The uncond style tokens, ``image_proj(zero embeds)`` (the
        reference's uncond_image_prompt_embeds); zeros before
        ``load_ip_adapter``."""
        if self.image_proj is not None:
            z = torch.zeros((batch, self.image_proj.proj.in_features), device=self.device)
            return self.image_proj(z)
        return torch.zeros((batch, self.ip_tokens, self.cfg.unet.context_dim or 768),
                           device=self.device)

    @torch.no_grad()
    def embed_neg_content(self, prompt: str, text_encoder_ckpt: str,
                          scale: float = 1.0) -> torch.Tensor:
        """The negative-content embedding [1, projection_dim]: the projected
        ViT-H CLIP *text* embedding of `prompt`, times `scale`, to subtract
        from the style image's (app/gradio_ctrlora_style_transfer.py:395-403).
        text_encoder_ckpt: HF ``text_model.*`` keys and
        ``text_projection.weight``."""
        cfg = self.neg_text_cfg
        sd = bridge.load_torch_state_dict(text_encoder_ckpt)
        state = bridge.port_entries(sd, bridge.clip_entries(cfg), prefix="text_model.")
        state["text_projection.weight"] = torch.from_numpy(sd["text_projection.weight"])
        with self.device:
            model = CLIPTextModel(cfg)
        model.load_state_dict(state, strict=True)
        ids = default_tokenizer()([prompt], max_length=cfg.max_length)
        return model.eval()(torch.from_numpy(ids).to(self.device)) * scale

    # ------------------------------------------------------------------
    def _sample_style_float(self, cond_images, style_tokens: torch.Tensor, prompt: str,
                            n_prompt: str = "", num_samples: int = 1, ddim_steps: int = 20,
                            scale: float = 7.5, lora_weights: Sequence[float] = (1.0, 1.0),
                            seed: int = 0, img2img_image: Optional[np.ndarray] = None,
                            img2img_strength: float = 0.8,
                            timings: Optional[dict] = None) -> torch.Tensor:
        """The style sampling call up to the decoded image [B, H, W, 3] in
        [-1, 1]: txt2img, or with `img2img_image` (uint8 [H, W, 3]) the
        content image's latent noised to step ``int(ddim_steps *
        img2img_strength)`` and decoded from there. With a `timings` dict,
        the device is synchronised at the phase boundaries and prep_s /
        ddim_s / decode_s, read off the call's spans as in
        ``CtrLoRA._sample_float``, are written into it."""
        pipe, n = self.pipe, num_samples
        sync = self._timing_sync(timings)
        with trace.timings_into(timings, **TIMINGS), trace.span("sample.request"):
            with trace.span("sample.prep"):
                images = self.prepare_images(cond_images)
                h, w = images[0].shape[:2]
                f = 2 ** (len(self.cfg.vae.ch_mult) - 1)
                ctx, unc = pipe.encode_text_cond_uncond(self.token_ids(prompt, n),
                                                        self.token_ids(n_prompt, n))
                conds = self.conditions(images, n, lora_weights)
                ip = style_tokens.to(self.device).repeat_interleave(n, dim=0)
                unc_ip = self.embed_style_tokens_zero(n) if self.image_proj is not None else None
                ddim = DDIMConfig(steps=ddim_steps, guidance_scale=scale)
                gen = torch.Generator().manual_seed(seed)
                if img2img_image is not None:
                    x = torch.from_numpy(img2img_image.astype(np.float32) / 127.5 - 1.0)
                    z0 = pipe.encode_first_stage(x.to(self.device)[None].expand(n, -1, -1, -1)
                                                 .contiguous())
                    t_start = max(1, min(int(ddim_steps * img2img_strength), ddim_steps))
                    z_T = ddim_stochastic_encode(pipe, z0, t_start - 1, ddim_steps,
                                                 generator=gen)
                else:
                    x_T = torch.randn((n, h // f, w // f, 4), generator=gen)
                sync()
            with trace.span("sample.sampler"):
                if img2img_image is not None:
                    z = ddim_decode_from(pipe, z_T, t_start, ctx, unc, conds, ddim,
                                         generator=gen, ip_context=ip, uncond_ip_context=unc_ip)
                else:
                    z = ddim_sample(pipe, ctx, unc, conds, x_T.shape, ddim, x_T=x_T,
                                    generator=gen, ip_context=ip, uncond_ip_context=unc_ip)
                sync()
            with trace.span("sample.decode"):
                img = pipe.decode_first_stage(z)
                sync()
        return img

    def sample_with_style(self, cond_images, style_tokens: torch.Tensor, prompt: str,
                          n_prompt: str = "", num_samples: int = 1, ddim_steps: int = 20,
                          scale: float = 7.5, lora_weights: Sequence[float] = (1.0, 1.0),
                          seed: int = 0, img2img_image: Optional[np.ndarray] = None,
                          img2img_strength: float = 0.8) -> List:
        """uint8 condition images [H, W, 3] (one per LoRA) and style tokens
        from ``embed_style`` -> a list of `num_samples` PIL images,
        deterministic under `seed` (see ``_sample_style_float``)."""
        from PIL import Image

        img = self._sample_style_float(cond_images, style_tokens, prompt, n_prompt,
                                       num_samples, ddim_steps, scale, lora_weights, seed,
                                       img2img_image, img2img_strength)
        out = torch.clamp(img.float() * 127.5 + 127.5, 0, 255).to(torch.uint8).cpu().numpy()
        return [Image.fromarray(x) for x in out]
