"""IP-Adapter parts of the port: the CLIP vision tower, the image-projection
model and the checkpoint bridges of the style pipeline (counterpart of
``ctrlora_tpu/models/ip_adapter.py``).

Reference trail:
  * IPCrossAttention with to_k_ip/to_v_ip and a per-site ip_scale
    (ldm/modules/attention_ip.py:196-289): ``models/attention.CrossAttention``
    with ``ip_tokens``.
  * ImageProjModel: a CLIP image embedding (1024) -> 4 context tokens of 768
    (app/gradio_ctrlora_style_transfer.py:93-111).
  * The ip-adapter file's '{2j+1}.to_{k,v}_ip.weight' keys -> the UNet's 16
    attn2 sites in encoder / middle / decoder order
    (app/gradio_ctrlora_style_transfer.py:114-174 and ip_layers.txt).

The vision tower is fp32 and plain (JAX's is einsums, no Pallas kernel):
its layers are the text tower's ``CLIPLayer`` without a mask, over a bias-free
patch convolution, a class token and learned positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ctrlora_tpu_torch.configs import UNetConfig
from ctrlora_tpu_torch.models.clip import CLIPLayer
from ctrlora_tpu_torch.models.layers import Dense, LayerNorm32
from ctrlora_tpu_torch.models.unet import decoder_plan, encoder_plan


class ImageProjModel(nn.Module):
    """CLIP image embedding [B, clip_embeddings_dim] -> LayerNorm of its
    projection as [B, clip_extra_context_tokens, cross_attention_dim]."""

    def __init__(self, cross_attention_dim: int = 768, clip_extra_context_tokens: int = 4,
                 clip_embeddings_dim: int = 1024):
        super().__init__()
        self.tokens, self.dim = clip_extra_context_tokens, cross_attention_dim
        self.proj = Dense(clip_embeddings_dim, clip_extra_context_tokens * cross_attention_dim)
        self.norm = LayerNorm32(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds).reshape(image_embeds.shape[0], self.tokens, self.dim)
        return self.norm(x)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """ViT image tower. The defaults are ViT-H/14, the IP-Adapter's image
    encoder. hidden_act: 'quick_gelu' for openai CLIP, 'gelu' for laion
    ViT-H."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    projection_dim: int = 1024
    hidden_act: str = "gelu"


class CLIPVisionModel(nn.Module):
    """Pixels [B, image_size, image_size, 3] (NHWC, as JAX's) -> projected
    image embeds [B, projection_dim] (CLIPVisionModelWithProjection's
    image_embeds): post_layernorm of the class token, then
    visual_projection."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(
            torch.zeros((cfg.image_size // cfg.patch_size) ** 2 + 1, d))
        self.pre_layrnorm = LayerNorm32(d)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.post_layernorm = LayerNorm32(d)
        self.visual_projection = Dense(d, cfg.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        x = self.patch_embedding(pixel_values.float().permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # [B, patches, d], row-major as JAX's reshape
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], dim=1)
        x = self.pre_layrnorm(x + self.position_embedding[None])
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, 0.0)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_image_preprocess(images: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 RGB [B, H, W, 3] -> normalised float32 [B, size, size, 3]: the
    shortest side resized to `size` (cv2 INTER_CUBIC), a centre crop, CLIP's
    mean and std."""
    import cv2

    out = []
    for img in images:
        h, w = img.shape[:2]
        scale = size / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        r = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
        top, left = (nh - size) // 2, (nw - size) // 2
        r = r[top:top + size, left:left + size]
        out.append((r.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD)
    return np.stack(out)


def _tensor(value) -> torch.Tensor:
    """An array or tensor of a state dict as an fp32 CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, np.float32))


def clip_vision_keys(cfg: CLIPVisionConfig) -> Dict[str, str]:
    """{the port's CLIPVisionModel key: the HF CLIPVisionModelWithProjection
    key} (``vision_model.*`` and ``visual_projection.weight``); the layouts
    are the same."""
    pre = "vision_model."
    out = {"class_embedding": pre + "embeddings.class_embedding",
           "position_embedding": pre + "embeddings.position_embedding.weight",
           "patch_embedding.weight": pre + "embeddings.patch_embedding.weight",
           "visual_projection.weight": "visual_projection.weight"}
    for leaf in ("weight", "bias"):
        for ln in ("pre_layrnorm", "post_layernorm"):
            out[f"{ln}.{leaf}"] = f"{pre}{ln}.{leaf}"
        for i in range(cfg.num_layers):
            src = f"{pre}encoder.layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"layer_{i}.self_attn.{n}.{leaf}"] = f"{src}self_attn.{n}.{leaf}"
            for n in ("layer_norm1", "layer_norm2"):
                out[f"layer_{i}.{n}.{leaf}"] = f"{src}{n}.{leaf}"
            for n in ("fc1", "fc2"):
                out[f"layer_{i}.{n}.{leaf}"] = f"{src}mlp.{n}.{leaf}"
    return out


def convert_clip_vision(sd: Mapping[str, np.ndarray], cfg: CLIPVisionConfig
                        ) -> Dict[str, torch.Tensor]:
    """An HF CLIPVisionModelWithProjection state dict -> the port's
    CLIPVisionModel state dict, fp32."""
    return {k: _tensor(sd[src]) for k, src in clip_vision_keys(cfg).items()}


# ---------------------------------------------------------------------------
# the ip-adapter file -> the UNet's attn2 sites
# ---------------------------------------------------------------------------

def ip_attn_sites(cfg: UNetConfig) -> List[Tuple[str, ...]]:
    """The attn2 sites in the reference's ip_layers.txt order (16 at SD1.5
    width): encoder transformers, middle, decoder transformers."""
    sites: List[Tuple[str, ...]] = []
    for i, step in enumerate(encoder_plan(cfg)[0]):
        if step.kind == "res" and step.attn:
            sites += [(f"in_{i}_attn", f"block_{d}", "attn2")
                      for d in range(cfg.transformer_depth)]
    sites += [("mid_attn", f"block_{d}", "attn2") for d in range(cfg.transformer_depth)]
    for i, step in enumerate(decoder_plan(cfg)):
        if step.attn:
            sites += [(f"out_{i}_attn", f"block_{d}", "attn2")
                      for d in range(cfg.transformer_depth)]
    return sites


# named ip_scale target subsets (app/gradio_ctrlora_style_transfer.py:134-173)
IP_SCALE_TARGETS = {
    "all": None,  # every site
    "style_blocks": [("out_3_attn",), ("out_4_attn",), ("out_5_attn",)],
    "style_layout": [
        ("in_7_attn",), ("in_8_attn",),
        ("out_3_attn",), ("out_4_attn",), ("out_5_attn",),
    ],
}


@torch.no_grad()
def load_ip_adapter_into(unet: nn.Module, ip_sd: Mapping[str, np.ndarray], cfg: UNetConfig,
                         ip_scale: float = 1.0, target: str = "all") -> nn.Module:
    """Copy the ip-adapter sub-dict's '{2j+1}.to_{k,v}_ip.weight' [inner,
    context_dim] into site j's ``to_k_ip`` / ``to_v_ip`` in place (cast to
    each parameter's dtype and device, so a UNet cast for inference stays
    in bf16), and set each site's ``ip_scale`` to `ip_scale` where `target`
    covers it and to 0 elsewhere. Returns `unet`."""
    if not cfg.ip_tokens:
        raise ValueError("the UNet has no image-prompt branch (ip_tokens = 0)")
    targets = IP_SCALE_TARGETS[target]
    for j, site in enumerate(ip_attn_sites(cfg)):
        attn = unet.get_submodule(".".join(site))
        for name in ("to_k_ip", "to_v_ip"):
            w = getattr(attn, name).weight
            src = _tensor(ip_sd[f"{2 * j + 1}.{name}.weight"])
            if src.shape != w.shape:
                raise ValueError(f"{'.'.join(site)}.{name}: file {tuple(src.shape)}, "
                                 f"model {tuple(w.shape)}")
            w.copy_(src)
        on = targets is None or any(site[:len(t)] == t for t in targets)
        attn.ip_scale.fill_(ip_scale if on else 0.0)
    return unet


def convert_image_proj(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The ip-adapter file's 'image_proj' sub-dict -> ImageProjModel's state
    dict, fp32."""
    return {k: _tensor(sd[k]) for k in ("proj.weight", "proj.bias", "norm.weight", "norm.bias")}
