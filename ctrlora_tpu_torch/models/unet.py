"""SD1.5 UNet with control-residual injection, the ControlNet branch
(latent hint, as CtrLoRA, or pixel hint through ``HintBlock``, as the
vanilla ControlNet) and the hint encoder (counterpart of
``ctrlora_tpu/models/unet.py``).

The same modules build SDXL's UNet and ControlNet (the port's own; the
JAX package has none): a transformer depth a level (``UNetConfig.depth_at``),
heads of a fixed width (``heads_at``), Linear projections in the
transformers, and ``label_emb`` of the vector y (``adm_in_channels``),
added onto the time embedding.

Public tensors keep the JAX layout: latents, hints and control taps are
NHWC, contexts [B, S, D]. Inside, activations are NCHW channels-last, so
the layout changes at the boundary are free views.

With ``cfg.use_checkpoint`` and grad enabled, every ResBlock and
SpatialTransformer is rematerialised in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctrlora_tpu_torch.configs import ControlNetConfig, LoRAConfig, UNetConfig
from ctrlora_tpu_torch.models.attention import SpatialTransformer
from ctrlora_tpu_torch.models.layers import (
    CL, Conv, Downsample, GroupNorm32, LabelEmbed, LoraIdx, ResBlock, TimestepEmbed, Upsample,
    ZeroConv, n_banks, zero_,
)


@dataclasses.dataclass(frozen=True)
class EncoderStep:
    kind: str  # 'conv' | 'res' | 'down'
    out_ch: int
    attn: bool = False
    ds: int = 1


def encoder_plan(cfg: UNetConfig) -> Tuple[List[EncoderStep], List[int], int]:
    """Static topology of the input blocks; returns (steps, skip_chans, ch)."""
    steps = [EncoderStep("conv", cfg.model_channels)]
    chans = [cfg.model_channels]
    ch, ds = cfg.model_channels, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch = mult * cfg.model_channels
            steps.append(EncoderStep("res", ch, attn=ds in cfg.attention_resolutions, ds=ds))
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            steps.append(EncoderStep("down", ch, ds=ds))
            chans.append(ch)
            ds *= 2
    return steps, chans, ch


@dataclasses.dataclass(frozen=True)
class DecoderStep:
    skip_ch: int
    out_ch: int
    attn: bool
    upsample: bool
    ds: int


def decoder_plan(cfg: UNetConfig) -> List[DecoderStep]:
    _, chans, _ = encoder_plan(cfg)
    chans = list(chans)
    ds = 2 ** (len(cfg.channel_mult) - 1)
    steps = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            skip = chans.pop()
            up = level > 0 and i == cfg.num_res_blocks
            steps.append(DecoderStep(skip, cfg.model_channels * mult,
                                     attn=ds in cfg.attention_resolutions,
                                     upsample=up, ds=ds))
            if up:
                ds //= 2
    return steps


def _level(ds: int) -> int:
    """The level of a block at downsampling factor `ds`."""
    return ds.bit_length() - 1


def _attn(cfg: UNetConfig, ch: int, lora: Optional[LoRAConfig] = None,
          ip_tokens: int = 0, level: int = -1) -> SpatialTransformer:
    """The transformer of a site `ch` wide at `level` (-1: the middle)."""
    heads = cfg.heads_at(ch)
    return SpatialTransformer(ch, heads, ch // heads, depth=cfg.depth_at(level),
                              context_dim=cfg.context_dim,
                              use_flash=cfg.use_flash_attention, lora=lora,
                              ip_tokens=ip_tokens, use_linear=cfg.use_linear_in_transformer)


def _embed(module: nn.Module, cfg: UNetConfig, timesteps, dtype, y=None,
           lora_idx: LoraIdx = None) -> torch.Tensor:
    """The time embedding, plus ``label_emb(y)`` where the model takes y."""
    emb = module.time_embed(timesteps, dtype, lora_idx)
    if cfg.adm_in_channels is None:
        return emb
    if y is None:
        raise ValueError(f"the model takes y [B, {cfg.adm_in_channels}]; none was given")
    return emb + module.label_emb(y, dtype)


def _build_encoder(module: nn.Module, cfg: UNetConfig, in_channels: int,
                   lora: Optional[LoRAConfig] = None, ip_tokens: int = 0) -> int:
    """Adds in_conv and the in_{i}_* blocks; returns the output width. Only
    the UNet passes its ``ip_tokens``: a control branch reads text only."""
    emb_dim = 4 * cfg.model_channels
    ch = cfg.model_channels
    module.in_conv = Conv(in_channels, ch)
    for i, step in enumerate(encoder_plan(cfg)[0][1:], start=1):
        if step.kind == "res":
            module.add_module(f"in_{i}_res", ResBlock(ch, step.out_ch, emb_dim, lora))
            ch = step.out_ch
            if step.attn:
                module.add_module(f"in_{i}_attn",
                                  _attn(cfg, ch, lora, ip_tokens, _level(step.ds)))
        else:
            module.add_module(f"in_{i}_down", Downsample(ch, step.out_ch))
    module.mid_res0 = ResBlock(ch, ch, emb_dim, lora)
    module.mid_attn = _attn(cfg, ch, lora, ip_tokens)
    module.mid_res1 = ResBlock(ch, ch, emb_dim, lora)
    return ch


def _build_decoder(module: nn.Module, cfg: UNetConfig, ch: int, ip_tokens: int = 0) -> None:
    """Adds the out_{i}_* blocks on an encoder of output width `ch`, then
    norm_out and the zero-initialised conv_out."""
    emb_dim = 4 * cfg.model_channels
    for i, step in enumerate(decoder_plan(cfg)):
        module.add_module(f"out_{i}_res", ResBlock(ch + step.skip_ch, step.out_ch, emb_dim))
        ch = step.out_ch
        if step.attn:
            module.add_module(f"out_{i}_attn",
                              _attn(cfg, ch, ip_tokens=ip_tokens, level=_level(step.ds)))
        if step.upsample:
            module.add_module(f"out_{i}_up", Upsample(ch, ch))
    module.norm_out = GroupNorm32(ch, silu=True)
    module.conv_out = zero_(Conv(ch, cfg.out_channels))


def _block(cfg: UNetConfig, block: nn.Module, *args):
    """Run a ResBlock or SpatialTransformer, rematerialised in the backward
    when cfg.use_checkpoint is set and grad is enabled. No RNG state is
    saved for the recomputation: the port has no dropout, so no block draws
    random numbers, and the training step's CUDA graph holds no read of
    the generators' state."""
    if cfg.use_checkpoint and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
    return block(*args)


def _nchw(x: torch.Tensor, dtype) -> torch.Tensor:
    """NHWC -> NCHW-logical channels-last in `dtype`."""
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=CL)


class UNet(nn.Module):
    """Controlled SD UNet: `control` holds 13 NHWC residuals. With
    control_mode 'decoder' (ControlNet, CtrLoRA) 0..11 add onto the encoder
    skips (consumed in reverse) and 12 onto the middle output; with
    'encoder' (ControlNet-Lite) 0..11 add onto the encoder blocks' outputs
    as they are made, and 12 onto the middle. ``only_mid_control`` keeps
    the middle tap only (decoder mode). ``conv_out`` starts at zero, as in
    JAX: a fresh UNet outputs exactly 0. With ``cfg.ip_tokens`` every attn2
    takes the context's last ``ip_tokens`` rows as image-prompt tokens."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.time_embed = TimestepEmbed(cfg.model_channels)
        if cfg.adm_in_channels is not None:
            self.label_emb = LabelEmbed(cfg.adm_in_channels, 4 * cfg.model_channels)
        _build_decoder(self, cfg, _build_encoder(self, cfg, cfg.in_channels,
                                                 ip_tokens=cfg.ip_tokens), cfg.ip_tokens)

    def forward(self, x, timesteps, context, control: Optional[Sequence[torch.Tensor]] = None,
                emb_rows: Optional[dict] = None, only_mid_control: bool = False,
                control_mode: str = "decoder", kv_rows: Optional[dict] = None,
                y: Optional[torch.Tensor] = None):
        """x [B, H, W, C] noisy latent -> [B, H, W, C] fp32 model output.
        emb_rows: {res_block_name: [1, C] or [B, C]} precomputed emb_proj
        rows. kv_rows: {attn_site_name: per-depth k|v} hoisted
        cross-attention projections of this `context`
        (``CtrLoraPipeline.xattn_kv_tables``). y [B, adm_in_channels]: the
        vector conditioning of a model that takes it (unread with
        emb_rows, which hold it)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        emb = _embed(self, cfg, timesteps, dt, y) if emb_rows is None else None
        row = lambda name: None if emb_rows is None else emb_rows[name]
        kvr = lambda name: None if kv_rows is None else kv_rows.get(name)
        context = context.to(dt)
        steps = encoder_plan(cfg)[0]
        n_enc = len(steps)
        if control is not None and len(control) != n_enc + 1:
            raise ValueError(f"expected {n_enc + 1} control residuals, got {len(control)}")
        enc_side = control is not None and control_mode == "encoder"
        hs = []
        h = self.in_conv(_nchw(x, dt))
        for i, step in enumerate(steps):
            if step.kind == "res":
                h = _block(cfg, getattr(self, f"in_{i}_res"), h, emb, row(f"in_{i}_res"))
                if step.attn:
                    h = _block(cfg, getattr(self, f"in_{i}_attn"), h, context, None,
                               kvr(f"in_{i}_attn"))
            elif step.kind == "down":
                h = getattr(self, f"in_{i}_down")(h)
            if enc_side:
                h = h + _nchw(control[i], dt)
            hs.append(h)
        h = _block(cfg, self.mid_res0, h, emb, row("mid_res0"))
        h = _block(cfg, self.mid_attn, h, context, None, kvr("mid_attn"))
        h = _block(cfg, self.mid_res1, h, emb, row("mid_res1"))
        if control is not None:
            h = h + _nchw(control[n_enc], dt)
        for i, step in enumerate(decoder_plan(cfg)):
            skip = hs.pop()
            if control is not None and not only_mid_control and not enc_side:
                skip = skip + _nchw(control[n_enc - 1 - i], dt)
            h = torch.cat([h, skip], dim=1)
            h = _block(cfg, getattr(self, f"out_{i}_res"), h, emb, row(f"out_{i}_res"))
            if step.attn:
                h = _block(cfg, getattr(self, f"out_{i}_attn"), h, context, None,
                           kvr(f"out_{i}_attn"))
            if step.upsample:
                h = getattr(self, f"out_{i}_up")(h)
        h = self.conv_out(self.norm_out(h))
        return h.permute(0, 2, 3, 1).float()


# the hint encoder's 3x3 convs: (width, stride), each followed by SiLU
HINT_WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class HintBlock(nn.Module):
    """Pixel hint -> ``model_channels`` features at 1/8 of its size: seven
    3x3 convs with SiLU, then the zero-initialised 3x3 conv ``conv_out``
    (reference cldm/cldm.py:147-163; JAX ``HintBlock``)."""

    def __init__(self, model_channels: int, hint_channels: int = 3):
        super().__init__()
        cin = hint_channels
        for i, (width, stride) in enumerate(HINT_WIDTHS):
            self.add_module(f"conv_{i}", Conv(cin, width, stride=stride))
            cin = width
        self.conv_out = zero_(Conv(cin, model_channels))

    def forward(self, hint: torch.Tensor, dtype) -> torch.Tensor:
        """hint [B, H, W, c] -> NCHW channels-last [B, model_channels, H/8, W/8]."""
        h = _nchw(hint, dtype)
        for i in range(len(HINT_WIDTHS)):
            h = F.silu(getattr(self, f"conv_{i}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """Control branch: the UNet's encoder and middle with a zero-conv tap
    after every input block and after the middle. hint_mode 'latent'
    (CtrLoRA): the VAE-encoded hint is the input stream. hint_mode 'image'
    (vanilla ControlNet): the noisy latent is, and the pixel hint, through
    ``hint_block``, is added after ``in_conv``.
    Either the fused tree (no LoRA parameters: serving) or the unfused tree
    with ``cfg.lora.n_loras`` stacked adapters on every Dense (training, and
    the loader's output); with ``switchable_banks`` its zero convs and
    transformer norms are [n]-banks too, all selected by ``lora_idx``."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        if cfg.hint_mode not in ("latent", "image"):
            raise ValueError(f"unknown hint_mode {cfg.hint_mode!r}")
        ucfg = cfg.unet
        self.cfg = cfg
        self.time_embed = TimestepEmbed(ucfg.model_channels, cfg.lora)
        if ucfg.adm_in_channels is not None:
            self.label_emb = LabelEmbed(ucfg.adm_in_channels, 4 * ucfg.model_channels)
        if cfg.hint_mode == "image":
            self.hint_block = HintBlock(ucfg.model_channels, cfg.hint_channels)
        ch = _build_encoder(self, ucfg, ucfg.in_channels, cfg.lora)
        banks = n_banks(cfg.lora)
        for i, step in enumerate(encoder_plan(ucfg)[0]):
            self.add_module(f"zero_{i}", ZeroConv(step.out_ch, banks))
        self.zero_mid = ZeroConv(ch, banks)

    def forward(self, x, timesteps, context, emb_rows: Optional[dict] = None,
                lora_idx: LoraIdx = None, hint: Optional[torch.Tensor] = None,
                kv_rows: Optional[dict] = None,
                y: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """x [B, h, w, 4]: the latent hint ('latent') or the noisy latent
        ('image', with the pixel hint [B, 8h, 8w, c] as `hint`) -> 13 NHWC
        taps (10 at SDXL's three levels) in the compute dtype. kv_rows: as
        the UNet's, for the fused tree (a LoRA site raises on one). y: as
        the UNet's."""
        ucfg = self.cfg.unet
        dt = ucfg.compute_dtype
        emb = _embed(self, ucfg, timesteps, dt, y, lora_idx) if emb_rows is None else None
        row = lambda name: None if emb_rows is None else emb_rows[name]
        kvr = lambda name: None if kv_rows is None else kv_rows.get(name)
        context = context.to(dt)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        h = self.in_conv(_nchw(x, dt))
        if self.cfg.hint_mode == "image":
            if hint is None:
                raise ValueError("hint_mode='image' needs the pixel hint")
            h = h + self.hint_block(hint, dt)
        outs = [nhwc(self.zero_0(h, lora_idx))]
        for i, step in enumerate(encoder_plan(ucfg)[0][1:], start=1):
            if step.kind == "res":
                h = _block(ucfg, getattr(self, f"in_{i}_res"), h, emb, row(f"in_{i}_res"),
                           lora_idx)
                if step.attn:
                    h = _block(ucfg, getattr(self, f"in_{i}_attn"), h, context, lora_idx,
                               kvr(f"in_{i}_attn"))
            else:
                h = getattr(self, f"in_{i}_down")(h)
            outs.append(nhwc(getattr(self, f"zero_{i}")(h, lora_idx)))
        h = _block(ucfg, self.mid_res0, h, emb, row("mid_res0"), lora_idx)
        h = _block(ucfg, self.mid_attn, h, context, lora_idx, kvr("mid_attn"))
        h = _block(ucfg, self.mid_res1, h, emb, row("mid_res1"), lora_idx)
        outs.append(nhwc(self.zero_mid(h, lora_idx)))
        return tuple(outs)
