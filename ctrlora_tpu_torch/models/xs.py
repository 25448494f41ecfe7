"""ControlNet-XS (counterpart of ``ctrlora_tpu/models/xs.py``; reference
cldm/cldm_xs.py, TwoStreamControlNet with ControlledUNetModelFixed): the
base UNet and a slim control stream in one module, run in lockstep.

The control stream is the UNet's encoder and middle at
``control_model_ratio`` of the base width (64 channels at SD1.5: 64/128/256
with 8 heads of 8/16/32), fed the noisy latent and, after its first conv,
the pixel hint through ``HintBlock``. After every encoder block the base
stream is corrected by a zero conv of the control stream (guiding
'encoder_double' or 'full'), and the control stream sees the base stream
through a zero conv, concatenated ('cat') or added ('add') or not at all
(None). The base decoder takes corrections from the control encoder's
outputs in reverse ('encoder', 'encoder_double'), or, with 'full', from the
control stream's own decoder, with mutual infusion at every decoder layer
but the last. ``learn_embedding`` blends a control time embedding into the
base's. ``no_control`` (or no hint) is the plain SD forward.

The base stream's modules carry the UNet's names, so the SD key table
fills them; the control stream's are ``ctrl_*``, the zero convs
``{enc,dec}_zero_{in,out}_{i}`` and ``mid_zero_{in,out}``, and the hint
encoder ``hint_block``, as the JAX names. Public tensors are NHWC, as the
UNet's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ctrlora_tpu_torch.configs import UNetConfig
from ctrlora_tpu_torch.models.layers import (
    Conv, Downsample, ResBlock, TimestepEmbed, Upsample, ZeroConv,
)
from ctrlora_tpu_torch.models.unet import (
    HintBlock, _attn, _block, _build_decoder, _build_encoder, _nchw, decoder_plan, encoder_plan,
)

XS_TRAINABLE_PREFIXES = ("ctrl_", "enc_zero_", "dec_zero_", "mid_zero_", "hint_block")


def control_config(cfg: UNetConfig, ratio: float) -> UNetConfig:
    """The control stream's UNetConfig: the base's at `ratio` of its width."""
    return dataclasses.replace(cfg, model_channels=max(1, int(cfg.model_channels * ratio)))


class XSUNet(nn.Module):
    """Base UNet + slim control stream, fused in one module (JAX ``XSUNet``)."""

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3,
                 control_model_ratio: float = 0.2, infusion2control: Optional[str] = "cat",
                 guiding: str = "encoder_double", learn_embedding: bool = False):
        super().__init__()
        if infusion2control not in ("cat", "add", None):
            raise ValueError(f"unknown infusion2control {infusion2control!r}")
        if guiding not in ("encoder", "encoder_double", "full"):
            raise ValueError(f"unknown guiding {guiding!r}")
        self.cfg = cfg
        self.ctr_cfg = ctr = control_config(cfg, control_model_ratio)
        self.infusion2control, self.guiding = infusion2control, guiding
        self.learn_embedding = learn_embedding
        cat, add = infusion2control == "cat", infusion2control == "add"
        emb_dim = 4 * cfg.model_channels  # both streams read the base's embedding

        # the base stream: the UNet's modules under the UNet's names
        self.time_embed = TimestepEmbed(cfg.model_channels)
        if learn_embedding:
            self.ctrl_time_embed = TimestepEmbed(cfg.model_channels)
        _build_decoder(self, cfg, _build_encoder(self, cfg, cfg.in_channels))

        # the control encoder, its zero convs both ways, and the hint encoder
        base_steps, base_chans, bch = encoder_plan(cfg)
        ctr_steps, ctr_chans, cch = encoder_plan(ctr)
        self.hint_block = HintBlock(ctr.model_channels, hint_channels)
        ch = cfg.in_channels
        for i, (bstep, cstep) in enumerate(zip(base_steps, ctr_steps)):
            if cstep.kind == "conv":
                self.ctrl_in_conv = Conv(ch, cstep.out_ch)
            elif cstep.kind == "res":
                self.add_module(f"ctrl_in_{i}_res", ResBlock(ch, cstep.out_ch, emb_dim))
                if cstep.attn:
                    self.add_module(f"ctrl_in_{i}_attn", _attn(ctr, cstep.out_ch))
            else:
                self.add_module(f"ctrl_in_{i}_down", Downsample(ch, cstep.out_ch))
            ch = cstep.out_ch
            if guiding in ("encoder_double", "full"):
                self.add_module(f"enc_zero_out_{i}", ZeroConv(ch, out_channels=bstep.out_ch))
            if cat:
                self.add_module(f"enc_zero_in_{i}", ZeroConv(bstep.out_ch))
                ch += bstep.out_ch
            elif add:
                self.add_module(f"enc_zero_in_{i}", ZeroConv(bstep.out_ch, out_channels=ch))
        self.ctrl_mid_res0 = ResBlock(ch, cch, emb_dim)
        self.ctrl_mid_attn = _attn(ctr, cch)
        self.ctrl_mid_res1 = ResBlock(cch, cch, emb_dim)
        self.mid_zero_out = ZeroConv(cch, out_channels=bch)

        dec_steps = decoder_plan(cfg)
        if guiding != "full":
            # corrections from the control encoder's outputs, in reverse
            hb = bch
            for i, step in enumerate(dec_steps):
                self.add_module(f"dec_zero_out_{i}",
                                ZeroConv(ctr_chans[len(ctr_chans) - 1 - i], out_channels=hb))
                hb = step.out_ch
            return
        # 'full': the control stream sees the base at the bottleneck, and its
        # own decoder runs beside the base's with mutual infusion
        ch = cch
        if cat:
            self.mid_zero_in = ZeroConv(bch)
            ch += bch
        elif add:
            self.mid_zero_in = ZeroConv(bch, out_channels=cch)
        for i, (step, cstep) in enumerate(zip(dec_steps, decoder_plan(ctr))):
            self.add_module(f"ctrl_out_{i}_res", ResBlock(ch + cstep.skip_ch, cstep.out_ch,
                                                          emb_dim))
            ch = cstep.out_ch
            if cstep.attn:
                self.add_module(f"ctrl_out_{i}_attn", _attn(ctr, ch))
            if cstep.upsample:
                self.add_module(f"ctrl_out_{i}_up", Upsample(ch, ch))
            if i == len(dec_steps) - 1:
                continue
            self.add_module(f"dec_zero_out_{i}", ZeroConv(ch, out_channels=step.out_ch))
            if cat:
                self.add_module(f"dec_zero_in_{i}", ZeroConv(step.out_ch))
                ch += step.out_ch
            elif add:
                self.add_module(f"dec_zero_in_{i}", ZeroConv(step.out_ch, out_channels=ch))

    def _enc_step(self, prefix: str, cfg: UNetConfig, i: int, step, h, emb, context):
        """Encoder step i of one stream (`prefix` '' for the base, 'ctrl_')."""
        if step.kind == "conv":
            return getattr(self, f"{prefix}in_conv")(h)
        if step.kind == "down":
            return getattr(self, f"{prefix}in_{i}_down")(h)
        h = _block(cfg, getattr(self, f"{prefix}in_{i}_res"), h, emb)
        if step.attn:
            h = _block(cfg, getattr(self, f"{prefix}in_{i}_attn"), h, context)
        return h

    def _dec_step(self, prefix: str, cfg: UNetConfig, i: int, step, h, emb, context):
        """Decoder step i of one stream over its concatenated input."""
        h = _block(cfg, getattr(self, f"{prefix}out_{i}_res"), h, emb)
        if step.attn:
            h = _block(cfg, getattr(self, f"{prefix}out_{i}_attn"), h, context)
        if step.upsample:
            h = getattr(self, f"{prefix}out_{i}_up")(h)
        return h

    def _mid(self, prefix: str, cfg: UNetConfig, h, emb, context):
        h = _block(cfg, getattr(self, f"{prefix}mid_res0"), h, emb)
        h = _block(cfg, getattr(self, f"{prefix}mid_attn"), h, context)
        return _block(cfg, getattr(self, f"{prefix}mid_res1"), h, emb)

    def _infuse(self, name: str, h_ctr, h_base):
        """The control stream after seeing the base through zero conv `name`."""
        if self.infusion2control == "cat":
            return torch.cat([h_ctr, getattr(self, name)(h_base)], dim=1)
        if self.infusion2control == "add":
            return h_ctr + getattr(self, name)(h_base)
        return h_ctr

    def _out(self, h):
        return self.conv_out(self.norm_out(h)).permute(0, 2, 3, 1).float()

    def forward(self, x, timesteps, context, hint: Optional[torch.Tensor] = None,
                no_control: bool = False) -> torch.Tensor:
        """x [B, h, w, C] noisy latent, pixel hint [B, 8h, 8w, c] in [0, 1]
        -> [B, h, w, C] fp32 model output; the plain SD forward where
        `no_control` is set or there is no hint."""
        cfg, ctr = self.cfg, self.ctr_cfg
        dt = cfg.compute_dtype
        # JAX blends ctrl * s + base * (1 - s) with s = control_scale ** 0.3;
        # no caller sets a scale other than 1, where the blend is the control's
        emb = (self.ctrl_time_embed if self.learn_embedding else self.time_embed)(timesteps, dt)
        context = context.to(dt)
        base_steps = encoder_plan(cfg)[0]
        dec_steps = decoder_plan(cfg)

        if no_control or hint is None:
            h, hs = _nchw(x, dt), []
            for i, step in enumerate(base_steps):
                h = self._enc_step("", cfg, i, step, h, emb, context)
                hs.append(h)
            h = self._mid("", cfg, h, emb, context)
            for i, step in enumerate(dec_steps):
                h = self._dec_step("", cfg, i, step, torch.cat([h, hs.pop()], dim=1), emb,
                                   context)
            return self._out(h)

        guided = self.hint_block(hint, dt)
        h_base = h_ctr = _nchw(x, dt)
        hs_base, hs_ctr = [], []
        for i, (bstep, cstep) in enumerate(zip(base_steps, encoder_plan(ctr)[0])):
            h_base = self._enc_step("", cfg, i, bstep, h_base, emb, context)
            h_ctr = self._enc_step("ctrl_", ctr, i, cstep, h_ctr, emb, context)
            if guided is not None:
                h_ctr = h_ctr + guided
                guided = None
            if self.guiding in ("encoder_double", "full"):
                h_base = h_base + getattr(self, f"enc_zero_out_{i}")(h_ctr)
            hs_base.append(h_base)
            hs_ctr.append(h_ctr)
            h_ctr = self._infuse(f"enc_zero_in_{i}", h_ctr, h_base)

        h_base = self._mid("", cfg, h_base, emb, context)
        h_ctr = self._mid("ctrl_", ctr, h_ctr, emb, context)
        h_base = h_base + self.mid_zero_out(h_ctr)
        if self.guiding == "full":
            h_ctr = self._infuse("mid_zero_in", h_ctr, h_base)

        ctr_dec = decoder_plan(ctr)
        for i, step in enumerate(dec_steps):
            if self.guiding != "full":
                h_base = h_base + getattr(self, f"dec_zero_out_{i}")(hs_ctr.pop())
            h_base = self._dec_step("", cfg, i, step, torch.cat([h_base, hs_base.pop()], dim=1),
                                    emb, context)
            if self.guiding == "full":
                h_ctr = self._dec_step("ctrl_", ctr, i, ctr_dec[i],
                                       torch.cat([h_ctr, hs_ctr.pop()], dim=1), emb, context)
                if i != len(dec_steps) - 1:
                    h_base = h_base + getattr(self, f"dec_zero_out_{i}")(h_ctr)
                    h_ctr = self._infuse(f"dec_zero_in_{i}", h_ctr, h_base)
        return self._out(h_base)
