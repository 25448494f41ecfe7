"""ControlNet-Lite (counterpart of ``ctrlora_tpu/models/lite.py``;
reference cldm/cldm_lite.py): an attention-free control branch whose taps
add onto the UNet's encoder side (``UNet(control_mode='encoder')``).

Each res step of the UNet's encoder plan is GroupNorm + SiLU + 3x3 conv; the
pixel hint enters through the same ``HintBlock`` as the vanilla ControlNet,
added after ``in_conv``; a zero conv taps every block and the middle.
``time_embed`` exists, because the checkpoint has its keys, but no block
reads it (the reference's Lite blocks ignore the embedding).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ctrlora_tpu_torch.configs import UNetConfig
from ctrlora_tpu_torch.models.layers import (
    Conv, Downsample, GroupNorm32, TimestepEmbed, ZeroConv,
)
from ctrlora_tpu_torch.models.unet import HintBlock, _nchw, encoder_plan


class ControlNetLite(nn.Module):
    def __init__(self, cfg: UNetConfig, hint_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        self.time_embed = TimestepEmbed(mc)  # unused, as in the reference
        self.hint_block = HintBlock(mc, hint_channels)
        ch = mc
        for i, step in enumerate(encoder_plan(cfg)[0]):
            if step.kind == "conv":
                self.in_conv = Conv(cfg.in_channels, step.out_ch)
            elif step.kind == "res":
                self.add_module(f"in_{i}_norm", GroupNorm32(ch, silu=True))
                self.add_module(f"in_{i}_conv", Conv(ch, step.out_ch))
            else:
                self.add_module(f"in_{i}_down", Downsample(ch, step.out_ch))
            ch = step.out_ch
            self.add_module(f"zero_{i}", ZeroConv(ch))
        self.mid_norm = GroupNorm32(ch, silu=True)
        self.mid_conv = Conv(ch, ch)
        self.zero_mid = ZeroConv(ch)

    def forward(self, x, timesteps, context, hint: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, h, w, 4] noisy latent, pixel hint [B, 8h, 8w, c] -> 13 NHWC
        taps in the compute dtype. `timesteps` and `context` are not read
        (no embedding, no attention); they keep the control call's
        signature."""
        dt = self.cfg.compute_dtype
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        outs = []
        h = self.in_conv(_nchw(x, dt)) + self.hint_block(hint, dt)
        for i, step in enumerate(encoder_plan(self.cfg)[0]):
            if step.kind == "res":
                h = getattr(self, f"in_{i}_conv")(getattr(self, f"in_{i}_norm")(h))
            elif step.kind == "down":
                h = getattr(self, f"in_{i}_down")(h)
            outs.append(nhwc(getattr(self, f"zero_{i}")(h)))
        h = self.mid_conv(self.mid_norm(h))
        outs.append(nhwc(self.zero_mid(h)))
        return tuple(outs)
