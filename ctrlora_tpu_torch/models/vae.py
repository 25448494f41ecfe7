"""AutoencoderKL, the SD1.5 first stage (counterpart of
``ctrlora_tpu/models/vae.py``): GroupNorm eps 1e-6 throughout, single-head
full-channel attention at the bottleneck through the flash kernel's BHSD
view. Images and latents are NHWC at the public methods.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import VAEConfig
from ctrlora_tpu_torch.models.layers import CL, Conv, GroupNorm32
from ctrlora_tpu_torch.ops import flash_attention as fa_ops


class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm32(cin, eps=1e-6, silu=True)
        self.conv1 = Conv(cin, cout)
        self.norm2 = GroupNorm32(cout, eps=1e-6, silu=True)
        self.conv2 = Conv(cout, cout)
        self.nin_shortcut = Conv(cin, cout, kernel_size=1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head attention over all positions, head dim = channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Conv(channels, channels, kernel_size=1)
        self.k = Conv(channels, channels, kernel_size=1)
        self.v = Conv(channels, channels, kernel_size=1)
        self.proj_out = Conv(channels, channels, kernel_size=1)

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.norm(x)
        # [B, 1, S, C] views of the channels-last projections
        to_seq = lambda t: t.contiguous(memory_format=CL).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        out = fa_ops.dot_product_attention(to_seq(self.q(hid)), to_seq(self.k(hid)),
                                           to_seq(self.v(hid)))
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv(cfg.in_channels, cfg.ch)
        ch = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            if level != len(cfg.ch_mult) - 1:
                # asymmetric (0, 1) pad, then a VALID stride-2 conv
                self.add_module(f"down_{level}_downsample",
                                Conv(ch, ch, stride=2, padding=0))
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn_1 = VAEAttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        self.norm_out = GroupNorm32(ch, eps=1e-6, silu=True)
        self.conv_out = Conv(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for level in range(len(cfg.ch_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(cfg.ch_mult) - 1:
                h = F.pad(h, (0, 1, 0, 1)).contiguous(memory_format=CL)
                h = getattr(self, f"down_{level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, ch)
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn_1 = VAEAttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        for level in reversed(range(len(cfg.ch_mult))):
            cout = cfg.ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResBlock(ch, cout))
                ch = cout
            if level != 0:
                self.add_module(f"up_{level}_upsample", Conv(ch, ch))
        self.norm_out = GroupNorm32(ch, eps=1e-6, silu=True)
        self.conv_out = Conv(ch, cfg.out_channels)

    def forward(self, z):
        cfg = self.cfg
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        for level in reversed(range(len(cfg.ch_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """KL autoencoder; ``encode`` returns the posterior (mean, logvar)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
                               2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim,
                               kernel_size=1)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, kernel_size=1)

    def _in(self, x):
        return x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2).contiguous(memory_format=CL)

    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, 3] in [-1, 1] -> (mean, logvar) [B, h, w, embed] fp32."""
        moments = self.quant_conv(self.encoder(self._in(x))).permute(0, 2, 3, 1).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z) -> torch.Tensor:
        """z [B, h, w, embed] -> image [B, H, W, 3] fp32."""
        return self.decoder(self.post_quant_conv(self._in(z))).permute(0, 2, 3, 1).float()


def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """A draw of the diagonal Gaussian posterior: mean + exp(logvar / 2) eps
    (logvar already clipped to [-30, 20] by ``encode``)."""
    return mean + torch.exp(0.5 * logvar) * eps
