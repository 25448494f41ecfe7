"""Weights for the layers a fresh port model zero-initialises, as the JAX
package's do: the UNet's conv_out, every ResBlock's out_conv and every
SpatialTransformer's proj_out. A fresh UNet outputs exactly 0, so no
gradient reaches a trainable weight; tests that train from a seeded init
put N(0, std) weights into those layers first (``seed_zeroed_layers_``),
and the CLI tests do it through ``seeded_training_pipelines``."""

import contextlib

import pytest
import torch
from torch import nn

from ctrlora_tpu_torch.models.attention import SpatialTransformer
from ctrlora_tpu_torch.models.layers import ResBlock
from ctrlora_tpu_torch.scripts import train_common


def zeroed_layers(module: nn.Module) -> list:
    """The convs of `module` that start at zero besides the control taps:
    its own conv_out where it is a UNet (it has norm_out), every ResBlock's
    out_conv and every SpatialTransformer's proj_out."""
    layers = [module.conv_out] if hasattr(module, "norm_out") else []
    for m in module.modules():
        if isinstance(m, ResBlock):
            layers.append(m.out_conv)
        elif isinstance(m, SpatialTransformer):
            layers.append(m.proj_out)
    return layers


@torch.no_grad()
def seed_zeroed_layers_(module: nn.Module, seed: int = 0, std: float = 0.05) -> None:
    """N(0, std) weights and biases in `module`'s zeroed layers, from a CPU
    generator seeded with `seed` (the same numbers on any device)."""
    gen = torch.Generator().manual_seed(seed)
    for conv in zeroed_layers(module):
        for p in (conv.weight, conv.bias):
            p.copy_(torch.randn(p.shape, generator=gen).to(p.device) * std)


@contextlib.contextmanager
def seeded_training_pipelines(seed: int = 0):
    """The training CLIs' pipelines with their UNet's and control module's
    zeroed layers seeded (``train_common.load_training_pipeline`` patched)."""
    real = train_common.load_training_pipeline

    def load(cfg, device, sd_ckpt, cn_ckpt, init_seed):
        pipe = real(cfg, device, sd_ckpt, cn_ckpt, init_seed)
        for module in (pipe.unet, pipe.control):
            if module is not None:
                seed_zeroed_layers_(module, seed)
        return pipe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_common, "load_training_pipeline", load)
        yield
