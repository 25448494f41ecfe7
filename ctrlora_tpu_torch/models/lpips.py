"""LPIPS perceptual metric, VGG16 variant (counterpart of
``ctrlora_tpu/models/lpips.py``): the ``lpips`` package's LPIPS(net='vgg'),
which torchmetrics' LearnedPerceptualImagePatchSimilarity wraps and the
reference evaluation uses (scripts/evaluate_control.py:65,128):

  x in [0,1] --(normalize)--> 2x-1 --ScalingLayer--> VGG16 features at
  relu1_2/relu2_2/relu3_3/relu4_3/relu5_3 --channel-unit-normalize-->
  squared diff --1x1 learned lin head--> spatial mean --sum over taps.

Plain cuDNN convolutions in fp32 (JAX's is ``lax.conv``, no Pallas kernel);
``lpips`` computes with TF32 off. Images are NHWC at the API and permuted
once inside. The widths come from the weights, so a narrow file with
VGG16's layer structure loads as well.

Weights load from a torchvision VGG16 state dict (``features.{i}.*``)
merged with the lpips lin heads (``lin{k}.model.1.weight`` or
``lins.{k}.model.1.weight``, [1, C, 1, 1]), or from the lpips package's own
naming (``net.slice{k}.{i}.*`` / ``net.net.slice{k}.{i}.*``); all use the
same conv layer indices.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.utils.precision import fp32_exact

# (out_channels, n_convs) per VGG16 block; a 2x2 maxpool sits between blocks
VGG16_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# torchvision vgg16.features conv-layer indices, block by block
CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LinHead(nn.Module):
    """The lpips 1x1 lin head as a per-channel weight [C] (JAX's
    ``lin{k}.kernel``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))


class LPIPS(nn.Module):
    """Per-image LPIPS distance between two NHWC RGB batches. ``widths``:
    the output channels of VGG16's five blocks."""

    def __init__(self, widths: Sequence[int] = tuple(c for c, _ in VGG16_PLAN)):
        super().__init__()
        cin, n = 3, 0
        for cout, (_, convs) in zip(widths, VGG16_PLAN):
            for _ in range(convs):
                self.add_module(f"conv{n}", nn.Conv2d(cin, cout, 3, padding=1))
                cin, n = cout, n + 1
        for k, c in enumerate(widths):
            self.add_module(f"lin{k}", LinHead(c))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor], device="cuda") -> "LPIPS":
        """A model sized from and loaded with a port state dict
        (``convert_lpips`` / ``init_lpips_params``), in eval mode."""
        widths = [state[f"lin{k}.weight"].shape[0] for k in range(len(VGG16_PLAN))]
        model = cls(widths)
        model.load_state_dict(state, strict=True)
        return model.to(device).eval().requires_grad_(False)

    def taps(self, x: torch.Tensor):
        """x NCHW (scaled) -> the five relu feature maps, yielded one at a
        time so that each is scored and dropped before the next."""
        n = 0
        for b, (_, convs) in enumerate(VGG16_PLAN):
            for _ in range(convs):
                x = F.relu(getattr(self, f"conv{n}")(x))
                n += 1
            yield x
            if b < len(VGG16_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)

    def forward(self, a: torch.Tensor, b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """a, b NHWC RGB, [0,1] when normalize=True (torchmetrics'
        normalize=True), else already [-1,1] -> LPIPS [B]."""
        x = torch.cat([a, b]).float().permute(0, 3, 1, 2)
        if normalize:
            x = 2.0 * x - 1.0
        n = a.shape[0]
        total = 0.0
        for k, f in enumerate(self.taps((x - self.shift) / self.scale)):
            f = f / (f.square().sum(1, keepdim=True).sqrt() + 1e-10)
            diff = (f[:n] - f[n:]).square()
            w = getattr(self, f"lin{k}").weight.view(1, -1, 1, 1)
            total = total + (diff * w).sum(1).mean((1, 2))
        return total


def lpips(model: LPIPS, a: torch.Tensor, b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Per-image LPIPS distance [B] in full fp32 (TF32 off for the call)."""
    with fp32_exact(), torch.no_grad():
        return model(a, b, normalize)


def init_lpips_params(generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Random-weight LPIPS state dict at VGG16's widths (tests / structure
    reference): He-normal convs, zero biases, lin heads uniform in [0, 0.1)."""
    state: Dict[str, torch.Tensor] = {}
    cin, n = 3, 0
    for cout, convs in VGG16_PLAN:
        for _ in range(convs):
            std = (2.0 / (9 * cin)) ** 0.5
            state[f"conv{n}.weight"] = torch.randn(cout, cin, 3, 3, generator=generator) * std
            state[f"conv{n}.bias"] = torch.zeros(cout)
            cin, n = cout, n + 1
    for k, (cout, _) in enumerate(VGG16_PLAN):
        state[f"lin{k}.weight"] = torch.rand(cout, generator=generator) * 0.1
    return state


def _f32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, np.float32))


def convert_lpips(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Torch state dict (torchvision ``features.{i}``, lpips
    ``net.slice{k}.{i}`` or ``net.net.slice{k}.{i}`` conv keys; lin heads
    ``lin{k}.model.1.weight`` or ``lins.{k}.model.1.weight``) -> the port's
    LPIPS state dict, fp32."""

    def conv_key(slice_idx: int, layer_idx: int) -> str:
        for key in (f"features.{layer_idx}", f"net.slice{slice_idx + 1}.{layer_idx}",
                    f"net.net.slice{slice_idx + 1}.{layer_idx}"):
            if key + ".weight" in sd:
                return key
        raise KeyError(f"no VGG conv weight for features.{layer_idx}")

    state: Dict[str, torch.Tensor] = {}
    n = 0
    for b, idxs in enumerate(CONV_IDX):
        for i in idxs:
            key = conv_key(b, i)
            state[f"conv{n}.weight"] = _f32(sd[key + ".weight"])
            state[f"conv{n}.bias"] = _f32(sd[key + ".bias"])
            n += 1
    for k in range(len(VGG16_PLAN)):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in sd:
                state[f"lin{k}.weight"] = _f32(sd[key]).reshape(-1)
                break
        else:
            raise KeyError(f"no lin head weight lin{k}")
    return state
