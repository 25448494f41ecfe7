"""NormalBAE surface-normal estimator (counterpart of
``ctrlora_tpu/annotators/normalbae.py``; reference annotator/normalbae:
NNET of "Estimating and Exploiting the Aleatoric Uncertainty in Surface
Normal Estimation", scannet.pt).

* Encoder: geffnet's tf_efficientnet_b5_ap (encoder.py:13-15): TF 'SAME'
  padding (``SameConv2d``: torch's ``padding='same'`` refuses stride 2, so
  the uneven pads are worked out per call by TF's rule), BatchNorm eps 1e-3,
  swish, squeeze-excite reduced from the block's input channels. The
  decoder reads stages 0, 1, 2 and 4 and the conv_head output before its
  BatchNorm (encoder.py:24-32).
* Decoder (decoder.py:104-180, the test branches): conv2 1x1, four
  ``UpSampleBN`` (bilinear with aligned corners to the skip's size, concat,
  two conv + BatchNorm (eps 1e-5) + LeakyReLU), the coarse ``out_conv_res8``
  head, then the res4/2/1 pixel MLPs (1x1 Conv1d stacks over the flattened
  map); each head's output through ``norm_normalize`` (unit xyz, kappa =
  elu + 1.01).
* Detector (annotator/normalbae/__init__.py:36-52): ImageNet-normalised
  input, the normals mapped to uint8 as (n + 1) / 2.

Inference only: the BatchNorms are folded when scannet.pt is loaded
(``mlsd.fold_batchnorms``: eps 1e-3 under ``encoder.``, 1e-5 under
``decoder.``, as JAX's ``convert_nnet``). The module keeps the file's key
names without DataParallel's 'module.'; the file's unused conv_head
BatchNorm (``encoder.original_model.bn2``) is left out before the strict
load. No file: torch's initialisation under ``nets.INIT_SEED``. The 2x
up-samplings are ``F.interpolate(bilinear, align_corners=True)``; JAX builds
their grids in float32 numpy, up to one float32 ulp of (H - 1) apart.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.mlsd import FoldedBN, fold_batchnorms

FILE = "scannet.pt"
ENCODER_EPS = 1e-3
DECODER_EPS = 1e-5

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_ch(ch: int, mult: float = 1.6) -> int:
    return make_divisible(ch * mult)


# (kernel, stride, expand, out, repeats) of B0; B5 scales width x1.6 and
# depth x2.2 (gen_efficientnet.py:525-533)
B0_STAGES = [(3, 1, 1, 16, 1), (3, 2, 6, 24, 2), (5, 2, 6, 40, 2), (3, 2, 6, 80, 3),
             (5, 1, 6, 112, 3), (5, 2, 6, 192, 4), (3, 1, 6, 320, 1)]
SKIP_STAGES = (0, 1, 2, 4)


def b5_stages():
    return [(k, s, e, round_ch(c), int(math.ceil(r * 2.2))) for (k, s, e, c, r) in B0_STAGES]


def same_pads(n: int, k: int, s: int) -> tuple:
    """TF's SAME padding of one axis of size n: (before, after), the odd
    pixel after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A bias-free conv with TF's SAME padding at any stride."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, k, stride, groups=groups, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
        return super().forward(F.pad(x, (l, r, t, b)) if t or b or l or r else x)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, c, 1)

    def forward(self, x):
        s = self.conv_expand(F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """geffnet's DepthwiseSeparableConv (efficientnet_builder.py:144-190)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv_dw = SameConv2d(cin, cin, k, stride, groups=cin)
        self.bn1 = FoldedBN(cin)
        self.se = SqueezeExcite(cin, max(1, int(cin * 0.25)))
        self.conv_pw = SameConv2d(cin, cout)
        self.bn2 = FoldedBN(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.bn2(self.conv_pw(self.se(F.silu(self.bn1(self.conv_dw(x))))))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """geffnet's InvertedResidual (efficientnet_builder.py:193-248)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int):
        super().__init__()
        mid = make_divisible(cin * expand)
        self.conv_pw = SameConv2d(cin, mid)
        self.bn1 = FoldedBN(mid)
        self.conv_dw = SameConv2d(mid, mid, k, stride, groups=mid)
        self.bn2 = FoldedBN(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        self.conv_pwl = SameConv2d(mid, cout)
        self.bn3 = FoldedBN(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class EfficientNetB5(nn.Module):
    def __init__(self):
        super().__init__()
        stem = round_ch(32)
        self.conv_stem = SameConv2d(3, stem, 3, 2)
        self.bn1 = FoldedBN(stem)
        blocks, cin = [], stem
        for k, s, e, c, r in b5_stages():
            stage = []
            for i in range(r):
                stride = s if i == 0 else 1
                stage.append(DepthwiseSeparable(cin, c, k, stride) if e == 1
                             else InvertedResidual(cin, c, k, stride, e))
                cin = c
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*blocks)
        self.conv_head = SameConv2d(cin, round_ch(1280))

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_stem(x)))
        skips = []
        for si, stage in enumerate(self.blocks):
            h = stage(h)
            if si in SKIP_STAGES:
                skips.append(h)
        return skips + [self.conv_head(h)]


def up_ac(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] with aligned corners (the reference's
    ``F.interpolate(..., align_corners=True)``; an identity at the same size)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class UpSampleBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), FoldedBN(cout),
                                  nn.LeakyReLU(), nn.Conv2d(cout, cout, 3, padding=1),
                                  FoldedBN(cout), nn.LeakyReLU())

    def forward(self, x, skip):
        return self._net(torch.cat([up_ac(x, skip.shape[2:]), skip], dim=1))


def pixel_mlp(cin: int) -> nn.Sequential:
    """The reference's 1x1 Conv1d refinement stack (decoder.py:36-57)."""
    return nn.Sequential(nn.Conv1d(cin, 128, 1), nn.ReLU(), nn.Conv1d(128, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 128, 1), nn.ReLU(), nn.Conv1d(128, 4, 1))


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """[B, 4, H, W]: unit xyz and kappa = elu + 1.01 (submodules.py:102-109)."""
    n, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt((n ** 2).sum(dim=1, keepdim=True)) + 1e-10
    return torch.cat([n / norm, F.elu(kappa) + 1.0 + 0.01], dim=1)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        stages = b5_stages()
        skip = [stages[i][3] for i in SKIP_STAGES]  # 24, 40, 64, 176
        head = round_ch(1280)
        self.conv2 = nn.Conv2d(head, 2048, 1)
        self.up1 = UpSampleBN(2048 + skip[3], 1024)
        self.up2 = UpSampleBN(1024 + skip[2], 512)
        self.up3 = UpSampleBN(512 + skip[1], 256)
        self.up4 = UpSampleBN(256 + skip[0], 128)
        self.out_conv_res8 = nn.Conv2d(512, 4, 3, padding=1)
        self.out_conv_res4 = pixel_mlp(512 + 4)
        self.out_conv_res2 = pixel_mlp(256 + 4)
        self.out_conv_res1 = pixel_mlp(128 + 4)

    def forward(self, feats):
        b0, b1, b2, b4, head = feats
        d1 = self.up1(self.conv2(head), b4)
        d2 = self.up2(d1, b2)
        d3 = self.up3(d2, b1)
        d4 = self.up4(d3, b0)
        out = norm_normalize(self.out_conv_res8(d2))
        for feat, mlp in ((d2, self.out_conv_res4), (d3, self.out_conv_res2),
                          (d4, self.out_conv_res1)):
            hw = (feat.shape[2] * 2, feat.shape[3] * 2)
            f = torch.cat([up_ac(feat, hw), up_ac(out, hw)], dim=1)
            out = norm_normalize(mlp(f.flatten(2)).reshape(f.shape[0], 4, *hw))
        return out


class NNET(nn.Module):
    """x [B, 3, H, W] ImageNet-normalised (H, W multiples of 16, as the
    reference's decoder needs to line its maps up) -> [B, 4, H, W]: the unit
    normal and kappa at full resolution (the reference's out[0][-1])."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.original_model = EfficientNetB5()
        self.decoder = Decoder()

    def forward(self, x):
        return self.decoder(self.encoder.original_model(x))


def fold_nnet(sd: nets.StateDict) -> nets.StateDict:
    """scannet.pt's tensors ('module.' gone) with the encoder's BatchNorms
    folded at eps 1e-3 and the decoder's at 1e-5, the unused ones left out."""
    enc = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k: v for k, v in sd.items() if not k.startswith("encoder.")}
    folded = {**fold_batchnorms(enc, ENCODER_EPS), **fold_batchnorms(dec, DECODER_EPS)}
    return nets.keep_keys(folded, nets.module_keys(NNET))


class NormalBaeDetector:
    """`state_dict`: scannet.pt's tensors (BatchNorms unfolded, as
    published); default the file in `ckpt_dir`, else torch's seeded init."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights(FILE, ckpt_dir, strip_module=True)
        self.model = nets.build(NNET, None if state_dict is None else fold_nnet(state_dict),
                                "normalbae", device)

    def normals(self, input_image: np.ndarray) -> torch.Tensor:
        """The [1, 4, H', W'] network output of a uint8 RGB image."""
        x = (input_image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return nets.forward(self.model, x[None])

    def __call__(self, input_image: np.ndarray) -> np.ndarray:
        assert input_image.ndim == 3
        normal = self.normals(input_image)[0, :3].permute(1, 2, 0).numpy()
        return (((normal + 1.0) * 0.5).clip(0, 1) * 255.0).astype(np.uint8)
