"""Lineart detectors (counterpart of ``ctrlora_tpu/annotators/lineart.py``).

* ``LineartDetector``: the informative-drawings ResNet generator
  (reference annotator/lineart/__init__.py:17-92: 3 residual blocks,
  reflection padding, InstanceNorm2d without affine, two
  ConvTranspose2d(3, stride 2, padding 1, output_padding 1) up-samplers);
  ``coarse`` selects the sk_model2.pth weights, else sk_model.pth.
* ``LineartAnimeDetector``: the Anime2Sketch 8-down UNet generator
  (reference annotator/lineart_anime/__init__.py:15-149), on the image
  resized (bicubic) to multiples of 256.
* ``LineartAnimeWithColorPromptDetector``: anime lineart over the image's
  down-sampled colour blocks.

The modules' parameter names are the published files' (sk_model*.pth,
netG.pth with 'module.' stripped), so the files load with
``load_state_dict``. The UNet's skip connections carry the features before
the next level's LeakyReLU, as the JAX package's ``AnimeUNet`` does. The
reference's LeakyReLU is in place, so its skips carry the features after
it; each skip goes straight into the parent level's ReLU, which gives the
same output for both, so the skips match the reference's output (bit for
bit with every LeakyReLU switched to in place, on one thread).
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np
import torch
from torch import nn

from ctrlora_tpu_torch.annotators import nets


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), nn.InstanceNorm2d(c), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), nn.InstanceNorm2d(c))

    def forward(self, x):
        return x + self.conv_block(x)


class LineartGenerator(nn.Module):
    """informative-drawings Generator(3, 1, n_blocks): x [B, 3, H, W] in
    [0, 1] -> the line map [B, 1, H, W] in [0, 1]."""

    def __init__(self, n_blocks: int = 3):
        super().__init__()
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, 64, 7),
                                    nn.InstanceNorm2d(64), nn.ReLU())
        self.model1 = nn.Sequential(
            nn.Conv2d(64, 128, 3, stride=2, padding=1), nn.InstanceNorm2d(128), nn.ReLU(),
            nn.Conv2d(128, 256, 3, stride=2, padding=1), nn.InstanceNorm2d(256), nn.ReLU())
        self.model2 = nn.Sequential(*(ResidualBlock(256) for _ in range(n_blocks)))
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 3, stride=2, padding=1, output_padding=1),
            nn.InstanceNorm2d(128), nn.ReLU(),
            nn.ConvTranspose2d(128, 64, 3, stride=2, padding=1, output_padding=1),
            nn.InstanceNorm2d(64), nn.ReLU())
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(64, 1, 7), nn.Sigmoid())

    def forward(self, x):
        for stage in (self.model0, self.model1, self.model2, self.model3, self.model4):
            x = stage(x)
        return x


class UnetSkipBlock(nn.Module):
    """One level of UnetGenerator(3, 1, 8, 64, InstanceNorm2d): its
    ``model`` Sequential holds the reference's layers at the reference's
    indices (the inner level at index 1 or 3), so the keys are netG.pth's.
    An inner level returns [its input, its up path] on the channels."""

    def __init__(self, outer: int, inner: int, input_nc: Optional[int] = None,
                 sub: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        down = nn.Conv2d(input_nc or outer, inner, 4, stride=2, padding=1)
        if outermost:
            layers = [down, sub, nn.ReLU(), nn.ConvTranspose2d(inner * 2, outer, 4, 2, 1),
                      nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                      nn.ConvTranspose2d(inner, outer, 4, 2, 1), nn.InstanceNorm2d(outer)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nn.InstanceNorm2d(inner), sub, nn.ReLU(),
                      nn.ConvTranspose2d(inner * 2, outer, 4, 2, 1), nn.InstanceNorm2d(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


# per-level (outer, inner) channels; level 0 is outermost, 7 innermost
ANIME_LEVELS = [(1, 64), (64, 128), (128, 256), (256, 512),
                (512, 512), (512, 512), (512, 512), (512, 512)]


class AnimeUNet(nn.Module):
    """x [B, 3, H, W] in [-1, 1] (H, W multiples of 256) -> [B, 1, H, W]
    in [-1, 1]."""

    def __init__(self):
        super().__init__()
        n = len(ANIME_LEVELS)
        block = UnetSkipBlock(*ANIME_LEVELS[n - 1], innermost=True)
        for lvl in range(n - 2, 0, -1):
            block = UnetSkipBlock(*ANIME_LEVELS[lvl], sub=block)
        self.model = UnetSkipBlock(*ANIME_LEVELS[0], input_nc=3, sub=block, outermost=True)

    def forward(self, x):
        return self.model(x)


class LineartDetector:
    """`state_dicts`: {'fine': sk_model.pth's tensors, 'coarse':
    sk_model2.pth's}; default the files in `ckpt_dir`. Where neither file
    is present both take torch's seeded init (one net), as JAX's take one
    Flax init."""

    FILES = (("fine", "sk_model.pth"), ("coarse", "sk_model2.pth"))

    def __init__(self, state_dicts: Optional[dict] = None, device="cuda",
                 ckpt_dir: Optional[str] = None):
        if state_dicts is None:
            state_dicts = {kind: sd for kind, f in self.FILES
                           if (sd := nets.read_weights(f, ckpt_dir, strip_module=True))
                           is not None}
        if state_dicts:
            self.models = {kind: nets.build(LineartGenerator, sd, f"lineart {kind}", device)
                           for kind, sd in state_dicts.items()}
        else:
            model = nets.build(LineartGenerator, None, "lineart", device)
            self.models = {"fine": model, "coarse": model}

    def __call__(self, input_image: np.ndarray, coarse: bool = False) -> np.ndarray:
        model = self.models["coarse" if coarse else "fine"]
        line = nets.forward(model, input_image[None].astype(np.float32) / 255.0)[0, 0].numpy()
        return (line * 255.0).clip(0, 255).astype(np.uint8)


class LineartAnimeDetector:
    """`state_dict`: netG.pth's tensors ('module.' stripped); default the
    file in `ckpt_dir`, else torch's seeded init."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights("netG.pth", ckpt_dir, strip_module=True)
        self.model = nets.build(AnimeUNet, state_dict, "lineart_anime", device)

    def __call__(self, input_image: np.ndarray) -> np.ndarray:
        H, W = input_image.shape[:2]
        Hn = 256 * int(np.ceil(H / 256.0))
        Wn = 256 * int(np.ceil(W / 256.0))
        img = cv2.resize(input_image, (Wn, Hn), interpolation=cv2.INTER_CUBIC)
        x = img[None].astype(np.float32) / 127.5 - 1.0
        line = nets.forward(self.model, x)[0, 0].numpy() * 127.5 + 127.5
        line = cv2.resize(line, (W, H), interpolation=cv2.INTER_CUBIC)
        return line.clip(0, 255).astype(np.uint8)


class LineartAnimeWithColorPromptDetector:
    """Anime lineart blended with the image's colour blocks (reference
    annotator/lineart_anime_with_color_prompt): where the lineart is dark
    the line, elsewhere the colour of the image down-sampled `block`
    times. `rng` is taken, as JAX's detector takes it, and not used."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        self.anime = LineartAnimeDetector(state_dict, device, ckpt_dir)

    def __call__(self, input_image: np.ndarray, rng: Optional[np.random.Generator] = None,
                 block: int = 64, threshold: int = 200) -> np.ndarray:
        line = self.anime(input_image)
        h, w = input_image.shape[:2]
        small = cv2.resize(input_image, (max(w // block, 1), max(h // block, 1)),
                           interpolation=cv2.INTER_CUBIC)
        color = cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)
        out = color.copy()
        dark = line < threshold
        out[dark] = np.stack([line] * 3, axis=-1)[dark]
        return out.astype(np.uint8)
