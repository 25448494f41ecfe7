"""Annotator registry: name -> lazily constructed detector (counterpart of
``ctrlora_tpu/annotators/registry.py``).

The names are the JAX registry's, the preprocessor set of the reference
apps (app/gradio_ctrlora.py:36-40). The numpy/cv2 detectors of
``simple.py`` are here under JAX's names, and so are the CNN detectors the
port has (``CNN``: HED and its sketch, the three lineart detectors, MLSD,
MiDaS with its depth and normal channels, UniFormer's segmentation,
OpenPose, PiDiNet, the darknet YOLO bbox detector and DensePose), which run
on ``device`` (the card unless the caller asks for the CPU). The other CNN
detectors (``NOT_PORTED``: the OneFormer segmenters, normalbae, zoe) are
registered too, and asking for one raises NotImplementedError: they are
ROADMAP queue 1 item 14 f, g and i, not ported yet.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

import torch

_FACTORIES: Dict[str, Callable] = {}
_CACHE: Dict[Tuple[str, str], object] = {}


def register(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn

    return deco


def available() -> list:
    return sorted(_FACTORIES)


def get(name: str, device="cuda"):
    """The detector `name`, built once for each device it is asked for (the
    numpy/cv2 detectors ignore the device)."""
    key = (name, str(torch.device(device)))
    if key not in _CACHE:
        if name not in _FACTORIES:
            raise KeyError(f"unknown annotator {name!r}; available: {available()}")
        _CACHE[key] = _FACTORIES[name](device)
    return _CACHE[key]


def _simple(cls_name: str):
    def factory(device):
        from ctrlora_tpu_torch.annotators import simple

        return getattr(simple, cls_name)()

    return factory


SIMPLE = {
    "none": "GrayscaleConverter",  # placeholder; 'none' handled by apps
    "canny": "CannyDetector",
    "blur": "Blurrer",
    "grayscale": "GrayscaleConverter",
    "jpeg": "JpegCompressor",
    "pad": "Padder",
    "palette": "PaletteDetector",
    "pixel": "Pixelater",
    "illusion": "IllusionConverter",
    "inpainting": "Inpainter",
    "inpainting_brush": "BrushInpainter",
    "outpainting": "Outpainter",
    "shuffle": "ContentShuffleDetector",
    "color_shuffle": "ColorShuffleDetector",
    "gray_random": "GrayDetector",
    "downsample": "DownSampleDetector",
}
for _name, _cls in SIMPLE.items():
    _FACTORIES[_name] = _simple(_cls)


def _cnn(module: str, cls_name: str):
    def factory(device):
        mod = importlib.import_module(f"ctrlora_tpu_torch.annotators.{module}")
        return getattr(mod, cls_name)(device=device)

    return factory


class _MidasChannel:
    """One of MidasDetector's (depth, normal) maps as a detector, on the
    'midas' net the registry keeps for the same device (JAX's
    ``_MidasChannel``: the two names share one net)."""

    def __init__(self, index: int, device):
        self.det = get("midas", device)
        self.index = index

    def __call__(self, img, **kw):
        return self.det(img, **kw)[self.index]


def _midas_channel(index: int):
    return lambda device: _MidasChannel(index, device)


# the CNN detectors of the port: name -> factory
CNN = {
    "hed": _cnn("hed", "HEDdetector"),
    "hedsketch": _cnn("hed", "HEDSketchDetector"),
    "lineart": _cnn("lineart", "LineartDetector"),
    "lineart_anime": _cnn("lineart", "LineartAnimeDetector"),
    "lineart_anime_with_color_prompt": _cnn("lineart", "LineartAnimeWithColorPromptDetector"),
    "mlsd": _cnn("mlsd", "MLSDdetector"),
    "midas": _cnn("midas", "MidasDetector"),
    "depth": _midas_channel(0),
    "normal": _midas_channel(1),
    "seg": _cnn("uniformer", "UniformerDetector"),
    "openpose": _cnn("openpose", "OpenposeDetector"),
    "pidinet": _cnn("pidinet", "PidiNetDetector"),
    "bbox": _cnn("bbox", "BBoxDetector"),
    "densepose": _cnn("densepose", "DenseposeDetector"),
}
_FACTORIES.update(CNN)

# the JAX registry's Flax CNN detectors, not ported yet
NOT_PORTED = ("seg_ofcoco", "seg_ofade20k", "normalbae", "zoe")


def _not_ported(name: str):
    def factory(device):
        raise NotImplementedError(
            f"annotator {name!r} is a CNN detector the PyTorch port does not have yet "
            f"(ROADMAP queue 1 item 14 f, g and i: {', '.join(NOT_PORTED)}); the port has: "
            f"{sorted(SIMPLE) + sorted(CNN)}")

    return factory


for _name in NOT_PORTED:
    _FACTORIES[_name] = _not_ported(_name)
