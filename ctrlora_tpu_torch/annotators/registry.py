"""Annotator registry: name -> lazily constructed detector (counterpart of
``ctrlora_tpu/annotators/registry.py``).

The names are the JAX registry's, the preprocessor set of the reference
apps (app/gradio_ctrlora.py:36-40). The numpy/cv2 detectors of
``simple.py`` are here under JAX's names. The CNN detectors (hed, lineart,
mlsd, openpose, pidinet, midas, depth/normal, the segmenters, densepose,
normalbae, zoe, bbox) are registered too, and asking for one raises
NotImplementedError: they are ROADMAP queue 1 item 14, not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

_FACTORIES: Dict[str, Callable] = {}
_CACHE: Dict[str, object] = {}


def register(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn

    return deco


def available() -> list:
    return sorted(_FACTORIES)


def get(name: str):
    if name not in _CACHE:
        if name not in _FACTORIES:
            raise KeyError(f"unknown annotator {name!r}; available: {available()}")
        _CACHE[name] = _FACTORIES[name]()
    return _CACHE[name]


def _simple(cls_name: str):
    def factory():
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

# the JAX registry's Flax CNN detectors, not ported yet
CNN = ("hed", "hedsketch", "lineart", "lineart_anime", "lineart_anime_with_color_prompt",
       "mlsd", "openpose", "pidinet", "midas", "depth", "normal", "seg", "seg_ofcoco",
       "seg_ofade20k", "densepose", "normalbae", "zoe", "bbox")


def _not_ported(name: str):
    def factory():
        raise NotImplementedError(
            f"annotator {name!r} is a CNN detector the PyTorch port does not have yet "
            f"(ROADMAP queue 1 item 14); the port has: {sorted(SIMPLE)}")

    return factory


for _name in CNN:
    _FACTORIES[_name] = _not_ported(_name)
