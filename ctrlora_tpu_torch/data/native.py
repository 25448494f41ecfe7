"""The port's ctypes binding of the native image prep
(``native/image_ops.cpp``): crop + resize + normalise a uint8 HWC image to
float32 in C++, outside the GIL, so the loader's threads run it in parallel.

The library builds at first use, never at import, with ``g++`` and the
flags of ``native/Makefile``, into ``ctrlora_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed on a hash of the source and the flags;
nothing is written into ``native/``. A failed build or load raises: the
datasets call this module only under ``CTRLORA_NATIVE_DATA``, and never fall
back to another resize there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared")

_U8P, _F32P, _I = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_ENTRIES = {
    # src, sh, sw, crop top, left, h, w, dst, dh, dw, scale, shift
    "ctrlora_resize_norm": [_U8P, _I, _I, _I, _I, _I, _I, _F32P, _I, _I,
                            ctypes.c_float, ctypes.c_float],
    # the same per image as arrays, dh, dw, scale, shift, n
    "ctrlora_batch_resize_norm": [ctypes.POINTER(_U8P), _IP, _IP, _IP, _IP, _IP, _IP,
                                  ctypes.POINTER(_F32P), _I, _I, ctypes.c_float,
                                  ctypes.c_float, _I],
    "ctrlora_native_version": [],
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libctrlora_data_{h.hexdigest()[:16]}.so"


def lib() -> ctypes.CDLL:
    """The library, built on first call; raises RuntimeError if the build
    or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                res = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                     capture_output=True, text=True, timeout=300)
            except OSError as e:
                raise RuntimeError(f"native image prep: cannot run {CXX!r}: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"native image prep: {CXX} failed ({res.returncode}):\n"
                                   f"{res.stderr}")
            os.replace(tmp, so)
        try:
            loaded = ctypes.CDLL(str(so))
        except OSError as e:
            raise RuntimeError(f"native image prep: cannot load {so}: {e}") from e
        for name, argtypes in _ENTRIES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int if name == "ctrlora_native_version" else None
        _lib = loaded
        return loaded


def version() -> int:
    return lib().ctrlora_native_version()


def _checked(img: np.ndarray, crop: Tuple[int, int, int, int]) -> np.ndarray:
    """The image as a contiguous uint8 [H, W, 3] array; raises unless the
    crop (top, left, h, w) is a non-empty box inside it (the C code reads
    the box unchecked)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"native image prep takes uint8 [H, W, 3], got {img.shape}")
    t, l, h, w = crop
    if not (0 <= t and 0 <= l and h > 0 and w > 0 and t + h <= img.shape[0]
            and l + w <= img.shape[1]):
        raise ValueError(f"crop {crop} is not a box inside the {img.shape[:2]} image")
    return img


def resize_norm(img: np.ndarray, crop: Tuple[int, int, int, int], out_size: Tuple[int, int],
                scale: float, shift: float) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [dh, dw, 3]: the crop (top, left, h, w)
    resized (area average down, bilinear up) to out_size (dh, dw), then
    x * scale + shift."""
    img = _checked(img, crop)
    dh, dw = out_size
    out = np.empty((dh, dw, 3), np.float32)
    t, l, h, w = crop
    lib().ctrlora_resize_norm(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1], t, l, h, w,
                              out.ctypes.data_as(_F32P), dh, dw, scale, shift)
    return out


def batch_resize_norm(imgs: Sequence[np.ndarray], crops: Sequence[Tuple[int, int, int, int]],
                      out_size: Tuple[int, int], scale: float, shift: float) -> np.ndarray:
    """``resize_norm`` of each image on the library's thread pool ->
    float32 [n, dh, dw, 3]."""
    n = len(imgs)
    dh, dw = out_size
    imgs = [_checked(im, c) for im, c in zip(imgs, crops)]
    out = np.empty((n, dh, dw, 3), np.float32)
    ints = lambda vals: (ctypes.c_int * n)(*vals)
    lib().ctrlora_batch_resize_norm(
        (_U8P * n)(*[im.ctypes.data_as(_U8P) for im in imgs]),
        ints(im.shape[0] for im in imgs), ints(im.shape[1] for im in imgs),
        *(ints(c[i] for c in crops) for i in range(4)),
        (_F32P * n)(*[out[i].ctypes.data_as(_F32P) for i in range(n)]),
        dh, dw, scale, shift, n)
    return out
