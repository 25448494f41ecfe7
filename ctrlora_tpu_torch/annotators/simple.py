"""Tier-1 algorithmic condition preprocessors, pure cv2/numpy/PIL
(counterpart of ``ctrlora_tpu/annotators/simple.py``).

Same `Detector.__call__(uint8 HWC RGB, **params) -> uint8 map` contract as
the reference's annotator zoo (annotator/{canny,blur,grayscale,jpeg,pad,
palette,pixel,illusion,shuffle,inpainting,inpainting_brush,outpainting}).
These run on the host inside the data pipeline; stochastic ones take an
optional rng for reproducibility.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import cv2
import numpy as np

from ctrlora_tpu_torch.annotators.util import img2mask, make_noise_disk


class CannyDetector:
    def __call__(self, img, low_threshold=100, high_threshold=200):
        return cv2.Canny(img, low_threshold, high_threshold)


class Blurrer:
    def __call__(self, img, ksize=51):
        return cv2.GaussianBlur(img, (ksize, ksize), cv2.BORDER_DEFAULT).astype("ubyte")


class GrayscaleConverter:
    def __call__(self, img):
        return np.stack([cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)] * 3, axis=-1).astype(
            "uint8"
        )


class JpegCompressor:
    def __call__(self, img, jpeg_quality=10):
        bgr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        _, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
        return cv2.cvtColor(cv2.imdecode(enc, 1), cv2.COLOR_BGR2RGB)


class Padder:
    def __call__(self, img, top_ratio=0.25, bottom_ratio=0.25, left_ratio=0.25, right_ratio=0.25):
        h, w = img.shape[:2]
        return cv2.copyMakeBorder(
            img,
            top=int(h * top_ratio), bottom=int(h * bottom_ratio),
            left=int(w * left_ratio), right=int(w * right_ratio),
            borderType=cv2.BORDER_CONSTANT, value=[0, 0, 0],
        )


class PaletteDetector:
    def __call__(self, img):
        h, w = img.shape[:2]
        small = cv2.resize(img, (max(w // 64, 1), max(h // 64, 1)), interpolation=cv2.INTER_CUBIC)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


class Pixelater:
    def __call__(
        self, img, palette=None, n_colors=16, scale=16, min_size=32,
        down_interpolation=cv2.INTER_NEAREST, rng: Optional[np.random.Generator] = None,
    ):
        oh, ow = img.shape[:2]
        nh, nw = max(oh // scale, min_size), max(ow // scale, min_size)
        img = cv2.resize(img, (nw, nh), interpolation=down_interpolation)
        if palette is None:
            palette = self.get_palette(img, n_colors, rng)
        pixels = img.reshape(-1, 3).astype(np.int32)
        # nearest palette color (exact; replaces the reference's KDTree)
        d = ((pixels[:, None, :] - palette[None].astype(np.int32)) ** 2).sum(-1)
        new_pixels = palette[np.argmin(d, axis=1)]
        out = new_pixels.reshape(nh, nw, 3)
        return cv2.resize(out, (ow, oh), interpolation=cv2.INTER_NEAREST)

    @staticmethod
    def get_palette(img, n_colors, rng: Optional[np.random.Generator] = None):
        from sklearn.cluster import KMeans

        seed = int(rng.integers(0, 2**31)) if rng is not None else None
        km = KMeans(n_clusters=n_colors, n_init=4, random_state=seed)
        km.fit(img.reshape(-1, 3))
        return np.clip(np.rint(km.cluster_centers_), 0, 255).astype(np.uint8)


class IllusionConverter:
    def __call__(self, img):
        # (the reference computes HSV then indexes the RGB image's 3rd channel
        # — effectively the blue channel; replicated for parity,
        # annotator/illusion/__init__.py:14-15)
        gray = img[:, :, 2]
        t = 256 // 3
        remap = np.zeros_like(gray)
        remap[(gray >= t) & (gray <= 255 - t)] = 127
        remap[gray > 255 - t] = 255
        big = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (11, 11))
        small = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
        out = cv2.morphologyEx(remap, cv2.MORPH_CLOSE, big)
        out = cv2.morphologyEx(out, cv2.MORPH_OPEN, small)
        return np.stack([out] * 3, axis=-1).astype("uint8")


class Inpainter:
    """Zero out a centered rectangle parameterized in percent (reference:
    annotator/inpainting/__init__.py)."""

    def __call__(self, img, rand_h=40, rand_h_1=40, rand_w=40, rand_w_1=40):
        h, w = img.shape[:2]
        hn, wn = int(h / 100.0 * rand_h), int(w / 100.0 * rand_w)
        hn1, wn1 = int(h / 100.0 * rand_h_1), int(w / 100.0 * rand_w_1)
        out = img.copy()
        out[(h - hn) // 2 : (h + hn1) // 2, (w - wn) // 2 : (w + wn1) // 2] = 0
        return out.astype("ubyte")


class Outpainter:
    """Keep only a centered rectangle (reference: annotator/outpainting)."""

    def __call__(self, img, rand_h=60, rand_w=60):
        h, w = img.shape[:2]
        hn, wn = int(h / 100.0 * rand_h), int(w / 100.0 * rand_w)
        out = np.zeros(img.shape)
        out[(h - hn) // 2 : (h + hn) // 2, (w - wn) // 2 : (w + wn) // 2] = img[
            (h - hn) // 2 : (h + hn) // 2, (w - wn) // 2 : (w + wn) // 2
        ]
        return out.astype("ubyte")


class BrushInpainter:
    """Random polyline brush masks (reference: annotator/inpainting_brush)."""

    def __init__(
        self,
        brush_num: Tuple[int, int] = (5, 9),
        brush_n_vertex: Tuple[int, int] = (4, 18),
        brush_mean_angle: float = 2 * math.pi / 5,
        brush_angle_range: float = 2 * math.pi / 15,
        brush_width_ratio: Tuple[float, float] = (0.02, 0.1),
    ):
        self.brush_num = brush_num
        self.brush_n_vertex = brush_n_vertex
        self.brush_mean_angle = brush_mean_angle
        self.brush_angle_range = brush_angle_range
        self.brush_width_ratio = brush_width_ratio

    def __call__(self, img, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        mask = self.sample_brushes(img.shape[0], img.shape[1], rng)
        out = img.copy()
        out[mask] = 0
        return out

    def sample_brushes(self, H: int, W: int, rng: np.random.Generator):
        from PIL import Image, ImageDraw

        min_w = int(self.brush_width_ratio[0] * min(H, W))
        max_w = int(self.brush_width_ratio[1] * min(H, W))
        n_brush = int(rng.integers(self.brush_num[0], self.brush_num[1] + 1))
        avg_r = math.sqrt(H * H + W * W) / 8
        mask = Image.new("L", (W, H), 255)
        for _ in range(n_brush):
            n_vertex = int(rng.integers(self.brush_n_vertex[0], self.brush_n_vertex[1] + 1))
            width = int(rng.integers(min_w, max_w + 1))
            min_a = self.brush_mean_angle - rng.random() * self.brush_angle_range
            max_a = self.brush_mean_angle + rng.random() * self.brush_angle_range
            vertex = [(int(rng.integers(0, W)), int(rng.integers(0, H)))]
            for j in range(n_vertex):
                angle = rng.random() * (max_a - min_a) + min_a
                if j % 2 == 0:
                    angle = 2 * math.pi - angle
                r = float(np.clip(rng.normal(avg_r, avg_r // 2), 0, 2 * avg_r))
                vertex.append(
                    (
                        min(max(vertex[-1][0] + r * math.cos(angle), 0), W),
                        min(max(vertex[-1][1] + r * math.sin(angle), 0), H),
                    )
                )
            draw = ImageDraw.Draw(mask)
            draw.line(vertex, fill=0, width=width)
            for v in vertex:
                draw.ellipse(
                    (v[0] - width // 2, v[1] - width // 2,
                     v[0] + width // 2, v[1] + width // 2),
                    fill=0,
                )
            if rng.random() > 0.5:
                mask = mask.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
            if rng.random() > 0.5:
                mask = mask.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        if rng.random() > 0.5:
            mask = mask.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        if rng.random() > 0.5:
            mask = mask.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        return np.array(mask) < 128


class ContentShuffleDetector:
    def __call__(self, img, h=None, w=None, f=None, rng=None):
        H, W, _ = img.shape
        h, w, f = h or H, w or W, f or 256
        rng = rng or np.random.default_rng()
        x = make_noise_disk(h, w, 1, f, rng) * float(W - 1)
        y = make_noise_disk(h, w, 1, f, rng) * float(H - 1)
        flow = np.concatenate([x, y], axis=2).astype(np.float32)
        return cv2.remap(img, flow, None, cv2.INTER_LINEAR)


class ColorShuffleDetector:
    def __call__(self, img, rng=None):
        rng = rng or np.random.default_rng()
        H, W, _ = img.shape
        F = int(rng.integers(64, 385))
        A = make_noise_disk(H, W, 3, F, rng)
        B = make_noise_disk(H, W, 3, F, rng)
        C = (A + B) / 2.0
        A = (C + (A - C) * 3.0).clip(0, 1)
        B = (C + (B - C) * 3.0).clip(0, 1)
        L = img.astype(np.float32) / 255.0
        Y = A * L + B * (1 - L)
        Y -= Y.min(axis=(0, 1), keepdims=True)
        Y /= np.maximum(Y.max(axis=(0, 1), keepdims=True), 1e-5)
        return (Y * 255.0).clip(0, 255).astype(np.uint8)


class GrayDetector:
    def __call__(self, img, rng=None):
        rng = rng or np.random.default_rng()
        eps = 1e-5
        X = img.astype(np.float32)
        kr, kg, kb = [rng.random() + eps for _ in range(3)]
        ks = kr + kg + kb
        Y = (X[:, :, 0] * kr + X[:, :, 1] * kg + X[:, :, 2] * kb) / ks
        return np.stack([Y] * 3, axis=2).clip(0, 255).astype(np.uint8)


class DownSampleDetector:
    def __call__(self, img, level=3, k=16.0, rng=None):
        rng = rng or np.random.default_rng()
        h = img.astype(np.float32)
        for _ in range(level):
            h += rng.normal(0.0, k, h.shape)
            h = cv2.pyrDown(h)
        for _ in range(level):
            h = cv2.pyrUp(h)
            h += rng.normal(0.0, k, h.shape)
        return h.clip(0, 255).astype(np.uint8)


class Image2MaskShuffleDetector:
    def __init__(self, resolution=(640, 512)):
        self.H, self.W = resolution

    def __call__(self, img, rng=None):
        m = img2mask(img, self.H, self.W, rng=rng)
        return (m * 255.0).clip(0, 255).astype(np.uint8)
