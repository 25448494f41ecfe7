"""OneFormer semantic segmentation, ``seg_ofcoco`` and ``seg_ofade20k``
(counterpart of ``ctrlora_tpu/annotators/oneformer/``; reference
annotator/oneformer: Swin-L OneFormer in 'semantic' task mode).

``OneFormer`` is the backbone (``swin.py``), the MSDeformAttn pixel decoder
(``pixel_decoder.py``) and the masked transformer decoder (``decoder.py``),
with the masks up-sampled to the padded input (oneformer_model.py:294-299).
The detector (DefaultPredictor + semantic inference): PIL's bilinear
shortest-edge resize (COCO 800 / 1333, ADE20k 640 / 2560), ImageNet
normalisation on 0..255, zero padding to a multiple of 32, the net, the
masks cropped and resized to the image, the class softmax without the
no-object class times the masks' sigmoid, the argmax and the dataset's
palette (this package's own ``palettes.json``, a copy of JAX's). JAX resizes
the masks to the image with cv2 on the host; the port resizes them on the
device with ``F.interpolate(bilinear, align_corners=False)``, the same
half-pixel rule (their sums differ by float rounding only).

Weights: 150_16_swin_l_oneformer_coco_100ep.pth and
250_16_swin_l_oneformer_ade20k_160k.pth, their tensors under 'model' as
detectron2 saves them; the file's training-only entries (the text
encoder, the contrastive heads) are left out before the strict load, as
JAX's ``convert_oneformer`` reads only these keys. No file, no net: the
detector raises FileNotFoundError, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.oneformer.decoder import MLP, DecoderConfig, OneFormerDecoder
from ctrlora_tpu_torch.annotators.oneformer.pixel_decoder import (
    MSDeformAttnPixelDecoder, PixelDecoderConfig,
)
from ctrlora_tpu_torch.annotators.oneformer.swin import SwinConfig, SwinTransformer
from ctrlora_tpu_torch.utils.precision import fp32_exact

PIXEL_MEAN = np.array([123.675, 116.280, 103.530], np.float32)
PIXEL_STD = np.array([58.395, 57.120, 57.375], np.float32)
SIZE_DIVISIBILITY = 32

COCO_FILE = "150_16_swin_l_oneformer_coco_100ep.pth"
ADE20K_FILE = "250_16_swin_l_oneformer_ade20k_160k.pth"


@dataclasses.dataclass(frozen=True)
class OneFormerConfig:
    swin: SwinConfig = SwinConfig()
    pixel: PixelDecoderConfig = PixelDecoderConfig()
    dec: DecoderConfig = DecoderConfig()
    # DefaultPredictor's ResizeShortestEdge bounds (COCO's defaults; the
    # ADE20k Swin yaml sets 640 / 2560)
    min_size_test: int = 800
    max_size_test: int = 1333
    palette: str = "coco"


def coco_config() -> OneFormerConfig:
    return OneFormerConfig(dec=DecoderConfig(num_queries=150, num_classes=133),
                           min_size_test=800, max_size_test=1333, palette="coco")


def ade20k_config() -> OneFormerConfig:
    return OneFormerConfig(dec=DecoderConfig(num_queries=250, num_classes=150),
                           min_size_test=640, max_size_test=2560, palette="ade20k")


@functools.lru_cache()
def palettes() -> Dict:
    with open(os.path.join(os.path.dirname(__file__), "palettes.json")) as f:
        return json.load(f)


def task_tokens(task: str = "semantic", seq_len: int = 77) -> np.ndarray:
    """'The task is {task}' through the CLIP BPE, padded with zeros, not EOT
    (the reference's Tokenize, data/tokenizer.py:86-116)."""
    from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer

    tok = default_tokenizer()
    ids = [tok.sot_token] + tok.encode(f"The task is {task}") + [tok.eot_token]
    out = np.zeros((seq_len,), np.int64)
    out[:len(ids)] = ids[:seq_len]
    if len(ids) > seq_len:
        out[-1] = tok.eot_token
    return out


class OneFormer(nn.Module):
    """(image [B, 3, H, W] normalised and padded, task token ids [B, 77] as
    floats) -> (class logits [B, Q, K+1], masks [B, Q, H, W])."""

    def __init__(self, cfg: OneFormerConfig):
        super().__init__()
        if cfg.pixel.conv_dim != cfg.dec.hidden_dim:
            raise ValueError("the port's decoder projects no input: conv_dim must equal "
                             "hidden_dim, as in every published config")
        self.backbone = SwinTransformer(cfg.swin)
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = MSDeformAttnPixelDecoder(cfg.pixel)
        self.sem_seg_head.predictor = OneFormerDecoder(cfg.dec, cfg.pixel.mask_dim)
        c = cfg.dec.hidden_dim
        self.task_mlp = MLP(cfg.dec.task_seq_len, c, c, 2)

    def forward(self, image, tasks):
        mask_features, maps = self.sem_seg_head.pixel_decoder(self.backbone(image))
        cls, masks = self.sem_seg_head.predictor(self.task_mlp(tasks), maps, mask_features)
        return cls, F.interpolate(masks, size=image.shape[2:], mode="bilinear",
                                  align_corners=False)


def resize_shortest_edge(img: np.ndarray, short: int, max_size: int) -> np.ndarray:
    """detectron2's ResizeShortestEdge.get_transform with PIL's bilinear."""
    h, w = img.shape[:2]
    scale = short / min(h, w)
    newh, neww = (short, scale * w) if h < w else (scale * h, short)
    if max(newh, neww) > max_size:
        s = max_size / max(newh, neww)
        newh, neww = newh * s, neww * s
    newh, neww = int(newh + 0.5), int(neww + 0.5)
    if (newh, neww) == (h, w):
        return img
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((neww, newh), Image.BILINEAR))


class OneformerDetector:
    """`cfg` with `state_dict` (the published file's tensors), default the
    file `file` in `ckpt_dir`."""

    def __init__(self, cfg: OneFormerConfig, state_dict=None, device="cuda",
                 ckpt_dir: Optional[str] = None, file: Optional[str] = None):
        self.cfg = cfg
        if state_dict is None and file is not None:
            state_dict = nets.read_weights(file, ckpt_dir)
        if state_dict is None:
            raise FileNotFoundError(f"OneformerDetector needs {file} in the annotator "
                                    f"checkpoint directory ({ckpt_dir or 'ckpts_dir()'})")
        factory = lambda: OneFormer(cfg)
        self.model = nets.build(factory, nets.keep_keys(state_dict, nets.module_keys(factory)),
                                f"oneformer {cfg.palette}", device)
        self.tasks = torch.from_numpy(task_tokens("semantic", cfg.dec.task_seq_len)[None]).float()
        meta = palettes()[cfg.palette]
        self.colors = np.asarray(meta["colors"], np.uint8)
        self.classes = meta["classes"]

    def prepare(self, img_rgb: np.ndarray) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """(the net's input [1, 3, Hp, Wp] on the model's device, the resized
        size (rh, rw) before the padding)."""
        resized = resize_shortest_edge(img_rgb, self.cfg.min_size_test, self.cfg.max_size_test)
        rh, rw = resized.shape[:2]
        x = (resized.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD
        x = np.pad(x, ((0, -rh % SIZE_DIVISIBILITY), (0, -rw % SIZE_DIVISIBILITY), (0, 0)))
        t = torch.from_numpy(np.ascontiguousarray(x)).to(nets.device_of(self.model))
        return t.permute(2, 0, 1)[None], (rh, rw)

    def task_input(self) -> torch.Tensor:
        return self.tasks.to(nets.device_of(self.model))

    def scores(self, cls: torch.Tensor, masks: torch.Tensor, resized: Tuple[int, int],
               hw: Tuple[int, int]) -> torch.Tensor:
        """[K, H, W]: the class softmax (no-object dropped) times the masks'
        sigmoid, the masks cropped to `resized` and resized to `hw`
        (sem_seg_postprocess, then semantic_inference)."""
        rh, rw = resized
        m = F.interpolate(masks[:, :, :rh, :rw], size=hw, mode="bilinear", align_corners=False)
        prob = torch.softmax(cls[0], dim=-1)[:, :-1]
        return torch.einsum("qc,qhw->chw", prob, torch.sigmoid(m[0]))

    def semantic_map(self, img_rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB [H, W, 3] -> class ids [H, W] int32."""
        x, resized = self.prepare(img_rgb)
        with torch.inference_mode(), fp32_exact():
            cls, masks = self.model(x, self.task_input())
            seg = self.scores(cls, masks, resized, img_rgb.shape[:2]).argmax(dim=0)
        return seg.to(torch.int32).cpu().numpy()

    def __call__(self, img_rgb: np.ndarray) -> np.ndarray:
        seg = self.semantic_map(img_rgb)
        return self.colors[np.clip(seg, 0, len(self.colors) - 1)]


def OneformerCOCODetector(device="cuda", ckpt_dir: Optional[str] = None) -> OneformerDetector:
    return OneformerDetector(coco_config(), device=device, ckpt_dir=ckpt_dir, file=COCO_FILE)


def OneformerADE20kDetector(device="cuda", ckpt_dir: Optional[str] = None) -> OneformerDetector:
    return OneformerDetector(ade20k_config(), device=device, ckpt_dir=ckpt_dir, file=ADE20K_FILE)
