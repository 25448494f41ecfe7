"""Bounding-box annotator: a darknet YOLO net built from its .cfg, then the
COCO colour mask (counterpart of ``ctrlora_tpu/annotators/bbox.py``;
reference annotator/bbox/__init__.py, which runs yolov4.weights through
cvlib / OpenCV-DNN).

``YoloV4`` builds the graph of any darknet detection cfg from the section
kinds YOLOv4's uses: convolutional (BatchNorm folded at load, darknet's eps
on the std: ``g = scale / (sqrt(var) + 1e-6)``), route, shortcut, maxpool
(stride 1, as YOLOv4's SPP pools), upsample (nearest) and yolo, with mish,
leaky (0.1) and linear activations. It raises on what it would run
differently from darknet: a maxpool of another stride, a route with
``groups``, a section kind it does not know. ``read_darknet_weights``
reads the published .weights binary (header, then per conv: bias, and
scale / mean / var where there is a BatchNorm, then the [f, cin, k, k]
kernel) and raises ValueError unless the file holds exactly the floats the
cfg needs. The box decode (sigmoid x scale_x_y), the greedy NMS of
cv2.dnn.NMSBoxes and the area-sorted mask drawing run on the host in
numpy, as in the JAX package.

yolov4.cfg and yolov4.weights are read from the checkpoint directory; the
detector raises FileNotFoundError naming the file that is missing (neither
package has an initialisation to fall back on).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.download import ckpts_dir, ensure_ckpt

NET_SIZE = 416
N_CLASSES = 80
CFG_FILE, WEIGHTS_FILE = "yolov4.cfg", "yolov4.weights"
KINDS = ("convolutional", "route", "shortcut", "maxpool", "upsample", "yolo")

# COCO-80 names in darknet order (reference yolov3_classes.txt)
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

# reference annotator/bbox/__init__.py:12-94 class -> RGB color
COLOR_DICT: Dict[str, Tuple[int, int, int]] = {
    "background": (0, 0, 100), "person": (255, 0, 0), "bicycle": (0, 255, 0),
    "car": (0, 0, 255), "motorcycle": (255, 255, 0), "airplane": (255, 0, 255),
    "bus": (0, 255, 255), "train": (128, 128, 0), "truck": (128, 0, 128),
    "boat": (0, 128, 128), "traffic light": (128, 128, 128),
    "fire hydrant": (64, 0, 0), "stop sign": (0, 64, 0),
    "parking meter": (0, 0, 64), "bench": (64, 64, 0), "bird": (64, 0, 64),
    "cat": (0, 64, 64), "dog": (192, 192, 192), "horse": (32, 32, 32),
    "sheep": (96, 96, 96), "cow": (160, 160, 160), "elephant": (224, 224, 224),
    "bear": (32, 0, 0), "zebra": (0, 32, 0), "giraffe": (0, 0, 32),
    "backpack": (32, 32, 0), "umbrella": (32, 0, 32), "handbag": (0, 32, 32),
    "tie": (96, 0, 0), "suitcase": (0, 96, 0), "frisbee": (0, 0, 96),
    "skis": (96, 96, 0), "snowboard": (96, 0, 96), "sports ball": (0, 96, 96),
    "kite": (160, 0, 0), "baseball bat": (0, 160, 0),
    "baseball glove": (0, 0, 160), "skateboard": (160, 160, 0),
    "surfboard": (160, 0, 160), "tennis racket": (0, 160, 160),
    "bottle": (224, 0, 0), "wine glass": (0, 224, 0), "cup": (0, 0, 224),
    "fork": (224, 224, 0), "knife": (224, 0, 224), "spoon": (0, 224, 224),
    "bowl": (64, 64, 64), "banana": (128, 64, 64), "apple": (64, 128, 64),
    "sandwich": (64, 64, 128), "orange": (128, 128, 64),
    "broccoli": (128, 64, 128), "carrot": (64, 128, 128),
    "hot dog": (192, 64, 64), "pizza": (64, 192, 64), "donut": (64, 64, 192),
    "cake": (192, 192, 64), "chair": (192, 64, 192), "couch": (64, 192, 192),
    "potted plant": (96, 32, 32), "bed": (32, 96, 32),
    "dining table": (32, 32, 96), "toilet": (96, 96, 32), "tv": (96, 32, 96),
    "laptop": (32, 96, 96), "mouse": (160, 32, 32), "remote": (32, 160, 32),
    "keyboard": (32, 32, 160), "cell phone": (160, 160, 32),
    "microwave": (160, 32, 160), "oven": (32, 160, 160),
    "toaster": (224, 32, 32), "sink": (32, 224, 32),
    "refrigerator": (32, 32, 224), "book": (224, 224, 32),
    "clock": (224, 32, 224), "vase": (32, 224, 224),
    "scissors": (64, 96, 96), "teddy bear": (96, 64, 96),
    "hair drier": (96, 96, 64), "toothbrush": (160, 96, 96),
}


# ---------------------------------------------------------------------------
# cfg parsing + graph
# ---------------------------------------------------------------------------

def parse_cfg(path: str) -> List[Tuple[str, Dict[str, str]]]:
    sections: List[Tuple[str, Dict[str, str]]] = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if line.startswith("["):
                sections.append((line.strip("[]"), {}))
            else:
                k, v = line.split("=", 1)
                sections[-1][1][k.strip()] = v.strip()
    return sections


def default_cfg_path(ckpt_dir: Optional[str] = None) -> str:
    """yolov4.cfg beside yolov4.weights in the checkpoint directory (it is
    published with the weights, AlexeyAB/darknet, and not in the repo)."""
    return os.path.join(ckpt_dir or ckpts_dir(), CFG_FILE)


def _act(name: str, x):
    if name == "mish":
        return x * torch.tanh(F.softplus(x))
    if name == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if name == "linear":
        return x
    raise ValueError(f"darknet activation {name!r} is not supported")


def _route_indices(opt: Dict[str, str], n: int) -> List[int]:
    idxs = [int(v) for v in opt["layers"].split(",")]
    return [i if i >= 0 else n + i for i in idxs]


class DarknetConv(nn.Module):
    """A darknet convolutional section: conv without bias, then the folded
    per-channel scale and bias (BatchNorm, or scale 1 and the conv's bias)."""

    def __init__(self, cin: int, f: int, k: int, stride: int, pad: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, f, k, stride, pad, bias=False)
        self.scale = nn.Parameter(torch.ones(f))
        self.bias = nn.Parameter(torch.zeros(f))

    def forward(self, x):
        return self.conv(x) * self.scale[:, None, None] + self.bias[:, None, None]


class YoloV4(nn.Module):
    """The darknet graph of a .cfg: x [1, 3, H, W] (RGB in 0..1, H and W
    multiples of the net's stride) -> the raw map of each yolo section,
    [1, 3 * (5 + classes), gh, gw]."""

    def __init__(self, cfg_path: Optional[str] = None):
        super().__init__()
        self.sections = parse_cfg(cfg_path or default_cfg_path())
        self.net_opt = self.sections[0][1]
        self.layers = self.sections[1:]
        self.conv_specs: List[Dict] = []  # per conv: in, filters, size, bn
        convs = []
        chans: List[int] = []
        c = int(self.net_opt.get("channels", 3))
        for i, (kind, opt) in enumerate(self.layers):
            if kind not in KINDS:
                raise ValueError(f"cfg section {i + 1} [{kind}]: a section kind the port "
                                 f"does not build (it builds {', '.join(KINDS)})")
            if kind == "convolutional":
                f, k = int(opt["filters"]), int(opt["size"])
                self.conv_specs.append({"in": c, "filters": f, "size": k,
                                        "bn": opt.get("batch_normalize", "0") == "1"})
                pad = k // 2 if opt.get("pad", "0") == "1" else 0
                convs.append(DarknetConv(c, f, k, int(opt.get("stride", 1)), pad))
                c = f
            elif kind == "route":
                if "groups" in opt:
                    raise ValueError(f"cfg section {i + 1} [route] has groups={opt['groups']}: "
                                     f"grouped routes are not supported")
                c = sum(chans[j] for j in _route_indices(opt, len(chans)))
            elif kind == "maxpool" and int(opt.get("stride", 1)) != 1:
                raise ValueError(f"cfg section {i + 1} [maxpool] has stride={opt['stride']}: "
                                 f"only stride-1 maxpools (YOLOv4's SPP) are supported")
            chans.append(c)
        self.convs = nn.ModuleList(convs)
        self.yolo_meta = [
            {
                "mask": [int(v) for v in opt["mask"].split(",")],
                "anchors": np.array(
                    [int(v) for v in opt["anchors"].split(",")], np.float32
                ).reshape(-1, 2),
                "scale_x_y": float(opt.get("scale_x_y", 1.0)),
                "classes": int(opt.get("classes", N_CLASSES)),
            }
            for kind, opt in self.layers if kind == "yolo"
        ]

    def n_weight_floats(self) -> int:
        n = 0
        for s in self.conv_specs:
            n += s["filters"] * (4 if s["bn"] else 1)
            n += s["filters"] * s["in"] * s["size"] ** 2
        return n

    def forward(self, x) -> List[torch.Tensor]:
        outs: List[torch.Tensor] = []
        yolo_raw: List[torch.Tensor] = []
        ci = 0
        for kind, opt in self.layers:
            if kind == "convolutional":
                x = _act(opt.get("activation", "linear"), self.convs[ci](x))
                ci += 1
            elif kind == "route":
                x = torch.cat([outs[i] for i in _route_indices(opt, len(outs))], dim=1)
            elif kind == "shortcut":
                i = int(opt["from"])
                x = _act(opt.get("activation", "linear"), x + outs[i if i >= 0 else len(outs) + i])
            elif kind == "maxpool":
                k = int(opt["size"])
                pad = (k - 1) // 2
                x = F.max_pool2d(F.pad(x, (pad, k - 1 - pad, pad, k - 1 - pad),
                                       value=float("-inf")), k, 1)
            elif kind == "upsample":
                s = int(opt.get("stride", 2))
                x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            else:  # yolo
                yolo_raw.append(x)
            outs.append(x)
        return yolo_raw


def read_darknet_weights(path: str, conv_specs: List[Dict]) -> Dict[str, torch.Tensor]:
    """A darknet .weights file -> YoloV4's state dict (BatchNorms folded,
    eps on the std). Header: major, minor, revision (int32), then the images
    seen, int64 where major * 10 + minor >= 2, else int32. Raises ValueError
    unless the file holds exactly the floats `conv_specs` need."""
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 3)
        if len(head) < 3:
            raise ValueError(f"{path}: a darknet weights file starts with a 12-byte header")
        major, minor, _rev = (int(v) for v in head)
        seen = np.fromfile(f, np.int64 if major * 10 + minor >= 2 else np.int32, 1)
        if len(seen) < 1:
            raise ValueError(f"{path}: the header ends before the images-seen count")
        buf = np.fromfile(f, np.float32)
    need = sum(s["filters"] * ((4 if s["bn"] else 1) + s["in"] * s["size"] ** 2)
               for s in conv_specs)
    if len(buf) != need:
        raise ValueError(f"{path}: {len(buf)} floats after the header, the cfg's "
                         f"{len(conv_specs)} convolutional sections need {need}")
    sd, off = {}, 0

    def take(n):
        nonlocal off
        v = buf[off:off + n]
        off += n
        return v

    for i, spec in enumerate(conv_specs):
        f, cin, k = spec["filters"], spec["in"], spec["size"]
        if spec["bn"]:
            bias, scale, mean, var = take(f), take(f), take(f), take(f)
            g = scale / (np.sqrt(var) + 1e-6)  # darknet eps-on-std
            post_scale, post_bias = g, bias - mean * g
        else:
            post_scale, post_bias = np.ones(f, np.float32), take(f)
        sd[f"convs.{i}.conv.weight"] = torch.from_numpy(take(f * cin * k * k).reshape(f, cin, k, k))
        sd[f"convs.{i}.scale"] = torch.from_numpy(post_scale.copy())
        sd[f"convs.{i}.bias"] = torch.from_numpy(post_bias.copy())
    return sd


# ---------------------------------------------------------------------------
# decode + NMS + drawing (host)
# ---------------------------------------------------------------------------

def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def decode_yolo(raw: np.ndarray, meta: Dict, net_w: int, net_h: int):
    """raw [gh,gw,3*(5+C)] -> (boxes_norm [N,4] cx,cy,w,h in 0..1,
    scores [N,C])."""
    gh, gw = raw.shape[:2]
    na = len(meta["mask"])
    C = meta["classes"]
    r = raw.reshape(gh, gw, na, 5 + C)
    sxy = meta["scale_x_y"]
    cx = (np.arange(gw, dtype=np.float32))[None, :, None]
    cy = (np.arange(gh, dtype=np.float32))[:, None, None]
    bx = (_sig(r[..., 0]) * sxy - 0.5 * (sxy - 1.0) + cx) / gw
    by = (_sig(r[..., 1]) * sxy - 0.5 * (sxy - 1.0) + cy) / gh
    anchors = meta["anchors"][meta["mask"]]
    bw = np.exp(r[..., 2]) * anchors[:, 0] / net_w
    bh = np.exp(r[..., 3]) * anchors[:, 1] / net_h
    obj = _sig(r[..., 4:5])
    cls = _sig(r[..., 5:]) * obj
    boxes = np.stack([bx, by, bw, bh], axis=-1).reshape(-1, 4)
    return boxes, cls.reshape(-1, C)


def nms_boxes(boxes: np.ndarray, scores: np.ndarray, score_thr: float,
              nms_thr: float) -> List[int]:
    """Greedy IoU NMS over [x,y,w,h] boxes — cv2.dnn.NMSBoxes semantics
    (score-descending, suppress IoU > nms_thr)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while len(order):
        i = order[0]
        if scores[i] < score_thr:
            break
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 0] + boxes[i, 2], boxes[rest, 0] + boxes[rest, 2])
        y2 = np.minimum(boxes[i, 1] + boxes[i, 3], boxes[rest, 1] + boxes[rest, 3])
        inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
        union = boxes[i, 2] * boxes[i, 3] + boxes[rest, 2] * boxes[rest, 3] - inter
        iou = inter / np.maximum(union, 1e-9)
        order = rest[iou <= nms_thr]
    return keep


def draw_bbox_mask(shape: Tuple[int, int, int], bboxes: List[List[int]],
                   labels: List[str]) -> np.ndarray:
    """The reference's mask drawing (annotator/bbox/__init__.py:115-145):
    clamp boxes, sort by area DESCENDING so small boxes paint over large."""
    h, w = shape[:2]
    mask = np.zeros(shape, np.uint8)
    if not bboxes:
        return mask
    areas = []
    clamped = []
    for (x1, y1, x2, y2) in bboxes:
        x1 = 0 if x1 < 0 else x1
        y1 = 0 if y1 < 0 else y1
        x2 = w if x2 < 0 else x2
        y2 = h if y2 < 0 else y2
        clamped.append((x1, y1, x2, y2))
        areas.append((x2 - x1) * (y2 - y1))
    for i in np.argsort(-np.asarray(areas)):
        x1, y1, x2, y2 = clamped[i]
        mask[y1:y2, x1:x2, :] = COLOR_DICT[labels[i]]
    return mask


def _require(path: str, what: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{what} not found: {path}; place {os.path.basename(path)} "
                                f"(published with AlexeyAB/darknet's YOLOv4) there")
    return path


class BBoxDetector:
    """reference annotator/bbox/__init__.py:97-145: the cfg's net with its
    .weights on `device` (default yolov4.cfg and yolov4.weights in
    `ckpt_dir`, ``download.ckpts_dir()``)."""

    def __init__(self, weights_path: Optional[str] = None, cfg_path: Optional[str] = None,
                 device="cuda", ckpt_dir: Optional[str] = None):
        directory = ckpt_dir or ckpts_dir()
        cfg_path = _require(cfg_path or default_cfg_path(directory), "darknet cfg")
        weights_path = _require(
            weights_path or ensure_ckpt(WEIGHTS_FILE, os.path.join(directory, WEIGHTS_FILE)),
            "darknet weights")
        with torch.random.fork_rng(devices=[]):
            net = YoloV4(cfg_path)
        state = read_darknet_weights(weights_path, net.conv_specs)
        self.yolo_meta = net.yolo_meta
        self.model = nets.build(lambda: net, state, "bbox", device)

    def raw_maps(self, image: np.ndarray) -> List[np.ndarray]:
        """The yolo sections' raw maps [gh, gw, 3 * (5 + C)] of `image`
        (RGB uint8) at NET_SIZE, on the host."""
        blob = cv2.resize(image, (NET_SIZE, NET_SIZE)).astype(np.float32) / 255.0
        return [r[0].permute(1, 2, 0).numpy() for r in nets.forward(self.model, blob[None])]

    def detect(self, image: np.ndarray, confidence: float = 0.4,
               nms_thresh: float = 0.5):
        """cvlib.detect_common_objects equivalent: returns (bboxes [x1,y1,
        x2,y2 in source pixels], labels, confidences)."""
        H, W = image.shape[:2]
        boxes_all, scores_all = [], []
        for raw, meta in zip(self.raw_maps(image), self.yolo_meta):
            b, s = decode_yolo(raw, meta, NET_SIZE, NET_SIZE)
            boxes_all.append(b)
            scores_all.append(s)
        boxes = np.concatenate(boxes_all)
        scores = np.concatenate(scores_all)
        cls_id = scores.argmax(-1)
        conf = scores[np.arange(len(scores)), cls_id]
        sel = conf > confidence
        boxes, cls_id, conf = boxes[sel], cls_id[sel], conf[sel]
        # to top-left pixel coords of the ORIGINAL image (cvlib scaling)
        px = np.stack([
            (boxes[:, 0] - boxes[:, 2] / 2) * W,
            (boxes[:, 1] - boxes[:, 3] / 2) * H,
            boxes[:, 2] * W, boxes[:, 3] * H,
        ], axis=1)
        keep = nms_boxes(px, conf, confidence, nms_thresh)
        out_boxes, labels, confs = [], [], []
        for i in keep:
            x, y, bw, bh = px[i]
            out_boxes.append([int(x), int(y), int(x + bw), int(y + bh)])
            labels.append(COCO_CLASSES[cls_id[i]])
            confs.append(float(conf[i]))
        return out_boxes, labels, confs

    def __call__(self, input_image: np.ndarray, confidence: float = 0.4,
                 nms_thresh: float = 0.5) -> np.ndarray:
        assert input_image.ndim == 3
        bboxes, labels, _ = self.detect(input_image, confidence, nms_thresh)
        return draw_bbox_mask(input_image.shape, bboxes, labels)
