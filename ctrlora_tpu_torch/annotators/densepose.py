"""DensePose annotator, densepose_rcnn_R_101_FPN_DL_s1x (counterpart of
``ctrlora_tpu/annotators/densepose.py``; reference
annotator/densepose/__init__.py, which runs detectron2's DefaultPredictor
and draws the fine segmentation with viridis over a black canvas).

The pipeline, module by module as JAX's:
ResNet-101 (caffe style: the stage stride in the first 1x1 conv; FrozenBN
folded at eps 1e-5) -> FPN p2..p6 -> the RPN head -> top-1000 proposals a
level, NMS 0.7 batched by level (host numpy) -> ROIAlign (aligned=False,
sampling 2) 7x7 -> the box head (2 FCs, softmax, class 0 = person) ->
person detections (score 0.05, NMS 0.5, at most 100; host numpy) -> the
semantic-FPN decoder over p2..p5 (GN-32, bilinear x2) -> ROIAlign 28x28 ->
the DeepLab chart head (ASPP at dilations 6/12/56 with image pooling, the
stacked 3x3 convs, ConvTranspose2d k4 s2 p1 predictors, bilinear x2) ->
the 112x112 charts -> the drawing.

``DensePoseRCNN`` keeps the detectron2 checkpoint's key names for the keys
JAX's ``convert_densepose`` reads (each FrozenBN's running statistics folded
into its ``norm.weight`` / ``norm.bias``). model_final_844d15.pkl is read
with a restricted unpickler that admits only numpy's array reconstruction,
dtypes and plain builtin containers; keys of the file the net does not read
are logged by name. Without the file the detector raises
FileNotFoundError, as JAX's (neither package has an initialisation to fall
back on). The convs, products, ROIAlign gathers and chart argmaxes run on
the detector's device in fp32; the anchors, the proposal selection, both
NMS and the drawing run on the host, as in the JAX package.

The widths are this module's constants (the published config's), read when
a net is built; the stage depths are a constructor argument.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.download import ckpts_dir, ensure_ckpt
from ctrlora_tpu_torch.annotators.mlsd import FoldedBN, fold_batchnorms
from ctrlora_tpu_torch.annotators.uniformer import resize
from ctrlora_tpu_torch.utils.precision import fp32_exact

log = logging.getLogger(__name__)

FILE = "model_final_844d15.pkl"
PIXEL_MEAN = np.array([103.530, 116.280, 123.675], np.float32)  # BGR
MIN_SIZE_TEST, MAX_SIZE_TEST = 800, 1333
ANCHOR_SIZES = (32, 64, 128, 256, 512)  # p2..p6
ASPECT_RATIOS = (0.5, 1.0, 2.0)
STRIDES = (4, 8, 16, 32, 64)
PRE_NMS_TOPK, POST_NMS_TOPK = 1000, 1000
RPN_NMS_THRESH = 0.7
SCORE_THRESH, BOX_NMS_THRESH, MAX_DET = 0.05, 0.5, 100
N_PART_LABELS = 24  # fine segmentation classes 1..24 (+bg)
CHARTS = {"coarse_segm": ("ann_index_lowres", 2), "fine_segm": ("index_uv_lowres", 25),
          "u": ("u_lowres", 25), "v": ("v_lowres", 25)}

# widths of densepose_rcnn_R_101_FPN_DL_s1x (ResNet-101, detectron2 defaults)
R101_STAGES = (3, 4, 23, 3)
STEM_OUT = 64
RES2_OUT = 256  # stage s: RES2_OUT * 2**s out, BOTTLENECK * 2**s inside
BOTTLENECK = 64
FPN_DIM = 256
BOX_FC = 1024
DECODER_DIM = 256  # the decoder's convs
DECODER_CLASSES = 256  # its predictor's output, the chart head's input
ASPP_DILATIONS = (6, 12, 56)
HEAD_DIM = 512
N_STACKED = 8
POOL_BOX, POOL_CHART = 7, 28


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

class _ArrayUnpickler(pickle.Unpickler):
    """Admits numpy's array reconstruction and dtypes, and builtin
    containers and scalars; any other global raises UnpicklingError."""

    ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode"),
        ("collections", "OrderedDict"),
    } | {("builtins", n) for n in ("dict", "list", "tuple", "set", "frozenset", "int", "float",
                                    "complex", "bool", "str", "bytes", "bytearray")}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a detectron2 "
                                         f"checkpoint (only numpy arrays and builtins)")
        return super().find_class(module, name)


def read_pkl(path: str) -> Dict[str, np.ndarray]:
    """A detectron2 .pkl checkpoint ({'model': {name: ndarray}, ...}) ->
    {name: ndarray}, through ``_ArrayUnpickler``."""
    with open(path, "rb") as f:
        data = _ArrayUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    model = data.get("model", data)
    return {k: np.asarray(v) for k, v in model.items() if hasattr(v, "shape")}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Conv(nn.Conv2d):
    """detectron2's Conv2d: a conv, then its `norm` (a folded FrozenBN or a
    GroupNorm-32) where it has one, then a ReLU where asked."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1, norm=None,
                 relu=False):
        super().__init__(cin, cout, k, stride, padding, dilation, bias=norm is None)
        if norm == "bn":
            self.norm = FoldedBN(cout)
        elif norm == "gn":
            self.norm = nn.GroupNorm(32, cout)
        else:
            self.norm = None
        self.relu = relu

    def forward(self, x):
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, cout, stride):
        super().__init__()
        self.conv1 = Conv(cin, mid, 1, stride, norm="bn", relu=True)
        self.conv2 = Conv(mid, mid, 3, 1, 1, norm="bn", relu=True)
        self.conv3 = Conv(mid, cout, 1, norm="bn")
        if cin != cout:
            self.shortcut = Conv(cin, cout, 1, stride, norm="bn")

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return F.relu(out + x)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, STEM_OUT, 7, 2, 3, norm="bn", relu=True)

    def forward(self, x):
        return F.max_pool2d(self.conv1(x), 3, 2, 1)


class ResNet(nn.Module):
    """x [B, 3, H, W] (BGR, mean-subtracted) -> {'res2'..'res5'}."""

    def __init__(self, stages: Sequence[int]):
        super().__init__()
        self.stem = Stem()
        cin = STEM_OUT
        for s, n_blocks in enumerate(stages):
            mid, cout = BOTTLENECK * 2 ** s, RES2_OUT * 2 ** s
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, mid, cout, 2 if b == 0 and s > 0 else 1))
                cin = cout
            setattr(self, f"res{s + 2}", nn.Sequential(*blocks))
        self.n_stages = len(stages)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for s in range(self.n_stages):
            x = getattr(self, f"res{s + 2}")(x)
            outs[f"res{s + 2}"] = x
        return outs


class FPN(nn.Module):
    """-> [p2, p3, p4, p5, p6]: 1x1 laterals, nearest x2 top-down sums
    (cropped to the lateral), 3x3 outputs, p6 = max_pool(p5, 1, 2)."""

    def __init__(self, stages: Sequence[int]):
        super().__init__()
        self.bottom_up = ResNet(stages)
        for i in range(2, 6):
            setattr(self, f"fpn_lateral{i}", Conv(RES2_OUT * 2 ** (i - 2), FPN_DIM, 1))
            setattr(self, f"fpn_output{i}", Conv(FPN_DIM, FPN_DIM, 3, padding=1))

    def forward(self, x) -> List[torch.Tensor]:
        feats = self.bottom_up(x)
        lats = [getattr(self, f"fpn_lateral{i}")(feats[f"res{i}"]) for i in range(2, 6)]
        for i in range(len(lats) - 2, -1, -1):
            up = lats[i + 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            lats[i] = lats[i] + up[:, :, :lats[i].shape[2], :lats[i].shape[3]]
        ps = [getattr(self, f"fpn_output{i + 2}")(lat) for i, lat in enumerate(lats)]
        return ps + [F.max_pool2d(ps[-1], 1, 2)]


class RPNHead(nn.Module):
    def __init__(self):
        super().__init__()
        a = len(ASPECT_RATIOS)
        self.conv = Conv(FPN_DIM, FPN_DIM, 3, padding=1, relu=True)
        self.objectness_logits = Conv(FPN_DIM, a, 1)
        self.anchor_deltas = Conv(FPN_DIM, 4 * a, 1)

    def forward(self, feats):
        """-> [(objectness [B, A, H, W], deltas [B, 4A, H, W])] a level."""
        return [(self.objectness_logits(t), self.anchor_deltas(t))
                for t in (self.conv(f) for f in feats)]


class ProposalGenerator(nn.Module):
    def __init__(self):
        super().__init__()
        self.rpn_head = RPNHead()


class BoxHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(FPN_DIM * POOL_BOX ** 2, BOX_FC)
        self.fc2 = nn.Linear(BOX_FC, BOX_FC)


class BoxPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.cls_score = nn.Linear(BOX_FC, 2)
        self.bbox_pred = nn.Linear(BOX_FC, 4)


class Upsample2x(nn.Module):
    """Bilinear x2, align_corners=False (``uniformer.resize``: the half-pixel
    gather of JAX's ``oneformer.pixel_decoder._resize_bilinear``)."""

    def forward(self, x):
        return resize(x, (2 * x.shape[2], 2 * x.shape[3]))


class Decoder(nn.Module):
    """The semantic-FPN decoder: scale_heads.{i} over p{i+2} ([conv3x3 + GN +
    ReLU, bilinear x2] until stride 4; p2 one conv), summed, then the 1x1
    predictor. A head's convs sit at the even slots of its Sequential."""

    def __init__(self):
        super().__init__()
        heads = []
        for i in range(4):
            ops = []
            for j in range(max(1, i)):
                ops.append(Conv(FPN_DIM if j == 0 else DECODER_DIM, DECODER_DIM, 3, padding=1,
                                norm="gn", relu=True))
                if i > 0:
                    ops.append(Upsample2x())
            heads.append(nn.Sequential(*ops))
        self.scale_heads = nn.ModuleList(heads)
        self.predictor = Conv(DECODER_DIM, DECODER_CLASSES, 1)

    def forward(self, feats):
        total = None
        for head, f in zip(self.scale_heads, feats[:4]):
            x = head(f)
            total = x if total is None else total + x
        return self.predictor(total)


def _norm_relu(conv: nn.Module, c: int) -> nn.Sequential:
    return nn.Sequential(conv, nn.GroupNorm(32, c), nn.ReLU())


class ASPP(nn.Module):
    """convs.0: 1x1; convs.1-3: 3x3 at the dilations (each + GN + ReLU);
    convs.4: image pooling, a 1x1 conv and ReLU, broadcast back; the five
    concatenated, then project (1x1 + GN + ReLU)."""

    def __init__(self, c: int):
        super().__init__()
        convs = [_norm_relu(nn.Conv2d(c, c, 1, bias=False), c)]
        convs += [_norm_relu(nn.Conv2d(c, c, 3, padding=d, dilation=d, bias=False), c)
                  for d in ASPP_DILATIONS]
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c, 1, bias=False),
                                   nn.ReLU()))
        self.convs = nn.ModuleList(convs)
        self.project = _norm_relu(nn.Conv2d(5 * c, c, 1, bias=False), c)

    def forward(self, x):
        outs = [conv(x) for conv in self.convs]
        outs[-1] = outs[-1].expand(-1, -1, x.shape[2], x.shape[3])
        return self.project(torch.cat(outs, dim=1))


class DeepLabHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.ASPP = ASPP(DECODER_CLASSES)
        for i in range(N_STACKED):
            setattr(self, f"body_conv_fcn{i + 1}",
                    Conv(DECODER_CLASSES if i == 0 else HEAD_DIM, HEAD_DIM, 3, padding=1,
                         relu=True))

    def forward(self, x):
        x = self.ASPP(x)
        for i in range(N_STACKED):
            x = getattr(self, f"body_conv_fcn{i + 1}")(x)
        return x


class ChartPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        for name, n in CHARTS.values():
            setattr(self, name, nn.ConvTranspose2d(HEAD_DIM, n, 4, stride=2, padding=1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """-> {chart: [N, n, 4x, 4x]}: the transposed conv, then bilinear x2."""
        out = {}
        for key, (name, _) in CHARTS.items():
            y = getattr(self, name)(x)
            out[key] = resize(y, (2 * y.shape[2], 2 * y.shape[3]))
        return out


class ROIHeads(nn.Module):
    def __init__(self):
        super().__init__()
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor()
        self.decoder = Decoder()
        self.densepose_head = DeepLabHead()
        self.densepose_predictor = ChartPredictor()


class DensePoseRCNN(nn.Module):
    """The modules of the detectron2 checkpoint under its key names;
    ``DenseposeDetector`` runs them stage by stage."""

    def __init__(self, stages: Sequence[int] = R101_STAGES):
        super().__init__()
        self.backbone = FPN(stages)
        self.proposal_generator = ProposalGenerator()
        self.roi_heads = ROIHeads()

    def trunk(self, x):
        """x [1, 3, H, W] -> (p2..p6, the RPN's (objectness, deltas) a level)."""
        ps = self.backbone(x)
        return ps, self.proposal_generator.rpn_head(ps)

    def box_head(self, pooled):
        """pooled [N, C, 7, 7] -> (person scores [N], deltas [N, 4])."""
        h = self.roi_heads.box_head
        p = self.roi_heads.box_predictor
        x = F.relu(h.fc2(F.relu(h.fc1(pooled.flatten(1)))))
        return torch.softmax(p.cls_score(x), dim=-1)[:, 0], p.bbox_pred(x)

    def chart_head(self, pooled):
        """pooled [N, DECODER_CLASSES, 28, 28] -> {chart: [N, n, 112, 112]}."""
        return self.roi_heads.densepose_predictor(self.roi_heads.densepose_head(pooled))


def unread_keys(sd: Dict[str, torch.Tensor], model: nn.Module) -> List[str]:
    """The keys of file `sd` (BatchNorms folded) that `model` does not hold."""
    return sorted(set(sd) - set(model.state_dict()))


# ---------------------------------------------------------------------------
# anchors, boxes, NMS (host numpy, as JAX's)
# ---------------------------------------------------------------------------

def level_anchors(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """detectron2 DefaultAnchorGenerator: centered at pixel*stride (offset
    0.0), XYXY. Returns [H*W*A, 4], A ordered by aspect ratio."""
    base = []
    area = float(size * size)
    for ar in ASPECT_RATIOS:
        bw = np.sqrt(area / ar)
        bh = ar * bw
        base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
    base = np.asarray(base, np.float32)  # [A, 4]
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_deltas(anchors: np.ndarray, deltas: np.ndarray,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """Box2BoxTransform.apply_deltas (detectron2 box_regression.py)."""
    wx, wy, ww, wh = weights
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    dx, dy, dw, dh = deltas[:, 0] / wx, deltas[:, 1] / wy, deltas[:, 2] / ww, deltas[:, 3] / wh
    clip = np.log(1000.0 / 16)
    dw, dh = np.minimum(dw, clip), np.minimum(dh, clip)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = np.exp(dw) * aw
    h = np.exp(dh) * ah
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy IoU NMS; returns kept indices sorted by score."""
    order = np.argsort(-scores)
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= thresh]
    return np.asarray(keep, np.int64)


def rpn_proposals(rpn_outs, strides, img_hw) -> Tuple[np.ndarray, np.ndarray]:
    """find_top_rpn_proposals (inference): per-level topk -> decode -> clip
    -> per-level NMS (batched via level offset) -> global top-1000.
    `rpn_outs`: (objectness [B,H,W,A], deltas [B,H,W,4A]) numpy a level."""
    all_boxes, all_scores, all_levels = [], [], []
    for lvl, ((obj, deltas), stride, size) in enumerate(
        zip(rpn_outs, strides, ANCHOR_SIZES)
    ):
        h, w = obj.shape[1], obj.shape[2]
        a = len(ASPECT_RATIOS)
        # [B,H,W,A] -> [H*W*A] (batch 1); anchors are HWA-ordered
        scores = np.asarray(obj, np.float32)[0].reshape(-1)
        dl = np.asarray(deltas, np.float32)[0].reshape(h * w, a, 4).reshape(-1, 4)
        anchors = level_anchors(h, w, stride, size)
        k = min(PRE_NMS_TOPK, scores.size)
        top = np.argpartition(-scores, k - 1)[:k]
        boxes = decode_deltas(anchors[top], dl[top])
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, img_hw[1])
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, img_hw[0])
        all_boxes.append(boxes)
        all_scores.append(scores[top])
        all_levels.append(np.full(k, lvl))
    boxes = np.concatenate(all_boxes)
    scores = np.concatenate(all_scores)
    levels = np.concatenate(all_levels)
    # batched NMS: offset boxes by level so levels never suppress each other
    offset = levels[:, None] * (max(img_hw) + 1)
    keep = nms(boxes + offset, scores, RPN_NMS_THRESH)[:POST_NMS_TOPK]
    return boxes[keep], scores[keep]


def assign_levels(boxes: np.ndarray, k_min=2, k_max=5) -> np.ndarray:
    """FPN ROI level assignment (poolers.py: floor(4 + log2(sqrt(area)/224)))."""
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0
    )
    lv = np.floor(4 + np.log2(np.sqrt(areas) / 224 + 1e-8))
    return np.clip(lv, k_min, k_max).astype(np.int64)


# ---------------------------------------------------------------------------
# ROIAlign v1 (aligned=False, POOLER_TYPE 'ROIAlign' in both yamls)
# ---------------------------------------------------------------------------

def roi_align(feat: torch.Tensor, boxes: torch.Tensor, scale: float, out_size: int,
              sampling: int = 2) -> torch.Tensor:
    """feat [1, C, H, W]; boxes [N, 4] XYXY image coords -> [N, C, out, out]:
    torchvision's roi_align(aligned=False) arithmetic as JAX's, by gathers
    on an NHWC view of `feat`."""
    n = boxes.shape[0]
    h, w = feat.shape[2], feat.shape[3]
    f = feat[0].permute(1, 2, 0)  # [H, W, C]
    x1, y1, x2, y2 = (boxes[:, i] * scale for i in range(4))
    bin_w = torch.clamp(x2 - x1, min=1.0) / out_size
    bin_h = torch.clamp(y2 - y1, min=1.0) / out_size
    idx = (torch.arange(out_size * sampling, dtype=feat.dtype, device=feat.device)
           + 0.5) / sampling
    xs = x1[:, None] + idx[None, :] * bin_w[:, None]
    ys = y1[:, None] + idx[None, :] * bin_h[:, None]
    s = idx.shape[0]
    yq = ys[:, :, None].expand(n, s, s)
    xq = xs[:, None, :].expand(n, s, s)
    # torchvision: out-of-range (< -1 or > size) -> 0; clamp to the edges
    valid = (yq > -1.0) & (yq < h) & (xq > -1.0) & (xq < w)
    yq = yq.clamp(0.0, h - 1)
    xq = xq.clamp(0.0, w - 1)
    y0, x0 = yq.floor(), xq.floor()
    wy, wx = (yq - y0)[..., None], (xq - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    y1i, x1i = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    v = (f[y0, x0] * ((1 - wy) * (1 - wx)) + f[y0, x1i] * ((1 - wy) * wx)
         + f[y1i, x0] * (wy * (1 - wx)) + f[y1i, x1i] * (wy * wx))
    v = v * valid[..., None]
    c = v.shape[-1]
    v = v.reshape(n, out_size, sampling, out_size, sampling, c).mean(dim=(2, 4))
    return v.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# detector
# ---------------------------------------------------------------------------

class DenseposeDetector:
    """RGB uint8 -> the fine-segmentation visualization (viridis over
    black), the reference's output contract
    (annotator/densepose/__init__.py:33-43), on `device`.

    `state_dict`: DensePoseRCNN's tensors (BatchNorms folded); default
    model_final_844d15.pkl in `ckpt_dir` (``download.ckpts_dir()``)."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None,
                 stages: Sequence[int] = R101_STAGES):
        if state_dict is None:
            path = ensure_ckpt(FILE, os.path.join(ckpt_dir or ckpts_dir(), FILE))
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"DensePose weights not found: {path}; place {FILE} (published at "
                    "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_"
                    f"R_101_FPN_DL_s1x/165712116/{FILE}) there")
            state_dict = fold_batchnorms({k: torch.from_numpy(v.astype(np.float32))
                                          for k, v in read_pkl(path).items()})
            with torch.device("meta"):
                unread = unread_keys(state_dict, DensePoseRCNN(stages))
            if unread:
                log.warning("densepose: %d keys of %s are not read: %s", len(unread), path,
                            ", ".join(unread))
            state_dict = {k: v for k, v in state_dict.items() if k not in unread}
        self.model = nets.build(lambda: DensePoseRCNN(stages), state_dict, "densepose",
                                device)
        self.device = nets.device_of(self.model)

    # -- stages -------------------------------------------------------------
    @staticmethod
    def prepare(img_rgb: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
        """The resized (short side MIN_SIZE_TEST, long at most MAX_SIZE_TEST,
        PIL bilinear), BGR mean-subtracted image padded to a multiple of 32
        [1, H, W, 3], and the resized (h, w)."""
        from PIL import Image

        h0, w0 = img_rgb.shape[:2]
        scale = MIN_SIZE_TEST / min(h0, w0)
        nh, nw = int(h0 * scale + 0.5), int(w0 * scale + 0.5)
        if max(nh, nw) > MAX_SIZE_TEST:
            s2 = MAX_SIZE_TEST / max(nh, nw)
            nh, nw = int(nh * s2 + 0.5), int(nw * s2 + 0.5)
        resized = np.asarray(
            Image.fromarray(img_rgb).resize((nw, nh), Image.BILINEAR), np.float32
        )
        bgr = resized[:, :, ::-1] - PIXEL_MEAN
        x = np.pad(bgr, ((0, (-nh) % 32), (0, (-nw) % 32), (0, 0)))[None]
        return np.ascontiguousarray(x, np.float32), (nh, nw)

    @torch.inference_mode()
    def trunk(self, x: np.ndarray):
        """-> (p2..p6 [1, C, h, w] on the device, the RPN's (objectness,
        deltas) a level as NHWC numpy)."""
        t = torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2)
        with fp32_exact():
            ps, rpn = self.model.trunk(t)
        nhwc = lambda y: y.permute(0, 2, 3, 1).cpu().numpy()
        return ps, [(nhwc(o), nhwc(d)) for o, d in rpn]

    @torch.inference_mode()
    def box_scores(self, ps, proposals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The box head over each proposal, pooled from its FPN level ->
        (person scores [N], deltas [N, 4]) on the host."""
        levels = assign_levels(proposals)
        boxes = torch.from_numpy(proposals.astype(np.float32)).to(self.device)
        pooled = torch.zeros((len(proposals), ps[0].shape[1], POOL_BOX, POOL_BOX),
                             device=self.device)
        with fp32_exact():
            for lv in np.unique(levels):
                sel = torch.from_numpy(np.where(levels == lv)[0]).to(self.device)
                pooled[sel] = roi_align(ps[lv - 2], boxes[sel], 1.0 / STRIDES[lv - 2],
                                        POOL_BOX, 2)
            scores, deltas = self.model.box_head(pooled)
        return scores.cpu().numpy(), deltas.cpu().numpy()

    @staticmethod
    def select(proposals, scores, deltas, hw) -> np.ndarray:
        """The person boxes: the deltas applied (weights 10, 10, 5, 5),
        clipped, score > SCORE_THRESH, NMS BOX_NMS_THRESH, at most MAX_DET."""
        nh, nw = hw
        boxes = decode_deltas(proposals, deltas, weights=(10, 10, 5, 5))
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, nw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, nh)
        keep = scores > SCORE_THRESH
        boxes, scores = boxes[keep], scores[keep]
        if not len(boxes):
            return np.zeros((0, 4), np.float32)
        return boxes[nms(boxes, scores, BOX_NMS_THRESH)[:MAX_DET]]

    @torch.inference_mode()
    def charts(self, ps, boxes: np.ndarray) -> Dict[str, torch.Tensor]:
        """The decoder over p2..p5, ROIAlign 28x28 at each box, the chart
        head -> {chart: [N, n, 112, 112]} on the device."""
        with fp32_exact():
            dec = self.model.roi_heads.decoder(ps)
            pooled = roi_align(dec, torch.from_numpy(boxes.astype(np.float32)).to(self.device),
                               0.25, POOL_CHART, 2)
            return self.model.chart_head(pooled)

    def detect(self, img_rgb: np.ndarray):
        """-> (boxes [N, 4] in the resized image, {chart: [N, n, 112, 112]}
        or None, the resized (h, w))."""
        x, hw = self.prepare(img_rgb)
        ps, rpn = self.trunk(x)
        proposals, _ = rpn_proposals(rpn, STRIDES, hw)
        if not len(proposals):
            return np.zeros((0, 4), np.float32), None, hw
        boxes = self.select(proposals, *self.box_scores(ps, proposals), hw)
        if not len(boxes):
            return boxes, None, hw
        return boxes, self.charts(ps, boxes), hw

    @staticmethod
    def part_labels(charts: Dict[str, torch.Tensor]) -> np.ndarray:
        """[N, 112, 112] uint8: the fine segmentation's argmax where the
        coarse segmentation says foreground."""
        labels = charts["fine_segm"].argmax(1) * (charts["coarse_segm"].argmax(1) > 0)
        return labels.to(torch.uint8).cpu().numpy()

    @staticmethod
    def draw(boxes: np.ndarray, labels: np.ndarray, hw, out_hw) -> np.ndarray:
        """Each box's part labels, resized to the box (nearest), viridis on
        a viridis(0) canvas of the resized image, then resized back to
        `out_hw` (bilinear) and BGR -> RGB."""
        nh, nw = hw
        canvas = cv2.applyColorMap(np.zeros((nh, nw), np.uint8), cv2.COLORMAP_VIRIDIS)
        for box, lab in zip(boxes, labels):
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            x2, y2 = min(x2, nw), min(y2, nh)
            if x2 <= x1 or y2 <= y1:
                continue
            lab = cv2.resize(lab, (x2 - x1, y2 - y1), interpolation=cv2.INTER_NEAREST)
            vis = cv2.applyColorMap(
                (lab.astype(np.float32) * (255.0 / N_PART_LABELS)).clip(0, 255)
                .astype(np.uint8), cv2.COLORMAP_VIRIDIS)
            region = canvas[y1:y2, x1:x2]
            mask = lab > 0
            region[mask] = vis[mask]
        out = cv2.resize(canvas, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
        return out[:, :, ::-1]  # BGR colormap canvas -> RGB

    def __call__(self, img_rgb: np.ndarray) -> np.ndarray:
        boxes, charts, hw = self.detect(img_rgb)
        labels = self.part_labels(charts) if charts is not None else []
        return self.draw(boxes, labels, hw, img_rgb.shape[:2])
