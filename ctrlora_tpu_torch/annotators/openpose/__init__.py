"""OpenPose detector (counterpart of ``ctrlora_tpu/annotators/openpose``;
reference annotator/openpose/__init__.py): the body pose, optionally the
hands and the face, drawn on a black canvas.

The three networks (``models.py``) run on the detector's device in fp32; the
resizes, the peak finding and limb matching (``decode.py``) and the drawing
run on the host in numpy and cv2, as in the JAX package. ``Body`` runs one
scale (0.5 x 368 px high), ``Hand`` four (0.5 to 2 x 368 px square) and
``Face`` 384 px. Each net reads its published file (body_pose_model.pth,
hand_pose_model.pth, facenet.pth) from the checkpoint directory, else takes
torch's initialisation under ``nets.INIT_SEED``.
"""

from __future__ import annotations

import colorsys
import math
from typing import Optional

import cv2
import numpy as np

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.openpose import decode, models

EPS = 0.01
STRIDE, PAD_VALUE = 8, 128
HAND_SCALES = (0.5, 1.0, 1.5, 2.0)
HAND_WSIZE = 128
FACE_SIZE = 384

BODY_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]

HAND_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8], [0, 9],
    [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15], [15, 16],
    [0, 17], [17, 18], [18, 19], [19, 20],
]


def smart_resize(x, s):
    Ht, Wt = s
    Ho, Wo = x.shape[:2]
    k = float(Ht + Wt) / float(Ho + Wo)
    interp = cv2.INTER_AREA if k < 1 else cv2.INTER_LANCZOS4
    if x.ndim == 2 or x.shape[2] in (1, 3):
        return cv2.resize(x, (int(Wt), int(Ht)), interpolation=interp)
    return np.stack([cv2.resize(x[:, :, i], (int(Wt), int(Ht)), interpolation=interp)
                     for i in range(x.shape[2])], axis=2)


def pad_right_down(img, stride, pad_value):
    h, w = img.shape[:2]
    pad_d = 0 if h % stride == 0 else stride - h % stride
    pad_r = 0 if w % stride == 0 else stride - w % stride
    out = np.pad(img, ((0, pad_d), (0, pad_r), (0, 0)), constant_values=pad_value)
    return out, (0, 0, pad_d, pad_r)


def draw_bodypose(canvas, candidate, subset):
    H, W = canvas.shape[:2]
    candidate = np.asarray(candidate)
    subset = np.asarray(subset)
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][np.array(decode.LIMB_SEQ[i]) - 1]
            if -1 in index:
                continue
            Y = candidate[index.astype(int), 0] * float(W)
            X = candidate[index.astype(int), 1] * float(H)
            mX, mY = X.mean(), Y.mean()
            length = math.hypot(X[0] - X[1], Y[0] - Y[1])
            angle = math.degrees(math.atan2(X[0] - X[1], Y[0] - Y[1]))
            poly = cv2.ellipse2Poly((int(mY), int(mX)), (int(length / 2), 4), int(angle),
                                    0, 360, 1)
            cv2.fillConvexPoly(canvas, poly, BODY_COLORS[i])
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            cv2.circle(canvas, (int(x * W), int(y * H)), 4, BODY_COLORS[i], -1)
    return canvas


def draw_handpose(canvas, all_hand_peaks):
    H, W = canvas.shape[:2]
    for peaks in all_hand_peaks:
        peaks = np.asarray(peaks)
        for ie, e in enumerate(HAND_EDGES):
            x1, y1 = peaks[e[0]]
            x2, y2 = peaks[e[1]]
            x1, y1, x2, y2 = int(x1 * W), int(y1 * H), int(x2 * W), int(y2 * H)
            if min(x1, y1, x2, y2) > EPS:
                rgb = colorsys.hsv_to_rgb(ie / len(HAND_EDGES), 1.0, 1.0)
                cv2.line(canvas, (x1, y1), (x2, y2), tuple(int(c * 255) for c in rgb), 2)
        for x, y in peaks:
            x, y = int(x * W), int(y * H)
            if x > EPS and y > EPS:
                cv2.circle(canvas, (x, y), 4, (0, 0, 255), -1)
    return canvas


def draw_facepose(canvas, all_lmks):
    H, W = canvas.shape[:2]
    for lmks in all_lmks:
        for x, y in np.asarray(lmks):
            x, y = int(x * W), int(y * H)
            if x > EPS and y > EPS:
                cv2.circle(canvas, (x, y), 3, (255, 255, 255), -1)
    return canvas


def draw_pose(pose, H, W, draw_body=True, draw_hand=True, draw_face=True):
    canvas = np.zeros((H, W, 3), np.uint8)
    if draw_body:
        canvas = draw_bodypose(canvas, pose["bodies"]["candidate"], pose["bodies"]["subset"])
    if draw_hand:
        canvas = draw_handpose(canvas, pose["hands"])
    if draw_face:
        canvas = draw_facepose(canvas, pose["faces"])
    return canvas


def read_flat(name: str, ckpt_dir: Optional[str]):
    """A published OpenPose file's tensors under their flat conv names
    ('module.' and any Sequential prefix dropped, as JAX's ``convert_flat``
    does), or None where the file is absent."""
    sd = nets.read_weights(name, ckpt_dir, strip_module=True)
    return None if sd is None else {".".join(k.split(".")[-2:]): v for k, v in sd.items()}


def net_input(img: np.ndarray) -> np.ndarray:
    """A uint8 HWC image as the nets take it: [1, H, W, 3] float32 /256 - 0.5."""
    return img[None].astype(np.float32) / 256.0 - 0.5


def unpad_resize(m: np.ndarray, padded_hw, pad, out_hw) -> np.ndarray:
    """A net's stride-8 map up-sampled to the padded input, cropped of the
    padding and resized to `out_hw`."""
    m = smart_resize(m, (m.shape[0] * STRIDE, m.shape[1] * STRIDE))
    m = m[: padded_hw[0] - pad[2], : padded_hw[1] - pad[3]]
    return smart_resize(m, out_hw)


class Body:
    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = read_flat("body_pose_model.pth", ckpt_dir)
        self.model = nets.build(models.BodyNet, state_dict, "openpose body", device)

    def maps(self, ori_img):
        """(heatmaps [H, W, 19], PAFs [H, W, 38]) of a uint8 BGR image at
        one scale (0.5 x 368 px high), back at the image's size."""
        H, W = ori_img.shape[:2]
        scale = 0.5 * 368 / H
        img = smart_resize(ori_img, (int(H * scale), int(W * scale)))
        padded, pad = pad_right_down(img, STRIDE, PAD_VALUE)
        paf, hm = (t[0].permute(1, 2, 0).numpy()
                   for t in nets.forward(self.model, net_input(padded)))
        return (unpad_resize(hm, padded.shape, pad, (H, W)),
                unpad_resize(paf, padded.shape, pad, (H, W)))

    def __call__(self, ori_img, thre1=0.1, thre2=0.05):
        """(candidate [N, 4], subset [P, 20]) (reference body.py:24-64)."""
        return decode.body_decode(*self.maps(ori_img), thre1, thre2)


class Hand:
    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = read_flat("hand_pose_model.pth", ckpt_dir)
        self.model = nets.build(models.HandNet, state_dict, "openpose hand", device)

    def heatmap(self, ori_img, scales=HAND_SCALES):
        """The [128, 128, 22] heatmaps of a BGR hand crop, averaged over the
        scales (reference hand.py:24-63)."""
        blur = cv2.GaussianBlur(ori_img, (0, 0), 0.8)
        heat = np.zeros((HAND_WSIZE, HAND_WSIZE, 22), np.float32)
        for s in scales:
            size = int(s * 368)
            padded, pad = pad_right_down(smart_resize(blur, (size, size)), STRIDE, PAD_VALUE)
            hm = nets.forward(self.model, net_input(padded))[0].permute(1, 2, 0).numpy()
            heat += unpad_resize(hm, padded.shape, pad, (HAND_WSIZE, HAND_WSIZE)) / len(scales)
        return heat

    def __call__(self, ori_img, scales=HAND_SCALES):
        """21 peaks [21, 2] in the crop's pixels (reference hand.py:65-91)."""
        return decode.hand_peaks(self.heatmap(ori_img, scales), ori_img.shape[:2])


class Face:
    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = read_flat("facenet.pth", ckpt_dir)
        self.model = nets.build(models.FaceNet, state_dict, "openpose face", device)

    def __call__(self, face_img):
        """The [71, H, W] heatmaps of a BGR face crop, the net at 384 px
        (reference face.py:331-346)."""
        H, W = face_img.shape[:2]
        x = net_input(smart_resize(face_img, (FACE_SIZE, FACE_SIZE)))
        hm = nets.forward(self.model, x)[0].permute(1, 2, 0).numpy()
        return np.transpose(smart_resize(hm, (H, W)), (2, 0, 1))


class OpenposeDetector:
    def __init__(self, device="cuda", ckpt_dir: Optional[str] = None):
        self.body = Body(device=device, ckpt_dir=ckpt_dir)
        self.hand = Hand(device=device, ckpt_dir=ckpt_dir)
        self.face = Face(device=device, ckpt_dir=ckpt_dir)

    def __call__(self, ori_img, hand_and_face=False, return_is_index=False):
        ori_img = ori_img[:, :, ::-1].copy()  # the reference feeds BGR
        H, W = ori_img.shape[:2]
        candidate, subset = self.body(ori_img)
        hands, faces = [], []
        if hand_and_face:
            for x, y, w, is_left in decode.hand_detect(candidate, subset, (H, W)):
                peaks = self.hand(ori_img[y: y + w, x: x + w]).astype(np.float32)
                if peaks.ndim == 2 and peaks.shape[1] == 2:
                    peaks[:, 0] = np.where(peaks[:, 0] < 1e-6, -1, peaks[:, 0] + x) / W
                    peaks[:, 1] = np.where(peaks[:, 1] < 1e-6, -1, peaks[:, 1] + y) / H
                    hands.append(peaks.tolist())
            for x, y, w in decode.face_detect(candidate, subset, (H, W)):
                peaks = decode.face_peaks(self.face(ori_img[y: y + w, x: x + w]))
                peaks = peaks.astype(np.float32)
                if peaks.ndim == 2 and peaks.shape[1] == 2:
                    peaks[:, 0] = np.where(peaks[:, 0] < 1e-6, -1, peaks[:, 0] + x) / W
                    peaks[:, 1] = np.where(peaks[:, 1] < 1e-6, -1, peaks[:, 1] + y) / H
                    faces.append(peaks.tolist())
        if candidate.ndim == 2 and candidate.shape[1] == 4:
            candidate = candidate[:, :2].copy()
            candidate[:, 0] /= W
            candidate[:, 1] /= H
        pose = dict(bodies=dict(candidate=candidate.tolist(), subset=subset.tolist()),
                    hands=hands, faces=faces)
        if return_is_index:
            return pose
        return draw_pose(pose, H, W)
