"""OpenPose CNNs: body, hand and face (counterpart of
``ctrlora_tpu/annotators/openpose/models.py``; reference
annotator/openpose/model.py and face.py:12-229).

The reference nets are VGG-style conv stacks built from OrderedDict specs,
and the published files (body_pose_model.pth, hand_pose_model.pth,
facenet.pth) hold their convs under flat names (``conv1_1.weight``,
``Mconv7_stage6_L2.bias``). The specs below are the JAX package's: a spec is
a list of (name, cfg), cfg = [in, out, k, stride, pad] for a conv or [k,
stride, pad] for a max pool (floor mode). Each network holds its convs as
attributes under those flat names, so a file loads with
``load_state_dict``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _conv_spec(pairs):
    return [(n, list(v)) for n, v in pairs]


BODY_BLOCK0 = _conv_spec([
    ("conv1_1", [3, 64, 3, 1, 1]), ("conv1_2", [64, 64, 3, 1, 1]),
    ("pool1_stage1", [2, 2, 0]),
    ("conv2_1", [64, 128, 3, 1, 1]), ("conv2_2", [128, 128, 3, 1, 1]),
    ("pool2_stage1", [2, 2, 0]),
    ("conv3_1", [128, 256, 3, 1, 1]), ("conv3_2", [256, 256, 3, 1, 1]),
    ("conv3_3", [256, 256, 3, 1, 1]), ("conv3_4", [256, 256, 3, 1, 1]),
    ("pool3_stage1", [2, 2, 0]),
    ("conv4_1", [256, 512, 3, 1, 1]), ("conv4_2", [512, 512, 3, 1, 1]),
    ("conv4_3_CPM", [512, 256, 3, 1, 1]), ("conv4_4_CPM", [256, 128, 3, 1, 1]),
])


def body_stage1(L):
    ch = 38 if L == 1 else 19
    return _conv_spec([
        (f"conv5_1_CPM_L{L}", [128, 128, 3, 1, 1]),
        (f"conv5_2_CPM_L{L}", [128, 128, 3, 1, 1]),
        (f"conv5_3_CPM_L{L}", [128, 128, 3, 1, 1]),
        (f"conv5_4_CPM_L{L}", [128, 512, 1, 1, 0]),
        (f"conv5_5_CPM_L{L}", [512, ch, 1, 1, 0]),
    ])


def body_stageN(i, L):
    ch = 38 if L == 1 else 19
    return _conv_spec([
        (f"Mconv1_stage{i}_L{L}", [185, 128, 7, 1, 3]),
        (f"Mconv2_stage{i}_L{L}", [128, 128, 7, 1, 3]),
        (f"Mconv3_stage{i}_L{L}", [128, 128, 7, 1, 3]),
        (f"Mconv4_stage{i}_L{L}", [128, 128, 7, 1, 3]),
        (f"Mconv5_stage{i}_L{L}", [128, 128, 7, 1, 3]),
        (f"Mconv6_stage{i}_L{L}", [128, 128, 1, 1, 0]),
        (f"Mconv7_stage{i}_L{L}", [128, ch, 1, 1, 0]),
    ])


# NB: the reference's no_relu_layers list (model.py:29-32) repeats
# 'Mconv7_stage6_L1' instead of listing 'Mconv7_stage6_L2', so the final
# heatmap head DOES get a ReLU there — reproduced bit-for-bit here
BODY_NO_RELU = {
    "conv5_5_CPM_L1", "conv5_5_CPM_L2",
    *{f"Mconv7_stage{i}_L{L}" for i in range(2, 7) for L in (1, 2)},
} - {"Mconv7_stage6_L2"}

HAND_BLOCK1_0 = _conv_spec([
    ("conv1_1", [3, 64, 3, 1, 1]), ("conv1_2", [64, 64, 3, 1, 1]),
    ("pool1_stage1", [2, 2, 0]),
    ("conv2_1", [64, 128, 3, 1, 1]), ("conv2_2", [128, 128, 3, 1, 1]),
    ("pool2_stage1", [2, 2, 0]),
    ("conv3_1", [128, 256, 3, 1, 1]), ("conv3_2", [256, 256, 3, 1, 1]),
    ("conv3_3", [256, 256, 3, 1, 1]), ("conv3_4", [256, 256, 3, 1, 1]),
    ("pool3_stage1", [2, 2, 0]),
    ("conv4_1", [256, 512, 3, 1, 1]), ("conv4_2", [512, 512, 3, 1, 1]),
    ("conv4_3", [512, 512, 3, 1, 1]), ("conv4_4", [512, 512, 3, 1, 1]),
    ("conv5_1", [512, 512, 3, 1, 1]), ("conv5_2", [512, 512, 3, 1, 1]),
    ("conv5_3_CPM", [512, 128, 3, 1, 1]),
])

HAND_BLOCK1_1 = _conv_spec([
    ("conv6_1_CPM", [128, 512, 1, 1, 0]), ("conv6_2_CPM", [512, 22, 1, 1, 0]),
])


def hand_stageN(i):
    return _conv_spec([
        (f"Mconv1_stage{i}", [150, 128, 7, 1, 3]),
        (f"Mconv2_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv3_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv4_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv5_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv6_stage{i}", [128, 128, 1, 1, 0]),
        (f"Mconv7_stage{i}", [128, 22, 1, 1, 0]),
    ])


HAND_NO_RELU = {"conv6_2_CPM", *{f"Mconv7_stage{i}" for i in range(2, 7)}}

FACE_BASE = _conv_spec([
    ("conv1_1", [3, 64, 3, 1, 1]), ("conv1_2", [64, 64, 3, 1, 1]),
    ("pool1", [2, 2, 0]),
    ("conv2_1", [64, 128, 3, 1, 1]), ("conv2_2", [128, 128, 3, 1, 1]),
    ("pool2", [2, 2, 0]),
    ("conv3_1", [128, 256, 3, 1, 1]), ("conv3_2", [256, 256, 3, 1, 1]),
    ("conv3_3", [256, 256, 3, 1, 1]), ("conv3_4", [256, 256, 3, 1, 1]),
    ("pool3", [2, 2, 0]),
    ("conv4_1", [256, 512, 3, 1, 1]), ("conv4_2", [512, 512, 3, 1, 1]),
    ("conv4_3", [512, 512, 3, 1, 1]), ("conv4_4", [512, 512, 3, 1, 1]),
    ("conv5_1", [512, 512, 3, 1, 1]), ("conv5_2", [512, 512, 3, 1, 1]),
    ("conv5_3_CPM", [512, 128, 3, 1, 1]),
])

FACE_STAGE1 = _conv_spec([
    ("conv6_1_CPM", [128, 512, 1, 1, 0]), ("conv6_2_CPM", [512, 71, 1, 1, 0]),
])


def face_stageN(i):
    return _conv_spec([
        (f"Mconv1_stage{i}", [199, 128, 7, 1, 3]),
        (f"Mconv2_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv3_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv4_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv5_stage{i}", [128, 128, 7, 1, 3]),
        (f"Mconv6_stage{i}", [128, 128, 1, 1, 0]),
        (f"Mconv7_stage{i}", [128, 71, 1, 1, 0]),
    ])


FACE_NO_RELU = {"conv6_2_CPM", *{f"Mconv7_stage{i}" for i in range(2, 7)}}


class SpecNet(nn.Module):
    """The convs of `specs` under their flat names."""

    def __init__(self, specs: Sequence):
        super().__init__()
        for spec in specs:
            for name, v in spec:
                if "pool" not in name:
                    cin, cout, k, s, p = v
                    self.add_module(name, nn.Conv2d(cin, cout, k, s, p))

    def run(self, x: torch.Tensor, spec, no_relu) -> torch.Tensor:
        """A conv / pool spec over [B, C, H, W]."""
        for name, v in spec:
            if "pool" in name:
                k, s, p = v
                x = F.max_pool2d(x, k, s, p)
            else:
                x = getattr(self, name)(x)
                if name not in no_relu:
                    x = F.relu(x)
        return x


BODY_SPECS = [BODY_BLOCK0, body_stage1(1), body_stage1(2)] + [
    body_stageN(i, L) for i in range(2, 7) for L in (1, 2)]
HAND_SPECS = [HAND_BLOCK1_0, HAND_BLOCK1_1] + [hand_stageN(i) for i in range(2, 7)]
FACE_SPECS = [FACE_BASE, FACE_STAGE1] + [face_stageN(i) for i in range(2, 7)]


class BodyNet(SpecNet):
    """x [B, 3, H, W] -> (PAFs [B, 38, H/8, W/8], heatmaps [B, 19, H/8, W/8])."""

    def __init__(self):
        super().__init__(BODY_SPECS)

    def forward(self, x):
        out1 = self.run(x, BODY_BLOCK0, BODY_NO_RELU)
        o1 = self.run(out1, body_stage1(1), BODY_NO_RELU)
        o2 = self.run(out1, body_stage1(2), BODY_NO_RELU)
        for i in range(2, 7):
            h = torch.cat([o1, o2, out1], dim=1)
            o1 = self.run(h, body_stageN(i, 1), BODY_NO_RELU)
            o2 = self.run(h, body_stageN(i, 2), BODY_NO_RELU)
        return o1, o2


class HandNet(SpecNet):
    """x [B, 3, H, W] -> heatmaps [B, 22, H/8, W/8]."""

    def __init__(self):
        super().__init__(HAND_SPECS)

    def forward(self, x):
        out1_0 = self.run(x, HAND_BLOCK1_0, HAND_NO_RELU)
        h = self.run(out1_0, HAND_BLOCK1_1, HAND_NO_RELU)
        for i in range(2, 7):
            h = self.run(torch.cat([h, out1_0], dim=1), hand_stageN(i), HAND_NO_RELU)
        return h


class FaceNet(SpecNet):
    """x [B, 3, H, W] -> the last stage's heatmaps [B, 71, H/8, W/8]."""

    def __init__(self):
        super().__init__(FACE_SPECS)

    def forward(self, x):
        feat = self.run(x, FACE_BASE, FACE_NO_RELU)
        h = self.run(feat, FACE_STAGE1, FACE_NO_RELU)
        for i in range(2, 7):
            h = self.run(torch.cat([h, feat], dim=1), face_stageN(i), FACE_NO_RELU)
        return h
