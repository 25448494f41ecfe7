"""OpenPose decoding: peak finding, PAF limb matching and person assembly
(the port's copy of ``ctrlora_tpu/annotators/openpose/decode.py``; given the
same maps it gives the same results bit for bit).

Host-side numpy of the standard CMU algorithm as the reference uses it
(annotator/openpose/body.py:66-213, hand.py:37-91, face.py:348-363,
util.py:155-290), every threshold and ratio kept. ``match_limbs`` is
quadratic in the peaks of a limb's two parts, in Python.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import cv2
import numpy as np
from scipy.ndimage import gaussian_filter

LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
           [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
           [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38], [45, 46]]


def find_peaks(heatmap: np.ndarray, thre1: float = 0.1):
    """Per-part local maxima with scores and global ids
    (body.py:80-103)."""
    all_peaks = []
    counter = 0
    for part in range(18):
        map_ori = heatmap[:, :, part]
        hm = gaussian_filter(map_ori, sigma=3)
        left = np.zeros_like(hm); left[1:, :] = hm[:-1, :]
        right = np.zeros_like(hm); right[:-1, :] = hm[1:, :]
        up = np.zeros_like(hm); up[:, 1:] = hm[:, :-1]
        down = np.zeros_like(hm); down[:, :-1] = hm[:, 1:]
        binary = np.logical_and.reduce(
            (hm >= left, hm >= right, hm >= up, hm >= down, hm > thre1)
        )
        ys, xs = np.nonzero(binary)
        peaks = [
            (int(x), int(y), float(map_ori[y, x]), counter + i)
            for i, (x, y) in enumerate(zip(xs, ys))
        ]
        counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def match_limbs(all_peaks, paf: np.ndarray, ori_h: int, thre2: float = 0.05,
                mid_num: int = 10):
    """Greedy PAF line-integral matching (body.py:110-149)."""
    connection_all = []
    special_k = []
    for k in range(len(MAP_IDX)):
        score_mid = paf[:, :, [x - 19 for x in MAP_IDX[k]]]
        candA = all_peaks[LIMB_SEQ[k][0] - 1]
        candB = all_peaks[LIMB_SEQ[k][1] - 1]
        if not candA or not candB:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(candA):
            for j, b in enumerate(candB):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(1e-3, math.sqrt(vec[0] ** 2 + vec[1] ** 2))
                vec = vec / norm
                xs = np.linspace(a[0], b[0], mid_num)
                ys = np.linspace(a[1], b[1], mid_num)
                vx = np.array([
                    score_mid[int(round(ys[t])), int(round(xs[t])), 0]
                    for t in range(mid_num)
                ])
                vy = np.array([
                    score_mid[int(round(ys[t])), int(round(xs[t])), 1]
                    for t in range(mid_num)
                ])
                score_midpts = vx * vec[0] + vy * vec[1]
                score = score_midpts.mean() + min(0.5 * ori_h / norm - 1, 0)
                if (np.count_nonzero(score_midpts > thre2) > 0.8 * mid_num
                        and score > 0):
                    candidates.append([i, j, score, score + a[2] + b[2]])
        candidates.sort(key=lambda x: x[2], reverse=True)
        connection = np.zeros((0, 5))
        for i, j, s, _ in candidates:
            if i not in connection[:, 3] and j not in connection[:, 4]:
                connection = np.vstack(
                    [connection, [candA[i][3], candB[j][3], s, i, j]]
                )
                if len(connection) >= min(len(candA), len(candB)):
                    break
        connection_all.append(connection)
    return connection_all, special_k


def assemble_people(all_peaks, connection_all, special_k):
    """Merge limb connections into per-person keypoint sets
    (body.py:155-205). Returns (candidate [N,4], subset [P,20])."""
    subset = -1 * np.ones((0, 20))
    candidate = np.array([p for part in all_peaks for p in part], np.float64).reshape(-1, 4)
    for k in range(len(MAP_IDX)):
        if k in special_k:
            continue
        partAs = connection_all[k][:, 0]
        partBs = connection_all[k][:, 1]
        indexA, indexB = np.array(LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][indexA] == partAs[i] or subset[j][indexB] == partBs[i]:
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][indexB] != partBs[i]:
                    subset[j][indexB] = partBs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(partBs[i]), 2] + connection_all[k][i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if np.count_nonzero(membership == 2) == 0:  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][indexB] = partBs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(partBs[i]), 2] + connection_all[k][i][2]
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[indexA] = partAs[i]
                row[indexB] = partBs[i]
                row[-1] = 2
                row[-2] = (
                    candidate[connection_all[k][i, :2].astype(int), 2].sum()
                    + connection_all[k][i][2]
                )
                subset = np.vstack([subset, row])
    keep = [
        i for i in range(len(subset))
        if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4
    ]
    return candidate, subset[keep]


def body_decode(heatmap: np.ndarray, paf: np.ndarray, thre1=0.1, thre2=0.05):
    all_peaks = find_peaks(heatmap, thre1)
    connection_all, special_k = match_limbs(all_peaks, paf, heatmap.shape[0], thre2)
    return assemble_people(all_peaks, connection_all, special_k)


def hand_peaks(heatmap: np.ndarray, ori_shape: Tuple[int, int], thre=0.05):
    """21 hand peaks via largest connected blob per part (hand.py:65-91);
    connected components via cv2 instead of skimage."""
    wsize = heatmap.shape[0]
    Hr, Wr = ori_shape
    out = []
    for part in range(21):
        map_ori = heatmap[:, :, part].copy()
        hm = gaussian_filter(map_ori, sigma=3)
        binary = (hm > thre).astype(np.uint8)
        if binary.sum() == 0:
            out.append([0, 0])
            continue
        n, labels = cv2.connectedComponents(binary, connectivity=8)
        sums = [map_ori[labels == i].sum() for i in range(1, n)]
        best = int(np.argmax(sums)) + 1
        map_ori[labels != best] = 0
        y, x = np.unravel_index(np.argmax(map_ori), map_ori.shape)
        out.append([int(x * Wr / wsize), int(y * Hr / wsize)])
    return np.array(out)


def face_peaks(heatmaps: np.ndarray, thre=0.05):
    """(face.py:348-363) heatmaps [71,H,W] -> peaks [N,2]."""
    all_peaks = []
    for part in range(heatmaps.shape[0]):
        m = heatmaps[part]
        binary = m > thre
        if not binary.any():
            continue
        ys, xs = np.where(binary)
        mi = np.argmax(m[ys, xs])
        all_peaks.append([int(xs[mi]), int(ys[mi])])
    return np.array(all_peaks)


def hand_detect(candidate, subset, ori_shape) -> List:
    """Hand boxes from body keypoints (util.py:155-218)."""
    ratio = 0.33
    H, W = ori_shape
    result = []
    for person in subset.astype(int):
        hands = []
        if np.sum(person[[5, 6, 7]] == -1) == 0:
            s, e, w_ = person[[5, 6, 7]]
            hands.append([*candidate[s][:2], *candidate[e][:2], *candidate[w_][:2], True])
        if np.sum(person[[2, 3, 4]] == -1) == 0:
            s, e, w_ = person[[2, 3, 4]]
            hands.append([*candidate[s][:2], *candidate[e][:2], *candidate[w_][:2], False])
        for x1, y1, x2, y2, x3, y3, is_left in hands:
            x = x3 + ratio * (x3 - x2)
            y = y3 + ratio * (y3 - y2)
            d_we = math.hypot(x3 - x2, y3 - y2)
            d_es = math.hypot(x2 - x1, y2 - y1)
            width = 1.5 * max(d_we, 0.9 * d_es)
            x, y = max(x - width / 2, 0), max(y - width / 2, 0)
            w1 = W - x if x + width > W else width
            w2 = H - y if y + width > H else width
            width = min(w1, w2)
            if width >= 20:
                result.append([int(x), int(y), int(width), is_left])
    return result


def face_detect(candidate, subset, ori_shape) -> List:
    """Face boxes from head keypoints (util.py:221-290)."""
    H, W = ori_shape
    result = []
    for person in subset.astype(int):
        if person[0] <= -1:
            continue
        parts = person[[0, 14, 15, 16, 17]]
        if all(p <= -1 for p in parts[1:]):
            continue
        x0, y0 = candidate[parts[0]][:2]
        width = 0.0
        for idx, mult in zip(parts[1:], (3.0, 3.0, 1.5, 1.5)):
            if idx > -1:
                x1, y1 = candidate[idx][:2]
                width = max(width, max(abs(x0 - x1), abs(y0 - y1)) * mult)
        x, y = max(x0 - width, 0), max(y0 - width, 0)
        w1 = W - x if x + width > W else width * 2
        w2 = H - y if y + width > H else width * 2
        width = min(w1, w2)
        if width >= 20:
            result.append([int(x), int(y), int(width)])
    return result
