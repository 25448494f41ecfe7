"""The port's DensePose (``ctrlora_tpu_torch/annotators/densepose.py``)
against the JAX package's on the CPU.

Seeded detectron2 pickles of the published key layout
(``chip_smoke.densepose_file_state``: FrozenBNs unfolded) at narrow widths
(SMALL: stem 8, res2 16, bottleneck 4, FPN, decoder and chart head 32 wide,
box FCs 64, 2 stacked convs; the port's width constants patched, JAX reads
them from the file): at ``stages=(1, 1, 1, 1)`` the ResNet features, FPN
levels and RPN maps agree in fp32 within 1e-5 x max|want|; ``roi_align``
(boxes across the map's edges), the box head, the decoder, the ASPP and
the chart head, each fed the same input, within 1e-5 x max|want|;
``level_anchors``, ``decode_deltas``, ``nms``, ``rpn_proposals`` and
``assign_levels`` give JAX's results bit for bit on the same inputs. The
whole detector at full R-101 depth (MIN_SIZE_TEST 64, MAX_SIZE_TEST 128 in
both packages, so no level holds more than 1,000 anchors), on a file whose
person bias lets a few proposals of the image through, and with
SCORE_THRESH 0 and MAX_DET 24 in both packages (24 persons), draws JAX's
canvas but on at most 0.1% of pixels. The .pkl is read through a restricted unpickler that
refuses any object but numpy arrays and builtins; keys of the file the net
does not read are logged by name; a missing file raises FileNotFoundError.
"""

import logging
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import densepose as jdp
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu_torch.annotators import densepose as tdp
from ctrlora_tpu_torch.annotators import download
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.annotators.mlsd import fold_batchnorms

SMALL = {"STEM_OUT": 8, "RES2_OUT": 16, "BOTTLENECK": 4, "FPN_DIM": 32, "BOX_FC": 64,
         "DECODER_DIM": 32, "DECODER_CLASSES": 32, "HEAD_DIM": 32, "N_STACKED": 2}
SIZES = {"MIN_SIZE_TEST": 64, "MAX_SIZE_TEST": 128}
STAGES = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    mp = pytest.MonkeyPatch()
    for k, v in SMALL.items():
        mp.setattr(tdp, k, v)
    yield
    mp.undo()


def image(seed, hw=(64, 80)):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


def close(got, want, rtol=1e-5):
    """`got` (torch NCHW or numpy) within rtol x max|want| of JAX's NHWC `want`."""
    if isinstance(got, torch.Tensor):
        got = got.permute(0, 2, 3, 1).numpy() if got.ndim == 4 else got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def pair(small):
    """(the port's detector, JAX's params) on one seeded state at STAGES."""
    st = chip_smoke.densepose_file_state(torch.Generator().manual_seed(1), stages=STAGES)["model"]
    det = tdp.DenseposeDetector(
        state_dict=fold_batchnorms({k: torch.from_numpy(v) for k, v in st.items()}),
        device="cpu", stages=STAGES)
    return det, jdp.convert_densepose(st, stages=STAGES)


def test_trunk_fpn_and_rpn_match_jax(pair):
    det, params = pair
    x = np.random.default_rng(2).normal(0, 50, (1, 64, 96, 3)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = det.model.backbone.bottom_up(t)
        ps = det.model.backbone(t)
    jfeats = jdp.resnet_forward(params["backbone"], jnp.asarray(x), stages=STAGES)
    for k in ("res2", "res3", "res4", "res5"):
        close(feats[k], jfeats[k])
    jps = jdp.fpn_forward(params["fpn"], jfeats)
    assert len(ps) == len(jps) == 5
    for g, w in zip(ps, jps):
        close(g, w)
    _, rpn = det.trunk(x)
    for (o, d), (jo, jd) in zip(rpn, jdp.rpn_head_forward(params["rpn"], jps)):
        close(o, jo)
        close(d, jd)


def test_host_box_functions_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    for args in ((4, 6, 8, 32), (2, 3, 64, 512)):
        np.testing.assert_array_equal(tdp.level_anchors(*args), jdp.level_anchors(*args))
    anchors = tdp.level_anchors(8, 10, 8, 64)
    deltas = rng.normal(0, 1, anchors.shape).astype(np.float32)
    for w in ((1.0, 1.0, 1.0, 1.0), (10, 10, 5, 5)):
        np.testing.assert_array_equal(tdp.decode_deltas(anchors, deltas, w),
                                      jdp.decode_deltas(anchors, deltas, w))
    boxes = tdp.decode_deltas(anchors, deltas)
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    np.testing.assert_array_equal(tdp.nms(boxes, scores, 0.5), jdp.nms(boxes, scores, 0.5))
    np.testing.assert_array_equal(tdp.assign_levels(boxes * 8), jdp.assign_levels(boxes * 8))
    rpn = [(rng.normal(0, 1, (1, h, w, 3)).astype(np.float32),
            rng.normal(0, 0.5, (1, h, w, 12)).astype(np.float32))
           for h, w in ((24, 32), (12, 16), (6, 8), (3, 4), (2, 2))]
    for got, want in zip(tdp.rpn_proposals(rpn, tdp.STRIDES, (90, 120)),
                         jdp.rpn_proposals(rpn, tdp.STRIDES, (90, 120))):
        np.testing.assert_array_equal(got, want)
    assert len(tdp.rpn_proposals(rpn, tdp.STRIDES, (90, 120))[0]) == 1000


def test_roi_align_matches_jax_across_the_edges():
    rng = np.random.default_rng(4)
    feat = rng.normal(0, 1, (1, 12, 15, 5)).astype(np.float32)
    boxes = np.array([[4.0, 2.0, 40.0, 30.0], [-12.0, -8.0, 20.0, 16.0],
                      [40.0, 30.0, 75.0, 66.0], [-30.0, 10.0, 90.0, 20.0],
                      [58.0, 46.0, 59.0, 46.5]], np.float32)
    for out, scale in ((7, 0.25), (28, 0.125)):
        got = tdp.roi_align(torch.from_numpy(feat).permute(0, 3, 1, 2),
                            torch.from_numpy(boxes), scale, out, 2)
        close(got, jdp.roi_align(jnp.asarray(feat), jnp.asarray(boxes), scale, out, 2),
              rtol=1e-6)


def test_heads_match_jax_on_the_same_inputs(pair):
    """The box head, the decoder, the ASPP and the chart head."""
    det, params = pair
    rng = np.random.default_rng(5)
    m = det.model
    pooled = rng.normal(0, 1, (9, 7, 7, SMALL["FPN_DIM"])).astype(np.float32)
    with torch.no_grad():
        s, d = m.box_head(torch.from_numpy(pooled).permute(0, 3, 1, 2))
    js, jd = jdp.box_head_forward(params["box"], jnp.asarray(pooled))
    close(s, js)
    close(d, jd)
    ps = [rng.normal(0, 1, (1, 16 // 2 ** i, 24 // 2 ** i, SMALL["FPN_DIM"])).astype(np.float32)
          for i in range(5)]
    with torch.no_grad():
        dec = m.roi_heads.decoder([torch.from_numpy(p).permute(0, 3, 1, 2) for p in ps])
    close(dec, jax.jit(jdp.decoder_forward)(params["decoder"], [jnp.asarray(p) for p in ps]))
    x = rng.normal(0, 1, (3, 28, 28, SMALL["DECODER_CLASSES"])).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        aspp = m.roi_heads.densepose_head.ASPP(t)
        charts = m.chart_head(t)
    close(aspp, jdp._aspp(params["dp_head"]["aspp"], jnp.asarray(x)))
    jcharts = jdp.deeplab_head_forward(params["dp_head"], jnp.asarray(x),
                                       n_stacked=int(params["dp_head"]["n_stacked"]))
    assert set(charts) == set(jcharts)
    for k in charts:
        assert charts[k].shape[2:] == (112, 112)
        close(charts[k], jcharts[k])


@pytest.fixture(scope="module")
def detectors(small, tmp_path_factory):
    """Both packages' detectors at full R-101 depth on one file written for
    image(6) (a few proposals pass SCORE_THRESH), MIN/MAX_SIZE_TEST small in
    both packages."""
    d = str(tmp_path_factory.mktemp("densepose_ckpts"))
    mp = pytest.MonkeyPatch()
    for k, v in SIZES.items():
        mp.setattr(tdp, k, v)
        mp.setattr(jdp, k, v)
    chip_smoke.write_detector_files(d, names=[tdp.FILE], image=image(6))
    mp.setenv(download.CKPT_ENV, d)
    mp.setattr(jreg, "_CACHE", {})
    mp.setattr(treg, "_CACHE", {})
    yield treg.get("densepose", "cpu"), jreg.get("densepose")
    mp.undo()


@pytest.mark.parametrize("score_thresh", [None, 0.0])
def test_detector_matches_jax(detectors, monkeypatch, score_thresh):
    """At most 0.1% of the canvas's pixels differ; the file's person bias
    lets 1-8 persons through, SCORE_THRESH 0 (with MAX_DET 24, both
    packages) every proposal, of which NMS keeps MAX_DET."""
    det, jdet = detectors
    if score_thresh is not None:
        for mod in (tdp, jdp):
            monkeypatch.setattr(mod, "SCORE_THRESH", score_thresh)
            monkeypatch.setattr(mod, "MAX_DET", 24)
    img = image(6)
    boxes, charts, hw = det.detect(img)
    jdetect, seen = jdet.detect, []
    monkeypatch.setattr(jdet, "detect", lambda im: seen.append(jdetect(im)) or seen[-1])
    got, want = det(img), jdet(img)
    jboxes = seen[0][0]
    assert hw == (64, 80) and len(boxes) == len(jboxes)
    assert (1 <= len(boxes) <= 8) if score_thresh is None else len(boxes) == 24
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-3)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == img.shape
    labels = det.part_labels(charts)
    assert labels.shape == (len(boxes), 112, 112) and labels.max() > 0
    assert (got != got[0, 0]).any() and (got != want).any(axis=-1).mean() <= 1e-3


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


def test_restricted_unpickler_refuses_objects(tmp_path):
    path = tmp_path / "x.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": {"a": np.zeros(2, np.float32), "b": _Evil()}}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match="getcwd"):
        tdp.read_pkl(str(path))
    with open(path, "wb") as f:
        pickle.dump({"model": {"a": np.arange(3, dtype=np.float32)}, "__author__": "x",
                     "matching_heuristics": True}, f, protocol=2)
    assert list(tdp.read_pkl(str(path))) == ["a"]


def test_unread_keys_are_logged_and_missing_file_raises(small, tmp_path, caplog):
    with pytest.raises(FileNotFoundError, match=tdp.FILE):
        tdp.DenseposeDetector(device="cpu", ckpt_dir=str(tmp_path), stages=STAGES)
    st = chip_smoke.densepose_file_state(torch.Generator().manual_seed(7), stages=STAGES)
    st["model"]["roi_heads.densepose_head.body_conv_fcn1.norm.weight"] = np.ones(32, np.float32)
    st["model"]["pixel_mean"] = np.zeros(3, np.float32)
    with open(tmp_path / tdp.FILE, "wb") as f:
        pickle.dump(st, f, protocol=2)
    with caplog.at_level(logging.WARNING):
        det = tdp.DenseposeDetector(device="cpu", ckpt_dir=str(tmp_path), stages=STAGES)
    assert "2 keys" in caplog.text and "pixel_mean" in caplog.text
    assert "body_conv_fcn1.norm.weight" in caplog.text
    np.testing.assert_array_equal(det.model.state_dict()["roi_heads.box_predictor.cls_score.bias"],
                                  st["model"]["roi_heads.box_predictor.cls_score.bias"])
