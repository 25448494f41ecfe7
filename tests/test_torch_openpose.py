"""The port's OpenPose (``ctrlora_tpu_torch/annotators/openpose/``) against
the JAX package's on the CPU.

Seeded body_pose_model.pth, hand_pose_model.pth and facenet.pth at their
published widths under their flat published names
(``chip_smoke.write_detector_files``; the body's heatmap head scaled so a
seeded map holds tens of peaks): JAX reads them through ``convert_flat``,
the port loads them as they are. The three nets agree in fp32 within 1e-4 x
max|want| on small images, odd sizes included (floor-mode pools); the
decode is bit-equal to JAX's on the same maps (a synthetic person whose
hands and face are found, and a seeded net's maps); the detector's canvas
differs on at most 0.1% of pixels and its pose holds as many candidates,
each within 1 px. At the published widths each net built on the meta device
has exactly the conv names JAX's specs name, at shapes JAX's forward traces.
"""

import logging

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import openpose as jop
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu.annotators.openpose import decode as jdecode
from ctrlora_tpu.annotators.openpose import models as jmodels
from ctrlora_tpu.apps import logic as jlogic
from ctrlora_tpu_torch.annotators import download, nets
from ctrlora_tpu_torch.annotators import openpose as top
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.annotators.openpose import decode as tdecode
from ctrlora_tpu_torch.annotators.openpose import models as tmodels
from ctrlora_tpu_torch.apps import logic

from test_torch_midas import assert_few_pixels_differ, layout

FILES = {"body": "body_pose_model.pth", "hand": "hand_pose_model.pth", "face": "facenet.pth"}
NETS = {"body": (tmodels.BodyNet, jmodels.body_forward, tmodels.BODY_SPECS),
        "hand": (tmodels.HandNet, jmodels.hand_forward, tmodels.HAND_SPECS),
        "face": (tmodels.FaceNet, jmodels.face_forward, tmodels.FACE_SPECS)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("openpose_ckpts"))
    chip_smoke.write_detector_files(d, names=list(FILES.values()))
    return d


@pytest.fixture(scope="module")
def dets(ckpt_dir):
    """(the port's detector, JAX's) on the seeded files."""
    mp = pytest.MonkeyPatch()
    mp.setenv(download.CKPT_ENV, ckpt_dir)
    try:
        jax_det = jop.OpenposeDetector()
    finally:
        mp.undo()
    return top.OpenposeDetector(device="cpu", ckpt_dir=ckpt_dir), jax_det


def image(seed, hw):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net, hw", [("body", (64, 72)), ("body", (60, 76)),
                                     ("hand", (64, 64)), ("face", (56, 64))])
def test_net_matches_jax(dets, net, hw):
    port = {"body": dets[0].body, "hand": dets[0].hand, "face": dets[0].face}[net]
    params = {"body": dets[1].body, "hand": dets[1].hand, "face": dets[1].face}[net].params
    x = top.net_input(image(hw[1], hw)[:, :, ::-1])
    want = NETS[net][1](params, jnp.asarray(x))
    got = nets.forward(port.model, x)
    if net != "body":
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert w.shape[1:3] == (hw[0] // 8, hw[1] // 8)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("net", list(NETS))
def test_keys_at_published_widths(net):
    factory, forward, specs = NETS[net]
    with torch.device("meta"):
        model = factory()
    convs = [name for spec in specs for name, _ in spec if "pool" not in name]
    assert set(model.state_dict()) == {f"{n}.{p}" for n in convs for p in ("weight", "bias")}
    params = jmodels.convert_flat(layout(model))
    out = jax.eval_shape(forward, params, jax.ShapeDtypeStruct((1, 368, 368, 3), jnp.float32))
    heads = {"body": [(1, 46, 46, 38), (1, 46, 46, 19)], "hand": [(1, 46, 46, 22)],
             "face": [(1, 46, 46, 71)]}[net]
    assert [o.shape for o in jax.tree_util.tree_leaves(out)] == heads


# ---------------------------------------------------------------------------
# the decode
# ---------------------------------------------------------------------------

def test_decode_bit_equal_to_jax_on_a_person():
    hm, paf = chip_smoke.person_maps()
    cand, subset = tdecode.body_decode(hm, paf)
    jcand, jsubset = jdecode.body_decode(hm, paf)
    assert len(subset) == 1 and subset[0][-1] == 18
    np.testing.assert_array_equal(cand, jcand)
    np.testing.assert_array_equal(subset, jsubset)
    hands = tdecode.hand_detect(cand, subset, (128, 128))
    faces = tdecode.face_detect(cand, subset, (128, 128))
    assert len(hands) == 2 and len(faces) == 1
    assert hands == jdecode.hand_detect(cand, subset, (128, 128))
    assert faces == jdecode.face_detect(cand, subset, (128, 128))
    heat = np.random.default_rng(0).random((64, 64, 22)).astype(np.float32) * 0.1
    heat[20:30, 10:20, :] += 0.5
    np.testing.assert_array_equal(tdecode.hand_peaks(heat, (90, 70)),
                                  jdecode.hand_peaks(heat, (90, 70)))
    face = np.moveaxis(heat[:, :, :20], -1, 0)
    np.testing.assert_array_equal(tdecode.face_peaks(face), jdecode.face_peaks(face))


def test_decode_bit_equal_to_jax_on_the_net_maps(dets):
    hm, paf = dets[0].body.maps(image(1, (128, 160))[:, :, ::-1].copy())
    peaks = tdecode.find_peaks(hm)
    assert 0 < sum(len(p) for p in peaks) < 500
    got, want = tdecode.body_decode(hm, paf), jdecode.body_decode(hm, paf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the detector and the registry
# ---------------------------------------------------------------------------

def assert_pose_close(got, want):
    """As many people and candidates, each candidate within 1 px."""
    assert len(got["bodies"]["subset"]) == len(want["bodies"]["subset"])
    g, w = np.asarray(got["bodies"]["candidate"]), np.asarray(want["bodies"]["candidate"])
    assert g.shape == w.shape
    if len(w):
        assert np.abs(g[:, :2] - w[:, :2]).max() * 128 <= 1.0


@pytest.mark.parametrize("hw", [(96, 96), (128, 112)])
def test_detector_matches_jax(dets, hw):
    port, jax_det = dets
    img = image(hw[0] + 7, hw)
    pose = port(img, return_is_index=True)
    assert_pose_close(pose, jax_det(img, return_is_index=True))
    assert len(pose["bodies"]["candidate"]) > 0
    assert_few_pixels_differ(port(img, hand_and_face=True), jax_det(img, hand_and_face=True))


def test_hand_and_face_match_jax(dets):
    """On a crop, as the detector calls them for a found person (the hand
    at two of its scales)."""
    port, jax_det = dets
    crop = image(2, (80, 80))[:, :, ::-1].copy()
    got = port.hand(crop, scales=(0.25, 0.5))
    want = jax_det.hand(crop, scales=(0.25, 0.5))
    assert got.shape == want.shape == (21, 2) and np.abs(got - want).max() <= 1
    got, want = port.face(crop), jax_det.face(crop)
    assert got.shape == want.shape == (71, 80, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture
def registries(ckpt_dir, monkeypatch):
    monkeypatch.setenv(download.CKPT_ENV, ckpt_dir)
    monkeypatch.setattr(jreg, "_CACHE", {})
    monkeypatch.setattr(treg, "_CACHE", {})


def test_detect_equals_jax(registries):
    img = image(9, (64, 64))
    got = logic.detect("openpose", img, 64, 64, device="cpu")
    want = jlogic.detect("openpose", img, 64, 64)
    assert got.shape == want.shape == (64, 64, 3)
    assert_few_pixels_differ(got, want)


def test_without_files_torch_init_under_the_seed(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=nets.__name__):
        a = top.Body(device="cpu", ckpt_dir=str(tmp_path))
    assert "no weight file" in caplog.text
    b = top.Body(device="cpu", ckpt_dir=str(tmp_path))
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    cand, subset = a(image(3, (48, 48)))
    assert cand.shape[1:] == (4,) and subset.shape[1:] == (20,)


def test_read_flat_drops_prefixes(ckpt_dir, tmp_path):
    """Keys under a Sequential prefix or 'module.' come back flat, as JAX's
    convert_flat reads them."""
    sd = torch.load(f"{ckpt_dir}/facenet.pth", weights_only=True)
    torch.save({f"module.model0.{k}": v for k, v in sd.items()}, tmp_path / "facenet.pth")
    flat = top.read_flat("facenet.pth", str(tmp_path))
    assert set(flat) == set(sd) and all(torch.equal(flat[k], sd[k]) for k in sd)
