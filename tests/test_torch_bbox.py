"""The port's darknet YOLO bbox detector (``ctrlora_tpu_torch/annotators/bbox.py``)
against the JAX package's on the CPU.

Two cfgs go through both packages' ``YoloV4`` from one seeded darknet
.weights file each: JAX's small cfg of every layer kind
(tests/test_bbox.py) and ``chip_smoke.YOLO_CFG`` (three yolo heads at
strides 8/16/32 on a 416^2 net, SPP maxpools, multi-layer routes,
upsamples); the raw yolo maps agree in fp32 within 1e-5 x max|want|, and
the folded parameters bit for bit, for a version 0.2 header (int64 images
seen) and a version 0.1 one (int32). A file of too few or too many floats
raises ValueError. ``decode_yolo``, ``nms_boxes`` and ``draw_bbox_mask``
give JAX's results bit for bit on seeded inputs. The detector, on a file
whose objectness biases let a few boxes of the image through
(``chip_smoke.write_detector_files(image=)``), gives JAX's boxes, labels
and mask (at most 0.1% of mask pixels differing). The port refuses what it
would run differently from darknet (a maxpool of stride 2, a route with
groups, an unknown section kind), and raises FileNotFoundError naming the
cfg or the weights where either is missing.
"""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import bbox as jbbox
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu_torch.annotators import bbox as tbbox
from ctrlora_tpu_torch.annotators import download, nets
from ctrlora_tpu_torch.annotators import registry as treg

# JAX's small cfg of every layer kind (tests/test_bbox.py)
SMALL_CFG = """
[net]
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish

[shortcut]
from=-2
activation=linear

[maxpool]
size=5
stride=1

[route]
layers=-1,-3

[convolutional]
batch_normalize=0
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=12,16, 19,36, 40,28
classes=80
scale_x_y=1.2
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image(seed, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


def write_weights(path, buf, version=(0, 2, 5)):
    with open(path, "wb") as f:
        np.asarray(version, np.int32).tofile(f)
        np.asarray([12345], np.int64 if version[0] * 10 + version[1] >= 2 else np.int32).tofile(f)
        buf.tofile(f)


@pytest.mark.parametrize("cfg,size", [("small", 32), ("three_heads", 64)])
@pytest.mark.parametrize("version", [(0, 2, 5), (0, 1, 0)])
def test_yolo_maps_match_jax(tmp_path, cfg, size, version):
    """One seeded file through both packages: the folded parameters bit for
    bit, the raw maps within 1e-5 x max|want|."""
    text = SMALL_CFG if cfg == "small" else chip_smoke.YOLO_CFG
    cfg_path = tmp_path / "net.cfg"
    cfg_path.write_text(text)
    jnet = jbbox.YoloV4(str(cfg_path))
    if cfg == "small":
        buf = np.abs(np.random.default_rng(1).normal(0, 0.3, jnet.n_weight_floats())).astype(
            np.float32)
        write_weights(tmp_path / "net.weights", buf, version)
    else:
        buf = chip_smoke.write_darknet_files(str(tmp_path), torch.Generator().manual_seed(2))
        write_weights(tmp_path / "net.weights", buf, version)
    tnet = tbbox.YoloV4(str(cfg_path))
    assert tnet.conv_specs == jnet.conv_specs and tnet.n_weight_floats() == len(buf)
    assert [{**m, "anchors": m["anchors"].tolist()} for m in tnet.yolo_meta] == \
        [{**m, "anchors": m["anchors"].tolist()} for m in jnet.yolo_meta]
    jparams = jnet.load_weights(str(tmp_path / "net.weights"))
    sd = tbbox.read_darknet_weights(str(tmp_path / "net.weights"), tnet.conv_specs)
    for i, p in enumerate(jparams):
        np.testing.assert_array_equal(sd[f"convs.{i}.conv.weight"].numpy().transpose(2, 3, 1, 0),
                                      p["kernel"])
        np.testing.assert_array_equal(sd[f"convs.{i}.scale"].numpy(), p["scale"])
        np.testing.assert_array_equal(sd[f"convs.{i}.bias"].numpy(), p["bias"])
    model = nets.build(lambda: tnet, sd, "bbox", "cpu")
    x = np.random.default_rng(3).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    got = nets.forward(model, x)
    want = jnet.forward(jparams, jnp.asarray(x))
    assert len(got) == len(want) == len(tnet.yolo_meta) == (1 if cfg == "small" else 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape[1] == 255 and g.permute(0, 2, 3, 1).shape == w.shape
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_weights_of_the_wrong_length_raise(tmp_path):
    cfg_path = tmp_path / "net.cfg"
    cfg_path.write_text(SMALL_CFG)
    specs = tbbox.YoloV4(str(cfg_path)).conv_specs
    n = tbbox.YoloV4(str(cfg_path)).n_weight_floats()
    for floats in (n - 1, n + 3):
        write_weights(tmp_path / "w", np.ones(floats, np.float32))
        with pytest.raises(ValueError, match=f"{floats} floats after the header"):
            tbbox.read_darknet_weights(str(tmp_path / "w"), specs)
    (tmp_path / "w").write_bytes(np.asarray([0, 2], np.int32).tobytes())
    with pytest.raises(ValueError, match="header"):
        tbbox.read_darknet_weights(str(tmp_path / "w"), specs)


def test_decode_nms_and_drawing_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    meta = {"mask": [3, 4, 5], "anchors": rng.uniform(10, 300, (9, 2)).astype(np.float32),
            "scale_x_y": 1.1, "classes": 80}
    raw = rng.normal(0, 2, (13, 13, 255)).astype(np.float32)
    for got, want in zip(tbbox.decode_yolo(raw, meta, 416, 416),
                         jbbox.decode_yolo(raw, meta, 416, 416)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    boxes = np.concatenate([rng.uniform(0, 400, (300, 2)), rng.uniform(5, 120, (300, 2))],
                           1).astype(np.float32)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    keep = tbbox.nms_boxes(boxes, scores, 0.4, 0.5)
    assert keep == jbbox.nms_boxes(boxes, scores, 0.4, 0.5) and 5 < len(keep) < 300
    names = tbbox.COCO_CLASSES
    bboxes = [[int(v) for v in rng.integers(-20, 200, 4)] for _ in range(12)]
    labels = [names[i] for i in rng.integers(0, 80, 12)]
    mask = tbbox.draw_bbox_mask((150, 180, 3), bboxes, labels)
    np.testing.assert_array_equal(mask, jbbox.draw_bbox_mask((150, 180, 3), bboxes, labels))
    assert mask.any()
    assert tbbox.COCO_CLASSES == jbbox.COCO_CLASSES and tbbox.COLOR_DICT == jbbox.COLOR_DICT


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """Both packages' detectors on one directory of seeded YOLO_CFG files,
    tuned so that a few boxes of image(6) pass."""
    d = str(tmp_path_factory.mktemp("bbox_ckpts"))
    chip_smoke.write_detector_files(d, names=["yolov4.weights"], image=image(6))
    mp = pytest.MonkeyPatch()
    mp.setenv(download.CKPT_ENV, d)
    mp.setattr(jreg, "_CACHE", {})
    mp.setattr(treg, "_CACHE", {})
    yield treg.get("bbox", "cpu"), jreg.get("bbox")
    mp.undo()


def test_detector_matches_jax(detectors):
    """The same boxes and labels; the mask within 0.1% of pixels."""
    det, jdet = detectors
    img = image(6)
    boxes, labels, confs = det.detect(img)
    jboxes, jlabels, jconfs = jdet.detect(img)
    assert 1 <= len(boxes) <= 8 and boxes == jboxes and labels == jlabels
    np.testing.assert_allclose(confs, jconfs, rtol=1e-5)
    got, want = det(img), jdet(img)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == img.shape
    assert got.any() and (got != want).any(axis=-1).mean() <= 1e-3


@pytest.mark.parametrize("section,match", [
    ("[maxpool]\nsize=2\nstride=2\n", "stride=2"),
    ("[route]\nlayers=-1\ngroups=2\ngroup_id=1\n", "groups=2"),
    ("[sam]\nfrom=-2\n", r"\[sam\]"),
])
def test_refuses_what_darknet_runs_differently(tmp_path, section, match):
    """JAX runs every maxpool at stride 1, ignores a route's groups and
    passes an unknown section through; the port raises."""
    cfg = SMALL_CFG.replace("[route]\nlayers=-1,-3\n", section + "\n[route]\nlayers=-1,-3\n")
    (tmp_path / "net.cfg").write_text(cfg)
    with pytest.raises(ValueError, match=match):
        tbbox.YoloV4(str(tmp_path / "net.cfg"))


def test_missing_files_raise_naming_them(tmp_path):
    with pytest.raises(FileNotFoundError, match="yolov4.cfg"):
        tbbox.BBoxDetector(device="cpu", ckpt_dir=str(tmp_path))
    (tmp_path / "yolov4.cfg").write_text(SMALL_CFG)
    with pytest.raises(FileNotFoundError, match="yolov4.weights"):
        tbbox.BBoxDetector(device="cpu", ckpt_dir=str(tmp_path))
