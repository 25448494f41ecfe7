"""The port's UniFormer-S + UPerNet segmenter
(``ctrlora_tpu_torch/annotators/uniformer.py``) against the JAX package's on
the CPU.

One seeded upernet_global_small.pth as mmseg saves it ('state_dict' beside
'meta', with an auxiliary head; ``chip_smoke.write_detector_files``) at
small widths (stages 16/32/64/128 wide, [1, 1, 2, 1] blocks, a 32-channel
head; both packages' constants patched for the module's tests): JAX reads
it through ``convert_uniformer``, the port loads it with its BatchNorms
folded. The stage features and logits agree in fp32 within 1e-4 x
max|want|; the BatchNorm fold, ``resize`` against JAX's ``_resize`` and
the adaptive pooling against JAX's agree; the ADE palette maps differ on
at most 0.1% of pixels (an argmax near a tie may flip). At the published
widths the module built on the meta device has exactly the keys JAX's
converter reads (BatchNorms unfolded), at shapes JAX's forward traces.
"""

import os

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import ade_palette as jpalette
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu.annotators import uniformer as juni
from ctrlora_tpu.apps import logic as jlogic
from ctrlora_tpu_torch.annotators import ade_palette as tpalette
from ctrlora_tpu_torch.annotators import download, nets
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.annotators import uniformer as tuni
from ctrlora_tpu_torch.annotators.mlsd import FoldedBN, fold_batchnorms
from ctrlora_tpu_torch.apps import logic

from test_torch_midas import Recorder, assert_few_pixels_differ, layout

PUBLISHED = {"EMBED_DIMS": (64, 128, 320, 512), "LAYERS": (3, 4, 8, 3), "CHANNELS": 512}
SMALL = {"EMBED_DIMS": (16, 32, 64, 128), "LAYERS": (1, 1, 2, 1), "CHANNELS": 32}
FILE = "upernet_global_small.pth"


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
        mp.setattr(juni, k, v)
        mp.setattr(tuni, k, v)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ckpt_dir(small, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("uniformer_ckpts"))
    chip_smoke.write_detector_files(d, names=[FILE])
    return d


@pytest.fixture(scope="module")
def file_sd(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, FILE), weights_only=True)["state_dict"]


@pytest.fixture(scope="module")
def dets(ckpt_dir, file_sd):
    """(the port's detector, JAX's, the JAX params) on the seeded file."""
    params = jax.tree_util.tree_map(
        jnp.asarray, juni.convert_uniformer({k: v.numpy() for k, v in file_sd.items()}))
    return (tuni.UniformerDetector(device="cpu", ckpt_dir=ckpt_dir),
            juni.UniformerDetector(params), params)


def image(seed, hw):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the network and its pieces
# ---------------------------------------------------------------------------

def test_backbone_and_logits_match_jax(dets):
    port, _, params = dets
    x = np.random.default_rng(0).standard_normal((1, 96, 136, 3)).astype(np.float32)
    feats = juni.uniformer_forward(params, jnp.asarray(x))
    got = nets.forward(port.model.backbone, x)
    assert [g.shape[2:] for g in got] == [(24, 34), (12, 17), (6, 8), (3, 4)]
    for g, w in zip(got, feats):
        assert_close(nhwc(g), np.asarray(w))
    want = np.asarray(juni.seg_logits(params, jnp.asarray(x)))
    logits = nhwc(nets.forward(port.model, x))
    assert logits.shape == want.shape == (1, 24, 34, 150)
    assert_close(logits, want)


@pytest.mark.parametrize("src, dst", [((3, 4), (24, 34)), ((6, 8), (24, 34)),
                                      ((24, 34), (96, 136)), ((24, 34), (80, 131)),
                                      ((7, 5), (3, 2))])
def test_resize_equals_jax(src, dst):
    """The port's resize (F.interpolate, align_corners=False) against JAX's
    half-pixel gather, up and down at integer and other scales."""
    x = np.random.default_rng(sum(dst)).standard_normal((1, *src, 5)).astype(np.float32)
    got = nhwc(tuni.resize(nchw(x), dst))
    np.testing.assert_array_equal(
        got, nhwc(F.interpolate(nchw(x), size=dst, mode="bilinear", align_corners=False)))
    np.testing.assert_allclose(got, np.asarray(juni._resize(jnp.asarray(x), dst)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("out", [1, 2, 3, 6])
def test_adaptive_pool_equals_jax(out):
    x = np.random.default_rng(out).standard_normal((1, 13, 17, 4)).astype(np.float32)
    got = nhwc(torch.nn.AdaptiveAvgPool2d(out)(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(juni._adaptive_avg_pool(jnp.asarray(x), out)),
                               rtol=0, atol=1e-6)


def test_batchnorm_fold_bit_equal_to_jax(file_sd):
    folded = fold_batchnorms(file_sd)
    npsd = {k: v.numpy() for k, v in file_sd.items()}
    prefixes = [k[:-len(".running_var")] for k in file_sd if k.endswith(".running_var")]
    assert len(prefixes) == 2 * 2 + 4 + 1 + 3 + 3 + 1  # CBlocks, PPM, bottleneck, FPN
    for p in prefixes:
        want = juni._fold_bn(npsd, p)
        np.testing.assert_array_equal(folded[p + ".weight"].numpy(), want["scale"])
        np.testing.assert_array_equal(folded[p + ".bias"].numpy(), want["bias"])


def test_keys_at_published_widths(monkeypatch):
    """UperNetUniFormer() at the published widths, each folded BatchNorm
    unfolded to the file's four tensors: exactly the keys
    convert_uniformer reads (num_batches_tracked aside), at shapes JAX's
    forward traces at 512 px."""
    for k, v in PUBLISHED.items():
        monkeypatch.setattr(juni, k, v)
        monkeypatch.setattr(tuni, k, v)
    with torch.device("meta"):
        model = tuni.UperNetUniFormer()
    sd = layout(model)
    for name, m in model.named_modules():
        if isinstance(m, FoldedBN):
            for stat in ("running_mean", "running_var"):
                sd[f"{name}.{stat}"] = sd[f"{name}.weight"]
    sd = Recorder(sd)
    params = juni.convert_uniformer(sd)
    assert sd.read == set(sd)
    assert sum(k.startswith("backbone.blocks3.") for k in sd) == 8 * 14
    out = jax.eval_shape(juni.seg_logits, params,
                         jax.ShapeDtypeStruct((1, 512, 512, 3), jnp.float32))
    assert out.shape == (1, 128, 128, 150)


def test_palette_is_jax_palette():
    assert tpalette.ADE_PALETTE == jpalette.ADE_PALETTE and len(tpalette.ADE_PALETTE) == 150


# ---------------------------------------------------------------------------
# the file, the detector and the registry
# ---------------------------------------------------------------------------

def test_read_weights_unwraps_the_checkpoint(ckpt_dir, file_sd):
    """The mmseg file nests its tensors under 'state_dict' beside 'meta';
    read_weights returns them, less auxiliary_head.*."""
    raw = torch.load(os.path.join(ckpt_dir, FILE), weights_only=True)
    assert set(raw) == {"state_dict", "meta"}
    assert any(k.startswith("auxiliary_head.") for k in file_sd)
    sd = nets.read_weights(FILE, ckpt_dir, drop=tuni.UNUSED)
    assert set(sd) == {k for k in file_sd if not k.startswith("auxiliary_head.")}
    assert all(torch.equal(sd[k], file_sd[k]) for k in sd)
    assert set(nets.read_weights(FILE, ckpt_dir)) == set(file_sd)


@pytest.mark.parametrize("hw", [(96, 128), (130, 100)])
def test_detector_matches_jax(dets, hw):
    """The shorter side to 512 (other side not a multiple of 32), the
    logits back at the image's size, argmax and palette."""
    port, jax_det, _ = dets
    img = image(hw[0], hw)
    got, want = port(img), jax_det(img)
    assert got.shape == (*hw, 3) and len(np.unique(want.reshape(-1, 3), axis=0)) > 1
    assert_few_pixels_differ(got, want)


@pytest.fixture
def registries(ckpt_dir, monkeypatch):
    monkeypatch.setenv(download.CKPT_ENV, ckpt_dir)
    monkeypatch.setattr(jreg, "_CACHE", {})
    monkeypatch.setattr(treg, "_CACHE", {})


def test_detect_equals_jax(registries):
    img = image(7, (80, 96))
    got = logic.detect("seg", img, 64, 64, device="cpu")
    want = jlogic.detect("seg", img, 64, 64)
    assert got.shape == want.shape == (64, 64, 3)
    assert_few_pixels_differ(got, want)
    assert type(treg.get("seg", "cpu")).__name__ == type(jreg.get("seg")).__name__


def test_without_the_file_raises_as_jax_does(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match=FILE):
        tuni.UniformerDetector(device="cpu", ckpt_dir=str(tmp_path))
    monkeypatch.setenv(download.CKPT_ENV, str(tmp_path))
    with pytest.raises(AssertionError, match=FILE):
        juni.UniformerDetector()(image(8, (32, 32)))
