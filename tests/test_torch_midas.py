"""The port's MiDaS (``ctrlora_tpu_torch/annotators/midas.py``) against the
JAX package's on the CPU.

One seeded dpt_large_384.pt in the published key layout
(``chip_smoke.write_detector_files``) at small widths (ViT 32 wide, 4
blocks of 2 heads, every block hooked; both packages' width constants
patched for the module's tests): JAX reads it through ``convert_dpt``, the
port loads it with its unused ViT norm and classifier left out. The network
agrees in fp32 within 1e-4 x max|want| at position grids of 24 and more
(384 px and up); below 384 px JAX's ``jax.image.resize`` antialiases the
grid where the reference's ``F.interpolate`` does not, and one test shows
that difference. The detector's depth map is within 1 level on at most
0.1% of pixels; its normal map is within 1 level on all but 0.1% of pixels
(where the ``bg_th`` mask flips) and differs on at most 0.5% (the uint8
truncation of a unit vector moves a level where rounding crosses a step).
At the published widths the module built on the meta device has exactly
the keys JAX's converter reads, at shapes JAX's forward traces.
"""

import logging
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import midas as jmidas
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu.apps import logic as jlogic
from ctrlora_tpu_torch.annotators import download, nets
from ctrlora_tpu_torch.annotators import midas as tmidas
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.apps import logic

PUBLISHED = {"VIT_DIM": 1024, "VIT_LAYERS": 24, "VIT_HEADS": 16, "HOOKS": (5, 11, 17, 23),
             "REASSEMBLE": (256, 512, 1024, 1024), "FEATURES": 256}
SMALL = {"VIT_DIM": 32, "VIT_LAYERS": 4, "VIT_HEADS": 2, "HOOKS": (0, 1, 2, 3),
         "REASSEMBLE": (8, 16, 32, 32), "FEATURES": 16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """Both packages' DPT widths cut to SMALL for the module's tests."""
    mp = pytest.MonkeyPatch()
    for k, v in SMALL.items():
        mp.setattr(jmidas, k, v)
        mp.setattr(tmidas, k, v)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ckpt_dir(small, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("midas_ckpts"))
    chip_smoke.write_detector_files(d, names=["dpt_large_384.pt"])
    return d


@pytest.fixture(scope="module")
def dets(ckpt_dir):
    """(the port's detector, JAX's) on the seeded file, and the JAX params."""
    sd = torch.load(os.path.join(ckpt_dir, "dpt_large_384.pt"), weights_only=True)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    jmidas.convert_dpt({k: v.numpy() for k, v in sd.items()}))
    return (tmidas.MidasDetector(device="cpu", ckpt_dir=ckpt_dir),
            jmidas.MidasDetector(params), params)


def image(seed, hw):
    import cv2

    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(384, 384), (416, 448)])
def test_dpt_matches_jax(dets, hw):
    """At the file's 24 x 24 grid and at a 26 x 28 one (the grid resized up)."""
    port, _, params = dets
    x = np.random.default_rng(hw[1]).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    want = np.asarray(jmidas.dpt_forward(params, jnp.asarray(x)))
    got = nets.forward(port.model, x).numpy()
    assert got.shape == want.shape == (1, *hw) and (want > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("grid, agrees", [((32, 32), True), ((24, 32), True), ((48, 48), True),
                                          ((12, 12), False), ((4, 4), False)])
def test_position_grid_resize(grid, agrees):
    """The port resizes the 24 x 24 grid as timm does (F.interpolate, no
    antialias). JAX's jax.image.resize agrees to rounding where the grid
    grows and antialiases where it shrinks: then it equals antialias=True."""
    pos = np.random.default_rng(0).standard_normal((1, 577, 8)).astype(np.float32)
    got = tmidas.resize_pos_embed(torch.from_numpy(pos), *grid).numpy()
    want = np.asarray(jmidas._resize_pos_embed(jnp.asarray(pos), *grid))
    plain = F.interpolate(torch.from_numpy(pos[0, 1:]).reshape(1, 24, 24, 8).permute(0, 3, 1, 2),
                          size=grid, mode="bilinear", align_corners=False)
    np.testing.assert_array_equal(got[0, 1:], plain.permute(0, 2, 3, 1).reshape(-1, 8).numpy())
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])
    if agrees:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.abs(got - want).max() > 0.1
        aa = F.interpolate(torch.from_numpy(pos[0, 1:]).reshape(1, 24, 24, 8).permute(0, 3, 1, 2),
                           size=grid, mode="bilinear", align_corners=False, antialias=True)
        np.testing.assert_allclose(want[0, 1:], aa.permute(0, 2, 3, 1).reshape(-1, 8).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("h", [12, 96])
def test_up2_within_a_position_ulp_of_jax(h):
    """F.interpolate (the reference's op) against JAX's gather form: equal
    up to one float32 ulp of (h - 1) in a sample's position."""
    x = np.random.default_rng(h).standard_normal((1, h, h + 4, 6)).astype(np.float32)
    want = np.asarray(jmidas._up2_align(jnp.asarray(x)))
    got = tmidas.upsample2(nchw(x)).permute(0, 2, 3, 1).numpy()
    step = max(np.abs(np.diff(x, axis=1)).max(), np.abs(np.diff(x, axis=2)).max())
    bound = 2 * np.spacing(np.float32(h + 3)) * step + 4 * np.spacing(np.abs(x).max())
    assert np.abs(got - want).max() <= bound


def layout(module) -> dict:
    """{key: a zero-copy float32 array of the key's shape} of a module built
    on the meta device."""
    return {k: np.broadcast_to(np.float32(0), tuple(v.shape))
            for k, v in module.state_dict().items()}


class Recorder(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_dpt_keys_at_published_widths(monkeypatch):
    """DPT() at the published widths: exactly the keys convert_dpt reads,
    at shapes JAX's forward traces at 384 px."""
    for k, v in PUBLISHED.items():
        monkeypatch.setattr(jmidas, k, v)
        monkeypatch.setattr(tmidas, k, v)
    with torch.device("meta"):
        model = tmidas.DPT()
    sd = Recorder(layout(model))
    params = jmidas.convert_dpt(sd)
    assert sd.read == set(sd) and len(sd) == 24 * 12 + 76
    out = jax.eval_shape(jmidas.dpt_forward, params,
                         jax.ShapeDtypeStruct((1, 384, 384, 3), jnp.float32))
    assert out.shape == (1, 384, 384)
    assert sd["pretrained.model.pos_embed"].shape == (1, 577, 1024)


# ---------------------------------------------------------------------------
# the detector and the registry
# ---------------------------------------------------------------------------

def assert_depth_close(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def assert_few_pixels_differ(got, want):
    """At most 0.1% of pixels differ (by any number of levels)."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    share = (got != want).any(axis=-1).mean()
    assert share <= 1e-3, share


def assert_normal_close(got, want):
    """Within 1 level but on at most 0.1% of pixels (the bg_th mask flips a
    pixel to or from the flat normal). The unit vector's truncation to
    uint8 moves a level wherever float32 rounding crosses a step: 0.14-0.15%
    of pixels at 1 level on these images, so at most 0.5% may differ."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    assert (diff > 1).mean() <= 1e-3 and (diff > 0).mean() <= 5e-3, (
        (diff > 1).mean(), (diff > 0).mean())


@pytest.mark.parametrize("hw", [(384, 400), (420, 384)])
def test_midas_detector_matches_jax(dets, hw):
    port, jax_det, _ = dets
    img = image(hw[1], hw)
    (d, n), (jd, jn) = port(img), jax_det(img)
    assert d.shape == hw and n.shape == (*hw, 3) and d.std() > 10
    assert_depth_close(d, jd)
    assert_normal_close(n, jn)


@pytest.fixture
def registries(ckpt_dir, monkeypatch):
    """Both registries reading the seeded file, with empty caches."""
    monkeypatch.setenv(download.CKPT_ENV, ckpt_dir)
    monkeypatch.setattr(jreg, "_CACHE", {})
    monkeypatch.setattr(treg, "_CACHE", {})


def test_depth_and_normal_share_one_net(registries):
    depth, normal = treg.get("depth", "cpu"), treg.get("normal", "cpu")
    assert depth.det is normal.det is treg.get("midas", "cpu")
    assert type(depth).__name__ == type(jreg.get("depth")).__name__ == "_MidasChannel"
    img = image(3, (384, 384))
    d, n = treg.get("midas", "cpu")(img)
    np.testing.assert_array_equal(depth(img), d)
    np.testing.assert_array_equal(normal(img), n)


@pytest.mark.parametrize("det", ["depth", "normal"])
def test_detect_equals_jax(registries, det):
    img = image(4, (400, 400))
    got = logic.detect(det, img, 384, 384, device="cpu")
    want = jlogic.detect(det, img, 384, 384)
    assert got.shape == want.shape == (384, 384, 3)
    (assert_depth_close if det == "depth" else assert_normal_close)(got, want)


def test_without_a_file_torch_init_under_the_seed(small, tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=nets.__name__):
        a = tmidas.MidasDetector(device="cpu", ckpt_dir=str(tmp_path))
    assert "no weight file" in caplog.text
    b = tmidas.MidasDetector(device="cpu", ckpt_dir=str(tmp_path))
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    d, n = a(image(5, (64, 96)))
    assert d.shape == (64, 96) and n.shape == (64, 96, 3)


def test_the_second_published_file_is_read(small, ckpt_dir, tmp_path):
    """Without dpt_large_384.pt the detector reads dpt_large-midas-2f21e586.pt."""
    os.symlink(os.path.join(ckpt_dir, "dpt_large_384.pt"),
               tmp_path / "dpt_large-midas-2f21e586.pt")
    a = tmidas.MidasDetector(device="cpu", ckpt_dir=str(tmp_path))
    b = tmidas.MidasDetector(device="cpu", ckpt_dir=ckpt_dir)
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
