"""The port's CNN detectors (HED, lineart fine and coarse, the anime UNet,
MLSD) against the JAX package's on the CPU.

One seeded state dict per published file, in the published key layout
(``chip_smoke.write_detector_files``), is written once with torch.save; the
JAX package reads it through its own loaders (``load_hed_params``,
``convert_lineart``, ``convert_anime_unet``, ``convert_mlsd``) and the port
loads it natively (MLSD with its BatchNorms folded). Network outputs agree
in fp32 within rtol 1e-4 / atol 1e-5; detector uint8 maps differ by at
most 1 level on at most 0.1% of pixels (MLSD's map is drawn from float
endpoints, so its drawing is compared loosely: 99% of pixels equal, and its
network map as above); ``decode_lines`` is bit-equal on one map. Shapes:
64^2 (the anime UNet 256^2, a multiple of 256 as its detector needs), one
jitted shape a net.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import hed as jhed
from ctrlora_tpu.annotators import lineart as jlin
from ctrlora_tpu.annotators import mlsd as jmlsd
from ctrlora_tpu_torch.annotators import download, nets
from ctrlora_tpu_torch.annotators import hed as thed
from ctrlora_tpu_torch.annotators import lineart as tlin
from ctrlora_tpu_torch.annotators import mlsd as tmlsd

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Six pytest processes share the host's cores: one torch thread each
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the files of this module's detectors (not DPT-Large's 1.4 GB one)
FILES = ["ControlNetHED.pth", "sk_model.pth", "sk_model2.pth", "netG.pth",
         "mlsd_large_512_fp32.pth"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("detector_ckpts")
    chip_smoke.write_detector_files(str(d), names=FILES)
    return str(d)


@pytest.fixture(scope="module")
def jax_dets(ckpt_dir):
    """The JAX package's detectors on the seeded files (its loaders read
    CTRLORA_ANNOTATOR_CKPTS when they are built)."""
    mp = pytest.MonkeyPatch()
    mp.setenv(download.CKPT_ENV, ckpt_dir)
    try:
        dets = {"hed": jhed.HEDdetector(jhed.load_hed_params(os.path.join(ckpt_dir,
                                                                         "ControlNetHED.pth"))),
                "lineart": jlin.LineartDetector(), "anime": jlin.LineartAnimeDetector(),
                "mlsd": jmlsd.MLSDdetector()}
    finally:
        mp.undo()
    assert set(dets["lineart"].params) == {"fine", "coarse"}
    return dets


@pytest.fixture(scope="module")
def port_dets(ckpt_dir):
    return {"hed": thed.HEDdetector(device="cpu", ckpt_dir=ckpt_dir),
            "lineart": tlin.LineartDetector(device="cpu", ckpt_dir=ckpt_dir),
            "anime": tlin.LineartAnimeDetector(device="cpu", ckpt_dir=ckpt_dir),
            "mlsd": tmlsd.MLSDdetector(device="cpu", ckpt_dir=ckpt_dir)}


def image(seed, hw=(64, 64)):
    import cv2

    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (5, 5), 1.5)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

def test_hed_network_matches_jax(jax_dets, port_dets):
    x = image(1)[None].astype(np.float32)
    want = jax_dets["hed"]._apply(jax_dets["hed"].params, jnp.asarray(x))
    got = nets.forward(port_dets["hed"].model, x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["fine", "coarse"])
def test_lineart_network_matches_jax(jax_dets, port_dets, kind):
    x = image(2)[None].astype(np.float32) / 255.0
    want = jax_dets["lineart"]._apply(jax_dets["lineart"].params[kind], jnp.asarray(x))
    got = nets.forward(port_dets["lineart"].models[kind], x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_anime_unet_matches_jax(jax_dets, port_dets):
    x = image(3, (256, 256))[None].astype(np.float32) / 127.5 - 1.0
    want = jax_dets["anime"]._apply(jax_dets["anime"].params, jnp.asarray(x))
    got = nets.forward(port_dets["anime"].model, x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_anime_unet_in_place_leaky_relu_gives_the_same_bits(port_dets):
    """The reference's LeakyReLU(0.2, True) overwrites each inner level's
    input before the skip concatenates it; every skip goes straight into the
    parent's ReLU, which gives the same output for x and LeakyReLU(x). So the
    port's skips (the features before the LeakyReLU) give the reference's
    output: bit-equal on one thread."""
    import copy

    model = port_dets["anime"].model
    in_place = copy.deepcopy(model)
    leaky = [m for m in in_place.modules() if isinstance(m, torch.nn.LeakyReLU)]
    assert len(leaky) == len(tlin.ANIME_LEVELS) - 1
    for m in leaky:
        m.inplace = True
    x = image(12, (256, 256))[None].astype(np.float32) / 127.5 - 1.0
    got = nets.forward(in_place, x)
    want = nets.forward(model, x)
    assert got.shape == (1, 1, 256, 256) and torch.equal(got, want)


def test_mlsd_network_matches_jax(jax_dets, port_dets):
    img = image(4)
    feed = np.concatenate([img, np.ones((64, 64, 1))], axis=-1).astype(np.float32)
    want = np.asarray(jax_dets["mlsd"]._apply(jax_dets["mlsd"].params,
                                              jnp.asarray(feed[None] / 127.5 - 1.0)))[0]
    got = port_dets["mlsd"].tp_map(img)
    assert got.shape == want.shape == (32, 32, 9)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mlsd_batchnorm_fold_equals_jax(ckpt_dir):
    sd = torch.load(os.path.join(ckpt_dir, "mlsd_large_512_fp32.pth"), weights_only=True)
    folded = tmlsd.fold_batchnorms(sd)
    npsd = {k: v.numpy() for k, v in sd.items()}
    prefixes = [k[:-len(".running_var")] for k in sd if k.endswith(".running_var")]
    assert prefixes and not any(k.endswith(("running_mean", "running_var", "tracked"))
                                for k in folded)
    for p in prefixes:
        scale, bias = jmlsd._fold_bn(npsd, p)
        np.testing.assert_array_equal(folded[p + ".weight"].numpy(), scale)
        np.testing.assert_array_equal(folded[p + ".bias"].numpy(), bias)


@pytest.mark.parametrize("h", [4, 32, 128])
def test_mlsd_upsample_within_a_position_ulp_of_jax(h):
    """F.interpolate (the reference's op) against JAX's gather: the sample
    positions may sit one float32 ulp of (h - 1) apart, so the outputs
    differ by at most that much of the largest step between neighbours."""
    import torch.nn.functional as F

    x = np.random.default_rng(h).standard_normal((1, h, h + 3, 5)).astype(np.float32)
    want = np.asarray(jmlsd._bilinear_up2_align(jnp.asarray(x)))
    got = nhwc(F.interpolate(nchw(x), scale_factor=2.0, mode="bilinear", align_corners=True))
    step = max(np.abs(np.diff(x, axis=1)).max(), np.abs(np.diff(x, axis=2)).max())
    bound = 2 * np.spacing(np.float32(h + 2)) * step + 4 * np.spacing(np.abs(x).max())
    assert np.abs(got - want).max() <= bound


# ---------------------------------------------------------------------------
# the detectors
# ---------------------------------------------------------------------------

def assert_uint8_close(got, want):
    """At most 1 level apart, on at most 0.1% of the pixels."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("safe", [False, True])
def test_hed_detector_matches_jax(jax_dets, port_dets, safe):
    img = image(5, (64, 80))
    assert_uint8_close(port_dets["hed"](img, safe=safe), jax_dets["hed"](img, safe=safe))


@pytest.mark.parametrize("coarse", [False, True])
def test_lineart_detector_matches_jax(jax_dets, port_dets, coarse):
    img = image(6)
    assert_uint8_close(port_dets["lineart"](img, coarse=coarse),
                       jax_dets["lineart"](img, coarse=coarse))


def test_lineart_anime_detector_matches_jax(jax_dets, port_dets):
    img = image(7, (200, 256))  # resized to 256 x 256 inside
    assert_uint8_close(port_dets["anime"](img), jax_dets["anime"](img))


def test_mlsd_detector_matches_jax(jax_dets, port_dets):
    img = image(8)
    got, want = port_dets["mlsd"](img), jax_dets["mlsd"](img)
    assert got.shape == want.shape == (64, 64) and got.dtype == np.uint8
    assert want.any() and (got == want).mean() >= 0.99


def test_decode_lines_bit_equal_to_jax(port_dets):
    """On the network's map (the seeded net's displacements are short:
    distance threshold 0) and on a map of long random displacements at
    the reference's 20."""
    rng = np.random.default_rng(9)
    wide = rng.standard_normal((32, 32, 9)).astype(np.float32) * np.float32(
        [1] + [30] * 4 + [1] * 4)
    for tp, dist in ((port_dets["mlsd"].tp_map(image(9)), 0.0), (wide, 20.0)):
        got = tmlsd.decode_lines(tp, 200, 3, 0.1, dist)
        want = jmlsd.decode_lines(tp, 200, 3, 0.1, dist)
        assert got.dtype == want.dtype and len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_sketch_and_color_prompt_follow_the_same_rng(jax_dets, port_dets, ckpt_dir):
    """hedsketch's threshold draws and the anime colour prompt agree under
    equal numpy generators."""
    img = image(10)
    sketch = thed.HEDSketchDetector(device="cpu", ckpt_dir=ckpt_dir)
    jsketch = jhed.HEDSketchDetector(jax_dets["hed"].params)
    assert_uint8_close(sketch(img, rng=np.random.default_rng(3)),
                       jsketch(img, rng=np.random.default_rng(3)))
    color = tlin.LineartAnimeWithColorPromptDetector(device="cpu", ckpt_dir=ckpt_dir)
    jcolor = jlin.LineartAnimeWithColorPromptDetector.__new__(
        jlin.LineartAnimeWithColorPromptDetector)
    jcolor.anime = jax_dets["anime"]
    img = image(11, (256, 256))
    got = color(img, rng=np.random.default_rng(4))
    want = jcolor(img, rng=np.random.default_rng(4))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # a pixel whose line is 1 level off across the threshold takes the block colour
    assert (diff.max(axis=-1) > 1).mean() <= 1e-3 and (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# weights, device, downloads
# ---------------------------------------------------------------------------

def test_without_files_torch_init_under_a_fixed_seed(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=nets.__name__):
        a = thed.HEDdetector(device="cpu", ckpt_dir=str(tmp_path))
    b = thed.HEDdetector(device="cpu", ckpt_dir=str(tmp_path))
    assert "no weight file" in caplog.text
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    lineart = tlin.LineartDetector(device="cpu", ckpt_dir=str(tmp_path))
    assert lineart.models["fine"] is lineart.models["coarse"]


@pytest.mark.parametrize("cls", [thed.HEDdetector, thed.HEDSketchDetector,
                                 tlin.LineartDetector, tlin.LineartAnimeDetector,
                                 tlin.LineartAnimeWithColorPromptDetector, tmlsd.MLSDdetector])
def test_detectors_default_to_the_card(cls, tmp_path):
    """Asked for nothing, a detector runs on cuda; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(ckpt_dir=str(tmp_path))


def test_ensure_ckpt_verifies_and_never_downloads(tmp_path, monkeypatch):
    f = tmp_path / "netG.pth"
    f.write_bytes(b"weights")
    assert download.ensure_ckpt("netG.pth", str(f)) == str(f)
    (tmp_path / "SHA256SUMS").write_text(f"{download.sha256(str(f))} netG.pth\n")
    assert download.ensure_ckpt("netG.pth", str(f)) == str(f)
    (tmp_path / "SHA256SUMS").write_text(f"{'0' * 64} netG.pth\n")
    with pytest.raises(RuntimeError, match="corrupted"):
        download.ensure_ckpt("netG.pth", str(f))
    missing = str(tmp_path / "sk_model.pth")
    assert download.ensure_ckpt("sk_model.pth", missing) == missing
    monkeypatch.setenv(download.ALLOW_ENV, "1")
    with pytest.raises(RuntimeError, match="does not download"):
        download.ensure_ckpt("sk_model.pth", missing)
    monkeypatch.setenv(download.CKPT_ENV, str(tmp_path))
    assert download.ckpts_dir() == str(tmp_path)
