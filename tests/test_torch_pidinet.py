"""The port's PiDiNet (``ctrlora_tpu_torch/annotators/pidinet.py``) against
the JAX package's on the CPU.

``convert_pdc`` gives JAX's kernels bit for bit on each op (cd, ad, rd,
cv). One seeded table5_pidinet.pth as published (pdc kernels unconverted,
'module.' keys under 'state_dict'; ``chip_smoke.write_detector_files``) at
the published widths (60 planes, dil 24, sa): JAX reads it through
``convert_pidinet``, the port converts it at load; the five edge maps of a
64^2 input agree in fp32 within 1e-5. The side outputs' bilinear
up-sampling (``F.interpolate``, align_corners=False) equals JAX's
``jax.image.resize`` to rounding at the four side stages. The detector's
map is within 1 level on at most 0.1% of pixels, with and without
``safe``.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import pidinet as jpidi
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu_torch.annotators import download, nets
from ctrlora_tpu_torch.annotators import pidinet as tpidi
from ctrlora_tpu_torch.annotators import registry as treg

FILE = "table5_pidinet.pth"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pidinet_ckpts"))
    chip_smoke.write_detector_files(d, names=[FILE])
    return d


@pytest.fixture(scope="module")
def file_sd(ckpt_dir):
    return torch.load(f"{ckpt_dir}/{FILE}", weights_only=True)["state_dict"]


def image(seed, hw=(64, 64)):
    import cv2

    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


@pytest.mark.parametrize("op", ["cd", "ad", "rd", "cv"])
def test_convert_pdc_bit_equal_to_jax(op):
    w = np.random.default_rng(3).standard_normal((6, 4, 3, 3)).astype(np.float32)
    got, want = tpidi.convert_pdc(op, w), jpidi.convert_pdc(op, w)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.shape[2:] == ((5, 5) if op == "rd" else (3, 3))
    np.testing.assert_array_equal(got, want)


def test_published_file_keys(file_sd):
    """The written file holds 'module.' + each of PiDiNet's keys, the pdc
    kernels at 3x3 (rd too); converted, they are JAX's kernels bit for
    bit."""
    model_sd = tpidi.PiDiNet().state_dict()
    assert set(file_sd) == {f"module.{k}" for k in model_sd}
    ops = tpidi.block_ops()
    assert set(ops.values()) == {"cd", "ad", "rd", "cv"}
    for k, v in file_sd.items():
        k = k[len("module."):]
        want = (*model_sd[k].shape[:2], 3, 3) if k in ops else tuple(model_sd[k].shape)
        assert tuple(v.shape) == want, k
    params = jpidi.convert_pidinet({k: v.numpy() for k, v in file_sd.items()})
    converted = tpidi.convert_state({k[len("module."):]: v for k, v in file_sd.items()})
    np.testing.assert_array_equal(
        converted["block1_3.conv1.weight"].numpy().transpose(2, 3, 1, 0),
        params["block1_3"]["conv1"]["kernel"])  # rd, 5x5
    np.testing.assert_array_equal(converted["init_block.weight"].numpy().transpose(2, 3, 1, 0),
                                  params["init_block"]["kernel"])


def test_net_matches_jax_at_published_width(file_sd):
    """The five sigmoid maps of a 64^2 input within 1e-5."""
    params = jax.tree_util.tree_map(
        jnp.asarray, jpidi.convert_pidinet({k: v.numpy() for k, v in file_sd.items()}))
    model = nets.build(tpidi.PiDiNet,
                       tpidi.convert_state({k[len("module."):]: v for k, v in file_sd.items()}),
                       "pidinet", "cpu")
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    got = nets.forward(model, x)
    want = jpidi.pidinet_forward(params, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("size", [64, 32, 16, 8])
def test_side_upsampling_equals_jax_resize(size):
    """A side stage's [1, 1, size, size] map up to 64^2: F.interpolate
    (bilinear, align_corners=False) against jax.image.resize, to rounding."""
    e = np.random.default_rng(size).standard_normal((1, size, size, 1)).astype(np.float32)
    got = F.interpolate(torch.from_numpy(e).permute(0, 3, 1, 2), size=(64, 64),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(e), (1, 64, 64, 1), method="bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(e).max())


@pytest.fixture(scope="module")
def detectors(ckpt_dir):
    mp = pytest.MonkeyPatch()
    mp.setenv(download.CKPT_ENV, ckpt_dir)
    mp.setattr(jreg, "_CACHE", {})
    mp.setattr(treg, "_CACHE", {})
    yield treg.get("pidinet", "cpu"), jreg.get("pidinet")
    mp.undo()


@pytest.mark.parametrize("safe", [False, True])
def test_detector_matches_jax(detectors, safe):
    """Within 1 level on at most 0.1% of pixels (non-square image)."""
    det, jdet = detectors
    img = image(4, (72, 56))
    got, want = det(img, safe=safe), jdet(img, safe=safe)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (72, 56)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    assert len(np.unique(got)) >= (2 if safe else 20)  # safe_step leaves 3 levels


def test_detector_without_file_takes_seeded_init(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv(download.CKPT_ENV, str(tmp_path))
    with caplog.at_level(logging.WARNING):
        a = tpidi.PidiNetDetector(device="cpu")
    assert "no weight file" in caplog.text
    b = tpidi.PidiNetDetector(device="cpu")
    img = image(5)
    np.testing.assert_array_equal(a(img), b(img))


def test_detector_on_cuda_without_a_card_raises(ckpt_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpidi.PidiNetDetector(device="cuda", ckpt_dir=ckpt_dir)
