"""The port's ZoeDepth (``ctrlora_tpu_torch/annotators/zoe.py``) against the
JAX package's on the CPU.

One seeded ZoeD_M12_N.pt in the published layout (``chip_smoke.
write_detector_files``: the tensors under 'model', with BEiT's classifier,
which the detector leaves out) at small widths (BEiT 32 wide, 4 blocks of 2
heads, every block hooked, the DPT neck 16 wide; both packages' width
constants patched for the module's tests; the metric head at its published
widths). JAX reads it through ``convert_zoe``. The relative-position index
is bit-equal to JAX's; the resized bias tables, the bicubic resize and the
net's raw metric depth agree in fp32 within the tolerances each test states
(the bin up-samplings' align-corners grids sit a float32 ulp apart, and the
log-binomial at MIN_TEMP, near an argmax over bins, passes that on). The
detector is held on its raw depth, averaged over the flip, not on its uint8
map: the 2/85 percentile stretch maps any depth range onto 0..255, so the
map is compared by shape and dtype only. At the published widths the module
built on the meta device has exactly the keys JAX's converter reads.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import zoe as jzoe
from ctrlora_tpu_torch.annotators import zoe as tzoe

SMALL = {"BEIT_DIM": 32, "BEIT_LAYERS": 4, "BEIT_HEADS": 2, "HOOKS": (0, 1, 2, 3),
         "REASSEMBLE": (8, 16, 32, 32), "FEATURES": 16}
JAX_CONSTANTS = ("BEIT_DIM", "BEIT_LAYERS", "BEIT_HEADS", "HOOKS")
# the raw metric depth, port against JAX: relative to the largest |depth|
DEPTH_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def patch_small(mp):
    for k, v in SMALL.items():
        mp.setattr(tzoe, k, v)
        if k in JAX_CONSTANTS:
            mp.setattr(jzoe, k, v)


@pytest.fixture(scope="module")
def small():
    mp = pytest.MonkeyPatch()
    patch_small(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ckpt_dir(small, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("zoe_ckpts"))
    chip_smoke.write_detector_files(d, names=[tzoe.FILE])
    return d


def jax_params(path):
    sd = torch.load(path, weights_only=True)["model"]
    return jax.tree_util.tree_map(jnp.asarray, jzoe.convert_zoe({k: v.numpy() for k, v in sd.items()}))


@pytest.fixture(scope="module")
def dets(ckpt_dir):
    """(the port's detector, JAX's)."""
    return (tzoe.ZoeDetector(device="cpu", ckpt_dir=ckpt_dir),
            jzoe.ZoeDetector(ckpt_path=os.path.join(ckpt_dir, tzoe.FILE)))


def jax_raw_depth(jdet, img):
    """JAX's detector's depth before the stretch: the padded inference of the
    image and of its flip, averaged (ZoeDetector.__call__)."""
    img01 = img.astype(np.float32) / 255.0
    d = jdet._infer_pad(img01)
    return (d + jdet._infer_pad(img01[:, ::-1])[:, ::-1]) / 2.0


def image(seed, hw):
    import cv2

    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


def assert_depth_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.ptp(want) > 1e-2, np.ptp(want)  # a range far above fp32 noise
    np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_RTOL * np.abs(want).max())


@pytest.mark.parametrize("window", [(24, 24), (12, 16), (3, 5), (32, 24)])
def test_relative_position_index_bit_equal(window):
    np.testing.assert_array_equal(tzoe.gen_relative_position_index(*window),
                                  jzoe.gen_relative_position_index(*window))


@pytest.mark.parametrize("window", [(24, 24), (32, 24), (12, 16)])
def test_rel_pos_bias_matches_jax(window):
    """The 47 x 47 grid resized (bilinear, no aligned corners) to the
    window's and gathered, for 16 heads: within 1e-6 of JAX's gather."""
    table = np.random.default_rng(window[0]).standard_normal((47 * 47 + 3, 16)).astype(np.float32)
    got = tzoe.rel_pos_bias(torch.from_numpy(table), *window).numpy()
    want = np.asarray(jzoe._rel_pos_bias(jnp.asarray(table), *window))
    n = window[0] * window[1] + 1
    assert got.shape == want.shape == (1, 16, n, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_zoe_forward_raw_depth_matches_jax(dets, ckpt_dir):
    """The net at a 12 x 16 token grid (the bias tables resized): the metric
    depth within DEPTH_RTOL of the largest |depth|."""
    port, _ = dets
    x = np.random.default_rng(3).uniform(-1, 1, (1, 192, 256, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jzoe.zoe_forward)(jax_params(os.path.join(ckpt_dir, tzoe.FILE)),
                                                jnp.asarray(x)))[..., 0]
    with torch.inference_mode():
        got = port.model(torch.from_numpy(x).permute(0, 3, 1, 2))[:, 0].numpy()
    assert_depth_close(got, want)


def test_infer_pad_with_flip_matches_jax(dets):
    """Reflect padding, the 'minimal' resize, the net, the bicubic resize
    back and the flip average on an 80 x 96 image: the raw depth within
    DEPTH_RTOL; the uint8 map has JAX's shape and dtype."""
    port, jdet = dets
    img = image(4, (80, 96))
    assert_depth_close(port.raw_depth(img), jax_raw_depth(jdet, img))
    got = port(img)
    assert got.shape == (80, 96) and got.dtype == np.uint8 and got.std() > 10


@pytest.mark.parametrize("src, dst", [((20, 28), (37, 45)), ((40, 24), (31, 50)), ((8, 8), (8, 16))])
def test_bicubic_resize_matches_jax(src, dst):
    x = np.random.default_rng(src[0]).standard_normal((1, *src, 2)).astype(np.float32)
    want = np.asarray(jzoe._resize_bicubic(jnp.asarray(x), dst))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bicubic",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_minimal_resize_size_equals_jax():
    for h in (1, 17, 96, 300, 384, 512, 608, 1000):
        for w in (1, 23, 96, 384, 512, 640, 1333):
            assert tzoe.minimal_resize_size(h, w) == jzoe.minimal_resize_size(h, w), (h, w)


def test_without_a_file_raises(small, tmp_path):
    with pytest.raises(FileNotFoundError, match=tzoe.FILE):
        tzoe.ZoeDetector(device="cpu", ckpt_dir=str(tmp_path))


PUBLISHED = {"BEIT_DIM": 1024, "BEIT_LAYERS": 24, "BEIT_HEADS": 16, "HOOKS": (5, 11, 17, 23),
             "REASSEMBLE": (256, 512, 1024, 1024), "FEATURES": 256}


def test_zoe_keys_at_published_widths(monkeypatch):
    """ZoeDepth() at the published widths: exactly the keys convert_zoe
    reads, at shapes JAX's forward traces at 384 x 512."""
    from test_torch_midas import Recorder, layout

    for k, v in PUBLISHED.items():
        monkeypatch.setattr(tzoe, k, v)
        if k in JAX_CONSTANTS:
            monkeypatch.setattr(jzoe, k, v)
    with torch.device("meta"):
        model = tzoe.ZoeDepth()
    sd = Recorder(layout(model))
    params = jzoe.convert_zoe(sd)
    assert sd.read == set(sd) and len(sd) == 24 * 16 + 121
    out = jax.eval_shape(jzoe.zoe_forward, params,
                         jax.ShapeDtypeStruct((1, 384, 512, 3), jnp.float32))
    assert out.shape == (1, 384, 512, 1)
    assert sd["core.core.pretrained.model.blocks.0.attn.relative_position_bias_table"].shape == \
        (47 * 47 + 3, 16)
