"""The port's NormalBAE (``ctrlora_tpu_torch/annotators/normalbae.py``)
against the JAX package's on the CPU, at the published widths on 64 x 64
images.

One seeded scannet.pt in the published layout (``chip_smoke.
write_detector_files``: the tensors under 'model' with DataParallel's
'module.', every BatchNorm unfolded, the conv_head's unused BatchNorm
included); JAX's tree is built by ``convert_nnet`` from the same tensors
(never by ``NNET().init``, which takes ~50 s on one core). The TF SAME
convolution equals XLA's "SAME" within 1e-5 at stride 1 and 2 on odd and
even sizes; the encoder's five maps agree within 1e-4 of their largest
|value|; the network's output (unit normals and kappa) within 2e-4
absolute (the decoder's align-corners grids sit a float32 ulp apart);
the detector's uint8 map within 1 level, on at most 0.5% of pixels (the
(n + 1) / 2 truncation moves a level wherever float32 rounding crosses a
step, as MiDaS's normal map does).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import normalbae as jnb
from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators import normalbae as tnb

NORMAL_ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("normalbae_ckpts"))
    chip_smoke.write_detector_files(d, names=[tnb.FILE])
    return d


@pytest.fixture(scope="module")
def dets(ckpt_dir):
    """(the port's detector, JAX's params from convert_nnet, JAX's jitted
    forward)."""
    sd = torch.load(os.path.join(ckpt_dir, tnb.FILE), weights_only=True)["model"]
    params = jax.tree_util.tree_map(jnp.asarray, jnb.convert_nnet(
        {k: v.numpy() for k, v in sd.items() if v.ndim}))
    return (tnb.NormalBaeDetector(device="cpu", ckpt_dir=ckpt_dir), params,
            jax.jit(jnb.NNET().apply))


def image(seed, hw):
    import cv2

    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (7, 7), 2.0)


def net_input(img):
    return ((img.astype(np.float32) / 255.0 - jnb._IMAGENET_MEAN) / jnb._IMAGENET_STD)[None]


@pytest.mark.parametrize("hw, k, stride, depthwise", [
    ((17, 23), 3, 2, False), ((16, 21), 5, 2, True), ((15, 15), 3, 1, True), ((9, 12), 1, 1, False)])
def test_same_conv_equals_xla_same(hw, k, stride, depthwise):
    """TF's SAME padding, the odd pixel after, on odd and even sizes."""
    rng = np.random.default_rng(k * stride)
    cin = 6
    x = rng.standard_normal((1, *hw, cin)).astype(np.float32)
    conv = tnb.SameConv2d(cin, cin, k, stride, groups=cin if depthwise else 1)
    w = rng.standard_normal(tuple(conv.weight.shape)).astype(np.float32)
    conv.weight.data = torch.from_numpy(w)
    with torch.inference_mode():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jnb._conv(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), stride,
                                cin if depthwise else 1))
    assert got.shape == want.shape == (1, -(-hw[0] // stride), -(-hw[1] // stride), cin)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_b5_stage_plan_equals_jax():
    assert tnb.b5_stages() == jnb.b5_stages()
    assert tnb.round_ch(32) == 48 and tnb.round_ch(1280) == 2048


def test_encoder_and_network_match_jax(dets):
    port, params, fwd = dets
    x = net_input(image(1, (64, 64)))
    feats = jnb.EffNetB5Encoder().apply({"params": params["params"]["encoder"]}, jnp.asarray(x))
    got = nets.forward(port.model.encoder.original_model, x)
    for g, w in zip(got, feats):
        w = np.asarray(w)
        assert g.shape == w.transpose(0, 3, 1, 2).shape
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    want = np.asarray(fwd(params, jnp.asarray(x)))
    out = nets.forward(port.model, x).permute(0, 2, 3, 1).numpy()
    assert out.shape == want.shape == (1, 64, 64, 4)
    assert np.abs(want[..., :3]).std() > 0.1  # normals that vary over the image
    np.testing.assert_allclose(out, want, rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_detector_matches_jax(dets, hw):
    """On a square and an oblong image (sizes whose decoder maps line up, as
    the reference needs: multiples of 16)."""
    port, params, fwd = dets
    img = image(hw[1], hw)
    got = port(img)
    normal = np.asarray(fwd(params, jnp.asarray(net_input(img))))[0, :, :, :3]
    want = (((normal + 1.0) * 0.5).clip(0, 1) * 255.0).astype(np.uint8)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.shape == (*hw, 3) and got.std() > 5
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, (diff.max(), (diff > 0).mean())


def test_without_a_file_torch_init_under_the_seed(tmp_path):
    a = tnb.NormalBaeDetector(device="cpu", ckpt_dir=str(tmp_path))
    b = tnb.NormalBaeDetector(device="cpu", ckpt_dir=str(tmp_path))
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    assert a(image(2, (32, 32))).shape == (32, 32, 3)


def test_nnet_keys_are_convert_nnets(ckpt_dir):
    """The folded module's keys are exactly the entries JAX's tree holds:
    every file tensor but the conv_head's BatchNorm is read."""
    sd = nets.read_weights(tnb.FILE, ckpt_dir, strip_module=True)
    folded = tnb.fold_nnet(sd)
    assert set(folded) == set(tnb.NNET().state_dict())
    assert not any(k.startswith("encoder.original_model.bn2") for k in folded)
    n_leaves = len(jax.tree_util.tree_leaves(jnb.convert_nnet(
        {k: v.numpy() for k, v in sd.items() if v.ndim})))
    assert n_leaves == len(folded)
