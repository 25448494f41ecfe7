"""The port's FID InceptionV3, its preprocessing, the Inception Score and
the evaluate_fid CLI against the JAX package on the CPU.

A seeded torchvision-named pt_inception state dict goes through both
packages' convert_inception; features and logits agree at [1, 75, 75, 3]
(75 px survives the stem, as in JAX's own test) within JAX's test's
tolerance, rtol 1e-3 / atol 1e-4. Every input comes from a numpy seed.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlora_tpu.models import inception as jinc
from ctrlora_tpu_torch import convert
from ctrlora_tpu_torch.models import inception as tinc
from ctrlora_tpu_torch.scripts import evaluate_fid as tfid
from ctrlora_tpu_torch.utils.image import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Six pytest processes share the host's cores: one torch thread each
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inception_sd(seed=0):
    """pt_inception-2015-12-05's torchvision names and shapes, seeded
    weights and BN buffers (weights N(0, 0.02), means N(0, 0.1), variances
    U(0.5, 1.5), as JAX's test draws them)."""
    rng = np.random.default_rng(seed)
    model = tinc.FIDInceptionV3()
    sd = {}
    for name, p in model.state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        if prefix == "fc":
            sd[name] = rng.normal(0, 0.02, tuple(p.shape)).astype(np.float32)
        elif leaf == "weight":
            sd[f"{prefix}.conv.weight"] = rng.normal(0, 0.02, tuple(p.shape)).astype(np.float32)
        elif leaf == "scale":
            c = p.shape[0]
            sd[f"{prefix}.bn.weight"] = rng.normal(1, 0.02, c).astype(np.float32)
            sd[f"{prefix}.bn.bias"] = rng.normal(0, 0.02, c).astype(np.float32)
            sd[f"{prefix}.bn.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            sd[f"{prefix}.bn.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sd[f"{prefix}.bn.num_batches_tracked"] = np.array(0, np.int64)
    return sd


@pytest.fixture(scope="module")
def inception():
    """(torch state dict, JAX tree, the JAX features at [1, 75, 75, 3],
    the input): JAX's network jitted once."""
    sd = inception_sd()
    jtree = jinc.convert_inception(sd)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 75, 75, 3)).astype(np.float32)
    want = jax.jit(jinc.inception_features)(jtree, jnp.asarray(x))
    return sd, jtree, [np.asarray(w) for w in want], x


@pytest.mark.parametrize("route", ["convert_inception", "carry"])
def test_inception_features_and_logits_match_jax(inception, route):
    """The port's model from its own convert_inception, and from the JAX
    tree through inception_from_jax (equal to it bit for bit): pool3
    features and fc logits within rtol 1e-3 / atol 1e-4."""
    sd, jtree, (want_f, want_l), x = inception
    state = tinc.convert_inception(sd)
    if route == "carry":
        carried = convert.inception_from_jax(jtree)
        assert set(carried) == set(state)
        for k in state:
            assert torch.equal(carried[k], state[k]), k
        state = carried
    model = tinc.FIDInceptionV3.from_state_dict(state, "cpu")
    f, logits = tinc.inception_features(model, torch.from_numpy(x))
    assert tuple(f.shape) == (1, 2048) and tuple(logits.shape) == (1, 1008)
    np.testing.assert_allclose(f.numpy(), want_f, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), want_l, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("hw", [(64, 48), (299, 299), (512, 384)])
def test_fid_preprocess_matches_jax(hw):
    """uint8 [2, H, W, 3] -> [-1, 1] at 299^2 (bilinear, align_corners
    False, no antialias: up, identity and down), within 1e-6."""
    imgs = np.random.default_rng(2).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = jinc.fid_preprocess(imgs)
    got = tinc.fid_preprocess(imgs, "cpu").numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inception_score_equals_jax():
    logits = np.random.default_rng(3).normal(0, 3, (40, 1008)).astype(np.float32)
    assert tinc.inception_score(logits) == jinc.inception_score(logits)
    assert tinc.inception_score(logits, splits=4) == jinc.inception_score(logits, splits=4)


def _jax_fid_script():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import evaluate_fid
    finally:
        sys.path.pop(0)
    return evaluate_fid


def test_frechet_distance_and_stats_equal_jax_script():
    rng = np.random.default_rng(4)
    fa = rng.normal(0, 1, (64, 16))
    fb = rng.normal(0.3, 1.2, (80, 16))
    jfid = _jax_fid_script()
    for got, want in zip(tfid.stats(fa), jfid.stats(fa)):
        np.testing.assert_array_equal(got, want)
    assert tfid.frechet_distance(*tfid.stats(fa), *tfid.stats(fb)) == \
        jfid.frechet_distance(*jfid.stats(fa), *jfid.stats(fb))


def test_evaluate_fid_cli_prints_finite_is_and_fid(tmp_path, capsys):
    """A full-width Inception file, 3 seeded 64 px images a set, --bs 2
    on the CPU: finite IS and FID, printed as JAX's script prints them (one
    2048-d matrix square root: ~11 s of the test's time)."""
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in inception_sd().items()},
               tmp_path / "pt_inception.pth")
    rng = np.random.default_rng(5)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        for i in range(3):
            write_png(str(tmp_path / d / f"{i:06d}.png"),
                      rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    out = tfid.main(["--dir_a", str(tmp_path / "a"), "--dir_b", str(tmp_path / "b"),
                     "--inception_ckpt", str(tmp_path / "pt_inception.pth"), "--bs", "2",
                     "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"IS: {out['IS']:.4f} +/- {out['IS std']:.4f}"
    assert lines[1] == "features: 3 vs 3 (2048-d)"
    assert lines[2] == f"FID: {out['FID']:.4f}"
    assert all(np.isfinite(v) for v in out.values()) and out["IS"] >= 1.0 and out["FID"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: cuda is valid")
@pytest.mark.parametrize("cli", ["evaluate_fid", "evaluate_restore", "evaluate_control"])
def test_evaluate_clis_refuse_cuda_without_a_card(cli, tmp_path):
    """Without --device cpu on a machine with no CUDA device each CLI
    raises; none falls back to the CPU."""
    import importlib

    mod = importlib.import_module(f"ctrlora_tpu_torch.scripts.{cli}")
    os.makedirs(tmp_path / "sample")
    argv = {"evaluate_fid": ["--dir_a", str(tmp_path), "--inception_ckpt", "x.pth"],
            "evaluate_restore": ["--sample_dir", str(tmp_path)],
            "evaluate_control": ["--sample_dir", str(tmp_path), "--detector", "canny"]}[cli]
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv)
