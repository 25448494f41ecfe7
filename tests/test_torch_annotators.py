"""The port's annotator registry and the evaluate_control /
evaluate_restore / evaluate_lineart(_is_coarse) CLIs against the JAX
package on the CPU.

Every simple detector of the registry gives JAX's output bit for bit on a
seeded image (the stochastic ones from equal numpy generators, ``pixel``
with a given palette), as do ``resize_image`` (up and down) and the other
helpers of ``util.py``. Each ported CNN detector's name builds its
detector on the CPU from seeded published-layout files
(``chip_smoke.write_detector_files``; DPT, UniFormer and DensePose at small
widths) and gives JAX's map within 1 level on 0.1% of pixels (MLSD's drawn
segments: 99% of pixels equal; the normal, seg, openpose, bbox and
densepose maps as ``test_ported_cnn_detector_builds_on_cpu_and_matches_jax``
says); the other CNN names (OneFormer's two, normalbae, zoe) raise
NotImplementedError. The CLIs, on a directory laid out as
the sample CLI writes it (3 items, 64 px, prompt.txt) with seeded tiny
LPIPS and CLIP files, print the values JAX's MetricAccumulator gives on
the same arrays; the lineart CLIs print JAX's flags and values.
"""

import os
import re

import cv2
import numpy as np
import pytest
import torch

from ctrlora_tpu import evaluation as jev
from ctrlora_tpu.annotators import densepose as jdensepose
from ctrlora_tpu.annotators import midas as jmidas
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu.annotators import simple as jsimple
from ctrlora_tpu.annotators import uniformer as juni
from ctrlora_tpu.annotators import util as jutil
from ctrlora_tpu.models.lpips import convert_lpips as jconvert_lpips
import chip_smoke
from ctrlora_tpu_torch.annotators import densepose as tdensepose
from ctrlora_tpu_torch.annotators import download
from ctrlora_tpu_torch.annotators import midas as tmidas
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.annotators import simple as tsimple
from ctrlora_tpu_torch.annotators import uniformer as tuni
from ctrlora_tpu_torch.annotators import util as tutil
from ctrlora_tpu_torch.scripts import (
    evaluate_control, evaluate_lineart, evaluate_lineart_is_coarse, evaluate_restore,
)
from ctrlora_tpu_torch.utils.image import write_png

from test_torch_densepose import SIZES as DENSEPOSE_SIZES
from test_torch_densepose import SMALL as DENSEPOSE_SMALL
from test_torch_evaluation import lpips_sd, tiny_clip_sd
from test_torch_midas import SMALL as DPT_SMALL
from test_torch_uniformer import SMALL as UNIFORMER_SMALL


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Six pytest processes share the host's cores: one torch thread each
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image(seed=0, hw=(96, 80)):
    """A seeded uint8 RGB image with structure (a blurred random field, so
    the edge and threshold detectors see edges and levels)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 2.0)


STOCHASTIC = {"inpainting_brush", "shuffle", "color_shuffle", "gray_random", "downsample"}


def detector_args(name):
    """Fresh keyword arguments for one call: an equal numpy generator for
    the stochastic detectors, a given palette for 'pixel'."""
    if name in STOCHASTIC:
        return {"rng": np.random.default_rng(7)}
    if name == "pixel":
        return {"palette": np.random.default_rng(2).integers(0, 256, (16, 3), dtype=np.uint8)}
    return {}


@pytest.mark.parametrize("name", sorted(treg.SIMPLE))
def test_simple_detector_bit_equal_to_jax(name):
    img = image(1)
    want = jreg.get(name)(img.copy(), **detector_args(name))
    got = treg.get(name)(img.copy(), **detector_args(name))
    assert type(treg.get(name)).__name__ == type(jreg.get(name)).__name__
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_image2mask_shuffle_bit_equal_to_jax():
    img = image(3)
    want = jsimple.Image2MaskShuffleDetector((64, 48))(img, rng=np.random.default_rng(4))
    got = tsimple.Image2MaskShuffleDetector((64, 48))(img, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,res", [((64, 48), 512), ((480, 640), 512), ((512, 512), 512),
                                    ((700, 300), 256)])
def test_resize_image_bit_equal_to_jax(hw, res):
    img = image(5, hw)
    np.testing.assert_array_equal(tutil.resize_image(img, res), jutil.resize_image(img, res))


def test_util_helpers_equal_to_jax():
    img = image(6)
    x = img[..., 0].astype(np.float32) / 255
    np.testing.assert_array_equal(tutil.nms(x, 0.3, 1.5), jutil.nms(x, 0.3, 1.5))
    np.testing.assert_array_equal(
        tutil.make_noise_disk(40, 30, 3, 16, np.random.default_rng(1)),
        jutil.make_noise_disk(40, 30, 3, 16, np.random.default_rng(1)))
    np.testing.assert_array_equal(tutil.min_max_norm(x), jutil.min_max_norm(x))
    np.testing.assert_array_equal(tutil.safe_step(x), jutil.safe_step(x))
    np.testing.assert_array_equal(tutil.img2mask(img, 32, 24, rng=np.random.default_rng(2)),
                                  jutil.img2mask(img, 32, 24, rng=np.random.default_rng(2)))
    for a in (img, img[..., :1], img[..., 0], np.concatenate([img, img[..., :1]], -1)):
        np.testing.assert_array_equal(tutil.HWC3(a), jutil.HWC3(a))


@pytest.mark.parametrize("name", sorted(treg.NOT_PORTED))
def test_cnn_detector_names_raise_not_implemented(name):
    assert name in jreg.available() and name in treg.available()
    with pytest.raises(NotImplementedError, match="item 14"):
        treg.get(name)


@pytest.fixture(scope="module")
def detector_ckpts(tmp_path_factory):
    """A CTRLORA_ANNOTATOR_CKPTS directory of seeded published-layout files
    for both packages (DPT, UniFormer and DensePose at small widths, both
    packages' width and DensePose's size constants patched; the YOLO and
    DensePose biases tuned to the 64^2 test image), and empty registry
    caches (restored after)."""
    d = tmp_path_factory.mktemp("detector_ckpts")
    mp = pytest.MonkeyPatch()
    for mods, widths in (((jmidas, tmidas), DPT_SMALL), ((juni, tuni), UNIFORMER_SMALL),
                         ((tdensepose,), DENSEPOSE_SMALL),
                         ((jdensepose, tdensepose), DENSEPOSE_SIZES)):
        for k, v in widths.items():
            for mod in mods:
                mp.setattr(mod, k, v)
    chip_smoke.write_detector_files(str(d), image=image(12, (64, 64)))
    mp.setenv(download.CKPT_ENV, str(d))
    mp.setattr(jreg, "_CACHE", {})
    mp.setattr(treg, "_CACHE", {})
    yield str(d)
    mp.undo()


@pytest.mark.parametrize("name", sorted(treg.CNN))
def test_ported_cnn_detector_builds_on_cpu_and_matches_jax(detector_ckpts, name):
    """Maps within 1 level on 0.1% of pixels; MLSD's drawn segments: 99% of
    pixels equal; the normal map: within 1 level on all but 0.1% of pixels,
    0.5% differing (tests/test_torch_midas.py); seg, openpose, bbox and
    densepose: 0.1% of pixels differing (an argmax near a tie, a peak or a
    box near a threshold).
    MiDaS at 384 px, the least input at which JAX resizes the position
    grid as the reference does."""
    midas = name in ("midas", "depth", "normal")
    img = image(12, (384, 384) if midas else (64, 64))
    det = treg.get(name, "cpu")
    assert treg.get(name, torch.device("cpu")) is det
    assert type(det).__name__ == type(jreg.get(name)).__name__
    kw = lambda: {"rng": np.random.default_rng(5)} if name in (
        "hedsketch", "lineart_anime_with_color_prompt") else {}
    got, want = det(img.copy(), **kw()), jreg.get(name)(img.copy(), **kw())
    pairs = zip(("depth", "normal"), got, want) if name == "midas" else [(name, got, want)]
    for kind, got, want in pairs:
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        if kind == "mlsd":
            assert want.any() and (got == want).mean() >= 0.99
        elif kind in ("seg", "openpose", "bbox", "densepose"):
            assert (diff.max(axis=-1) > 0).mean() <= 1e-3
        elif kind == "normal":
            diff = diff.max(axis=-1)
            assert (diff > 1).mean() <= 1e-3 and (diff > 0).mean() <= 5e-3
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(),
                                                                    (diff > 0).mean())


def test_registry_names_are_jax_names():
    assert treg.available() == jreg.available()
    with pytest.raises(KeyError):
        treg.get("no_such_detector")


# ---------------------------------------------------------------------------
# evaluate_control and evaluate_restore
# ---------------------------------------------------------------------------

PROMPTS = ["a photo of a house by a lake", "a red car", "a dog on grass"]


@pytest.fixture(scope="module")
def sample_dir(tmp_path_factory):
    """3 items at 64 px as the sample CLI writes them (sample/, control/,
    img/, 'NNNNNN: prompt' lines), and seeded tiny LPIPS (VGG16's layers at
    widths 4-8) and CLIP (2 x 64) files."""
    root = tmp_path_factory.mktemp("samples")
    rng = np.random.default_rng(8)
    for sub in ("sample", "control", "img"):
        os.makedirs(root / sub)
    for i in range(3):
        img = image(10 + i, (64, 64))
        write_png(str(root / "img" / f"{i:06d}.png"), img)
        write_png(str(root / "sample" / f"{i:06d}.png"),
                  np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8))
        write_png(str(root / "control" / f"{i:06d}.png"),
                  np.stack([cv2.Canny(img, 100, 200)] * 3, -1))
    with open(root / "prompt.txt", "w") as f:
        f.write("\n".join(f"{i:06d}: {p}" for i, p in enumerate(PROMPTS)) + "\n")
    lp = lpips_sd(widths=(4, 8, 8, 8, 8))
    clip = tiny_clip_sd()
    torch.save({k: torch.from_numpy(v) for k, v in lp.items()}, root / "lpips.pth")
    torch.save({k: torch.from_numpy(v) for k, v in clip.items()}, root / "clip.pth")
    return root, lp, clip


def _read(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _jax_expected(root, lp, clip, mode, bs=2):
    """JAX's MetricAccumulator over the arrays the CLI reads, batch by
    batch, with each sample's prompt."""
    acc = jev.MetricAccumulator(lpips_params=jconvert_lpips(lp),
                                clip_scorer=jev.CLIPScorer.from_torch_state(clip))
    names = sorted(os.listdir(root / "sample"))
    to512 = lambda im: jutil.resize_image(jutil.HWC3(im), 512).astype(np.float32) / 255.0
    for s in range(0, len(names), bs):
        batch = names[s:s + bs]
        samples = np.stack([_read(root / "sample" / n) for n in batch])
        if mode == "control":
            canny = jreg.get("canny")
            a = np.stack([to512(canny(x, low_threshold=100, high_threshold=200))
                          for x in samples])
            b = np.stack([to512(_read(root / "control" / n)) for n in batch])
        else:
            a = np.stack([to512(x) for x in samples])
            b = np.stack([to512(_read(root / "img" / n)) for n in batch])
        acc.update(a, b, sample=samples, prompts=[PROMPTS[int(n[:6])] for n in batch])
    return acc.compute()


@pytest.mark.parametrize("mode", ["restore", "control"])
def test_evaluate_cli_prints_jax_values(sample_dir, mode, capsys):
    """--bs 2 --device cpu with --lpips_ckpt and --clip_ckpt: the five
    metrics printed as 'NAME: value' (4 decimals) and returned, each within
    1e-4 of JAX's value (CLIPScore within 1e-3). At 512^2 SSIM's variance
    terms cancel in fp32: the two packages' SSIM sit ~2e-5 apart here."""
    root, lp, clip = sample_dir
    argv = ["--sample_dir", str(root), "--bs", "2", "--device", "cpu",
            "--lpips_ckpt", str(root / "lpips.pth"), "--clip_ckpt", str(root / "clip.pth")]
    if mode == "control":
        got = evaluate_control.main(argv + ["--detector", "canny"])
    else:
        got = evaluate_restore.main(argv)
    want = _jax_expected(root, lp, clip, mode)
    assert set(got) == set(want) == {"mse", "psnr", "ssim", "lpips", "clip score"}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Dataset size: 3"
    printed = dict(re.match(r"([A-Z ]+): (-?[0-9.]+)$", ln).groups() for ln in lines[1:])
    assert set(printed) == {k.upper() for k in want}
    for k, v in want.items():
        tol = 1e-3 if k == "clip score" else 1e-4
        assert abs(float(printed[k.upper()]) - v) <= tol, (k, printed[k.upper()], v)
        assert abs(got[k] - v) <= tol, (k, got[k], v)
    assert got["lpips"] >= 0 and 0 <= got["clip score"] <= 100


def test_evaluate_restore_reads_bare_prompt_lines(sample_dir, tmp_path):
    """A prompt.txt of bare lines keys prompts by line index, as JAX's
    CLIs do: stems '0', '1', ... match, and CLIPScore is computed."""
    root, _, _ = sample_dir
    for sub in ("sample", "img"):
        os.makedirs(tmp_path / sub)
        for i in range(2):
            os.link(root / sub / f"{i:06d}.png", tmp_path / sub / f"{i}.png")
    with open(tmp_path / "prompt.txt", "w") as f:
        f.write("\n".join(PROMPTS[:2]) + "\n")
    got = evaluate_restore.main(["--sample_dir", str(tmp_path), "--device", "cpu",
                                 "--clip_ckpt", str(root / "clip.pth")])
    assert set(got) == {"mse", "psnr", "ssim", "clip score"}


# ---------------------------------------------------------------------------
# evaluate_lineart_is_coarse and evaluate_lineart
# ---------------------------------------------------------------------------

def _jax_script(name):
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lineart_clis_print_jax_values(sample_dir, detector_ckpts, tmp_path, monkeypatch,
                                       capsys):
    """On the 3-item sample directory, with the seeded sk_model*.pth: the
    coarse flags file equals JAX's, and evaluate_lineart prints JAX's MSE,
    PSNR and SSIM (4 decimals, within 1e-4) with and without the flags."""
    import sys

    root, _, _ = sample_dir
    flags = {}
    for who in ("port", "jax"):
        out = str(tmp_path / f"{who}_flags.txt")
        if who == "port":
            evaluate_lineart_is_coarse.main(["--sample_dir", str(root), "--out", out,
                                             "--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["x", "--sample_dir", str(root), "--out", out])
            _jax_script("evaluate_lineart_is_coarse").main()
        with open(out) as f:
            flags[who] = f.read()
    assert flags["port"] == flags["jax"] and len(flags["port"].splitlines()) == 3
    capsys.readouterr()
    for is_coarse in (str(tmp_path / "port_flags.txt"), str(tmp_path / "none.txt")):
        args = ["--sample_dir", str(root), "--is_coarse", is_coarse, "--bs", "2"]
        got = evaluate_lineart.main(args + ["--device", "cpu"])
        printed = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["x"] + args)
        _jax_script("evaluate_lineart").main()
        jprinted = capsys.readouterr().out
        parse = lambda text: dict(re.match(r"([A-Z ]+): (-?[0-9.]+)$", ln).groups()
                                  for ln in text.splitlines())
        p, j = parse(printed), parse(jprinted)
        assert set(p) == set(j) == {"MSE", "PSNR", "SSIM"} and set(got) == {"mse", "psnr",
                                                                            "ssim"}
        for k in j:
            assert abs(float(p[k]) - float(j[k])) <= 1e-4, (k, p[k], j[k])
