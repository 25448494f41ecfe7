"""The port's numpy/cv2 annotators and the evaluate_control /
evaluate_restore CLIs against the JAX package on the CPU.

Every simple detector of the registry gives JAX's output bit for bit on a
seeded image (the stochastic ones from equal numpy generators, ``pixel``
with a given palette), as do ``resize_image`` (up and down) and the other
helpers of ``util.py``; a CNN detector's name raises NotImplementedError.
The two CLIs, on a directory laid out as the sample CLI writes it (3
items, 64 px, prompt.txt) with seeded tiny LPIPS and CLIP files, print the
values JAX's MetricAccumulator gives on the same arrays.
"""

import os
import re

import cv2
import numpy as np
import pytest
import torch

from ctrlora_tpu import evaluation as jev
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu.annotators import simple as jsimple
from ctrlora_tpu.annotators import util as jutil
from ctrlora_tpu.models.lpips import convert_lpips as jconvert_lpips
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.annotators import simple as tsimple
from ctrlora_tpu_torch.annotators import util as tutil
from ctrlora_tpu_torch.scripts import evaluate_control, evaluate_restore
from ctrlora_tpu_torch.utils.image import write_png

from test_torch_evaluation import lpips_sd, tiny_clip_sd


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


@pytest.mark.parametrize("name", sorted(treg.CNN))
def test_cnn_detector_names_raise_not_implemented(name):
    assert name in jreg.available() and name in treg.available()
    with pytest.raises(NotImplementedError, match="item 14"):
        treg.get(name)


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
