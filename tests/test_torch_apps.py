"""The port's app logic (``ctrlora_tpu_torch/apps/logic.py``) and gradio
front ends against the JAX package's on the CPU.

* the presets, ``reformat_prompt`` and ``detect`` equal JAX's: ``detect``
  for 'none', 'canny' and each ported CNN name with both packages reading
  one CTRLORA_ANNOTATOR_CKPTS directory of seeded files
  (``chip_smoke.write_detector_files``), uint8 maps within 1 level on 0.1%
  of pixels (MLSD's drawn segments: 99% of pixels equal); ``detect`` for
  'bbox' and 'densepose' gives a [512, 512, 3] uint8 map with colour;
* ``AppState.process`` / ``process2`` with a fake model pass
  ``_sample_images`` the same images, prompts, ``control_scales``,
  ``lora_weights``, seed and guess mode as JAX's AppState
  (tests/test_apps.py's pattern);
* ``process_controlnet`` and ``process_style`` run end to end at tiny size
  (deterministic under the seed, the model cached);
* each gradio module exits with JAX's message where gradio is missing.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from ctrlora_tpu.annotators import registry as jreg
from ctrlora_tpu.apps import logic as jlogic
from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.annotators import download
from ctrlora_tpu_torch.annotators import registry as treg
from ctrlora_tpu_torch.apps import logic
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.utils import ckpt_torch as bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image(seed, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (5, 5), 1.5)


def test_presets_equal_jax():
    assert logic.DET_CHOICES == jlogic.DET_CHOICES
    assert logic.ADD_PROMPTS == jlogic.ADD_PROMPTS
    assert logic.NEG_PROMPTS == jlogic.NEG_PROMPTS
    assert logic.DET_PARAMS == jlogic.DET_PARAMS


@pytest.mark.parametrize("prompt", [" a ,  b,, c , ", "", "one", ",,", "x, y ,z"])
def test_reformat_prompt_equals_jax(prompt):
    assert logic.reformat_prompt(prompt) == jlogic.reformat_prompt(prompt)


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def detector_env(tmp_path_factory):
    """One directory of seeded detector files for both packages, and empty
    registry caches (restored after the module)."""
    d = tmp_path_factory.mktemp("app_ckpts")
    chip_smoke.write_detector_files(str(d), names=["ControlNetHED.pth", "sk_model.pth",
                                                   "sk_model2.pth", "netG.pth",
                                                   "mlsd_large_512_fp32.pth"])
    mp = pytest.MonkeyPatch()
    mp.setenv(download.CKPT_ENV, str(d))
    mp.setattr(jreg, "_CACHE", {})
    mp.setattr(treg, "_CACHE", {})
    yield str(d)
    mp.undo()


@pytest.mark.parametrize("det", ["none", "canny", "hed", "hedsketch", "lineart",
                                 "lineart_coarse", "lineart_anime",
                                 "lineart_anime_with_color_prompt", "mlsd"])
def test_detect_equals_jax(detector_env, monkeypatch, det):
    """At 64 px in and out (the resizes are identities), hedsketch's
    threshold draws from equal generators."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(7 if seed is None else seed))
    img = image(3)
    got = logic.detect(det, img, 64, 64, device="cpu")
    want = jlogic.detect(det, img, 64, 64)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
    if det == "mlsd":
        assert want.any() and (got == want).mean() >= 0.99
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("det", ["bbox", "densepose"])
def test_detect_bbox_and_densepose(tmp_path, monkeypatch, det):
    """The two app choices ported last, on the CPU from seeded files (the
    YOLO cfg of chip_smoke, DensePose at small widths and sizes), tuned so
    that a few boxes of the image pass: [512, 512, 3] uint8 with colour."""
    from ctrlora_tpu_torch.annotators import densepose as tdensepose

    from test_torch_densepose import SIZES, SMALL

    for k, v in {**SMALL, **SIZES}.items():
        monkeypatch.setattr(tdensepose, k, v)
    img = image(9)
    name = {"bbox": "yolov4.weights", "densepose": tdensepose.FILE}[det]
    chip_smoke.write_detector_files(str(tmp_path), names=[name], image=img)
    monkeypatch.setenv(download.CKPT_ENV, str(tmp_path))
    monkeypatch.setattr(treg, "_CACHE", {})
    out = logic.detect(det, img, 64, 512, device="cpu")
    assert out.dtype == np.uint8 and out.shape == (512, 512, 3)
    assert (out != out[0, 0]).any() if det == "densepose" else out.any()


def test_detect_builds_cnn_detectors_on_the_card_by_default(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(treg, "_CACHE", {})
    monkeypatch.setenv(download.CKPT_ENV, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        logic.detect("hed", image(4))
    assert logic.detect("canny", image(4), 64, 64).shape == (64, 64, 3)


# ---------------------------------------------------------------------------
# AppState.process / process2 wiring
# ---------------------------------------------------------------------------

def fake_model(calls, taps):
    """A model whose _sample_images records its arguments; the port's
    counts taps as n_taps, JAX's as pipe.n_control_taps."""

    def sample(images, prompt, n_prompt, num_samples, ddim_steps, scale, lora_weights, seed,
               eta=0.0, guess_mode=False, control_scales=None):
        calls.append(dict(images=[np.array(i) for i in images], prompt=prompt,
                          n_prompt=n_prompt, num_samples=num_samples, ddim_steps=ddim_steps,
                          scale=scale, lora_weights=tuple(lora_weights), seed=seed, eta=eta,
                          guess_mode=guess_mode, control_scales=list(control_scales)))
        return np.zeros((num_samples, 8, 8, 3), np.uint8)

    return SimpleNamespace(_sample_images=sample, n_taps=taps,
                           pipe=SimpleNamespace(n_control_taps=taps))


def both_states(monkeypatch):
    calls = {"port": [], "jax": []}
    port, jx = logic.AppState(device="cpu"), jlogic.AppState()
    monkeypatch.setattr(port, "build_model", lambda *a, **k: fake_model(calls["port"], 13))
    monkeypatch.setattr(jx, "build_model", lambda *a, **k: fake_model(calls["jax"], 13))
    return port, jx, calls


def assert_same_calls(calls):
    (got,), (want,) = calls["port"], calls["jax"]
    assert len(got["images"]) == len(want["images"])
    for a, b in zip(got["images"], want["images"]):
        np.testing.assert_array_equal(a, b)
    assert {k: v for k, v in got.items() if k != "images"} == \
        {k: v for k, v in want.items() if k != "images"}


@pytest.mark.parametrize("guess_mode", [False, True])
def test_process_passes_what_jax_passes(monkeypatch, guess_mode):
    port, jx, calls = both_states(monkeypatch)
    img = image(5, (48, 40))[..., 0]  # grey: HWC3 makes it RGB in both
    args = ("canny", img, " a , house,", "low ,", 2, 7, guess_mode, 0.8, 6.5, 11, 0.25,
            "sd", "cn", "l1")
    out = port.process(*args)
    jout = jx.process(*args)
    assert_same_calls(calls)
    assert len(out) == len(jout) == 3 and np.array_equal(out[0], jout[0])
    want = [0.8 * 0.825 ** float(12 - i) for i in range(13)] if guess_mode else [0.8] * 13
    assert calls["port"][0]["control_scales"] == want


@pytest.mark.parametrize("guess_mode", [False, True])
def test_process2_passes_what_jax_passes(monkeypatch, guess_mode):
    port, jx, calls = both_states(monkeypatch)
    a, b = image(6, (64, 48)), image(7, (80, 64))  # centre-cropped to 64 x 48
    args = (a, b, "p ,q", "n", 1, 3, 1.2, 7.5, 5, 0.0, "sd", "cn", "l1", "l2", 1.0, 0.5)
    out = port.process2(*args, guess_mode=guess_mode)
    jout = jx.process2(*args, guess_mode=guess_mode)
    assert_same_calls(calls)
    assert calls["port"][0]["images"][1].shape == (64, 48, 3)
    for x, y in zip(out, jout):
        np.testing.assert_array_equal(x, y)


def test_seed_minus_one_draws_a_seed(monkeypatch):
    port, _, calls = both_states(monkeypatch)
    port.process("none", image(8), "p", "n", 1, 2, False, 1.0, 7.5, -1, 0.0, "sd", "cn", "l")
    assert 0 <= calls["port"][0]["seed"] <= 65535


def test_app_state_caches_on_the_paths(monkeypatch):
    built = []
    monkeypatch.setattr(logic, "CtrLoRA", lambda num_loras, device: SimpleNamespace(
        create_model=lambda *a: built.append(a)))
    state = logic.AppState(device="cpu")
    m1 = state.build_model("sd", "cn", ["a"])
    assert state.build_model("sd", "cn", ["a"]) is m1 and len(built) == 1
    state.build_model("sd", "cn", ["a", "b"])
    assert len(built) == 2


def test_app_state_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert logic.AppState().device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        logic.AppState().build_model(str(tmp_path / "sd"), str(tmp_path / "cn"), ["l"])


# ---------------------------------------------------------------------------
# the vanilla ControlNet and style apps at tiny size
# ---------------------------------------------------------------------------

def tiny_image_config():
    """The tiny image-hint ControlNet with a /8 VAE, so the hint and the
    image share a size (as phase 11's rehearsal configs)."""
    cfg = configs.tiny_test_config(hint_mode="image")
    vae = dataclasses.replace(cfg.vae, ch_mult=(1, 1, 2, 2))
    return dataclasses.replace(cfg, vae=vae, clip=dataclasses.replace(cfg.clip,
                                                                      vocab_size=49408))


def small_detect(monkeypatch):
    """The apps detect at 512 px; 64 here."""
    import functools

    monkeypatch.setattr(logic, "detect", functools.partial(logic.detect, detect_resolution=64,
                                                           image_resolution=64))


def test_process_controlnet_end_to_end(tmp_path, monkeypatch):
    cfg = tiny_image_config()
    monkeypatch.setattr(logic, "sd15_config", lambda: cfg)
    small_detect(monkeypatch)
    src = CtrLoraPipeline(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    for m in src.modules():
        chip_smoke.random_init_(m, gen)
    combined = {}
    for prefix, module, entries in chip_smoke.sd_parts(cfg):
        combined.update(bridge.export_tree(getattr(src, module).state_dict(), entries, prefix))
    combined.update(bridge.export_control_base(src.control.state_dict(), cfg.control))
    path = str(tmp_path / "controlnet.ckpt")
    torch.save({k: torch.from_numpy(v) for k, v in combined.items()}, path)

    cache = logic.ModelCache()
    pipe = logic.build_controlnet(path, device="cpu", cache=cache)
    for name in ("unet", "control", "vae"):
        got, want = getattr(pipe, name).state_dict(), getattr(src, name).state_dict()
        assert all(torch.equal(got[k].float(), want[k].float()) for k in want
                   if not k.endswith("qkv.weight"))
    run = lambda seed: logic.process_controlnet("canny", image(9), "a house", "", 2, 2, 1.0,
                                                7.5, seed, path, device="cpu", cache=cache)
    out = run(3)
    assert logic.build_controlnet(path, device="cpu", cache=cache) is pipe
    assert len(out) == 3 and out[0].shape == (64, 64, 3)
    assert all(o.shape == (64, 64, 3) and o.dtype == np.uint8 for o in out[1:])
    again, other = run(3), run(4)
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    assert not np.array_equal(out[1], other[1])


def test_process_style_end_to_end(tmp_path, monkeypatch):
    """StyleCtrLoRA through the app logic at tiny size: the tiny style
    configuration of chip_smoke's phase 13 rehearsal from its writer."""
    import functools

    from ctrlora_tpu_torch import style as style_mod

    cfg = configs.tiny_test_config(n_loras=1, switchable_banks=True)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, ip_tokens=4),
                              clip=dataclasses.replace(cfg.clip, vocab_size=49408))
    gen = torch.Generator().manual_seed(1)
    paths, _ = chip_smoke.write_style_files(cfg, "cpu", str(tmp_path), gen,
                                            chip_smoke.TINY_VISION, None, torch.float32)
    monkeypatch.setattr(logic, "StyleCtrLoRA", functools.partial(
        style_mod.StyleCtrLoRA, cfg=cfg, vision_cfg=chip_smoke.TINY_VISION, bf16=False))
    small_detect(monkeypatch)
    cache = logic.ModelCache()
    run = lambda **kw: logic.process_style(
        "none", image(10), image(11, (40, 56)), "a house", "", 1, 2, 7.5, 5, paths["sd"],
        paths["basecn"], paths["loras"][0], paths["ip"], 1.0, "all",
        image_encoder_ckpt=paths["vision"], device="cpu", cache=cache, **kw)
    out = run()
    assert len(out) == 3 and out[1].shape == (40, 56, 3) and out[2].shape == (64, 64, 3)
    assert np.array_equal(run()[2], out[2])
    i2i = run(img2img=image(12), img2img_strength=0.5)
    assert i2i[2].shape == (64, 64, 3) and not np.array_equal(i2i[2], out[2])
    assert cache.key is not None
    assert set(logic.STYLE_TARGETS.values()) == {"all", "style_blocks", "style_layout"}


# ---------------------------------------------------------------------------
# the gradio front ends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gradio_ctrlora", "gradio_controlnet",
                                  "gradio_ctrlora_style_transfer"])
def test_gradio_module_exits_with_jax_message(name):
    try:
        import gradio  # noqa: F401
        pytest.skip("gradio is installed")
    except ImportError:
        pass
    port = subprocess.run([sys.executable, "-m", f"ctrlora_tpu_torch.app.{name}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jx = subprocess.run([sys.executable, os.path.join("app", f"{name}.py")], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
    assert port.returncode == jx.returncode == 1
    want = jx.stderr.strip().splitlines()[-1].replace("ctrlora_tpu", "ctrlora_tpu_torch")
    assert port.stderr.strip().splitlines()[-1] == want
