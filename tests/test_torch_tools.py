"""The port's checkpoint and dataset tools against the JAX package's
scripts on the CPU, on tiny files.

* ``tool_combine_weights``: the written dict is bit-equal to JAX's tool's.
* ``tool_extract_weights`` (-t control; -t lora; -t lora --from_base
  --tasks): bit-equal to JAX's tool on the same .ckpt (a tiny YAML config),
  equal to the seeded source; a port ``Trainer`` checkpoint directory of
  the same weights gives the same files as the .ckpt.
* ``tool_make_control_init``: the copied keys equal JAX's tool's output
  (its ControlNetConfig patched to the tiny config's), the key set and the
  newly added keys are JAX's, the zero convs are zero.
* ``tool_make_cond_images``: the hash-seeded per-file parameters equal
  JAX's, and a canny run writes JAX's PNGs bit for bit.

JAX's scripts run in-process (``runpy``-style import from scripts/, argv
patched); JAX's pipeline init is replaced by zeros of its shapes, since the
.ckpt files hold every control weight (checked: the output is the seeded
source's).
"""

import dataclasses
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.scripts import (
    tool_combine_weights, tool_extract_weights, tool_make_cond_images, tool_make_control_init,
)
from ctrlora_tpu_torch.training.trainer import Trainer
from ctrlora_tpu_torch.utils import ckpt_torch as bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """scripts/<name>.py of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    jax_script(name).main()


def load(path):
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy() for k, v in sd.items()}


def assert_dicts_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def seeded_(module, rng):
    with torch.no_grad():
        for name, p in module.named_parameters():
            std = p[0].numel() ** -0.5 if p.ndim >= 2 else 0.1
            p.copy_(torch.from_numpy(rng.normal(0, std, p.shape).astype(np.float32)))


def write_yaml(path, n_loras, tasks=None):
    text = f"preset: tiny\nmodel:\n  control:\n    lora:\n      n_loras: {n_loras}\n"
    if tasks:
        text += "  tasks:\n" + "".join(f"  - {t}\n" for t in tasks)
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Tiny files from a seeded port pipeline: the SD file, a finetune
    .ckpt (base control + slot 0's LoRA, module keys), a 2-task pretrain
    .ckpt (loras_dict keys) and the YAML configs."""
    tmp = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(3)
    cfg = configs.tiny_test_config(n_loras=1)
    pipe = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    for m in pipe.modules():
        seeded_(m, rng)
    sd = {}
    for prefix, module, entries in (
            ("model.diffusion_model.", pipe.unet, bridge.unet_entries(cfg.unet)),
            ("first_stage_model.", pipe.vae, bridge.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", pipe.clip,
             bridge.clip_entries(cfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in bridge.export_tree(module.state_dict(), entries).items()})
    sd["model_ema.decay"] = torch.tensor(0.9999)
    paths = {"sd": str(tmp / "sd.ckpt"), "finetune": str(tmp / "finetune.ckpt"),
             "pretrain": str(tmp / "pretrain.ckpt"), "base": str(tmp / "base.ckpt"),
             "lora": str(tmp / "lora.ckpt")}
    torch.save({"state_dict": sd}, paths["sd"])
    cstate = pipe.control.state_dict()
    base = bridge.export_control_base(cstate, cfg.control)
    lora = bridge.export_lora_slot(cstate, cfg.control, 0)
    torch.save({k: torch.from_numpy(v) for k, v in base.items()}, paths["base"])
    torch.save({k: torch.from_numpy(v) for k, v in lora.items()}, paths["lora"])
    torch.save({k: torch.from_numpy(v) for k, v in {**base, **lora}.items()}, paths["finetune"])

    cfg2 = dataclasses.replace(configs.tiny_test_config(n_loras=2), tasks=("hed", "canny"))
    with torch.random.fork_rng():
        torch.manual_seed(5)
        pre = CtrLoraPipeline(cfg2, "cpu", fuse_lora=False)
    seeded_(pre.control, rng)
    pstate = pre.control.state_dict()
    pre_sd = dict(bridge.export_control_base(pstate, cfg2.control))
    for slot, task in enumerate(cfg2.tasks):
        for j, (tpath, fpath) in enumerate(bridge.lora_site_entries(cfg2.control)):
            down = pstate[convert.port_key((*fpath, "lora_down"))][slot].numpy()
            up = pstate[convert.port_key((*fpath, "lora_up"))][slot].numpy()
            pre_sd[f"control_model.loras_dict.{task}.{j}.down.weight"] = np.ascontiguousarray(down.T)
            pre_sd[f"control_model.loras_dict.{task}.{j}.up.weight"] = np.ascontiguousarray(up.T)
    torch.save({k: torch.from_numpy(v) for k, v in pre_sd.items()}, paths["pretrain"])
    return dict(tmp=tmp, cfg=cfg, cfg2=cfg2, pipe=pipe, paths=paths, base=base, lora=lora,
                pstate=pstate, yaml1=write_yaml(tmp / "tiny1.yaml", 1),
                yaml2=write_yaml(tmp / "tiny2.yaml", 2, ["hed", "canny"]))


@pytest.fixture()
def fast_jax_init(monkeypatch):
    """JAX's pipeline init as zeros of its shapes (eval_shape, no compile)."""
    from ctrlora_tpu.pipeline import CtrLoraPipeline as JPipe

    orig = JPipe.init

    def init(self, key, image_size=8):
        shapes = jax.eval_shape(lambda k: orig(self, k, image_size=image_size), key)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(JPipe, "init", init)


# ---------------------------------------------------------------------------
# tool_combine_weights
# ---------------------------------------------------------------------------

def test_combine_weights_bit_equal_to_jax(files, tmp_path, monkeypatch, capsys):
    p = files["paths"]
    args = ["--sd_ckpt", p["sd"], "--base_ckpt", p["base"], "--lora_ckpt", p["lora"]]
    tool_combine_weights.main(args + ["--save_path", str(tmp_path / "port.ckpt")])
    run_jax(monkeypatch, "tool_combine_weights", args + ["--save_path", str(tmp_path / "j.ckpt")])
    got, want = load(tmp_path / "port.ckpt"), load(tmp_path / "j.ckpt")
    assert_dicts_bit_equal(got, want)
    assert "model_ema.decay" not in got and np.array_equal(got["logvar"], np.zeros(1000,
                                                                                    np.float32))
    assert "Saved combined weights to" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tool_extract_weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["control", "lora"])
def test_extract_bit_equal_to_jax(files, tmp_path, monkeypatch, fast_jax_init, kind):
    args = ["-t", kind, "--ckpt", files["paths"]["finetune"], "--config", files["yaml1"]]
    got = tool_extract_weights.main(args + ["--save_path", str(tmp_path / "port.ckpt")])
    run_jax(monkeypatch, "tool_extract_weights", args + ["--save_path", str(tmp_path / "j.ckpt")])
    want = load(tmp_path / "j.ckpt")
    assert_dicts_bit_equal(load(tmp_path / "port.ckpt"), want)
    source = files["base"] if kind == "control" else files["lora"]
    assert_dicts_bit_equal(got[str(tmp_path / "port.ckpt")], source)


def test_extract_from_base_per_task_bit_equal_to_jax(files, tmp_path, monkeypatch,
                                                     fast_jax_init):
    args = ["-t", "lora", "--from_base", "--ckpt", files["paths"]["pretrain"],
            "--config", files["yaml2"], "--tasks", "hed", "canny"]
    tool_extract_weights.main(args + ["--save_path", str(tmp_path / "port")])
    run_jax(monkeypatch, "tool_extract_weights", args + ["--save_path", str(tmp_path / "j")])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "j")) == [
        "canny.ckpt", "hed.ckpt"]
    cfg2 = files["cfg2"]
    for slot, task in enumerate(("hed", "canny")):
        got = load(tmp_path / "port" / f"{task}.ckpt")
        assert_dicts_bit_equal(got, load(tmp_path / "j" / f"{task}.ckpt"))
        assert_dicts_bit_equal(got, bridge.export_lora_slot(files["pstate"], cfg2.control, slot))


@pytest.mark.parametrize("kind", ["control", "lora"])
def test_extract_from_a_trainer_directory_equals_the_ckpt(files, tmp_path, kind):
    """A Trainer(trainable='lora') checkpoint directory of the same weights:
    the trainable control weights come from its ckpt_*.pt, the frozen ones
    from the config's seed-0 init, here the trained model's own."""
    cfg = files["cfg"]
    pipe = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    pipe.control.load_state_dict(tool_make_control_init.fresh_control_state(cfg.control))
    trainer = Trainer(pipe, TrainConfig(trainable="lora"), str(tmp_path / "run"))
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for p in trainer.state.trainable.values():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    trainer.save(3)
    cstate = pipe.control.state_dict()
    ckpt = tmp_path / "same.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in {
        **bridge.export_control_base(cstate, cfg.control),
        **bridge.export_lora_slot(cstate, cfg.control, 0)}.items()}, ckpt)
    outs = []
    for src in (str(tmp_path / "run"), str(ckpt)):
        out = str(tmp_path / f"{len(outs)}.ckpt")
        tool_extract_weights.main(["-t", kind, "--ckpt", src, "--config", files["yaml1"],
                                   "--save_path", out])
        outs.append(load(out))
    assert_dicts_bit_equal(*outs)
    with pytest.raises(FileNotFoundError):
        tool_extract_weights.trainer_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# tool_make_control_init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hint_mode", ["latent", "image"])
def test_make_control_init_copies_as_jax(files, tmp_path, monkeypatch, capsys, hint_mode):
    import ctrlora_tpu.configs as jconfigs

    tiny = jconfigs.tiny_test_config()
    monkeypatch.setattr(jconfigs, "ControlNetConfig", lambda hint_mode, lora: dataclasses.replace(
        tiny.control, hint_mode=hint_mode, lora=lora))
    run_jax(monkeypatch, "tool_make_control_init", [
        "--sd_ckpt", files["paths"]["sd"], "--output_path", str(tmp_path / "j.ckpt"),
        "--hint_mode", hint_mode])
    jax_new = [ln for ln in capsys.readouterr().out.splitlines() if "newly added" in ln]
    want = load(tmp_path / "j.ckpt")

    cfg = dataclasses.replace(files["cfg"].control, hint_mode=hint_mode,
                              lora=configs.LoRAConfig(n_loras=0))
    sd = bridge.load_torch_state_dict(files["paths"]["sd"])
    got, new = tool_make_control_init.make_control_init(sd, cfg)
    assert sorted(got) == sorted(want)
    assert [f"These weights are newly added: control_model.{k}" for k in new] == jax_new
    copied = [k for k in want if "model.diffusion_model." + k[len("control_model."):] in sd]
    assert len(copied) + len(new) == len(want) and copied
    for k in copied:
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(got[k], sd["model.diffusion_model." + k[len("control_model."):]])
    zero = [k for k in got if k.startswith(("control_model.zero_convs",
                                            "control_model.middle_block_out"))]
    assert zero and all(not got[k].any() for k in zero)
    assert any("input_hint_block" in k for k in new) == (hint_mode == "image")


def test_make_control_init_cli_writes_the_file(files, tmp_path, monkeypatch):
    """main() at the tiny control config: the file holds what it returns."""
    monkeypatch.setattr(tool_make_control_init, "ControlNetConfig",
                        lambda hint_mode, lora: dataclasses.replace(
                            files["cfg"].control, hint_mode=hint_mode, lora=lora))
    out = tool_make_control_init.main(["--sd_ckpt", files["paths"]["sd"],
                                       "--output_path", str(tmp_path / "init.ckpt")])
    assert_dicts_bit_equal(load(tmp_path / "init.ckpt"), out)


# ---------------------------------------------------------------------------
# tool_make_cond_images
# ---------------------------------------------------------------------------

def test_cond_image_params_equal_jax():
    j = jax_script("tool_make_cond_images")
    assert tool_make_cond_images.CHOICES == j.CHOICES
    for name in ("a.jpg", "000123.png", "dir/x y.jpeg", 17):
        for det in j.CHOICES + ["pad"]:
            got = tool_make_cond_images.random_params(det, tool_make_cond_images.rng_by_hash(name))
            want = j.random_params(det, j.rng_by_hash(name))
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), (det, k)


def test_make_cond_images_canny_writes_jax_pngs(tmp_path, monkeypatch):
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(2)
    for i in range(2):
        img = cv2.GaussianBlur(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8), (5, 5), 2)
        cv2.imwrite(str(src / f"{i}.jpg"), img)
    results = tool_make_cond_images.main(["--input_dir", str(src), "--output_dir",
                                          str(tmp_path / "port"), "--detector", "canny",
                                          "--device", "cpu"])
    assert results == [("0.jpg", True), ("1.jpg", True)]
    run_jax(monkeypatch, "tool_make_cond_images", ["--input_dir", str(src), "--output_dir",
                                                   str(tmp_path / "j"), "--detector", "canny"])
    for i in range(2):
        got = cv2.imread(str(tmp_path / "port" / f"{i}.png"))
        assert got.shape[:2] == (512, 640)
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "j" / f"{i}.png")))
