"""The port's dataset reader, preset loader and sample CLI on the CPU:

* ``data.datasets.CustomDataset`` against the JAX package's on a directory
  in tmp_path (items skipped for missing files, up- and down-scaling, prompt
  dropout): the same items and the same arrays, exactly, from the same
  numpy draws; ``CTRLORA_NATIVE_DATA`` is honoured (the native image prep)
  rather than ignored;
* ``configs.load_model_config``: the port's presets (cnxs_sd15 among
  them), a YAML file, and a clear error for a name that is neither;
* ``python -m ctrlora_tpu_torch.scripts.sample`` (its ``main``) on the tiny
  preset with ``--device cpu``, for each sampler: it writes sample/,
  control/, img/ and prompt.txt, pads the short last batch, and its samples
  equal the port's samplers called directly on the same items, weights and
  seeds; it defaults to the card and never falls back to the CPU;
* the LoRA loading of the CLI: a reference-format LoRA ``.ckpt`` and the
  port trainer's ``ckpt_*.pt``.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from ctrlora_tpu.data import datasets as jax_datasets

from ctrlora_tpu_torch import configs, lora_fuse
from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.data import datasets, native
from ctrlora_tpu_torch.models.unet import encoder_plan
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.sampling import ddim, dpm_solver, plms
from ctrlora_tpu_torch.scripts import sample as cli
from ctrlora_tpu_torch.training.trainer import Trainer
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import loading
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer

ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test run shares the host's cores between several test processes:
    one torch thread keeps these small-model tests from oversubscribing
    them (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Five listed items, one without its source file; sources 24^2 (scaled
    down to 16) and 8^2 (scaled up), targets 20^2."""
    root = tmp_path_factory.mktemp("ds")
    (root / "source").mkdir()
    (root / "target").mkdir()
    rng = np.random.default_rng(0)
    with open(root / "prompt.json", "w") as f:
        for i in range(5):
            size = 8 if i == 2 else 24
            if i != 3:
                cv2.imwrite(str(root / "source" / f"{i}.png"),
                            rng.integers(0, 256, (size, size, 3), np.uint8))
            cv2.imwrite(str(root / "target" / f"{i}.jpg"),
                        rng.integers(0, 256, (20, 20, 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.jpg",
                                "prompt": f"a tiny picture number {i}"}) + "\n")
    return str(root)


@pytest.mark.parametrize("resolution,drop_rate", [(None, 0.0), (16, 0.0), (16, 0.5), (32, 0.0)])
def test_custom_dataset_matches_jax(dataset_dir, resolution, drop_rate):
    ours = datasets.CustomDataset(dataset_dir, drop_rate=drop_rate, resolution=resolution)
    ref = jax_datasets.CustomDataset(dataset_dir, drop_rate=drop_rate, resolution=resolution)
    assert len(ours) == len(ref) == 4 and ours.data == ref.data
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(len(ours)):
        a, b = ours.get(i, r1), ref.get(i, r2)
        assert a.keys() == b.keys() and a["txt"] == b["txt"]
        for k in ("jpg", "hint"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_custom_dataset_errors(dataset_dir, tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        datasets.CustomDataset(str(tmp_path))
    monkeypatch.setenv("CTRLORA_NATIVE_DATA", "1")
    ds = datasets.CustomDataset(dataset_dir, resolution=16)
    got = ds.get(0, np.random.default_rng(0))
    src = datasets.imread_rgb(os.path.join(dataset_dir, ds.data[0]["source"]))
    want = native.resize_norm(src, (0, 0, *src.shape[:2]), (16, 16), 1 / 255.0, 0.0)
    np.testing.assert_array_equal(got["hint"], want)


def test_load_model_config():
    assert configs.load_model_config("tiny") == configs.tiny_test_config()
    assert configs.load_model_config("tiny", n_loras=2).control.lora.n_loras == 2
    assert configs.load_model_config("ctrlora_finetune") == configs.ctrlora_finetune_config()
    assert (configs.load_model_config("ctrlora_inference", lora_num=2)
            == configs.ctrlora_inference_config(lora_num=2))
    assert configs.load_model_config("ctrlora_pretrain") == configs.ctrlora_pretrain_config()
    assert configs.load_model_config("cldm_v15") == configs.sd15_config()
    assert configs.load_model_config("cnlite_sd15") == configs.cnlite_config()
    assert configs.load_model_config("cnxs_sd15") == configs.cnxs_config()
    assert (configs.load_model_config("configs/ctrlora_finetune_sd15_rank128.yaml")
            == configs.ctrlora_finetune_config(128))
    with pytest.raises(ValueError, match="neither a preset"):
        configs.load_model_config("no_such_preset")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _randomize(pipe, seed):
    rng = np.random.default_rng(seed)
    for m in pipe.modules():
        for name, p in m.named_parameters():
            parts = name.split(".")
            is_norm = len(parts) > 1 and "norm" in parts[-2]
            std = (0.05 if any(z in name for z in ZERO_INIT) else
                   p[0].numel() ** -0.5 if p.ndim >= 2 and not is_norm else 0.1)
            base = 1.0 if is_norm and name.endswith("weight") else 0.0
            p.data.copy_(torch.from_numpy((base + rng.normal(0, std, p.shape)).astype(np.float32)))


def _write_files(cfg, tmp, seed):
    """SD and Base ControlNet files (and a LoRA file where the config has a
    slot) from a seeded unfused pipeline; returns (paths, the pipeline)."""
    src = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    _randomize(src, seed)
    sd = {}
    for prefix, module, entries in (
            ("model.diffusion_model.", src.unet, bridge.unet_entries(cfg.unet)),
            ("first_stage_model.", src.vae, bridge.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", src.clip,
             bridge.clip_entries(cfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in bridge.export_tree(module.state_dict(), entries).items()})
    paths = {"sd": str(tmp / "sd.ckpt"), "cn": str(tmp / "basecn.ckpt"),
             "lora": str(tmp / "lora0.ckpt")}
    torch.save({"state_dict": sd}, paths["sd"])
    cstate = src.control.state_dict()
    torch.save({k: torch.from_numpy(v)
                for k, v in bridge.export_control_base(cstate, cfg.control).items()}, paths["cn"])
    if cfg.control.lora.n_loras:
        torch.save({k: torch.from_numpy(v)
                    for k, v in bridge.export_lora_slot(cstate, cfg.control, 0).items()},
                   paths["lora"])
    return paths, src


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    return _write_files(configs.tiny_test_config(), tmp_path_factory.mktemp("cli_ckpts"), 3)[0]


CASES = {
    "ddim_eta": ["--sampler", "ddim", "--eta", "0.5"],
    "plms": ["--sampler", "plms"],
    "dpm_multistep": ["--sampler", "dpm_solver", "--dpm_order", "3", "--dpm_thresholding"],
    "dpm_singlestep": ["--sampler", "dpm_solver", "--dpm_method", "singlestep",
                       "--dpm_algorithm", "dpmsolver"],
}


def _direct(pipe, sampler, items, seed, steps=3):
    """What the CLI should write for one padded batch, from the port's
    functions called directly."""
    cfg = pipe.cfg
    tok = default_tokenizer()
    hint = torch.from_numpy(np.stack([it["hint"] for it in items]))
    ids = torch.from_numpy(tok([it["txt"] for it in items], max_length=cfg.clip.max_length))
    nids = torch.from_numpy(tok([""] * len(items), max_length=cfg.clip.max_length))
    ctx, unc = pipe.encode_text_cond_uncond(ids, nids)
    conds = [Conditioning(pipe.encode_first_stage(hint))]
    shape = (len(items), hint.shape[1] // 2, hint.shape[2] // 2, 4)
    gen = torch.Generator().manual_seed(seed)
    x_T = torch.randn(shape, generator=gen)
    scales = [1.0] * (len(encoder_plan(cfg.control.unet)[0]) + 1)
    args = (pipe, ctx, unc, conds, shape)
    if sampler == "ddim_eta":
        noise = torch.randn((steps, *shape), generator=gen)
        z = ddim.ddim_sample(*args, ddim.DDIMConfig(steps=steps, eta=0.5), x_T=x_T,
                             noise=noise, control_scales=scales)
    elif sampler == "plms":
        z = plms.plms_sample(*args, ddim.DDIMConfig(steps=steps), x_T=x_T,
                             control_scales=scales)
    elif sampler == "dpm_multistep":
        z = dpm_solver.dpm_solver_sample(*args, ddim.DDIMConfig(steps=steps), x_T=x_T,
                                         control_scales=scales, order=3, thresholding=True)
    else:
        z = dpm_solver.dpm_solver_singlestep_sample(*args, ddim.DDIMConfig(steps=steps),
                                                    x_T=x_T, control_scales=scales,
                                                    algorithm="dpmsolver")
    img = pipe.decode_first_stage(z)
    return torch.clamp(img * 127.5 + 127.5, 0, 255).to(torch.uint8).numpy()


def _read_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_samples_equal_direct_calls(dataset_dir, tiny_files, tmp_path, case, capsys):
    out = str(tmp_path / "out")
    cli.main(["--config", "tiny", "--device", "cpu", "--dataroot", dataset_dir,
              "--save_dir", out, "--sd_ckpt", tiny_files["sd"], "--cn_ckpt", tiny_files["cn"],
              "--resolution", "16", "--n_samples", "3", "--ddim_steps", "3", "--bs", "2",
              "--seed", "7", *CASES[case]])
    assert "sampled 3/3" in capsys.readouterr().out
    for sub in ("sample", "control", "img"):
        assert sorted(os.listdir(os.path.join(out, sub))) == [f"{i:06d}.png" for i in range(3)]
    with open(os.path.join(out, "prompt.txt")) as f:
        lines = f.read().splitlines()
    ds = datasets.CustomDataset(dataset_dir, resolution=16)
    rng = np.random.default_rng(7)
    items = [ds.get(i, rng) for i in range(3)]
    assert lines == [f"{i:06d}: {it['txt']}" for i, it in enumerate(items)]

    pipe = CtrLoraPipeline(configs.tiny_test_config(), "cpu")
    states = loading.load_ctrlora(pipe, tiny_files["sd"], tiny_files["cn"], basecn_skip="lora")
    pipe.load_state_dicts(states.unet, states.control, states.vae, states.clip)
    pipe.cast_for_inference()
    # batch 0: items 0-1; batch 1: item 2, padded with itself to the batch of 2
    want = np.concatenate([_direct(pipe, case, items[:2], 7),
                           _direct(pipe, case, [items[2], items[2]], 9)[:1]])
    got = np.stack([_read_rgb(os.path.join(out, "sample", f"{i:06d}.png")) for i in range(3)])
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0
    for i, it in enumerate(items):
        np.testing.assert_array_equal(_read_rgb(os.path.join(out, "control", f"{i:06d}.png")),
                                      (it["hint"] * 255).astype(np.uint8))
        np.testing.assert_array_equal(
            _read_rgb(os.path.join(out, "img", f"{i:06d}.png")),
            ((it["jpg"] + 1) * 127.5).clip(0, 255).astype(np.uint8))


def test_cli_defaults_to_the_card_without_fallback(dataset_dir, tmp_path):
    args = cli.build_parser().parse_args(["--dataroot", "d", "--save_dir", "s"])
    assert args.device == "cuda" and args.sampler == "ddim" and args.ddim_steps == 50
    assert (args.scale, args.eta, args.seed, args.bs, args.resolution) == (7.5, 0.0, 42, 4, 512)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would be used")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--config", "tiny", "--dataroot", dataset_dir, "--save_dir", str(tmp_path)])


def test_cli_loads_reference_lora_and_trainer_checkpoint(tmp_path):
    """``--lora_ckpt``: a reference-format LoRA file fills slot 0 (and the
    fused ControlNet carries it); the port trainer's ``ckpt_*.pt`` restores
    its trainable tensors the same way."""
    cfg = configs.tiny_test_config(n_loras=1)
    paths, src = _write_files(cfg, tmp_path, 4)
    want = src.control.state_dict()

    def fused_of(state):
        probe = CtrLoraPipeline(cfg, "cpu")
        return lora_fuse.fuse_control_tree(probe.control, state, 0, cfg.control.lora)

    pipe = cli.load_pipeline(cfg, "cpu", paths["sd"], paths["cn"], paths["lora"])
    for k, v in fused_of(want).items():
        torch.testing.assert_close(pipe.control.state_dict()[k], v)

    trainer_pipe = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    trainer_pipe.control.load_state_dict(want)
    trainer = Trainer(trainer_pipe, TrainConfig(trainable="lora"), str(tmp_path / "run"))
    with torch.no_grad():
        for name, p in trainer_pipe.control.named_parameters():
            if "lora_up" in name or name.startswith("zero_"):
                p.add_(0.01)
    ckpt = trainer.save(1)
    assert os.path.basename(ckpt) == "ckpt_00000001.pt"
    pipe = cli.load_pipeline(cfg, "cpu", paths["sd"], paths["cn"], ckpt)
    for k, v in fused_of(trainer_pipe.control.state_dict()).items():
        torch.testing.assert_close(pipe.control.state_dict()[k], v)
    bogus = str(tmp_path / "bogus.ckpt")
    torch.save({"control_model.time_embed.0.weight": torch.zeros(1)}, bogus)
    with pytest.raises(ValueError, match="no LoRA keys"):
        cli.load_pipeline(cfg, "cpu", paths["sd"], paths["cn"], bogus)
