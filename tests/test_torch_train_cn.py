"""The baselines' checkpoints and training CLI on the CPU, and the repair of
--gradacc in the training CLIs:

* the vanilla and Lite loaders (``utils.loading.load_ctrlora`` with
  ``basecn_skip='lora'``) against JAX's ``load_ctrlora`` on synthetic
  reference-format files (``input_hint_block.*`` keys and Lite's table),
  tensor for tensor, and the port's exporter writing the file back;
* ``scripts.train_cn.main`` for both variants over written PNG pairs with
  --bs 2 --gradacc 2 --use_ema: metrics, checkpoints, the image log, the
  frozen UNet; 2 steps, --resume, 2 more give the bits of 4 straight steps;
  --tp 2 at one process and a --config that names nothing raise,
  --shard_opt_state at one process trains as replicated; no fallback to the
  CPU (--variant xs: tests/test_torch_xs.py);
* the image log of an image-hint model (``training.trainer.image_log_rows``:
  the pixel hint goes to the sampler as it is; Lite builds no row tables)
  against the JAX hook's arrays with JAX's starting noise, rtol 2e-3 /
  atol 2e-4;
* ``scripts.train_ctrlora_finetune.main`` with --bs 2 --gradacc 2: its first
  update equals one AdamW step on the mean of the two micro-batch
  gradients, the micro-batches being the loader's batch of 4 split in two
  and drawing from the step's generator in turn; the pretrain CLI takes
  --gradacc 2 too.

The CLI's model is a tiny image-hint configuration whose VAE downsamples by
8, as the hint encoder does (the tiny preset's VAE downsamples by 2), given
to the CLI through its preset table; images are 64x64.
"""

import dataclasses
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models.lite import lite_entries as jax_lite_entries
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig
from ctrlora_tpu.sampling.ddim import ddim_sample as jax_ddim_sample
from ctrlora_tpu.utils import ckpt_torch as jax_bridge
from ctrlora_tpu.utils import loading as jax_loading

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.data.loader import Loader, to_device
from ctrlora_tpu_torch.data.scheduler import SingleTaskSchedule
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.scripts import train_cn
from ctrlora_tpu_torch.scripts import train_common as common
from ctrlora_tpu_torch.scripts import train_ctrlora_finetune as finetune
from ctrlora_tpu_torch.scripts import train_ctrlora_pretrain as pretrain
from ctrlora_tpu_torch.training import step as pstep
from ctrlora_tpu_torch.training import train_state as pts
from ctrlora_tpu_torch.training.trainer import image_log_rows, step_seed
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import loading
from tests.test_torch_plms_dpm import _random_params
from tests.torch_fresh import seeded_training_pipelines

RES = 64  # the CLI's image size here (the hint encoder needs a multiple of 8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test run shares the host's cores between
    several test processes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _seeded_zeroed_layers():
    """The CLIs train from the seeded init, whose UNet outputs 0 as JAX's
    does: its zeroed layers get weights so that gradients flow."""
    with seeded_training_pipelines():
        yield


def _variant(cfg, variant):
    return dataclasses.replace(cfg, control=dataclasses.replace(cfg.control, variant=variant))


# ---------------------------------------------------------------------------
# reference-format files -> both loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["controlnet", "lite"])
def test_baseline_loader_matches_jax(variant, tmp_path):
    jcfg = _variant(jax_tiny(hint_mode="image"), variant)
    jpipe = JaxPipeline(jcfg)
    src = _random_params(jpipe, 60)
    sd = {}
    for prefix, tree, entries in (
            ("model.diffusion_model.", src.unet, jax_bridge.unet_entries(jcfg.unet)),
            ("first_stage_model.", src.vae, jax_bridge.vae_entries(jcfg.vae)),
            ("cond_stage_model.transformer.text_model.", src.clip,
             jax_bridge.clip_entries(jcfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in jax_bridge.export_tree(tree, entries).items()})
    entries = (jax_lite_entries(jcfg.control.unet) if variant == "lite"
               else jax_bridge.controlnet_entries(jcfg.control))
    cn = {f"control_model.{k}": torch.from_numpy(v)
          for k, v in jax_bridge.export_tree(src.control, entries).items()}
    assert any(".input_hint_block.14." in k for k in cn)
    paths = str(tmp_path / "sd.ckpt"), str(tmp_path / "cn.ckpt")
    torch.save({"state_dict": sd}, paths[0])
    torch.save(cn, paths[1])
    # JAX's loader starts from the pipeline's init: here other random
    # weights, which every key of the files replaces
    init = _random_params(jpipe, 61)
    jpipe.init = lambda rng, image_size=8: init
    want = jax_loading.load_ctrlora(jpipe, *paths, basecn_skip="lora")
    pcfg = _variant(configs.tiny_test_config(hint_mode="image"), variant)
    states = loading.load_ctrlora(CtrLoraPipeline(pcfg, "cpu", fuse_lora=False), *paths,
                                  basecn_skip="lora")
    for name in ("unet", "control", "vae", "clip"):
        ref = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, getattr(want, name)))
        got = getattr(states, name)
        assert sorted(got) == sorted(ref), name
        bad = [k for k in ref if not torch.equal(got[k], ref[k])]
        assert not bad, f"{name}: {bad[:5]}"
    back = bridge.export_control_base(states.control, pcfg.control)
    assert sorted(back) == sorted(cn)
    assert all(np.array_equal(back[k], cn[k].numpy()) for k in cn)


# ---------------------------------------------------------------------------
# the baselines' CLI
# ---------------------------------------------------------------------------

def cli_config(variant):
    """A tiny image-hint model whose VAE has four levels (latent /8)."""
    cfg = _variant(configs.tiny_test_config(hint_mode="image"), variant)
    return dataclasses.replace(cfg, vae=dataclasses.replace(cfg.vae, ch_mult=(1, 1, 2, 2)))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Six pairs: square, landscape and portrait."""
    root = tmp_path_factory.mktemp("cn_ds")
    (root / "source").mkdir()
    (root / "target").mkdir()
    rng = np.random.default_rng(0)
    with open(root / "prompt.json", "w") as f:
        for i in range(6):
            shape = [(72, 72), (72, 88), (88, 72)][i % 3]
            for sub in ("source", "target"):
                cv2.imwrite(str(root / sub / f"{i}.png"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"a picture {i}"}) + "\n")
    return str(root)


def _patch_tiny(mp):
    """train_cn at the tiny size: the variants' presets and the image size."""
    for variant in ("controlnet", "lite"):
        mp.setitem(train_cn.PRESETS, variant, lambda v=variant: cli_config(v))
    mp.setattr(train_cn, "RESOLUTION", RES)


@pytest.fixture
def tiny_cli(monkeypatch):
    _patch_tiny(monkeypatch)


def _cn_flags(dataset_dir, variant, name, steps, *extra):
    return ["--variant", variant, "--device", "cpu", "--dataroot", dataset_dir,
            "--bs", "2", "--gradacc", "2", "--max_steps", str(steps), "--log_every", "1",
            "--ckpt_logger_freq", "2", "--img_logger_freq", "4", "--use_ema",
            "--num_workers", "2", "-n", name, *extra]


def _metrics(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def straight(dataset_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("cn")
    with pytest.MonkeyPatch.context() as mp:
        _patch_tiny(mp)
        return {v: train_cn.main(_cn_flags(dataset_dir, v, str(root / v), 4))
                for v in ("controlnet", "lite")}


@pytest.mark.parametrize("variant", ["controlnet", "lite"])
def test_train_cn_cli(straight, variant):
    run = straight[variant]
    events = [(ln["event"], ln.get("step")) for ln in _metrics(run.workdir)]
    assert events == [("init", None), ("train", 1), ("train", 2), ("ckpt", 2), ("train", 3),
                      ("train", 4), ("ckpt", 4), ("image_log", 4)]
    train = [ln for ln in _metrics(run.workdir) if ln["event"] == "train"]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0 for ln in train)
    trainer = run.trainer
    assert trainer.cfg.trainable == "all" and trainer.cfg.grad_accum == 2
    assert all(trainer.mask["control"].values()) and not any(trainer.mask["unet"].values())
    assert trainer.pipe.cfg.control.variant == variant
    assert run.loader.schedule.batch_size == 4 and run.loader.last_step == 3
    png = cv2.imread(os.path.join(run.workdir, "image_log", "step_00000004.png"))
    assert png.shape == (48 + 3 * RES, 2 * RES, 3)
    assert trainer.state.ema.updates == 4
    # the frozen UNet is the seeded one, bit for bit
    seeded = common.load_training_pipeline(cli_config(variant), "cpu", None, None, 42)
    for name, p in trainer.pipe.unet.named_parameters():
        assert torch.equal(p, seeded.unet.state_dict()[name]), name


@pytest.mark.parametrize("variant", ["controlnet", "lite"])
def test_train_cn_resume_is_bit_equal_to_straight(straight, tiny_cli, dataset_dir, tmp_path,
                                                  variant):
    first = train_cn.main(_cn_flags(dataset_dir, variant, str(tmp_path / "a"), 2))
    resumed = train_cn.main(_cn_flags(dataset_dir, variant, str(tmp_path / "b"), 4, "--resume",
                                      os.path.join(first.workdir, "ckpt_00000002.pt")))
    assert [ln["step"] for ln in _metrics(resumed.workdir) if ln["event"] == "train"] == [3, 4]
    a, b = straight[variant].trainer.state, resumed.trainer.state
    assert b.step == 4 and b.ema.updates == 4
    for k, p in a.trainable.items():
        assert torch.equal(p, b.trainable[k]), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i, st in sa.items():
        assert all(torch.equal(st[k], sb[i][k]) for k in ("exp_avg", "exp_avg_sq")), i


@pytest.mark.parametrize("extra,error,match", [
    (["--config", "no_such_config.yaml"], ValueError, "neither a preset"),
    (["--tp", "2"], ValueError, "--tp 2 does not divide 1 devices"),
    (["--shard_opt_state"], None, None),
    (["--gradacc", "0"], ValueError, "gradacc"),
])
def test_train_cn_flags_raise(tiny_cli, dataset_dir, tmp_path, extra, error, match):
    """The flags that cannot run here raise; at one process
    --shard_opt_state keeps the whole AdamW state and trains as replicated."""
    argv = ["--device", "cpu", "--dataroot", dataset_dir, "-n", str(tmp_path / "x"), *extra]
    if error is not None:
        with pytest.raises(error, match=match):
            train_cn.main(argv)
        return
    run = train_cn.main([*argv, "--max_steps", "1", "--log_every", "1", "--num_workers", "2"])
    assert run.trainer.cfg.shard_opt_state and run.trainer.mesh is None
    assert type(run.trainer.state.optimizer) is torch.optim.AdamW
    train = [ln for ln in _metrics(run.workdir) if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1] and np.isfinite(train[0]["loss"])


def test_train_cn_arguments(dataset_dir, tmp_path):
    with pytest.raises(SystemExit):
        train_cn.parse_args(["--dataroot", dataset_dir, "--multigen20m"])  # needs --task
    args = train_cn.parse_args(["--dataroot", dataset_dir, "--variant", "lite"])
    assert args.device == "cuda" and args.bs == 1 and args.num_workers == 16
    assert train_cn.model_config(args) == configs.cnlite_config()
    assert train_cn.model_config(train_cn.parse_args(["--dataroot", "d"])) == configs.sd15_config()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):  # no fallback to the CPU
            train_cn.main(["--dataroot", dataset_dir, "-n", str(tmp_path / "y")])


@pytest.mark.parametrize("variant", ["lite", "controlnet"])
def test_image_log_rows_match_jax(variant):
    """The JAX hook's arrays (ctrlora_tpu/training/trainer.py
    make_image_log_hook) for an image-hint model: control, reconstruction
    and CFG-9.0 samples from the pixel hint, with its starting noise."""
    jcfg = jax_tiny(hint_mode="image")
    jcfg = dataclasses.replace(_variant(jcfg, variant),
                               vae=dataclasses.replace(jcfg.vae, ch_mult=(1, 1, 2, 2)))
    jpipe = JaxPipeline(jcfg)
    params = _random_params(jpipe, 62)
    rng = np.random.default_rng(3)
    batch = {"jpg": rng.uniform(-1, 1, (3, RES, RES, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, (3, RES, RES, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, (3, 16)).astype(np.int32)}
    step, steps, b, lat = 5, 3, 2, RES // 8
    ids = jnp.asarray(batch["token_ids"][:b])
    hint = jnp.asarray(batch["hint"][:b])
    z = jax_ddim_sample(jpipe, params, jax.random.PRNGKey(step),
                        jpipe.encode_text_tokens(params, ids),
                        jpipe.encode_text_tokens(params, jnp.zeros_like(ids)),
                        [JaxConditioning(hint)], (b, lat, lat, 4),
                        JaxDDIMConfig(steps=steps, guidance_scale=9.0))
    recon = jpipe.decode_first_stage(params, jpipe.encode_first_stage(
        params, jnp.asarray(batch["jpg"][:b])))
    ref = {"control": np.asarray(hint), "reconstruction": np.asarray(recon),
           "samples": np.asarray(jpipe.decode_first_stage(params, z))}
    pipe = CtrLoraPipeline(cli_config(variant), "cpu", fuse_lora=False)
    pipe.load_state_dicts(*(convert.params_from_jax(p) for p in params))
    x_T = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(step))[1], (b, lat, lat, 4), jnp.float32)))
    rows = image_log_rows(pipe, {k: torch.from_numpy(v) for k, v in batch.items()}, step, steps,
                          x_T=x_T)
    for k in ref:
        assert rows[k].shape == ref[k].shape == (b, RES, RES, 3)
        np.testing.assert_allclose(rows[k], ref[k], rtol=2e-3, atol=2e-4, err_msg=k)


# ---------------------------------------------------------------------------
# --gradacc in the CtrLoRA CLIs
# ---------------------------------------------------------------------------

def test_finetune_gradacc_averages_micro_batches(dataset_dir, tmp_path):
    """The CLI's first step at --bs 2 --gradacc 2 against the same step
    made by hand: the loader's batch of 4 split in two, each half's
    gradient from the step's generator in turn, their mean, one AdamW step."""
    flags = ["--config", "tiny", "--device", "cpu", "--dataroot", dataset_dir,
             "--resolution", "32", "--bs", "2", "--gradacc", "2", "--max_steps", "1",
             "--log_every", "1", "--num_workers", "2", "--name", str(tmp_path / "ft")]
    run = finetune.main(flags)
    assert run.loader.schedule.batch_size == 4 and run.trainer.state.step == 1

    args = finetune.parse_args(flags)
    pipe = common.load_training_pipeline(configs.load_model_config("tiny"), "cpu", None, None,
                                         args.seed)
    tcfg = common.train_config(args, "lora")
    mask = pts.trainable_mask(pipe, tcfg)
    opt = pts.make_optimizer(pipe, tcfg, mask)
    loader = Loader(finetune.build_datasets(args), SingleTaskSchedule(6, 4, seed=args.seed),
                    num_workers=1, max_length=pipe.cfg.clip.max_length)
    batch = to_device(loader.load_batch(0), "cpu")
    gen = torch.Generator().manual_seed(step_seed(args.seed + 1, 0))
    for i in range(2):
        micro = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        (pstep.loss_for_batch(pipe, micro, gen)[0] / 2).backward()
    opt.step()
    got = run.trainer.state.trainable
    for name, p in pts.trainable_parameters(pipe, mask).items():
        torch.testing.assert_close(got[name], p, rtol=0, atol=0, msg=name)


def test_split_micro_batches():
    batch = {"jpg": torch.arange(24.).reshape(6, 2, 2), "task_idx": torch.zeros(6)}
    split = pstep.split_micro_batches(batch, 3)
    assert split["jpg"].shape == (3, 2, 2, 2) and split["task_idx"].shape == (3, 2)
    assert torch.equal(split["jpg"][1], batch["jpg"][2:4])


def test_pretrain_takes_gradacc(tmp_path):
    """The pretrain CLI at --bs 1 --gradacc 2: one task a step over its
    global batch of 2."""
    root = tmp_path / "mg"
    for d in ("json_files", "images", "conditions"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(1)
    for task in ("hed", "canny"):
        with open(root / "json_files" / f"aesthetics_plus_all_group_{task}_all.json", "w") as f:
            for i in range(3):
                for sub, ext in (("images", "jpg"), ("conditions", "png")):
                    cv2.imwrite(str(root / sub / f"{task}_{i}.{ext}"),
                                rng.integers(0, 256, (40, 40, 3), np.uint8))
                f.write(json.dumps({"source": f"./{task}_{i}.jpg",
                                    f"control_{task}": f"{task}_{i}.png",
                                    "prompt": f"a {task} image {i}"}) + "\n")
    run = pretrain.main([
        "--config", "tiny", "--device", "cpu", "--json_dir", str(root / "json_files"),
        "--meta_dir", str(root), "--tasks", "hed", "canny", "--resolution", "32", "--bs", "1",
        "--gradacc", "2", "--max_steps", "2", "--log_every", "1", "--img_logger_freq", "100",
        "--ckpt_logger_freq", "100", "--num_workers", "2", "--name", str(tmp_path / "pt")])
    train = [ln for ln in _metrics(run.workdir) if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0 for ln in train)
    assert run.loader.schedule.batch_size == 2 and run.trainer.cfg.grad_accum == 2
