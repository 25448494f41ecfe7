"""The port's training CLIs in-process on the CPU (tiny preset, --device
cpu), and the image-log hook against the JAX package's:

* ``scripts.train_ctrlora_finetune``: resolution 32, batch 2, 4 steps with
  --use_ema: its metrics.jsonl lines, checkpoints and image-log PNG; 2
  steps, --resume, 2 more steps give the bits of the 4 straight steps
  (trainable weights, EMA shadow, AdamW moments); --cache_latents trains
  from the moments; at one process --tp 2 raises and --shard_opt_state
  trains as replicated; the default device
  is the card, with no fallback to the CPU;
* ``scripts.train_ctrlora_pretrain``: two tasks over a MultiGen directory;
* ``training.trainer.image_log_rows`` (control, reconstruction, CFG-9.0
  samples) against the JAX hook's arrays with JAX's starting noise, for a
  pixel and a latent-cached batch, within rtol 2e-3 / atol 2e-4 before the
  uint8 cast; the PNG of the hook has the JAX hook's shape (the prompt
  strip: shape only).
"""

import importlib.util
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models.vae import AutoencoderKL
from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.sampling.ddim import DDIMConfig as JaxDDIMConfig
from ctrlora_tpu.sampling.ddim import ddim_sample as jax_ddim_sample
from ctrlora_tpu.training import trainer as jax_trainer

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.scripts import train_ctrlora_finetune as finetune
from ctrlora_tpu_torch.scripts import train_ctrlora_pretrain as pretrain
from ctrlora_tpu_torch.training import train_state as pts
from ctrlora_tpu_torch.training import trainer as trainer_mod
from ctrlora_tpu_torch.training.trainer import image_log_rows, make_image_log_hook
from tests.test_torch_plms_dpm import _random_params
from tests.torch_fresh import seeded_training_pipelines

RES, BS = 32, 2


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


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Six pairs: square, landscape and portrait."""
    root = tmp_path_factory.mktemp("ft_ds")
    (root / "source").mkdir()
    (root / "target").mkdir()
    rng = np.random.default_rng(0)
    with open(root / "prompt.json", "w") as f:
        for i in range(6):
            shape = [(40, 40), (40, 48), (48, 40)][i % 3]
            for sub in ("source", "target"):
                cv2.imwrite(str(root / sub / f"{i}.png"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"a picture {i}"}) + "\n")
    return str(root)


def _flags(dataset_dir, name, steps, *extra):
    return ["--config", "tiny", "--device", "cpu", "--dataroot", dataset_dir,
            "--resolution", str(RES), "--bs", str(BS), "--max_steps", str(steps),
            "--log_every", "1", "--ckpt_logger_freq", "2", "--img_logger_freq", "4",
            "--use_ema", "--num_workers", "2", "--name", name, *extra]


def _metrics(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def straight(dataset_dir, tmp_path_factory):
    return finetune.main(_flags(dataset_dir, str(tmp_path_factory.mktemp("ft") / "run"), 4))


def test_finetune_cli_logs_checkpoints_and_image_log(straight):
    lines = _metrics(straight.workdir)
    events = [(ln["event"], ln.get("step")) for ln in lines]
    assert events == [("init", None), ("train", 1), ("train", 2), ("ckpt", 2), ("train", 3),
                      ("train", 4), ("ckpt", 4), ("image_log", 4)]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0
               for ln in lines if ln["event"] == "train")
    assert sorted(f for f in os.listdir(straight.workdir) if f.endswith(".pt")) == [
        "ckpt_00000002.pt", "ckpt_00000004.pt"]
    png = cv2.imread(os.path.join(straight.workdir, "image_log", "step_00000004.png"))
    assert png.shape == (48 + 3 * RES, 2 * RES, 3)  # prompt strip + 3 rows of 2 tiles
    assert straight.trainer.state.step == 4 and straight.loader.last_step == 3
    assert straight.trainer.cfg.use_ema and straight.trainer.state.ema.updates == 4
    assert straight.seconds["load"] > 0


def test_finetune_resume_is_bit_equal_to_straight(straight, dataset_dir, tmp_path):
    first = finetune.main(_flags(dataset_dir, str(tmp_path / "a"), 2))
    assert first.trainer.state.step == 2
    resumed = finetune.main(_flags(dataset_dir, str(tmp_path / "b"), 4, "--resume",
                                   os.path.join(first.workdir, "ckpt_00000002.pt")))
    assert [ln["step"] for ln in _metrics(resumed.workdir) if ln["event"] == "train"] == [3, 4]
    assert resumed.loader.last_step == 3
    a, b = straight.trainer.state, resumed.trainer.state
    assert b.step == 4 and b.ema.updates == 4
    for k, p in a.trainable.items():
        assert torch.equal(p, b.trainable[k]), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i, st in sa.items():
        assert all(torch.equal(st[k], sb[i][k]) for k in ("exp_avg", "exp_avg_sq")), i


def test_finetune_cache_latents(dataset_dir, tmp_path):
    run = finetune.main(_flags(dataset_dir, str(tmp_path / "c"), 2, "--cache_latents"))
    train = [ln for ln in _metrics(run.workdir) if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0 for ln in train)
    assert run.seconds["precompute"] > 0
    cached = run.loader.load_batch(0)
    assert set(cached) == {"jpg_moments", "hint_moments", "token_ids", "task_idx"}
    assert cached["jpg_moments"].shape == (BS, RES // 2, RES // 2, 8)


@pytest.mark.parametrize("extra,error,match", [
    (["--tp", "2"], ValueError, "--tp 2 does not divide 1 devices"),
    (["--shard_opt_state"], None, None),
])
def test_finetune_multi_device_flags_raise(dataset_dir, tmp_path, extra, error, match):
    """At one process: --tp 2 cannot split the one device's model; with
    --shard_opt_state one rank keeps the whole AdamW state and the run
    trains as replicated (tests/test_torch_parallel.py holds the sharded
    state on two ranks)."""
    if error is not None:
        with pytest.raises(error, match=match):
            finetune.main(_flags(dataset_dir, str(tmp_path / "x"), 1, *extra))
        return
    run = finetune.main(_flags(dataset_dir, str(tmp_path / "x"), 1, *extra))
    assert run.trainer.cfg.shard_opt_state and run.trainer.mesh is None
    assert type(run.trainer.state.optimizer) is torch.optim.AdamW
    train = [ln for ln in _metrics(run.workdir) if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1] and np.isfinite(train[0]["loss"])


def test_finetune_argument_errors(dataset_dir, tmp_path):
    with pytest.raises(SystemExit):
        finetune.parse_args(["--multigen_json", "x.json", "--multigen_meta", "m", "--task",
                             "hed", "--cache_latents"])
    with pytest.raises(SystemExit):
        finetune.parse_args(["--config", "tiny"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):  # no fallback to the CPU
            finetune.main(["--config", "tiny", "--dataroot", dataset_dir,
                           "--name", str(tmp_path / "y")])


@pytest.fixture(scope="module")
def multigen_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mg")
    for d in ("json_files", "images", "conditions"):
        (root / d).mkdir()
    rng = np.random.default_rng(1)
    for task in ("hed", "canny"):
        with open(root / "json_files" / f"aesthetics_plus_all_group_{task}_all.json", "w") as f:
            for i in range(4):
                shape = (40, 48) if i % 2 else (48, 40)
                cv2.imwrite(str(root / "images" / f"{task}_{i}.jpg"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
                cv2.imwrite(str(root / "conditions" / f"{task}_{i}.png"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
                f.write(json.dumps({"source": f"./{task}_{i}.jpg",
                                    f"control_{task}": f"{task}_{i}.png",
                                    "prompt": f"a {task} image {i}"}) + "\n")
    return str(root)


def test_pretrain_cli_two_tasks(multigen_dir, tmp_path):
    run = pretrain.main([
        "--config", "tiny", "--device", "cpu", "--json_dir",
        os.path.join(multigen_dir, "json_files"), "--meta_dir", multigen_dir,
        "--tasks", "hed", "canny", "--resolution", str(RES), "--bs", str(BS),
        "--max_steps", "2", "--log_every", "1", "--ckpt_logger_freq", "2",
        "--img_logger_freq", "2", "--num_workers", "2", "--name", str(tmp_path / "pt")])
    trainer = run.trainer
    cfg = trainer.pipe.cfg
    assert cfg.tasks == ("hed", "canny") and cfg.control.lora.n_loras == 2
    assert trainer.cfg.trainable == "all" and all(trainer.mask["control"].values())
    assert not any(trainer.mask["unet"].values())
    train = [ln for ln in _metrics(run.workdir) if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0 for ln in train)
    # one round of the schedule trains both tasks
    sched = run.loader.schedule
    assert {sched.task_for_step(s) for s in range(2)} == {0, 1}
    assert os.path.exists(os.path.join(run.workdir, "ckpt_00000002.pt"))
    assert os.path.exists(os.path.join(run.workdir, "image_log", "step_00000002.png"))
    assert pretrain.model_config(pretrain.parse_args(
        ["--json_dir", "j", "--meta_dir", "m", "--tasks", "hed"])).tasks == ("hed",)


# ---------------------------------------------------------------------------
# the image-log hook against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hook_env():
    jpipe = JaxPipeline(jax_tiny(n_loras=1))
    params = _random_params(jpipe, 51)
    rng = np.random.default_rng(2)
    batch = {"jpg": rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, (3, 16)).astype(np.int32),
             "task_idx": np.zeros((3,), np.int32)}
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu", fuse_lora=False)
    pipe.load_state_dicts(*(convert.params_from_jax(p) for p in params))
    return jpipe, params, batch, pipe


@pytest.mark.parametrize("cached", [False, True])
def test_image_log_rows_match_jax(hook_env, cached):
    """The arrays of the JAX hook (ctrlora_tpu/training/trainer.py
    make_image_log_hook), pixel batch or latent-cached batch, with its
    starting noise."""
    jpipe, params, batch, pipe = hook_env
    step, steps, b, size = 3, 3, 2, 16
    if cached:
        enc = lambda x: np.asarray(jnp.concatenate(jpipe.vae.apply(
            params.vae, jnp.asarray(x), method=AutoencoderKL.encode), axis=-1))
        batch = {"jpg_moments": enc(batch["jpg"]), "hint_moments": enc(batch["hint"]),
                 "token_ids": batch["token_ids"], "task_idx": batch["task_idx"]}
    ids = jnp.asarray(batch["token_ids"][:b])
    ctx = jpipe.encode_text_tokens(params, ids)
    unc = jpipe.encode_text_tokens(params, jnp.zeros_like(ids))
    if cached:
        hint_in = jpipe.first_stage_from_moments(jnp.asarray(batch["hint_moments"][:b]))
        control = jpipe.decode_first_stage(params, hint_in) * 0.5 + 0.5
        recon = jpipe.decode_first_stage(params, jpipe.first_stage_from_moments(
            jnp.asarray(batch["jpg_moments"][:b])))
    else:
        control = jnp.asarray(batch["hint"][:b])
        hint_in = jpipe.encode_first_stage(params, control)
        recon = jpipe.decode_first_stage(
            params, jpipe.encode_first_stage(params, jnp.asarray(batch["jpg"][:b])))
    shape = (b, size // 2, size // 2, 4)
    z = jax_ddim_sample(jpipe, params, jax.random.PRNGKey(step), ctx, unc,
                        [JaxConditioning(hint_in, lora_idx=jnp.int32(0))], shape,
                        JaxDDIMConfig(steps=steps, guidance_scale=9.0))
    ref = {"control": np.asarray(control), "reconstruction": np.asarray(recon),
           "samples": np.asarray(jpipe.decode_first_stage(params, z))}
    x_T = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(step))[1], shape, jnp.float32)))
    rows = image_log_rows(pipe, {k: torch.from_numpy(v) for k, v in batch.items()}, step,
                          steps, x_T=x_T)
    assert rows.keys() == ref.keys()
    for k in ref:
        assert rows[k].shape == ref[k].shape == (b, size, size, 3)
        np.testing.assert_allclose(rows[k], ref[k], rtol=2e-3, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("pil", [True, False])
def test_prompt_strip(monkeypatch, pil):
    """The strip is drawn with PIL where it is installed, else with cv2,
    at the same shape."""
    if not pil:
        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda name, *a: None if name == "PIL" else real(name, *a))
    strip = trainer_mod._txt_strip(["a long prompt about a house by the lake", "b"], 70)
    assert strip.shape == (48, 70, 3) and strip.dtype == np.uint8
    assert strip.min() < 128 and strip.max() == 255  # dark text on white


def test_image_log_png_has_the_jax_layout(hook_env, tmp_path):
    """The port hook's PNG (prompts decoded from the token ids) and the JAX
    hook's (prompts from the batch's txt) have the same layout: the
    prompt strip (shape only), then control, reconstruction and samples."""
    jpipe, params, batch, pipe = hook_env
    step, steps = 3, 2
    tcfg = configs.TrainConfig(trainable="lora")
    mask = pts.trainable_mask(pipe, tcfg)
    state = pts.TrainState(step, pts.branches(pipe), pts.make_optimizer(pipe, tcfg, mask),
                           pts.trainable_parameters(pipe, mask))
    path = make_image_log_hook(pipe, str(tmp_path / "port"), ddim_steps=steps)(
        state, step, {k: torch.from_numpy(v) for k, v in batch.items()})
    os.makedirs(tmp_path / "jax" / "image_log")
    jhook = jax_trainer.make_image_log_hook(jpipe, str(tmp_path / "jax"), ddim_steps=steps)
    jhook(jax_trainer.TrainState(jnp.int32(step), params, None, None), step,
          dict(batch, txt=np.array(["a", "b", "c"])))
    jpng = cv2.imread(str(tmp_path / "jax" / "image_log" / f"step_{step:08d}.png"))
    assert cv2.imread(path).shape == jpng.shape == (48 + 3 * 16, 2 * 16, 3)
