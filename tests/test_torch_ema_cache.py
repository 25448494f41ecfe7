"""The port's EMA and latent cache against the JAX package's, on the CPU
(tiny configuration, fp32, rtol 2e-3 / atol 2e-4 as
tests/test_torch_training.py):

* ``training.ema``: three updates of a shadow equal JAX ``ema_update``'s,
  and two training steps with ``use_ema`` leave JAX's shadow;
* ``Trainer.eval_params``: the shadow inside, the live weights back bit for
  bit after, and checkpoints that carry the shadow;
* ``training.latent_cache``: ``precompute_moments`` (a padded tail batch
  included) equal to JAX's, and ``LatentCachedDataset.get`` equal exactly.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.configs import TrainConfig as JaxTrainConfig
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.data import datasets as jax_datasets
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.training import ema as jax_ema
from ctrlora_tpu.training import latent_cache as jax_cache
from ctrlora_tpu.training import step as jstep
from ctrlora_tpu.training import train_state as jts

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.data import datasets
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.training import ema, latent_cache
from ctrlora_tpu_torch.training import step as pstep
from ctrlora_tpu_torch.training import train_state as pts
from ctrlora_tpu_torch.training.trainer import Trainer
from tests.test_torch_plms_dpm import _random_params
from tests.test_torch_pretrain import batches, jax_step_draws

RTOL, ATOL = 2e-3, 2e-4
# as tests/test_torch_pretrain.py: steps large enough to see, and an Adam
# eps that keeps the rounding noise of near-zero gradients out of them
TCFG = dict(trainable="lora", learning_rate=1e-3, adam_eps=1e-6, use_ema=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test run shares the host's cores between
    several test processes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def jax_params():
    jpipe = JaxPipeline(jax_tiny(n_loras=1))
    return jpipe, _random_params(jpipe, 41)


def _port_pipe(params):
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu", fuse_lora=False)
    pipe.load_state_dicts(*(convert.params_from_jax(p) for p in params))
    return pipe


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------

def test_ema_updates_match_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    ours = ema.ema_init({k: torch.from_numpy(v) for k, v in start.items()})
    ref = jax_ema.ema_init({k: jnp.asarray(v) for k, v in start.items()})
    for _ in range(3):
        live = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        ema.ema_update(ours, {k: torch.from_numpy(v) for k, v in live.items()}, decay=0.95)
        ref = jax_ema.ema_update(ref, {k: jnp.asarray(v) for k, v in live.items()}, decay=0.95)
    assert ours.updates == int(ref.updates) == 3
    for k in shapes:
        assert ours.params[k].dtype == torch.float32
        _close(ours.params[k].numpy(), ref.params[k], rtol=1e-6, atol=1e-7)


def test_ema_shadow_of_two_steps_matches_jax(jax_params):
    jpipe, params = jax_params
    jcfg = JaxTrainConfig(**TCFG)
    jstate, tx, jmask = jts.create_train_state(params, jcfg)
    jfn = jstep.make_train_step(jpipe, tx, jcfg, donate=False, mask=jmask)
    key = jax.random.PRNGKey(3)
    data = batches(1, (0, 0))
    for b in data:
        jstate, _ = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()}, key)
    shadow = convert.params_from_jax(jax_ema.ema_params(jstate.params, jstate.ema).control)

    pipe = _port_pipe(params)
    tcfg = configs.TrainConfig(**TCFG)
    mask = pts.trainable_mask(pipe, tcfg)
    opt = pts.make_optimizer(pipe, tcfg, mask)
    trainable = pts.trainable_parameters(pipe, mask)
    state = pts.TrainState(0, pts.branches(pipe), opt, trainable, ema.ema_init(trainable))
    fn = pstep.make_train_step(pipe, opt, tcfg)
    for s, b in enumerate(data):
        fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
           draws=jax_step_draws(jax.random.fold_in(key, s)))
    assert state.ema.updates == int(jstate.ema.updates) == 2
    assert set(state.ema.params) == set(trainable) and all(k.startswith("control.")
                                                           for k in trainable)
    for k, v in state.ema.params.items():
        _close(v.numpy(), shadow[k.split(".", 1)[1]].numpy(), msg=k)
        assert not torch.equal(v, trainable[k].detach()), k  # the shadow lags


def _tiny_trainer(tmp_path, **kw):
    gen = torch.Generator().manual_seed(3)
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu", fuse_lora=False)
    tcfg = configs.TrainConfig(trainable="lora", learning_rate=1e-3, use_ema=True, **kw)
    batch = lambda: {"jpg": torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1,
                     "hint": torch.rand(2, 16, 16, 3, generator=gen),
                     "token_ids": torch.randint(1, 128, (2, 16), generator=gen)}
    return Trainer(pipe, tcfg, str(tmp_path)), batch


def test_eval_params_swaps_and_restores_bit_for_bit(tmp_path):
    trainer, batch = _tiny_trainer(tmp_path)
    trainer.fit([batch(), batch()], max_steps=2)
    live = {k: p.detach().clone() for k, p in trainer.state.trainable.items()}
    shadow = trainer.state.ema.params
    assert any(not torch.equal(live[k], shadow[k]) for k in live)
    with trainer.eval_params():
        for k, p in trainer.state.trainable.items():
            assert torch.equal(p, shadow[k]), k
    for k, p in trainer.state.trainable.items():
        assert torch.equal(p, live[k]), k


def test_checkpoint_carries_the_ema(tmp_path):
    trainer, batch = _tiny_trainer(tmp_path / "a")
    trainer.fit([batch(), batch()], max_steps=2)
    path = trainer.save(2)
    other, _ = _tiny_trainer(tmp_path / "b")
    other.restore(path)
    assert other.state.step == 2 and other.state.ema.updates == 2
    for k, v in trainer.state.ema.params.items():
        assert torch.equal(other.state.ema.params[k], v), k
    plain = Trainer(other.pipe, configs.TrainConfig(trainable="lora"), str(tmp_path / "c"))
    assert plain.state.ema is None
    with plain.eval_params():  # no EMA: nothing is swapped
        pass


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def custom_dir(tmp_path_factory):
    """Ten pairs (a batch of 8 and a padded tail of 2), 16^2 after resize
    (8^2 latents: the tiny VAE halves)."""
    root = tmp_path_factory.mktemp("cache")
    (root / "source").mkdir()
    (root / "target").mkdir()
    rng = np.random.default_rng(8)
    with open(root / "prompt.json", "w") as f:
        for i in range(10):
            for sub in ("source", "target"):
                cv2.imwrite(str(root / sub / f"{i}.png"),
                            rng.integers(0, 256, (20, 20, 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"cached {i}"}) + "\n")
    return str(root)


def test_precompute_moments_matches_jax(jax_params, custom_dir):
    jpipe, params = jax_params
    jm, hm = jax_cache.precompute_moments(
        jpipe, params, jax_datasets.CustomDataset(custom_dir, resolution=16), log=lambda m: None)
    ds = datasets.CustomDataset(custom_dir, resolution=16)
    pm, ph = latent_cache.precompute_moments(_port_pipe(params), ds, log=lambda m: None)
    for ours, ref in ((pm, jm), (ph, hm)):
        assert ours.dtype == np.float32 and ours.shape == ref.shape == (10, 8, 8, 8)
        _close(ours, ref)


def test_latent_cached_dataset_get_matches_jax(custom_dir):
    rng = np.random.default_rng(1)
    jm, hm = (rng.normal(size=(10, 8, 8, 8)).astype(np.float32) for _ in range(2))
    ours = latent_cache.LatentCachedDataset(
        datasets.CustomDataset(custom_dir, drop_rate=0.5, resolution=16), jm, hm)
    ref = jax_cache.LatentCachedDataset(
        jax_datasets.CustomDataset(custom_dir, drop_rate=0.5, resolution=16), jm, hm)
    for i in range(10):
        a, b = ours.get(i, np.random.default_rng(i)), ref.get(i, np.random.default_rng(i))
        assert a.keys() == b.keys() and a["txt"] == b["txt"]
        for k in ("jpg_moments", "hint_moments"):
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="cache size"):
        latent_cache.LatentCachedDataset(ours.ds, jm[:3], hm)
