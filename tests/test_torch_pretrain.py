"""The port's pretrain step against the JAX package at tiny size: two LoRA
banks (one per task), trainable='all', two AdamW steps, task 0 then task 1,
each with the random draws of the JAX step's key (``fold_in(key, step)``).
Every control parameter after step 2 matches JAX's within rtol 2e-3 /
atol 2e-4 (fp32 on the CPU, as tests/test_torch_training.py), and bank 0
moves in step 2, which trains task 1: its gradient there is a dense zero,
and AdamW's momentum and decay still move it, as optax moves JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from ctrlora_tpu.configs import TrainConfig as JaxTrainConfig
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.training import step as jstep
from ctrlora_tpu.training import train_state as jts

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.training import step as pstep
from ctrlora_tpu_torch.training import train_state as pts
from tests.test_torch_plms_dpm import _random_params

RTOL, ATOL = 2e-3, 2e-4
# lr 1e-3 moves each parameter ~1e-3 a step, so a wrong update shows above
# atol; adam_eps 1e-6 (torch's and optax's default is 1e-8) keeps Adam's
# g / (|g| + eps) from turning the fp32 rounding noise of gradients near
# 1e-8 (both frameworks have some on this tiny model) into lr-sized steps
TCFG = dict(trainable="all", learning_rate=1e-3, adam_eps=1e-6)
B, SIZE, LAT = 2, 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test run shares the host's cores between
    several test processes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_step_draws(key, b=B, lat=LAT):
    """The draws of the JAX loss_for_batch / _batch_conds / p_losses made
    from one step's key, as port tensors."""
    rest, z_rng, t_rng = jax.random.split(key, 3)
    _, h_rng = jax.random.split(rest)
    t_rng, n_rng = jax.random.split(t_rng)
    shape = (b, lat, lat, 4)
    draws = {"z_eps": jax.random.normal(z_rng, shape), "hint_eps": jax.random.normal(h_rng, shape),
             "t": jax.random.randint(t_rng, (b,), 0, 1000), "noise": jax.random.normal(n_rng, shape)}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


def batches(seed, tasks):
    rng = np.random.default_rng(seed)
    return [{"jpg": rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, (B, 16)).astype(np.int32),
             "task_idx": np.full((B,), t, np.int32)} for t in tasks]


@pytest.fixture(scope="module")
def runs():
    jpipe = JaxPipeline(jax_tiny(n_loras=2))
    params = _random_params(jpipe, 31)
    jcfg = JaxTrainConfig(**TCFG)
    jstate, tx, jmask = jts.create_train_state(params, jcfg)
    jfn = jstep.make_train_step(jpipe, tx, jcfg, donate=False, mask=jmask)
    key = jax.random.PRNGKey(7)
    data = batches(0, (0, 1))
    jax_after = []
    for b in data:
        jstate, _ = jfn(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()}, key)
        jax_after.append(convert.params_from_jax(jstate.params.control))

    pcfg = configs.tiny_test_config(n_loras=2)
    pipe = CtrLoraPipeline(pcfg, "cpu", fuse_lora=False)
    pipe.load_state_dicts(*(convert.params_from_jax(p) for p in params))
    tcfg = configs.TrainConfig(**TCFG)
    mask = pts.trainable_mask(pipe, tcfg)
    opt = pts.make_optimizer(pipe, tcfg, mask)
    state = pts.TrainState(0, pts.branches(pipe), opt, pts.trainable_parameters(pipe, mask))
    fn = pstep.make_train_step(pipe, opt, tcfg)
    unet = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    port_after = []
    for s, b in enumerate(data):
        draws = jax_step_draws(jax.random.fold_in(key, s))
        state, metrics = fn(state, {k: torch.from_numpy(v) for k, v in b.items()}, draws=draws)
        assert np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0
        port_after.append({k: v.clone() for k, v in pipe.control.state_dict().items()})
    return pipe, mask, unet, jax_after, port_after


def test_pretrain_steps_match_jax(runs):
    pipe, mask, _, jax_after, port_after = runs
    assert all(mask["control"].values()) and not any(mask["unet"].values())
    assert set(port_after[-1]) == set(jax_after[-1])
    for name, value in port_after[-1].items():
        np.testing.assert_allclose(value.numpy(), jax_after[-1][name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_bank_of_the_other_task_moves(runs):
    """Step 2 trains task 1: each LoRA bank stack is one parameter whose
    gradient there is dense, zero in bank 0, and bank 0 still moves
    (AdamW's momentum from step 1 and its decay), in the port as in JAX."""
    pipe, _, _, jax_after, port_after = runs
    ups = {k: p for k, p in pipe.control.named_parameters() if k.endswith("lora_up")}
    assert ups
    for k, p in ups.items():
        assert p.grad is not None and p.grad.shape == p.shape, k
        assert not p.grad[0].any() and p.grad[1].any(), k
        for after in (port_after, jax_after):
            assert not torch.equal(after[1][k][0], after[0][k][0]), k


def test_frozen_unet_is_bit_identical(runs):
    pipe, _, unet, _, _ = runs
    assert all(torch.equal(v, unet[k]) for k, v in pipe.unet.state_dict().items())


def test_pretrain_preset():
    cfg = configs.load_model_config("ctrlora_pretrain", tasks=("hed", "canny"), lora_rank=4)
    assert cfg.control.lora.n_loras == 2 and cfg.control.lora.rank == 4
    assert cfg.tasks == ("hed", "canny") and not cfg.control.lora.switchable_banks
    assert cfg.control.hint_mode == "latent"
    assert configs.ctrlora_pretrain_config().tasks == configs.MULTIGEN_TASKS
    assert len(configs.MULTIGEN_TASKS) == 9
