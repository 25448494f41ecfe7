"""The port's finetune step against the JAX package at tiny size: the
unfused LoRA control tree loads through ``convert.params_from_jax``, the
loss of one batch and every trainable gradient match ``jax.grad`` of the
JAX ``loss_for_batch`` with the same random draws, the trainable set and
the AdamW step match the JAX mask and optimizer, and the Trainer runs,
logs and checkpoints.

fp32 on the CPU; tolerance rtol=2e-3, atol=2e-4 as tests/test_parity.py
(the frameworks sum convolutions and matmuls in different orders); the
optimizer step, from identical parameters and gradients, to rtol 1e-5.
"""

import copy
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from ctrlora_tpu_torch.training.trainer import Trainer
from tests.torch_fresh import seed_zeroed_layers_

RTOL, ATOL = 2e-3, 2e-4
ZERO_INIT = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")
TCFG = dict(trainable="lora", learning_rate=1e-3)


def _random_params(shapes, seed):
    """Seeded numpy weights for a JAX parameter tree of ShapeDtypeStructs
    (faster than running flax's init): lecun-normal kernels, N(0, 1/r)
    lora_down, and N(0, 0.05) for the layers a fresh model zero-initialises
    (and lora_up), so every branch carries signal."""
    rng = np.random.default_rng(seed)

    def f(path, s):
        ks, leaf = jax.tree_util.keystr(path), path[-1].key
        if leaf == "scale":
            v = 1 + rng.normal(0, 0.1, s.shape)
        elif leaf == "lora_down":
            v = rng.normal(0, 1 / s.shape[-1], s.shape)
        elif leaf == "lora_up" or (leaf == "kernel" and any(z in ks for z in ZERO_INIT)):
            v = rng.normal(0, 0.05, s.shape)
        elif leaf == "kernel":
            v = rng.normal(0, math.prod(s.shape[:-1]) ** -0.5, s.shape)
        else:  # biases, embeddings
            v = rng.normal(0, 0.02, s.shape)
        return jnp.asarray(v, s.dtype)

    return jax.tree_util.tree_map_with_path(f, shapes)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def _flat_mask(params_tree, mask_tree):
    """JAX boolean mask -> {port parameter name: bool}."""
    full = jax.tree_util.tree_map(lambda p, m: np.full(p.shape, m), params_tree, mask_tree)
    return {k: bool(v.all()) for k, v in convert.params_from_jax(full).items()}


def _port_pipeline(params, cfg=None):
    pipe = CtrLoraPipeline(cfg or configs.tiny_test_config(n_loras=1), "cpu", fuse_lora=False)
    pipe.load_state_dicts(*(convert.params_from_jax(p) for p in params))
    return pipe


def seeded_inputs():
    """The tiny JAX model's seeded parameters and one batch of 2 at 16^2."""
    jpipe = JaxPipeline(jax_tiny(n_loras=1))
    shapes = jax.eval_shape(functools.partial(jpipe.init, image_size=8), jax.random.PRNGKey(0))
    params = type(shapes)(*(_random_params(p, 20 + i) for i, p in enumerate(shapes)))
    rng = np.random.default_rng(0)
    batch = {"jpg": rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, size=(2, 16, 16, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, size=(2, 16)).astype(np.int32)}
    return params, batch


def loss_draws(key, shape=(2, 8, 8, 4)):
    """The draws JAX loss_for_batch / _batch_conds / p_losses make from
    `key`, from the same key splits, as torch tensors."""
    rest, z_rng, t_rng = jax.random.split(key, 3)
    _, h_rng = jax.random.split(rest)
    t_rng, n_rng = jax.random.split(t_rng)
    draws = {"z_eps": jax.random.normal(z_rng, shape), "hint_eps": jax.random.normal(h_rng, shape),
             "t": jax.random.randint(t_rng, (shape[0],), 0, 1000),
             "noise": jax.random.normal(n_rng, shape)}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_side():
    """Tiny JAX model, one batch, its loss and gradients, and the random
    draws loss_for_batch makes from its key. The grad is jitted: on this
    model one CPU compile (~10 s) beats eager dispatch (~35 s)."""
    jpipe = JaxPipeline(jax_tiny(n_loras=1))
    params, batch = seeded_inputs()
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_for_batch(jpipe, p, jbatch, key), has_aux=True))(params)
    return params, batch, loss_draws(key), float(loss), metrics, grads


def test_trainable_set_matches_jax_mask(jax_side):
    params = jax_side[0]
    pipe = _port_pipeline(params)
    tcfg = configs.TrainConfig(**TCFG)
    mask = pts.trainable_mask(pipe, tcfg)
    jmask = jts.trainable_mask(params, JaxTrainConfig(**TCFG))
    assert mask["control"] == _flat_mask(params.control, jmask.control)
    assert not any(mask["unet"].values()) and not any(mask["vae"].values())
    assert pts.count_trainable(pipe, mask) == jts.count_trainable(params, jmask)
    names = [n for n, t in mask["control"].items() if t]
    assert any("lora_down" in n for n in names) and any(n.startswith("zero_") for n in names)
    assert any(".norm1." in n for n in names) and not any("in_norm" in n for n in names)


def test_loss_and_trainable_grads_match_jax(jax_side):
    params, batch, draws, jloss, jmetrics, jgrads = jax_side
    pipe = _port_pipeline(params)
    tcfg = configs.TrainConfig(**TCFG)
    mask = pts.trainable_mask(pipe, tcfg)
    opt = pts.make_optimizer(pipe, tcfg, mask)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = pstep.loss_for_batch(pipe, tbatch, draws=draws)
    _close(loss.item(), jloss)
    _close(metrics["t_mean"].item(), jmetrics["t_mean"])
    loss.backward()
    ref = convert.params_from_jax(jgrads.control)
    trainable = [n for n, t in mask["control"].items() if t]
    for name, p in pipe.control.named_parameters():
        if name in trainable:
            assert p.grad is not None, name
            _close(p.grad.numpy(), ref[name].numpy())
        else:
            assert p.grad is None, name  # frozen: no gradient computed
    assert all(p.grad is None for p in pipe.unet.parameters())
    # grad_norm: the JAX norm restricted to the mask's trainable leaves
    jnorm = math.sqrt(sum(float(np.sum(ref[n].numpy().astype(np.float64) ** 2))
                          for n in trainable))
    _close(pstep.trainable_grad_norm(opt).item(), jnorm)


def test_adamw_step_matches_jax_optimizer(jax_side):
    params, _, _, _, _, jgrads = jax_side
    pipe = _port_pipeline(params)
    tcfg = configs.TrainConfig(**TCFG)
    mask = pts.trainable_mask(pipe, tcfg)
    opt = pts.make_optimizer(pipe, tcfg, mask)
    grads = convert.params_from_jax(jgrads.control)
    before = {n: p.detach().clone() for n, p in pipe.control.named_parameters()}
    for name, p in pipe.control.named_parameters():
        if p.requires_grad:
            p.grad = grads[name].clone()
    opt.step()
    jmask = jts.trainable_mask(params, JaxTrainConfig(**TCFG))
    tx = jts.make_optimizer(JaxTrainConfig(**TCFG), jmask)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    ref = convert.params_from_jax(optax.apply_updates(params, updates).control)
    for name, p in pipe.control.named_parameters():
        _close(p.detach().numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-7)
        assert torch.equal(p.detach(), before[name]) != mask["control"][name], name


def _tiny_trainer(tmp_path, **kw):
    gen = torch.Generator().manual_seed(3)
    cfg = configs.tiny_test_config(n_loras=1)
    pipe = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    with torch.no_grad():
        for name, p in pipe.control.named_parameters():
            if "lora_up" in name or name.startswith("zero_"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    for i, module in enumerate((pipe.unet, pipe.control)):  # fresh, both output 0 (as JAX's)
        seed_zeroed_layers_(module, 3 + i)
    tcfg = configs.TrainConfig(trainable="lora", log_every=1, **kw)
    batch = lambda: {"jpg": torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1,
                     "hint": torch.rand(2, 16, 16, 3, generator=gen),
                     "token_ids": torch.randint(1, 128, (2, 16), generator=gen)}
    return Trainer(pipe, tcfg, str(tmp_path)), pipe, batch


def test_trainer_fit_logs_and_keeps_frozen_weights(tmp_path):
    trainer, pipe, batch = _tiny_trainer(tmp_path, ckpt_every=3)
    frozen = {f"{b}.{n}": p.detach().clone() for b, m in pts.branches(pipe).items()
              for n, p in m.named_parameters() if not trainer.mask[b][n]}
    trained = {k: p.detach().clone() for k, p in
               pts.trainable_parameters(pipe, trainer.mask).items()}
    state = trainer.fit([batch() for _ in range(4)], max_steps=3)
    assert state.step == 3
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["event"] == "init" and lines[0]["trainable_params_m"] > 0
    train = [ln for ln in lines if ln["event"] == "train"]
    assert [ln["step"] for ln in train] == [1, 2, 3]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0 and ln["steps_per_sec"] > 0
               for ln in train)
    assert os.path.exists(os.path.join(tmp_path, "ckpt_00000003.pt"))
    with open(os.path.join(tmp_path, "trainable_params.txt")) as f:
        assert f.read().split() == list(trained)
    now = {f"{b}.{n}": p for b, m in pts.branches(pipe).items() for n, p in m.named_parameters()}
    assert all(torch.equal(now[k], v) for k, v in frozen.items())
    assert all(not torch.equal(now[k], v) for k, v in trained.items())


def test_save_restore_round_trip(tmp_path):
    trainer, pipe, batch = _tiny_trainer(tmp_path)
    trainer.fit([batch(), batch()], max_steps=2)
    path = trainer.save(2)
    saved = {k: p.detach().clone() for k, p in
             pts.trainable_parameters(pipe, trainer.mask).items()}
    saved_opt = copy.deepcopy(trainer.state.optimizer.state_dict())
    trainer.fit([batch()], max_steps=3)
    assert trainer.state.step == 3
    trainer.restore(path)
    assert trainer.state.step == 2
    for k, p in pts.trainable_parameters(pipe, trainer.mask).items():
        assert torch.equal(p, saved[k]), k
    for i, st in saved_opt["state"].items():
        got = trainer.state.optimizer.state_dict()["state"][i]
        assert all(torch.equal(got[k], v) for k, v in st.items() if torch.is_tensor(v))


def test_grad_accum_averages_micro_batch_grads(tmp_path):
    trainer, pipe, batch = _tiny_trainer(tmp_path)
    mb = [batch(), batch()]
    tcfg = configs.TrainConfig(trainable="lora", grad_accum=2)
    opt = trainer.state.optimizer
    params = list(pts.trainable_parameters(pipe, trainer.mask).values())
    # manual average with the same draws, before any update
    gen = torch.Generator().manual_seed(9)
    opt.zero_grad()
    for b in mb:
        (pstep.loss_for_batch(pipe, b, gen)[0] / 2).backward()
    want = [p.grad.clone() for p in params]
    step = pstep.make_train_step(pipe, opt, tcfg)
    stacked = {k: torch.stack([b[k] for b in mb]) for k in mb[0]}
    _, metrics = step(trainer.state, stacked, torch.Generator().manual_seed(9))
    for p, w in zip(params, want):
        torch.testing.assert_close(p.grad, w)
    _close(metrics["grad_norm"].item(),
           torch.linalg.vector_norm(torch.cat([w.flatten() for w in want])).item(), 1e-5, 0)


def test_latent_cached_batch_matches_pixel_batch(tmp_path):
    """A batch of posterior moments (mean | logvar) gives the pixel batch's
    loss under the same draws, as the JAX latent cache does."""
    _, pipe, batch = _tiny_trainer(tmp_path)
    pixels = batch()
    with torch.no_grad():
        cached = {f"{k}_moments": torch.cat(pipe.vae.encode(pixels[k]), dim=-1)
                  for k in ("jpg", "hint")}
    cached["token_ids"] = pixels["token_ids"]
    gen = torch.Generator().manual_seed(4)
    draws = {"z_eps": torch.randn(2, 8, 8, 4, generator=gen),
             "hint_eps": torch.randn(2, 8, 8, 4, generator=gen), "t": torch.tensor([3, 800]),
             "noise": torch.randn(2, 8, 8, 4, generator=gen)}
    with torch.no_grad():
        want = pstep.loss_for_batch(pipe, pixels, draws=draws)[0]
        got = pstep.loss_for_batch(pipe, cached, draws=draws)[0]
    torch.testing.assert_close(got, want)


def _draw_case(case):
    """A tiny pipeline (latent- or image-hint) and a batch (pixels or, for
    'cached', posterior moments) for the draw-order tests."""
    gen = torch.Generator().manual_seed(11)
    hint_mode = "image" if case == "image_hint" else "latent"
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1, hint_mode=hint_mode), "cpu",
                           fuse_lora=False)
    with torch.no_grad():
        for name, p in pipe.control.named_parameters():
            if "lora_up" in name or name.startswith("zero_"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    for i, module in enumerate((pipe.unet, pipe.control)):
        seed_zeroed_layers_(module, 7 + i)
    size = 16 if hint_mode == "latent" else 64  # an image hint is at 8x the latent's size
    batch = {"jpg": torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1,
             "hint": torch.rand(2, size, size, 3, generator=gen),
             "token_ids": torch.randint(1, 128, (2, 16), generator=gen)}
    if case == "cached":
        with torch.no_grad():
            batch = {**{f"{k}_moments": torch.cat(pipe.vae.encode(batch[k]), dim=-1)
                        for k in ("jpg", "hint")}, "token_ids": batch["token_ids"]}
    return pipe, batch


@pytest.mark.parametrize("case", ["latent_hint", "image_hint", "cached"])
def test_global_draws_are_the_generator_draws_of_loss_for_batch(case):
    """The graphed step draws up front with ``global_draws``: the same
    numbers, in the same order, that ``loss_for_batch`` draws from the
    generator, so the loss is the same bit for bit."""
    pipe, batch = _draw_case(case)
    with torch.no_grad():
        want, want_m = pstep.loss_for_batch(pipe, batch, torch.Generator().manual_seed(21))
        draws = pstep.global_draws(pipe, batch, torch.Generator().manual_seed(21), 1)
        got, got_m = pstep.loss_for_batch(pipe, batch, draws=draws)
    assert set(draws) == ({"z_eps", "t", "noise"} | ({"hint_eps"} if case != "image_hint"
                                                       else set()))
    assert torch.equal(got, want)
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)


def _numpy_extract(table, t, ndim):
    out = torch.as_tensor(table)[t.long()]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


@pytest.mark.parametrize("fn", ["extract", "q_sample", "get_v", "predict_eps_from_z_and_v",
                                "predict_start_from_z_and_v"])
def test_device_tables_give_the_numpy_tables_values(fn):
    """The tables the schedule helpers read are copied to the device once
    and kept; each helper gives what indexing the numpy table gives, in
    dtype and value, and a second call reads the same copy."""
    from ctrlora_tpu_torch import schedules as sch

    sched = sch.make_schedule("linear", 1000, parameterization="v")
    gen = torch.Generator().manual_seed(2)
    x, e = torch.randn(3, 4, 4, 2, generator=gen), torch.randn(3, 4, 4, 2, generator=gen)
    t = torch.tensor([0, 517, 999])
    a = lambda: _numpy_extract(sched.sqrt_alphas_cumprod, t, 4)
    b = lambda: _numpy_extract(sched.sqrt_one_minus_alphas_cumprod, t, 4)
    if fn == "extract":
        got, want = sch.extract(sched.lvlb_weights, t, 4), _numpy_extract(sched.lvlb_weights, t, 4)
    elif fn == "q_sample":
        got, want = sch.q_sample(sched, x, t, e), a() * x + b() * e
    elif fn == "get_v":
        got, want = sch.get_v(sched, x, e, t), a() * e - b() * x
    elif fn == "predict_eps_from_z_and_v":
        got, want = sch.predict_eps_from_z_and_v(sched, x, t, e), a() * e + b() * x
    else:
        got, want = sch.predict_start_from_z_and_v(sched, x, t, e), a() * x - b() * e
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    table = sch.device_table(sched.sqrt_alphas_cumprod, "cpu")
    assert table is sch.device_table(sched.sqrt_alphas_cumprod, t.device)
    assert table.dtype == torch.float32 and np.array_equal(table.numpy(),
                                                           sched.sqrt_alphas_cumprod)


def _signature(device="cuda", mesh=None, batch=None, **train):
    batch = batch if batch is not None else {
        "jpg": torch.zeros(2, 16, 16, 3), "hint": torch.zeros(2, 16, 16, 3),
        "token_ids": torch.zeros(2, 16, dtype=torch.long)}
    return pstep.graph_signature(configs.TrainConfig(trainable="lora", **train),
                                 torch.device(device), mesh, batch)


@pytest.mark.parametrize("case", ["cpu", "distributed_mesh", "grad_accum", "string_value"])
def test_steps_that_stay_eager_have_no_graph_signature(case):
    from types import SimpleNamespace

    assert _signature() is not None
    assert _signature(mesh=SimpleNamespace(distributed=False)) is not None
    kw = {"cpu": dict(device="cpu"),
          "distributed_mesh": dict(mesh=SimpleNamespace(distributed=True)),
          "grad_accum": dict(grad_accum=2),
          "string_value": dict(batch={"jpg": torch.zeros(2, 16, 16, 3), "txt": "a prompt"}),
          }[case]
    assert _signature(**kw) is None


@pytest.mark.parametrize("change", ["key_set", "shape", "dtype", "task_idx"])
def test_graph_signatures_tell_batches_apart(change):
    base = {"jpg": torch.zeros(2, 16, 16, 3), "hint": torch.zeros(2, 16, 16, 3),
            "token_ids": torch.zeros(2, 16, dtype=torch.long), "task_idx": 1}
    other = dict(base)
    if change == "key_set":
        other["jpg_moments"] = other.pop("jpg")
    elif change == "shape":
        other["jpg"] = torch.zeros(4, 16, 16, 3)
    elif change == "dtype":
        other["token_ids"] = other["token_ids"].int()
    else:
        other["task_idx"] = 2
    assert _signature(batch=base) == _signature(batch={k: v for k, v in base.items()})
    assert _signature(batch=other) is not None
    assert _signature(batch=other) != _signature(batch=base)
    # a tensor task_idx is copied in like the other tensors: its value is not in the key
    one, two = dict(base, task_idx=torch.tensor([1, 1])), dict(base, task_idx=torch.tensor([2, 2]))
    assert _signature(batch=one) == _signature(batch=two) is not None


def test_a_cpu_step_runs_eager_and_counts_it(tmp_path):
    from ctrlora_tpu_torch.utils import trace

    trainer, pipe, batch = _tiny_trainer(tmp_path)
    before = trace.summary()["counters"]
    trainer.fit([batch(), batch()], max_steps=2)
    after = trace.summary()["counters"]
    n = lambda c, k: c.get(f"train.graph.{k}", 0)
    assert n(after, "eager") - n(before, "eager") == 2
    assert n(after, "captures") == n(before, "captures") and \
        n(after, "replays") == n(before, "replays")
