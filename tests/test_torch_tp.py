"""Tensor parallelism of the PyTorch port (``ctrlora_tpu_torch/parallel/tp.py``)
on gloo ranks on the CPU at tiny size (two heads a site): meshes 1x2, 2x2
and 1x4 (4 ranks), held against the JAX package under
``tensor_parallel(create_mesh_2d(...))`` (tests/test_tp.py) and against the
port's one process.

  * apply_model of a batch of 4 on each mesh: against JAX's forward on the
    same mesh (rtol 2e-3 / atol 2e-4, the port-vs-JAX tolerance of
    tests/test_torch_training.py) and the port's one-process forward
    (rtol 1e-5 / atol 1e-6: only the order of the heads' sums differs). At
    1x4 the two heads do not divide tp: the attention sites run whole and
    only the feed-forwards split (JAX constrain's model_units).
  * the finetune step (one rank-4 LoRA on every control Linear: LoRA'd
    sites) at 1x2 and 2x2: loss against JAX's TP step at rtol 2e-4
    (tests/test_tp.py), loss, grad norm, gradients and parameters against
    one process (as tests/test_torch_parallel.py, lr 1e-6 for its reason),
    and the ranks' parameters bit-identical after every step.
  * ``sample.py --tp 2`` on 2 ranks: the one-rank run's PNGs within one
    uint8 level.
  * a 3-step CFG DDIM through ``tp_sample`` on each mesh with the
    cross-attention k|v hoisted (each rank's table holds its own heads'
    columns) is bit for bit the one without.
"""

import os

import numpy as np
import pytest
import torch

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.parallel import mesh as pmesh
from ctrlora_tpu_torch.parallel import tp
from ctrlora_tpu_torch.scripts import sample as sample_cli
from ctrlora_tpu_torch.training.trainer import Trainer
from tests import torch_ranks as ranks

RTOL, ATOL = 2e-3, 2e-4
SELF = dict(rtol=1e-5, atol=1e-7)
TCFG = dict(trainable="lora", learning_rate=1e-6, log_every=1)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **tol)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from ctrlora_tpu.configs import TrainConfig as JaxTrainConfig
    from ctrlora_tpu.parallel.tp import create_mesh_2d, shard_batch_2d, tensor_parallel
    from ctrlora_tpu.pipeline import Conditioning as JaxConditioning
    from ctrlora_tpu.training.step import make_train_step
    from ctrlora_tpu.training.train_state import create_train_state

    jpipe, params, states = ranks.jax_side()
    batches = ranks.numpy_batches(2)
    key = jax.random.PRNGKey(5)
    draws = [ranks.jax_draws(jax.random.fold_in(key, k), 4) for k in range(2)]
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 8, 4))
    t = jnp.full((4,), 500, jnp.int32)
    ctx = jax.random.normal(jax.random.PRNGKey(2), (4, 16, 64))
    hz = jax.random.normal(jax.random.PRNGKey(3), (4, 8, 8, 4))

    def fwd(p, x, t, ctx, hz):
        return jpipe.apply_model(p, x, t, ctx, [JaxConditioning(hz, lora_idx=jnp.int32(0))])

    jax_fwd = {}
    for shape in ((2, 2), (1, 4)):
        with tensor_parallel(create_mesh_2d(*shape)):
            jax_fwd[shape] = np.asarray(jax.jit(fwd)(params, x, t, ctx, hz))
    jax_fwd[(1, 2)] = jax_fwd[(2, 2)]  # GSPMD: one function on any mesh
    jcfg = JaxTrainConfig(**{k: v for k, v in TCFG.items() if k != "log_every"})
    state, tx, _ = create_train_state(params, jcfg)
    mesh = create_mesh_2d(2, 2)
    with tensor_parallel(mesh):
        step = make_train_step(jpipe, tx, jcfg, donate=False)
        _, m = step(state, shard_batch_2d(mesh, batches[0]), key)
    jax_loss = float(m["loss"])

    to_t = lambda a: torch.from_numpy(np.asarray(a))
    fwd_in = {"x": to_t(x), "t": to_t(t).long(), "ctx": to_t(ctx), "hz": to_t(hz)}
    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    got = {}
    for world in (2, 4):
        root = str(tmp_path_factory.mktemp(f"tp{world}"))
        torch.save({"states": states, "batches": tbatches, "draws": draws, "tcfg": TCFG,
                    "fwd": fwd_in}, os.path.join(root, "inputs.pt"))
        got[world] = ranks.run_ranks(ranks.tp_rank, world, root,
                                     {"tp": 2, "meshes": MESHES[world]})
    pipe = ranks.train_pipeline(states)
    one_fwd = ranks.forward(pipe, fwd_in)
    tr = Trainer(ranks.train_pipeline(states), configs.TrainConfig(**TCFG),
                 str(tmp_path_factory.mktemp("tp_one")))
    one = ranks.explicit_steps(tr, tbatches, draws)
    return {"jax_fwd": jax_fwd, "jax_loss": jax_loss, "ranks": got, "one_fwd": one_fwd,
            "one": one}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_tp_forward_matches_jax_and_one_process(tp_runs, shape):
    world = shape[0] * shape[1]
    outs = [r["forward"][shape] for r in tp_runs["ranks"][world]]
    y = outs[0]["y"]
    assert y.shape == (4, 8, 8, 4) and all(o["y"] is None for o in outs[1:])
    _close(y.numpy(), tp_runs["one_fwd"].numpy(), rtol=1e-5, atol=1e-6)
    _close(y.numpy(), tp_runs["jax_fwd"][shape], rtol=RTOL, atol=ATOL)
    split = outs[0]["split"]
    if shape[1] == 4:  # 2 heads: the attention sites run whole, the FFs split
        assert split and all(".ff." in n for n in split)
    else:
        assert any(".attn1." in n for n in split) and any(".attn2." in n for n in split)
        assert any("lora_up" in n for n in split)  # the control's LoRA'd sites
    assert not any(n.endswith("to_out.bias") or n.endswith("ff.out.bias") for n in split)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_tp_ddim_with_hoisted_kv_equals_in_loop(tp_runs, shape):
    outs = [r["forward"][shape]["ddim"] for r in tp_runs["ranks"][shape[0] * shape[1]]]
    on, off = outs[0][True], outs[0][False]
    assert on.shape == (4, 8, 8, 4) and torch.isfinite(on).all()
    assert torch.equal(on, off)
    assert all(o[True] is None and o[False] is None for o in outs[1:])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_train_step_matches_jax_and_one_process(tp_runs, world):
    """Two steps over the (world / 2, 2) mesh on JAX's draws."""
    got = [r["explicit"] for r in tp_runs["ranks"][world]]
    assert [r["mesh"] for r in tp_runs["ranks"][world]] == [
        ((world // 2, 2), r // 2, r % 2) for r in range(world)]
    _close(got[0][0]["loss"], tp_runs["jax_loss"], rtol=2e-4)
    for k, want in enumerate(tp_runs["one"]):
        scale = max(g.abs().max().item() for g in want["grads"].values())
        for steps in got:
            _close(steps[k]["loss"], want["loss"], **SELF)
            _close(steps[k]["grad_norm"], want["grad_norm"], **SELF)
            for name, p in want["params"].items():
                _close(steps[k]["params"][name].numpy(), p.numpy(), err_msg=name, **SELF)
                _close(steps[k]["grads"][name].numpy(), want["grads"][name].numpy(),
                       rtol=1e-5, atol=1e-5 * scale, err_msg=name)
        for steps in got[1:]:
            for name, p in got[0][k]["params"].items():
                assert torch.equal(p, steps[k]["params"][name]), name


def test_local_range_and_context():
    """The site rule without a group: whole heads a rank or the whole site,
    and nothing changes outside the context."""
    assert tp.active() is None and tp.local_range(8) is None
    with tp.tensor_parallel(pmesh.Mesh(1, 4, 1)) as ctx:
        assert tp.active() is ctx
        assert tp.local_range(2) is None  # 2 heads over 4: replicated
        assert tp.local_range(8) == (2, 4)
        with pytest.raises(RuntimeError, match="process group"):
            tp.copy_to_model(torch.ones(2))
    with tp.tensor_parallel(pmesh.Mesh(2, 1, 3)):
        assert tp.local_range(8) is None  # tp 1: every site whole
    assert tp.active() is None


def test_sample_cli_tp_equals_one_rank(tmp_path):
    """``sample.py --tp 2`` on 2 ranks (batch 2, DDIM) writes the one-rank
    run's PNGs."""
    flags = ranks.write_sample_files(str(tmp_path))
    common = [*flags, "--n_samples", "2", "--bs", "2", "--ddim_steps", "3", "--seed", "5"]
    one = str(tmp_path / "one")
    sample_cli.main([*common, "--save_dir", one])
    two = str(tmp_path / "two")
    ranks.run_ranks(ranks.sample_cli_rank, 2, str(tmp_path / "ranks"),
                    {"argv": [*common, "--save_dir", two, "--tp", "2"]})
    want, got = ranks.read_samples(one), ranks.read_samples(two)
    assert got.shape == want.shape == (2, 16, 16, 3) and want.std() > 0
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
