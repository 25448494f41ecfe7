"""Data parallelism and optimizer-state sharding of the PyTorch port
(``ctrlora_tpu_torch/parallel/mesh.py``) on gloo ranks on the CPU, held
against the port's one-process run on the same global batch and against
the JAX package's step on ``create_mesh(2)``.

The ranks are spawned processes (tests/torch_ranks.py): a ``file://``
store under the test's directory, one torch thread each, joined within
120 s. JAX is imported in the test process only. Tolerances: the ranks
against one process rtol 1e-5 / atol 1e-7 (the same arithmetic but for
the order of a two-term gradient sum); against JAX rtol 2e-3 / atol 2e-4
(tests/test_torch_training.py); the sharded optimizer against the
replicated one rtol 1e-4 (tests/test_pipeline.py's sharding test); the
sample CLI's PNGs within one uint8 level of the one-rank run's.

The steps take lr 1e-6. AdamW's second update, m / sqrt(v), is a ratio of
an element's gradients, whatever their size: where an element's gradient
is a near-cancelling sum over the batch, the summation order's rounding
is a large part of it, and moves the update by up to a few percent of lr
(2.3e-6 at lr 1e-4, beyond atol 1e-7). So the gradients are compared
directly, and at lr 1e-6 that rounding stays below atol.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.parallel import mesh as pmesh
from ctrlora_tpu_torch.scripts import sample as sample_cli
from ctrlora_tpu_torch.training.trainer import Trainer
from tests import torch_ranks as ranks

RTOL, ATOL = 2e-3, 2e-4
SELF = dict(rtol=1e-5, atol=1e-7)
TCFG = dict(trainable="lora", learning_rate=1e-6, log_every=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **tol)


def _params_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Two global batches of 4 through: the JAX step on create_mesh(2); the
    port on one process; the port on 2 gloo ranks (on JAX's draws, then
    through Trainer.fit, replicated and with the optimizer state sharded)."""
    import jax

    from ctrlora_tpu.configs import TrainConfig as JaxTrainConfig
    from ctrlora_tpu.parallel.mesh import create_mesh, replicate, shard_batch
    from ctrlora_tpu.training.step import make_train_step
    from ctrlora_tpu.training.train_state import create_train_state
    from ctrlora_tpu_torch import convert

    root = str(tmp_path_factory.mktemp("dp"))
    jpipe, params, states = ranks.jax_side()
    batches = ranks.numpy_batches(2)
    key = jax.random.PRNGKey(5)
    draws = [ranks.jax_draws(jax.random.fold_in(key, k), 4) for k in range(2)]
    jcfg = JaxTrainConfig(**{k: v for k, v in TCFG.items() if k != "log_every"})
    state, tx, _ = create_train_state(params, jcfg)
    step = make_train_step(jpipe, tx, jcfg, donate=False)
    mesh = create_mesh(2)
    jax_steps = []
    with mesh:
        state = replicate(mesh, state)
        for b in batches:
            state, m = step(state, shard_batch(mesh, b), key)
            jax_steps.append({"loss": float(m["loss"]),
                              "params": convert.params_from_jax(state.params.control)})

    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    torch.save({"states": states, "batches": tbatches, "draws": draws, "tcfg": TCFG},
               os.path.join(root, "inputs.pt"))
    got = ranks.run_ranks(ranks.training_rank, 2, root, {"tp": 1, "fit": True})

    one = {}
    for name, kw in (("explicit", {}), ("fit", {}), ("fit_shard", {"shard_opt_state": True})):
        tr = Trainer(ranks.train_pipeline(states),
                     configs.TrainConfig(**TCFG, ckpt_every=2, **kw),
                     os.path.join(root, f"one_{name}"))
        one[name] = (ranks.explicit_steps(tr, tbatches, draws) if name == "explicit"
                     else ranks.fit_steps(tr, tbatches))
        one[f"{name}_optimizer"] = type(tr.state.optimizer).__name__
    return {"jax": jax_steps, "ranks": got, "one": one, "root": root, "states": states,
            "batches": tbatches}


def test_init_distributed_unconfigured_returns_false(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert pmesh.init_distributed() is False
    assert not pmesh.in_group() and pmesh.world_size() == 1 and pmesh.process_index() == 0
    mesh = pmesh.create_mesh()
    assert mesh.shape == (1, 1) and not mesh.distributed
    with pytest.raises(ValueError, match=r"mesh 1x2 needs 2 devices, have 1"):
        pmesh.create_mesh_2d(1, 2)


def test_init_distributed_unreachable_raises(monkeypatch):
    """Configured (torchrun's variables) but nobody listens: RuntimeError
    within seconds, never a lone rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not form"):
        pmesh.init_distributed(device="cpu", timeout_s=2)
    assert time.monotonic() - t0 < 60
    assert not pmesh.in_group()
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.init_distributed()


def test_mesh_layout_groups_and_batch_rows(tmp_path):
    """A 2x2 mesh on 4 ranks: the model axis minor (rank = d*tp + m), the
    groups' sums, shard_batch's rows and its error, JAX's mesh wording."""
    got = ranks.run_ranks(ranks.mesh_rank, 4, str(tmp_path))
    for r, out in enumerate(got):
        d, m = divmod(r, 2)
        assert out["layout"] == ((2, 2), d, m, [m, 2 + m], [2 * d, 2 * d + 1])
        assert out["sums"]["data"] == float(m + 2 + m)  # ranks m and 2+m
        assert out["sums"]["model"] == float(4 * d + 1)  # ranks 2d and 2d+1
        assert out["sums"]["model_bf16"] == (torch.bfloat16, 4 * d + 2.0)
        assert out["rows"] == list(range(4 * d, 4 * d + 4))
        assert out["rows_axis1"] == list(range(4 * d, 4 * d + 4))
        assert out["errors"][:2] == ["mesh 4x2 needs 8 devices, have 4",
                                     "mesh 1x2 needs 2 devices, have 4"]
        assert "does not divide over the 2 data ranks" in out["errors"][2]
        assert out["flat"] == ((4, 1), [0, 1, 2, 3])
        assert out["replicated"] == [0.0, 0.0, 0.0]
        assert out["partition"] == [0, 0, 1, 1, 0]  # 5, 4 | 4, then 2 and 1 to the lighter


def test_dp_steps_match_one_process_and_jax(dp_runs):
    """Two DP steps on JAX's draws: each rank's loss, grad norm and
    trainable parameters equal the one-process run's, and JAX's mesh step's
    loss and parameters; the ranks' parameters are bit-identical."""
    r0, r1 = (r["explicit"] for r in dp_runs["ranks"])
    for k, want in enumerate(dp_runs["one"]["explicit"]):
        for got in (r0[k], r1[k]):
            _close(got["loss"], want["loss"], **SELF)
            _close(got["grad_norm"], want["grad_norm"], **SELF)
            _params_close(got["params"], want["params"], **SELF)
            scale = max(g.abs().max().item() for g in want["grads"].values())
            _params_close(got["grads"], want["grads"], rtol=1e-5, atol=1e-5 * scale)
        for name, p in r0[k]["params"].items():
            assert torch.equal(p, r1[k]["params"][name]), name
        jax_k = dp_runs["jax"][k]
        _close(r0[k]["loss"], jax_k["loss"], rtol=RTOL, atol=ATOL)
        for name, p in r0[k]["params"].items():
            _close(p.numpy(), jax_k["params"][name.split(".", 1)[1]].numpy(), rtol=RTOL,
                   atol=ATOL, err_msg=name)
    assert [r["mesh"] for r in dp_runs["ranks"]] == [((2, 1), 0, 0), ((2, 1), 1, 0)]
    assert r0[1]["loss"] != r0[0]["loss"]


def test_dp_fit_matches_one_process(dp_runs):
    """Trainer.fit on 2 ranks, each drawing the global batch's draws from
    the step's generator and keeping its rows, equals the one-process fit."""
    r0, r1 = (r["fit"] for r in dp_runs["ranks"])
    for k, want in enumerate(dp_runs["one"]["fit"]):
        for got in (r0[k], r1[k]):
            _close(got["loss"], want["loss"], **SELF)
            _close(got["grad_norm"], want["grad_norm"], **SELF)
            _params_close(got["params"], want["params"], **SELF)
        for name, p in r0[k]["params"].items():
            assert torch.equal(p, r1[k]["params"][name]), name
    assert dp_runs["ranks"][0]["fit_optimizer"] == "AdamW"


def test_shard_opt_state_matches_replicated(dp_runs):
    """The sharded AdamW state gives the replicated trajectory; each rank
    keeps about half of the moment elements; at one process the flag keeps
    the state whole."""
    for r in dp_runs["ranks"]:
        assert r["fit_shard_optimizer"] == "ShardedOptimizer"
        for got, want in zip(r["fit_shard"], r["fit"]):
            _close(got["loss"], want["loss"], rtol=1e-4)
            _close(got["grad_norm"], want["grad_norm"], rtol=1e-4)
            _params_close(got["params"], want["params"], rtol=1e-4, atol=1e-7)
    shares = [r["moment_share"] for r in dp_runs["ranks"]]
    assert abs(sum(shares) - 1) < 1e-9 and max(shares) < 0.55
    a, b = (r["fit_shard"][-1]["params"] for r in dp_runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert dp_runs["one"]["fit_shard_optimizer"] == "AdamW"


def test_sharded_checkpoint_restores_at_world_one(dp_runs, tmp_path):
    """The checkpoint the sharded 2-rank run wrote at step 2 (rank 0 only,
    the AdamW state consolidated) restores into a one-process trainer,
    whose next step equals the next step from the replicated run's
    checkpoint."""
    root = dp_runs["root"]
    assert os.path.exists(os.path.join(root, "fit_shard", "metrics.jsonl"))
    nxt = []
    for name in ("fit", "fit_shard"):
        tr = Trainer(ranks.train_pipeline(dp_runs["states"]),
                     configs.TrainConfig(**TCFG, shard_opt_state=True),
                     str(tmp_path / name))
        tr.restore(os.path.join(root, name, "ckpt_00000002.pt"))
        assert tr.state.step == 2
        _params_close(ranks.trainable_snapshot(tr), dp_runs["ranks"][0][name][-1]["params"],
                      rtol=0, atol=0)
        nxt.append(ranks.fit_steps(tr, dp_runs["batches"][:1] * 3)[-1])
    _close(nxt[1]["loss"], nxt[0]["loss"], rtol=1e-4)
    _params_close(nxt[1]["params"], nxt[0]["params"], rtol=1e-4, atol=1e-7)


def test_sample_cli_dp_equals_one_rank(tmp_path):
    """``sample.py --dp`` on 2 ranks (batch 2, DDIM at eta 0.5 so that the
    eta draws are split too) writes the one-rank run's PNGs."""
    flags = ranks.write_sample_files(str(tmp_path))
    common = [*flags, "--n_samples", "4", "--bs", "2", "--ddim_steps", "3", "--eta", "0.5",
              "--seed", "7"]
    one = str(tmp_path / "one")
    sample_cli.main([*common, "--save_dir", one])
    two = str(tmp_path / "two")
    ranks.run_ranks(ranks.sample_cli_rank, 2, str(tmp_path / "ranks"),
                    {"argv": [*common, "--save_dir", two, "--dp"]})
    want, got = ranks.read_samples(one), ranks.read_samples(two)
    assert got.shape == want.shape == (4, 16, 16, 3) and want.std() > 0
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with open(os.path.join(one, "prompt.txt")) as a, open(os.path.join(two, "prompt.txt")) as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="--tp 2 must divide the 1 devices"):
        sample_cli.main([*common, "--save_dir", str(tmp_path / "x"), "--tp", "2"])
