"""Several ranks of the PyTorch port on the CPU, for the parallel tests:
spawned processes over gloo with a ``file://`` store under the test's own
directory (no port is shared between test processes), one torch thread a
rank, and a join timeout so that a hung rank fails its test instead of the
suite's clock. Nothing here imports JAX: the spawned ranks import this
module and the port only.

A rank body is a module-level function ``body(rank, root, spec)`` that
reads ``root/inputs.pt`` (written by the test) and writes
``root/out_<rank>.pt``; :func:`run_ranks` returns those outputs in rank
order, or fails with the first rank's traceback."""

import contextlib
import multiprocessing
import os
import time
import traceback

import torch

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.parallel import mesh as pmesh
from ctrlora_tpu_torch.parallel import tp
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.training.trainer import Trainer

JOIN_TIMEOUT_S = 120


def _entry(body, rank, world, root, spec):
    torch.set_num_threads(1)
    try:
        pmesh.init_distributed(init_method=f"file://{os.path.join(root, 'store')}", rank=rank,
                               world_size=world, device="cpu", timeout_s=JOIN_TIMEOUT_S)
        torch.save(body(rank, root, spec), os.path.join(root, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if pmesh.in_group():
            torch.distributed.destroy_process_group()


def run_ranks(body, world: int, root: str, spec=None, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run `body` on `world` spawned gloo ranks; their outputs in rank order."""
    os.makedirs(root, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(body, r, world, root, spec), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    # a rank that fails leaves the others waiting at a collective: stop all
    while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
           and not any(p.exitcode for p in procs)):
        time.sleep(0.05)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(root, f"err_{r}.txt")).read() for r in range(world)
              if os.path.exists(os.path.join(root, f"err_{r}.txt"))]
    if errors:
        raise AssertionError(f"a rank failed:\n{errors[0]}")
    if hung:
        raise AssertionError(f"ranks {hung} did not finish within {timeout} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"ranks exited with codes {bad}")
    return [torch.load(os.path.join(root, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# what the tests share with their ranks
# ---------------------------------------------------------------------------

def train_pipeline(states) -> CtrLoraPipeline:
    """The tiny one-LoRA training pipeline with the given port state dicts."""
    pipe = CtrLoraPipeline(configs.tiny_test_config(n_loras=1), "cpu", fuse_lora=False)
    pipe.load_state_dicts(*states)
    return pipe


def trainable_snapshot(trainer: Trainer) -> dict:
    return {k: p.detach().clone() for k, p in trainer.state.trainable.items()}


def explicit_steps(trainer: Trainer, batches, draws) -> list:
    """Steps on host-global batches with the global batch's draws given
    (each rank takes its rows of both); per step: loss, grad_norm and the
    trainable parameters after it."""
    out = []
    for batch, d in zip(batches, draws):
        local = batch if trainer.mesh is None else pmesh.shard_batch(trainer.mesh, batch)
        with trainer._tp_scope():
            trainer.state, m = trainer.step_fn(trainer.state, local, None, draws=d)
        out.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                    "params": trainable_snapshot(trainer),
                    "grads": {k: p.grad.clone() for k, p in trainer.state.trainable.items()
                              if p.grad is not None}})
    return out


def fit_steps(trainer: Trainer, batches) -> list:
    """``Trainer.fit`` over host-global batches (the step's own draws from
    its generator); per step: loss, grad_norm and the parameters."""
    out = []
    step_fn = trainer.step_fn

    def spy(*a, **kw):
        state, m = step_fn(*a, **kw)
        out.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                    "params": trainable_snapshot(trainer)})
        return state, m

    trainer.step_fn = spy
    trainer.fit(batches, max_steps=len(batches))
    trainer.step_fn = step_fn
    return out


def forward(pipe, inp):
    """One controlled UNet evaluation of the test's inputs."""
    with torch.no_grad():
        return pipe.apply_model(inp["x"], inp["t"], inp["ctx"],
                                [Conditioning(inp["hz"], lora_idx=0)])


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def training_rank(rank, root, spec):
    """Over a (world / tp, tp) mesh: two steps on the given draws, and (tp
    1) two ``Trainer.fit`` steps, replicated and with the optimizer state
    sharded, each checkpointed at step 2. Rank 1 starts from perturbed
    weights: the trainer's replicate must give it rank 0's."""
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    tcfg = inp["tcfg"]

    def trainer(name, **kw):
        pipe = train_pipeline(inp["states"])
        if rank:
            with torch.no_grad():
                for m in pipe.modules():
                    for p in m.parameters():
                        p.add_(0.01)
        return Trainer(pipe, configs.TrainConfig(**{**tcfg, **kw}),
                       os.path.join(root, name), tp=spec["tp"])

    out = {}
    tr = trainer("explicit")
    out["mesh"] = (tr.mesh.shape, tr.mesh.data_index, tr.mesh.model_index)
    out["explicit"] = explicit_steps(tr, inp["batches"], inp["draws"])
    if spec.get("fit"):
        for name, shard in (("fit", False), ("fit_shard", True)):
            tr = trainer(name, shard_opt_state=shard, ckpt_every=2)
            out[name] = fit_steps(tr, inp["batches"])
            out[f"{name}_optimizer"] = type(tr.state.optimizer).__name__
            if shard:
                out["moment_share"] = tr.state.optimizer.moment_share()
    return out


@contextlib.contextmanager
def kv_in_loop(pipe: CtrLoraPipeline):
    """The samplers' cross-attention k|v products back inside the step loop
    (the pipeline offers no hoisted tables), to hold a hoisted run against."""
    pipe.xattn_kv_tables = lambda context, conds=(): None
    try:
        yield
    finally:
        del pipe.xattn_kv_tables


def tp_ddim(pipe, mesh, inp) -> dict:
    """A 3-step CFG DDIM of the test's batch through ``tp.tp_sample`` over
    `mesh`, with the cross-attention k|v hoisted (as the samplers make it)
    and in the loop: {hoist: latents on rank 0 (None elsewhere)}."""
    from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample

    def run(ctx, unc, hz, x_T, hoist=True):
        with contextlib.nullcontext() if hoist else kv_in_loop(pipe):
            return ddim_sample(pipe, ctx, unc, [Conditioning(hz, lora_idx=0)],
                               tuple(x_T.shape), DDIMConfig(steps=3), x_T=x_T)

    call = tp.tp_sample(run, mesh)
    args = (inp["ctx"], torch.zeros_like(inp["ctx"]), inp["hz"], inp["x"])
    return {hoist: call(*args, hoist=hoist) for hoist in (False, True)}


def forward_rank(rank, root, spec):
    """apply_model of the test's batch under tensor_parallel over each of
    `spec['meshes']`, gathered on rank 0 (None elsewhere), with the number
    of split parameters each rank recorded; and ``tp_ddim`` on each mesh."""
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    pipe = train_pipeline(inp["states"])
    out = {}
    for dp, tpn in spec["meshes"]:
        mesh = pmesh.create_mesh_2d(dp, tpn)
        rows = pmesh.shard_batch(mesh, {k: inp["fwd"][k] for k in ("x", "t", "ctx", "hz")})
        with tp.tensor_parallel(mesh) as ctx:
            y = forward(pipe, rows)
        names = {id(p): f"{i}.{n}" for i, m in enumerate(pipe.modules())
                 for n, p in m.named_parameters()}
        out[(dp, tpn)] = {"y": pmesh.gather_rows(mesh, y),
                          "split": sorted(names[i] for i in ctx.split_ids),
                          "ddim": tp_ddim(pipe, mesh, inp["fwd"])}
    return out


def sample_cli_rank(rank, root, spec):
    """The sample CLI's main on this rank with the test's flags."""
    from ctrlora_tpu_torch.scripts import sample

    sample.main(spec["argv"])
    return {}


def mesh_rank(rank, root, spec):
    """The mesh layout, the groups' sums, shard_batch and the mesh errors."""
    out = {}
    mesh = pmesh.create_mesh_2d(2, 2)
    out["layout"] = (mesh.shape, mesh.data_index, mesh.model_index, mesh.data_ranks(),
                     mesh.model_ranks())
    sums = {}
    for axis, group in (("data", mesh.data_group), ("model", mesh.model_group)):
        t = torch.tensor([float(rank)])
        pmesh.all_reduce_(t, group)
        sums[axis] = t.item()
    bf = torch.tensor([rank + 0.5], dtype=torch.bfloat16)
    pmesh.all_reduce_(bf, mesh.model_group)
    sums["model_bf16"] = (bf.dtype, bf.item())
    out["sums"] = sums
    batch = {"a": torch.arange(8).reshape(8, 1), "b": torch.arange(16).reshape(2, 8)}
    out["rows"] = pmesh.shard_batch(mesh, batch["a"])[:, 0].tolist()
    out["rows_axis1"] = pmesh.shard_batch(mesh, batch["b"], axis=1)[0].tolist()
    errors = []
    for fn in (lambda: pmesh.create_mesh_2d(4, 2), lambda: pmesh.create_mesh_2d(1, 2),
               lambda: pmesh.shard_batch(mesh, torch.zeros(3, 2))):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    flat = pmesh.create_mesh()
    out["flat"] = (flat.shape, flat.data_ranks())
    t = torch.full((3,), float(rank))
    pmesh.replicate(flat, [t])
    out["replicated"] = t.tolist()
    out["partition"] = pmesh.partition_parameters([5, 1, 4, 4, 2], 2)
    return out


def tp_rank(rank, root, spec):
    """``training_rank`` and ``forward_rank`` in one spawn."""
    return {**training_rank(rank, root, spec), "forward": forward_rank(rank, root, spec)}


# ---------------------------------------------------------------------------
# the tests' own inputs (the JAX side runs in the test process only)
# ---------------------------------------------------------------------------

def random_jax_params(shapes, seed):
    """Seeded numpy weights for a JAX parameter tree of ShapeDtypeStructs, as
    tests/test_torch_training.py's ``_random_params``: lecun-normal kernels,
    N(0, 1/r) lora_down, N(0, 0.05) for lora_up and the layers a fresh
    model zero-initialises."""
    import math

    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    zero_init = ("conv_out", "out_conv", "proj_out", "zero_", "lora_up")

    def f(path, s):
        ks, leaf = jax.tree_util.keystr(path), path[-1].key
        if leaf == "scale":
            v = 1 + rng.normal(0, 0.1, s.shape)
        elif leaf == "lora_down":
            v = rng.normal(0, 1 / s.shape[-1], s.shape)
        elif leaf == "lora_up" or (leaf == "kernel" and any(z in ks for z in zero_init)):
            v = rng.normal(0, 0.05, s.shape)
        elif leaf == "kernel":
            v = rng.normal(0, math.prod(s.shape[:-1]) ** -0.5, s.shape)
        else:
            v = rng.normal(0, 0.02, s.shape)
        return jnp.asarray(v, s.dtype)

    return jax.tree_util.tree_map_with_path(f, shapes)


def jax_side(batch: int = 4, seed: int = 20):
    """The tiny one-LoRA JAX pipeline with seeded weights, and those
    weights as the port's state dicts."""
    import functools

    import jax

    from ctrlora_tpu.configs import tiny_test_config
    from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
    from ctrlora_tpu_torch import convert

    jpipe = JaxPipeline(tiny_test_config(n_loras=1))
    shapes = jax.eval_shape(functools.partial(jpipe.init, image_size=8), jax.random.PRNGKey(0))
    params = type(shapes)(*(random_jax_params(p, seed + i) for i, p in enumerate(shapes)))
    states = tuple(convert.params_from_jax(p) for p in params)
    return jpipe, params, states


def jax_draws(key, b: int, lat: int = 8) -> dict:
    """The draws the JAX ``loss_for_batch`` makes from `key` (its splits)
    for a latent-hint batch of b, as torch tensors."""
    import jax
    import numpy as np

    rest, z_rng, t_rng = jax.random.split(key, 3)
    _, h_rng = jax.random.split(rest)
    t_rng, n_rng = jax.random.split(t_rng)
    shape = (b, lat, lat, 4)
    d = {"z_eps": jax.random.normal(z_rng, shape), "hint_eps": jax.random.normal(h_rng, shape),
         "t": jax.random.randint(t_rng, (b,), 0, 1000), "noise": jax.random.normal(n_rng, shape)}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def numpy_batches(n: int, b: int = 4, seed: int = 0) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"jpg": rng.uniform(-1, 1, size=(b, 16, 16, 3)).astype(np.float32),
             "hint": rng.uniform(0, 1, size=(b, 16, 16, 3)).astype(np.float32),
             "token_ids": rng.integers(1, 128, size=(b, 16)).astype(np.int32)}
            for _ in range(n)]


def write_sample_files(root: str, seed: int = 3) -> dict:
    """A CustomDataset of four items (16^2) and seeded SD and Base
    ControlNet files of the tiny config, for the sample CLI; returns the
    CLI's file flags."""
    import json

    import cv2
    import numpy as np

    from ctrlora_tpu_torch.utils import ckpt_torch as bridge

    rng = np.random.default_rng(seed)
    data = os.path.join(root, "data")
    for sub in ("source", "target"):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
    with open(os.path.join(data, "prompt.json"), "w") as f:
        for i in range(4):
            cv2.imwrite(os.path.join(data, "source", f"{i}.png"),
                        rng.integers(0, 256, (16, 16, 3), np.uint8))
            cv2.imwrite(os.path.join(data, "target", f"{i}.jpg"),
                        rng.integers(0, 256, (16, 16, 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.jpg",
                                "prompt": f"a tiny picture number {i}"}) + "\n")
    cfg = configs.tiny_test_config()
    src = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in ((n, p) for m in src.modules() for n, p in m.named_parameters()):
            std = 0.05 if p.ndim < 2 or "zero_" in name or "out" in name else p[0].numel() ** -0.5
            base = 1.0 if p.ndim == 1 and "norm" in name and name.endswith("weight") else 0.0
            p.copy_(base + torch.randn(p.shape, generator=gen) * std)
    sd = {}
    for prefix, module, entries in (
            ("model.diffusion_model.", src.unet, bridge.unet_entries(cfg.unet)),
            ("first_stage_model.", src.vae, bridge.vae_entries(cfg.vae)),
            ("cond_stage_model.transformer.text_model.", src.clip,
             bridge.clip_entries(cfg.clip))):
        sd.update({prefix + k: torch.from_numpy(v)
                   for k, v in bridge.export_tree(module.state_dict(), entries).items()})
    torch.save({"state_dict": sd}, os.path.join(root, "sd.ckpt"))
    torch.save({k: torch.from_numpy(v) for k, v in
                bridge.export_control_base(src.control.state_dict(), cfg.control).items()},
               os.path.join(root, "basecn.ckpt"))
    return ["--config", "tiny", "--device", "cpu", "--dataroot", data, "--resolution", "16",
            "--sd_ckpt", os.path.join(root, "sd.ckpt"),
            "--cn_ckpt", os.path.join(root, "basecn.ckpt")]


def read_samples(out: str) -> "np.ndarray":
    import cv2
    import numpy as np

    names = sorted(os.listdir(os.path.join(out, "sample")))
    return np.stack([cv2.imread(os.path.join(out, "sample", n)) for n in names])
