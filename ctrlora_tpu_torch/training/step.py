"""The training step: frozen-tower encodes, eps-MSE, AdamW on the trainable
set (counterpart of ``ctrlora_tpu/training/step.py``).

Batches are dicts of tensors on the pipeline's device:
  jpg       [B, H, W, 3] float32 in [-1, 1]  (target image)
  hint      [B, H, W, 3] float32 in [0, 1]   (condition; the latent-hint
            branch feeds the [0, 1] hint to the VAE, as the reference does;
            an image-hint branch takes the pixels as they are, at 8x the
            latent's size)
  token_ids [B, 77] int                      (tokenized prompt)
  task_idx  optional int or [B] int          (LoRA index; batches are single-task)
Latent-cached batches carry jpg_moments / hint_moments (posterior mean |
logvar) instead of jpg / hint (latent-hint models only). With grad_accum >
1 every tensor has a leading [accum] axis of micro-batches
(``split_micro_batches`` makes it from a loader's batch).

The frozen towers (VAE, CLIP) run under ``torch.no_grad``; the UNet's
parameters are frozen by the trainable mask (sd_locked), so autograd
computes activation gradients through its decoder but no weight gradient
of a frozen parameter (see ``trainable_grad_norm``).

On a CUDA device a step issues the same ~10k kernels on the same shapes
every time, and the host's issue of them paces it. So the step keeps the
forward and backward of one batch signature (``graph_signature``) as a
CUDA graph: the first step of a signature runs eager (it also warms up the
kernels, cuBLAS and cuDNN), the second captures the graph, in place of the
one kept before, and replays it, and every later one copies its batch and
draws into the graph's buffers and replays it. The gradient norm, AdamW
and the EMA stay eager after the replay. Off CUDA, over a distributed mesh, under grad_accum > 1 and where
the step draws from torch's global generator, the step runs eager
(``forward_backward``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ctrlora_tpu_torch.configs import TrainConfig
from ctrlora_tpu_torch.ops import kernel_flags
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
from ctrlora_tpu_torch.training.ema import ema_update
from ctrlora_tpu_torch.training.losses import p_losses
from ctrlora_tpu_torch.training.train_state import TrainState
from ctrlora_tpu_torch.utils import trace

Batch = Mapping[str, torch.Tensor]


def _latent(pipe: CtrLoraPipeline, batch: Batch, key: str, generator, eps):
    if f"{key}_moments" in batch:  # latent cache: same sampling, no encode
        return pipe.first_stage_from_moments(batch[f"{key}_moments"], generator, eps)
    return pipe.encode_first_stage(batch[key], generator, eps)


def loss_for_batch(pipe: CtrLoraPipeline, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss of one batch. The random draws (posterior noise of jpg and, for
    a latent-hint model, of the hint; t; the diffusion noise) come from
    `generator` in that order, or from `draws` ('z_eps', 'hint_eps', 't',
    'noise') where given, so two runs can share them exactly. An
    image-hint model takes the pixel hint as its condition: no encode, no
    'hint_eps'."""
    draws = draws or {}
    latent_hint = pipe.cfg.control.hint_mode == "latent"
    if "hint" not in batch and not latent_hint:
        raise ValueError("latent-cached batches (hint_moments) require hint_mode='latent'; "
                         "image-hint models consume raw pixels")
    with torch.no_grad():
        z = _latent(pipe, batch, "jpg", generator, draws.get("z_eps"))
        context = pipe.encode_text_tokens(batch["token_ids"])
        hint = (_latent(pipe, batch, "hint", generator, draws.get("hint_eps")) if latent_hint
                else batch["hint"])
    task_idx = batch.get("task_idx")
    if isinstance(task_idx, torch.Tensor) and task_idx.ndim > 0:
        task_idx = task_idx[0]  # batches are single-task
    conds = [Conditioning(hint, lora_idx=task_idx)]
    return p_losses(pipe, z, context, conds, t=draws.get("t"), noise=draws.get("noise"),
                    generator=generator)


def trainable_grad_norm(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    """Global L2 norm of the trainable parameters' gradients (fp32). Frozen
    parameters have no gradient: the JAX step's norm also counts the frozen
    base-ControlNet weights' gradients, which the reference never computes."""
    grads = [p.grad.float() for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def split_micro_batches(batch: Batch, accum: int) -> Dict[str, torch.Tensor]:
    """A loader's batch of accum * B examples -> [accum, B, ...] tensors:
    micro-batch i holds examples i*B .. (i+1)*B - 1."""
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}


def global_draws(pipe: CtrLoraPipeline, batch: Batch, generator: torch.Generator,
                 dp: int) -> Dict[str, torch.Tensor]:
    """The draws ``loss_for_batch`` makes from `generator`, in its order, for
    the global batch of `dp` times this batch's rows: each data rank draws
    them all and keeps its rows (``mesh.shard_batch``), so a step of an
    N-rank run draws what the one-rank step on the global batch draws."""
    dev = generator.device
    src = batch["jpg_moments" if "jpg_moments" in batch else "jpg"]
    b = src.shape[0] * dp
    if "jpg_moments" in batch:
        lat = (b, *src.shape[1:3], src.shape[3] // 2)
    else:
        f = 2 ** (len(pipe.cfg.vae.ch_mult) - 1)
        lat = (b, src.shape[1] // f, src.shape[2] // f, pipe.cfg.vae.embed_dim)
    out = {"z_eps": torch.randn(lat, generator=generator, device=dev)}
    if pipe.cfg.control.hint_mode == "latent":
        out["hint_eps"] = torch.randn(lat, generator=generator, device=dev)
    out["t"] = torch.randint(0, pipe.schedule.num_timesteps, (b,), generator=generator,
                             device=dev)
    out["noise"] = torch.randn(lat, generator=generator, device=dev)
    return out


def graph_signature(cfg: TrainConfig, device, mesh, batch: Mapping) -> Optional[tuple]:
    """The key of the CUDA graph that replays a step on `batch`: its key set,
    each tensor's shape and dtype, and an int ``task_idx`` (a tensor one is
    copied in like the rest). None where the step runs eager: off CUDA,
    over a distributed mesh (its all-reduces), under grad_accum > 1, and
    for a batch value that is neither a tensor nor an int task_idx."""
    if torch.device(device).type != "cuda" or cfg.grad_accum != 1:
        return None
    if mesh is not None and mesh.distributed:
        return None
    key = []
    for name in sorted(batch):
        value = batch[name]
        if isinstance(value, torch.Tensor):
            key.append((name, tuple(value.shape), value.dtype))
        elif name == "task_idx" and (value is None or isinstance(value, int)):
            key.append((name, value))
        else:
            return None
    return tuple(key)


def _accumulate(sums: Dict[str, torch.Tensor], metrics: Mapping[str, torch.Tensor],
                n: int) -> None:
    for k, v in metrics.items():
        sums[k] = sums.get(k, 0.0) + v / n


def forward_backward(pipe: CtrLoraPipeline, optimizer, cfg: TrainConfig, mesh, batch: Batch,
                     generator: Optional[torch.Generator] = None, draws=None
                     ) -> Dict[str, torch.Tensor]:
    """The eager forward and backward of one step (see ``make_train_step``):
    the gradients set afresh, micro-batch by micro-batch, reduced over the
    mesh; returns the loss metrics averaged over the micro-batches."""
    from ctrlora_tpu_torch.parallel import mesh as pmesh
    from ctrlora_tpu_torch.parallel import tp

    distributed = mesh is not None and mesh.distributed
    optimizer.zero_grad(set_to_none=True)
    micro = ([{k: v[i] for k, v in batch.items()} for i in range(cfg.grad_accum)]
             if cfg.grad_accum > 1 else [batch])
    if draws is None or cfg.grad_accum == 1:
        draws = [draws] * len(micro)
    elif len(draws) != len(micro):
        raise ValueError(f"{len(draws)} draws for {len(micro)} micro-batches")
    if distributed and generator is None and any(d is None for d in draws):
        raise ValueError("a step over a mesh needs a generator or draws: every rank "
                         "draws the global batch's")
    sums: Dict[str, torch.Tensor] = {}
    for mb, mb_draws in zip(micro, draws):
        if distributed:
            mb_draws = pmesh.shard_batch(mesh, dict(
                mb_draws if mb_draws is not None else
                global_draws(pipe, mb, generator, mesh.dp)))
        with trace.span("train.forward"):
            loss, metrics = loss_for_batch(pipe, mb, generator, mb_draws)
        with trace.span("train.backward"):
            (loss / len(micro)).backward()
        _accumulate(sums, metrics, len(micro))
    if distributed:
        params = optimizer.param_groups[0]["params"]
        tp.reduce_split_grads(params)
        pmesh.all_reduce_tensors_([p.grad for p in params if p.grad is not None],
                                  mesh.data_group, divide=mesh.dp)
        names = list(sums)
        means = torch.stack([sums[k].float() for k in names])
        pmesh.all_reduce_tensors_([means], mesh.data_group, divide=mesh.dp)
        sums = dict(zip(names, means.unbind()))
    return sums


class _StepGraph:
    """One batch signature's forward and backward, captured as a CUDA graph
    over buffers that each replay's batch and draws are copied into."""

    def __init__(self, key: tuple, pipe: CtrLoraPipeline, params: Sequence[torch.Tensor],
                 batch: Batch, draws: Mapping[str, torch.Tensor]):
        self.key, dev = key, pipe.device
        static = lambda v: torch.empty_like(v, device=dev).copy_(v)
        self.batch = {k: static(v) if isinstance(v, torch.Tensor) else v
                      for k, v in batch.items()}
        self.draws = {k: static(v) for k, v in draws.items()}
        for p in params:
            p.grad = None  # the graph writes each gradient afresh
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            loss, metrics = loss_for_batch(pipe, self.batch, None, self.draws)
            loss.backward()
            self.sums: Dict[str, torch.Tensor] = {}
            _accumulate(self.sums, metrics, 1)
        self.grads = [p.grad for p in params]

    def replay(self, params: Sequence[torch.Tensor], batch: Batch,
               draws: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for k, buf in self.batch.items():
            if isinstance(buf, torch.Tensor):
                buf.copy_(batch[k])
        for k, buf in self.draws.items():
            buf.copy_(draws[k])
        with trace.span("train.graph.replay"):
            self.graph.replay()
        for p, g in zip(params, self.grads):
            p.grad = g
        trace.count("train.graph.replays")
        # copies: the next replay overwrites the graph's own
        return {k: v.clone() for k, v in self.sums.items()}


def make_train_step(pipe: CtrLoraPipeline, optimizer, cfg: TrainConfig,
                    mesh=None) -> Callable:
    """Returns step(state, batch, generator, draws=None) -> (state, metrics):
    gradients of the batch loss (micro-batch gradients averaged under
    grad_accum, micro-batch i drawing from `generator` after micro-batch
    i - 1), their global norm, one AdamW step, then the EMA update of
    ``state.ema`` when ``cfg.use_ema``. `draws` (see ``loss_for_batch``)
    replace the generator's draws: one dict, or under grad_accum a
    sequence of one dict per micro-batch.

    Over a `mesh` (``parallel.mesh``) `batch` holds this rank's rows (of
    each micro-batch), and `draws` are the global batch's (each rank
    takes its rows; from `generator`, each rank draws the global batch's,
    :func:`global_draws`). After the last micro-batch, and not before
    (DDP's no_sync), the split sites' gradients are summed over the model
    group (``parallel.tp``), then every trainable gradient is averaged
    over the data group in one bucketed all-reduce (a sum divided by dp),
    and the loss metrics with them; ``grad_norm`` is taken after that.

    Where ``graph_signature`` gives a key and the step has all its draws
    (given whole, or from `generator` by :func:`global_draws`, which draws
    what ``loss_for_batch`` would), the forward and backward run as the
    key's CUDA graph from the key's second step in a row on (the module
    docstring); the returned metrics are the same, and each trainable
    ``grad`` is the graph's gradient after it. The counters
    ``train.graph.captures``, ``train.graph.replays`` and
    ``train.graph.eager`` (eager steps) count the steps
    (``utils.trace.summary``)."""
    params: List[torch.Tensor] = [p for group in optimizer.param_groups
                                  for p in group["params"]]
    graph: Optional[_StepGraph] = None
    eager_key: Optional[tuple] = None  # the key of the last eager step

    def graph_key(batch, generator, draws):
        """(the step's graph key, or None where it runs eager; its draws).
        The key holds the kernel flags: they switch kernels between two
        steps (``kernel_flags.override``), and a graph replays the kernels
        it captured."""
        sig = graph_signature(cfg, pipe.device, mesh, batch)
        names = ("z_eps", "hint_eps", "t", "noise")
        if pipe.cfg.control.hint_mode != "latent":
            names = ("z_eps", "t", "noise")
        if sig is None or (draws is None and generator is None) or (
                draws is not None and any(k not in draws for k in names)):
            return None, draws
        draws = {k: draws[k] for k in names} if draws is not None else \
            global_draws(pipe, batch, generator, 1)
        drawn = tuple((k, tuple(v.shape), v.dtype) for k, v in draws.items())
        return (sig, drawn, kernel_flags.flags()), draws

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Mapping[str, torch.Tensor]] = None):
        nonlocal graph, eager_key
        with trace.span("train.step", state.step):
            key, draws = graph_key(batch, generator, draws)
            replay = key is not None and graph is not None and graph.key == key
            if not replay and key is not None and key == eager_key:
                graph = None  # the old graph's memory goes back before the capture
                graph = _StepGraph(key, pipe, params, batch, draws)
                trace.count("train.graph.captures")
                replay = True
            if replay:
                sums = graph.replay(params, batch, draws)
            else:
                sums = forward_backward(pipe, optimizer, cfg, mesh, batch, generator, draws)
                trace.count("train.graph.eager")
                eager_key = key
            with trace.span("train.update"):
                sums["grad_norm"] = trainable_grad_norm(optimizer)
                optimizer.step()
                if cfg.use_ema:
                    ema_update(state.ema, state.trainable, cfg.ema_decay)
            state.step += 1
            return state, sums

    return step
