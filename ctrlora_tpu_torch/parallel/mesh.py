"""Process groups, batch sharding and replication over ``torch.distributed``
(counterpart of ``ctrlora_tpu/parallel/mesh.py`` and of the mesh half of
``ctrlora_tpu/parallel/tp.py``).

JAX runs one process over a device mesh; torch runs one process per rank
(``torchrun --nproc_per_node N``), so the mesh here is this rank's place in
a ``(data, model)`` grid of ranks and the process groups along each axis:

  * the data group: the ranks that hold the same model slice (one per
    model index); gradients are averaged over it;
  * the model group: the ranks that hold the same batch rows (one per data
    index); the tensor-parallel sites all-reduce over it (``parallel.tp``).

The model axis is minor, as in JAX's ``create_mesh_2d``: rank = d * tp + m.
Every rank holds whole parameters (replicated, as the JAX package keeps
them). With optimizer-state sharding each data rank keeps the AdamW moments
of about 1/dp of the trainable elements (:class:`ShardedOptimizer`).

Collectives take the backend as it comes: NCCL for CUDA ranks, gloo for CPU
ranks. Several ranks may share one card over gloo when the caller names it
(a check of what the ranks compute, not of speed); gloo on CUDA tensors, and
on any type but fp32, is staged through fp32 host tensors here, and the NCCL
path hands the tensors to NCCL as they are.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# torchrun's environment: any of these set means "this is a distributed run"
_ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# group formation and every collective's timeout: long enough for rank 0 to
# write a checkpoint or an image log while the others wait at a collective
DEFAULT_TIMEOUT_S = 1800.0
_BUCKET_ELEMENTS = 1 << 26  # 64M elements a flattened bucket

_device: Optional[torch.device] = None  # the device init_distributed chose


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def init_distributed(init_method: Optional[str] = None, backend: Optional[str] = None,
                     device=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group. Returns True when distributed mode is active.

    Configured by `init_method` (with `rank` and `world_size`, or RANK and
    WORLD_SIZE in the environment) or by torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; ``env://``). Not
    configured: returns False (one process, no group). Configured but the
    group does not form within `timeout_s`: raises RuntimeError, as JAX's
    fail-loud policy does, so a run never trains N ranks without a gradient
    exchange.

    The rank's device is `device`, else ``cuda:LOCAL_RANK``; it never falls
    back to the CPU or to a card another rank uses on its own. The backend
    is `backend`, else NCCL for a CUDA device and gloo for the CPU; several
    ranks on one card need ``backend='gloo'`` and the card as `device`.
    """
    global _device
    if in_group():
        return True
    env = {v: os.environ[v] for v in _ENV_VARS if os.environ.get(v)}
    if init_method is None and not env:
        return False  # one process
    try:
        rank = int(os.environ["RANK"]) if rank is None else int(rank)
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else int(world_size))
    except KeyError as e:
        raise RuntimeError(f"distributed run configured ({init_method or env}) but {e} "
                           "is not set; give rank and world_size") from e
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed run configured, but torch sees no CUDA device; "
                               "pass device='cpu' (gloo) to run the ranks on the CPU")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        index = local_rank if device.index is None else device.index
        if backend == "nccl" and index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: LOCAL_RANK {index} but only "
                               f"{torch.cuda.device_count()} CUDA devices; NCCL needs one "
                               "card a rank (several ranks on one card: backend='gloo')")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"distributed run configured ({init_method or env}) but the {backend} group of "
            f"{world_size} ranks did not form (rank {rank}): {type(e).__name__}: {e}; refusing "
            "to run alone (it would train without a gradient exchange)") from e
    _device = device
    return True


def in_group() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_device() -> Optional[torch.device]:
    """The device `init_distributed` gave this rank (None outside a group)."""
    return _device if in_group() else None


def process_index() -> int:
    """This rank (0 outside a group): only rank 0 writes logs and files."""
    return dist.get_rank() if in_group() else 0


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the (data, model) grid, and the groups along each
    axis (None outside a process group: nothing to exchange)."""

    dp: int
    tp: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self):
        return (self.dp, self.tp)

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    def data_ranks(self) -> List[int]:
        """The ranks of this rank's data group (same model index)."""
        return [d * self.tp + self.model_index for d in range(self.dp)]

    def model_ranks(self) -> List[int]:
        """The ranks of this rank's model group (same data index)."""
        return [self.data_index * self.tp + m for m in range(self.tp)]

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def create_mesh_2d(dp: int, tp: int) -> Mesh:
    """The (data, model) mesh over every rank; the model axis is minor.
    Every rank must call it (the groups are formed collectively)."""
    n = world_size()
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {n}")
    if not in_group():
        return Mesh(1, 1, 0)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(tp):  # every rank forms every group, in one order
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model_group = g
    return Mesh(dp, tp, rank, data_group, model_group)


def create_mesh(n: Optional[int] = None) -> Mesh:
    """The 1-D data mesh over every rank (JAX ``create_mesh``)."""
    return create_mesh_2d(world_size() if n is None else n, 1)


# ---------------------------------------------------------------------------
# collectives (gloo staged through the host)
# ---------------------------------------------------------------------------

def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


# what gloo takes as it is; anything else goes through the host as fp32
# (a sum) or as bytes (a broadcast)
_GLOO_TYPES = (torch.float32, torch.float64)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (gloo: through an fp32 host copy)."""
    if _nccl(group) or (t.device.type == "cpu" and t.dtype in _GLOO_TYPES):
        dist.all_reduce(t, group=group)
        return t
    host = t.detach().to("cpu", torch.float32)
    dist.all_reduce(host, group=group)
    with torch.no_grad():
        t.copy_(host)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite `t` with rank `src`'s bits (gloo on a card: through a host
    copy of its bytes)."""
    if _nccl(group) or (t.device.type == "cpu" and t.dtype in _GLOO_TYPES):
        dist.broadcast(t, src, group=group)
        return t
    host = t.detach().contiguous().to("cpu").reshape(-1).view(torch.uint8)
    dist.broadcast(host, src, group=group)
    with torch.no_grad():
        t.copy_(host.view(t.dtype).reshape(t.shape))
    return t


def _buckets(tensors: Sequence[torch.Tensor]):
    """`tensors` in runs of one device and dtype of at most _BUCKET_ELEMENTS."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if run and (t.device != run[0].device or t.dtype != run[0].dtype
                    or size + t.numel() > _BUCKET_ELEMENTS):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def _flat_collective(tensors: Sequence[torch.Tensor], op: Callable[[torch.Tensor], Any]):
    """Apply `op` to each bucket flattened into one buffer, then copy the
    buffer back into the tensors (their layouts kept)."""
    for run in _buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in run])
        op(flat)
        with torch.no_grad():
            for t, piece in zip(run, flat.split([t.numel() for t in run])):
                t.copy_(piece.view(t.shape))


def all_reduce_tensors_(tensors: Sequence[torch.Tensor], group, divide: int = 1) -> None:
    """Sum each tensor over `group` in place, bucketed, then divide by
    `divide` (gloo has no AVG: the mean is the sum over the group size)."""
    if group is None or not tensors:
        return

    def op(flat):
        all_reduce_(flat, group)
        if divide != 1:
            flat.div_(divide)

    _flat_collective(tensors, op)


def _tensors_of(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors_of(sub)]
    if tree is None:
        return []
    raise TypeError(f"replicate: cannot walk a {type(tree).__name__}")


# ---------------------------------------------------------------------------
# the JAX mesh functions
# ---------------------------------------------------------------------------

def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """This rank's contiguous block of rows of a host-global batch (a dict,
    list, tensor or array) along `axis`: block `data_index` of `dp`; the
    model ranks of one data index take the same rows."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    n = batch.shape[axis]
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows on axis {axis} does not divide over the "
                         f"{mesh.dp} data ranks")
    rows = n // mesh.dp
    lo = mesh.data_index * rows
    if isinstance(batch, torch.Tensor):
        return batch.narrow(axis, lo, rows)
    return np.take(batch, np.arange(lo, lo + rows), axis=axis)


@torch.no_grad()
def replicate(mesh: Mesh, tree) -> Any:
    """Broadcast every tensor of `tree` (modules' parameters and buffers,
    dicts, lists) from rank 0 in place, so all ranks start identical.
    Returns `tree`."""
    if mesh.distributed:
        _flat_collective(_tensors_of(tree), lambda flat: broadcast_(flat, 0))
    return tree


def partition_parameters(sizes: Sequence[int], n: int) -> List[int]:
    """The owner (0..n-1) of each parameter: largest first, each to the
    least-loaded owner so far (ties to the lowest index)."""
    loads = [0] * n
    owners = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        o = min(range(n), key=lambda j: (loads[j], j))
        owners[i] = o
        loads[o] += sizes[i]
    return owners


class ShardedOptimizer:
    """ZeRO-1 over the data ranks (the counterpart of ``shard_largest_axis``
    on the optimizer state, ``TrainConfig.shard_opt_state``): whole
    parameters are dealt to the data ranks by :func:`partition_parameters`;
    each rank keeps and steps the AdamW state of its own parameters only,
    then every parameter is broadcast from its owner, so all ranks hold the
    same bits. The gradients are whole on every rank (averaged before
    ``step``). JAX splits each large moment on its first divisible axis;
    whole parameters keep torch's AdamW as it is, and the moments of a LoRA
    trainable set (hundreds of tensors) still part evenly.

    ``state_dict()`` (collective: every data rank calls it) is AdamW's own
    format over the full parameter list, so a checkpoint written at one
    world size restores at any other, with or without sharding.
    """

    def __init__(self, params: Sequence[nn.Parameter], mesh: Mesh,
                 make: Callable[[List[nn.Parameter]], torch.optim.Optimizer]):
        self.params = list(params)
        self.mesh = mesh
        self.owners = partition_parameters([p.numel() for p in self.params], mesh.dp)
        self.local_index = [i for i, o in enumerate(self.owners) if o == mesh.data_index]
        local = [self.params[i] for i in self.local_index]
        self.local = make(local) if local else None
        proto = self.local or make(self.params[:1])
        self.param_groups = [{**{k: v for k, v in proto.param_groups[0].items()
                                 if k != "params"}, "params": self.params}]

    def moment_share(self) -> float:
        """This rank's share of the trainable elements whose moments it keeps."""
        total = sum(p.numel() for p in self.params)
        return sum(self.params[i].numel() for i in self.local_index) / max(total, 1)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        if self.local is not None:
            self.local.step()
        if self.mesh.dp > 1:
            for d in range(self.mesh.dp):
                mine = [p for p, o in zip(self.params, self.owners) if o == d]
                src = d * self.mesh.tp + self.mesh.model_index
                _flat_collective(mine, lambda flat, src=src: broadcast_(
                    flat, src, self.mesh.data_group))

    def state_dict(self) -> Dict[str, Any]:
        local = self.local.state_dict() if self.local is not None else {"state": {}}
        mine = {self.local_index[j]: {k: v.detach().cpu() if torch.is_tensor(v) else v
                                      for k, v in st.items()}
                for j, st in local["state"].items()}
        if self.mesh.dp > 1:
            parts = [None] * self.mesh.dp
            dist.all_gather_object(parts, mine, group=self.mesh.data_group)
        else:
            parts = [mine]
        state = {i: st for part in parts for i, st in part.items()}
        group = {k: v for k, v in self.param_groups[0].items() if k != "params"}
        return {"state": dict(sorted(state.items())),
                "param_groups": [{**group, "params": list(range(len(self.params)))}]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Keep this rank's parameters' entries of a full AdamW state dict."""
        if len(sd["param_groups"][0]["params"]) != len(self.params):
            raise ValueError(f"optimizer state of {len(sd['param_groups'][0]['params'])} "
                             f"parameters for {len(self.params)}")
        if self.local is None:
            return
        group = {**sd["param_groups"][0], "params": list(range(len(self.local_index)))}
        state = {j: sd["state"][i] for j, i in enumerate(self.local_index) if i in sd["state"]}
        self.local.load_state_dict({"state": state, "param_groups": [group]})


# ---------------------------------------------------------------------------
# data-parallel sampling
# ---------------------------------------------------------------------------

def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _concat(parts):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    if isinstance(first, np.ndarray):
        return np.concatenate(parts, axis=0)
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([p[i] for p in parts]) for i in range(len(first)))
    raise TypeError(f"cannot gather a {type(first).__name__}")


def shard_args(mesh: Mesh, args) -> list:
    """Arguments with two or more axes are batch arguments (split on axis 0,
    as JAX's dp_sample_jit places them); the rest pass as they are."""
    return [shard_batch(mesh, a) if getattr(a, "ndim", 0) >= 2 else a for a in args]


def gather_rows(mesh: Mesh, out):
    """The data ranks' outputs (host tensors or arrays) concatenated on axis
    0 on rank 0, in data order; None on every other rank. The model ranks
    of one data index hold the same rows, so only model index 0 sends."""
    out = _to_host(out)
    if not mesh.distributed:
        return out
    if mesh.model_index != 0:
        return None
    parts = [None] * mesh.dp if mesh.rank == 0 else None
    dist.gather_object(out, parts, dst=0, group=mesh.data_group)
    return _concat(parts) if mesh.rank == 0 else None


def dp_sample(fn: Callable, mesh: Mesh) -> Callable:
    """Data-parallel sampling: ``call(*args, **kw)`` runs ``fn`` on this
    rank's rows of every batch argument (the parameters are replicated:
    every rank holds the same weights) and returns the outputs of all rows
    on rank 0 (None elsewhere). No collective runs in the sampler loop:
    each rank denoises its own rows, and the outputs reach rank 0 as host
    tensors."""

    def call(*args, **kw):
        return gather_rows(mesh, fn(*shard_args(mesh, args), **kw))

    return call
