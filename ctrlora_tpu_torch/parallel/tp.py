"""Tensor parallelism over the model group of a ``(data, model)`` mesh
(counterpart of ``ctrlora_tpu/parallel/tp.py``).

Megatron-style, as JAX's GSPMD constraints shard it: every rank holds whole
parameters (replicated) and computes with its own slice of them.

  * self- and cross-attention: rank m computes q, k and v for its heads
    only (the weight rows ``[m*H/tp*D, (m+1)*H/tp*D)``, a LoRA's up
    projection the same rows), attends over them, and contracts its slice
    of ``to_out``'s input (a LoRA's down projection the same columns); ONE
    all-reduce over the model group, then the bias, once.
  * the GEGLU feed-forward: ``proj`` computes both halves' rows of the
    local hidden slice, the gate is applied locally, ``out`` contracts the
    slice; one all-reduce, then the bias.
  * everything else (convs, norms, embeddings, the VAE and CLIP) runs
    whole on every model rank.

Two autograd functions carry the exchanges: ``copy_to_model`` (f: identity
forward, all-reduce backward) before a split projection, and
``reduce_from_model`` (g: all-reduce forward, identity backward) after a
contracting one. A site runs replicated where ``heads % tp != 0`` (JAX
``constrain``'s ``model_units``), and then, as JAX's XLA path, through the
plain attention. The batch is split over the data axis before the model
runs (``mesh.shard_batch``), so JAX's second condition, a batch that does
not divide dp, raises there instead.

Kernels: JAX pins ``geglu_ffn``, ``fused_group_norm`` and ``fuse_qkv`` off
under TP, since GSPMD cannot partition a custom call. Here each rank calls
the kernels on whole local tensors, so only what a split forbids is off:
kernel C on a split feed-forward (C fuses the whole hidden), and the fused
q|k|v product and kernel B's fused-qkv entry on a split attention site (q,
k and v are separate local projections). Kernel B's BSHD entry (and B4/B5
in training) takes the local heads, since its plans are keyed on the head
dim; kernel A (GroupNorm) and kernel D (the row unpack) act on activations
every model rank holds whole and keep running.

A sliced weight's gradient is partial on each model rank (its rows or
columns, or a LoRA factor fed by the local slice): the split sites record
their parameters (:func:`mark_split`) and the train step sums those
gradients over the model group. The output bias, and every weight that
every model rank computes whole, has the whole gradient already.

The context is read at call time (no tracing): outside
:func:`tensor_parallel` nothing changes, no collective runs and the same
kernels run in the same order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

from ctrlora_tpu_torch.parallel.mesh import Mesh, all_reduce_, all_reduce_tensors_, dp_sample


@dataclasses.dataclass(frozen=True, eq=False)
class TPContext:
    mesh: Mesh
    split_ids: Set[int] = dataclasses.field(default_factory=set)


_ACTIVE: Optional[TPContext] = None


def active() -> Optional[TPContext]:
    return _ACTIVE


@contextlib.contextmanager
def tensor_parallel(mesh: Mesh) -> Iterator[TPContext]:
    """Split the attention and feed-forward sites over `mesh`'s model group
    for calls made inside the block."""
    global _ACTIVE
    ctx = TPContext(mesh)
    prev = _ACTIVE
    _ACTIVE = ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def local_range(units: int) -> Optional[Tuple[int, int]]:
    """This model rank's [lo, hi) of `units` (heads, or hidden features)
    under an active context with tp > 1 that divides them; None where the
    site runs whole (no context, tp 1, or units % tp != 0)."""
    ctx = _ACTIVE
    if ctx is None or ctx.mesh.tp == 1 or units % ctx.mesh.tp:
        return None
    n = units // ctx.mesh.tp
    m = ctx.mesh.model_index
    return m * n, (m + 1) * n


class _CopyToModel(torch.autograd.Function):
    """f: identity forward; the backward sums the gradient over the model
    group (each rank's split branch contributes its slice's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the forward sums the ranks' partial products over the model group;
    identity backward (every rank needs the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _group():
    group = _ACTIVE.mesh.model_group
    if group is None:
        raise RuntimeError("tensor parallelism with tp > 1 needs a process group")
    return group


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, _group())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, _group())


def mark_split(*params) -> None:
    """Record parameters whose gradient a split site leaves partial."""
    _ACTIVE.split_ids.update(id(p) for p in params if p is not None)


def _lora(dense, lora_idx):
    """(down [.., in, r], up [.., r, out], scale) of a LoRA Dense, else None."""
    from ctrlora_tpu_torch.models.layers import _take

    if getattr(dense, "lora", None) is None:
        return None
    scale = (None if dense.lora.network_alpha is None
             else dense.lora.network_alpha / dense.lora.rank)
    return _take(dense.lora_down, lora_idx), _take(dense.lora_up, lora_idx), scale


def split_dense(dense, x: torch.Tensor, ranges: Sequence[Tuple[int, int]],
                lora_idx=None) -> List[torch.Tensor]:
    """The output columns [lo, hi) of each range of ``dense(x, lora_idx)``
    (its weight rows, bias entries and LoRA up-projection columns; the LoRA
    down-projection once for all ranges)."""
    mark_split(dense.weight, dense.bias)
    w, b = dense.weight.to(x.dtype), dense.bias
    lora = _lora(dense, lora_idx)
    z = None
    if lora is not None:
        mark_split(dense.lora_down, dense.lora_up)
        z = x @ lora[0].to(x.dtype)
    outs = []
    for lo, hi in ranges:
        y = F.linear(x, w[lo:hi], None if b is None else b[lo:hi].to(x.dtype))
        if z is not None:
            t = z @ lora[1][..., lo:hi].to(x.dtype)
            y = y + (t if lora[2] is None else t * lora[2])
        outs.append(y)
    return outs


def contract_dense(dense, x: torch.Tensor, lo: int, hi: int, lora_idx=None) -> torch.Tensor:
    """This rank's partial ``dense`` product of its input slice x (the input
    features [lo, hi)), without the bias: the model group's sum of these is
    ``dense(full input) - bias``."""
    mark_split(dense.weight)
    y = F.linear(x, dense.weight[:, lo:hi].to(x.dtype))
    lora = _lora(dense, lora_idx)
    if lora is not None:
        mark_split(dense.lora_down, dense.lora_up)
        t = (x @ lora[0][..., lo:hi, :].to(x.dtype)) @ lora[1].to(x.dtype)
        y = y + (t if lora[2] is None else t * lora[2])
    return y


def reduce_split_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum over the model group the gradients of the parameters among
    `params` that a split site used (partial on each model rank), in
    `params`' order."""
    ctx = _ACTIVE
    if ctx is None or ctx.mesh.tp == 1:
        return
    grads = [p.grad for p in params if id(p) in ctx.split_ids and p.grad is not None]
    all_reduce_tensors_(grads, ctx.mesh.model_group)


def tp_sample(fn: Callable, mesh: Mesh) -> Callable:
    """Model-parallel sampling (JAX ``tp_sample_jit``): ``call(*args,
    **kw)`` runs ``fn`` on this rank's data rows of every batch argument
    (two or more axes) inside ``tensor_parallel(mesh)``, so the attention
    heads and GEGLU hidden are split over the model group; the rows of all
    data ranks reach rank 0 as host tensors (None elsewhere). The batch
    needs to divide dp only, not dp * tp."""

    rows = dp_sample(fn, mesh)

    def call(*args, **kw):
        with tensor_parallel(mesh):
            return rows(*args, **kw)

    return call
