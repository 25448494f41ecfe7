"""Hand-written Hopper kernels of the port, each beside its plain version.

A wrapper given a CPU tensor computes its plain PyTorch version; given a
CUDA tensor it launches its kernel or raises, and so it does on any other
device, but for one scoped case: inside :func:`meta_takes_plain` (a FLOP
count, ``utils/flops.py``) a tensor on the ``meta`` device (shapes without
data) takes the plain version, so a kernel's work counts as its plain
version's products without arithmetic. Every wrapper counts its kernel
launches in a plain integer attribute, ``<wrapper>.launches``
(:func:`wrappers` lists them). The wrappers on the training path are
``torch.autograd.Function``s, so a kernel output carries its gradient.
"""

import contextlib
import contextvars
from typing import Iterator

_META_TAKES_PLAIN = contextvars.ContextVar("ctrlora_meta_takes_plain", default=False)


def takes_plain(t) -> bool:
    """Whether a wrapper given tensor `t` computes its plain version: `t`
    lies on the CPU, or on the meta device inside :func:`meta_takes_plain`."""
    kind = t.device.type
    return kind == "cpu" or (kind == "meta" and _META_TAKES_PLAIN.get())


@contextlib.contextmanager
def meta_takes_plain() -> Iterator[None]:
    """Inside the block a meta tensor takes its wrapper's plain version;
    on leaving it, whether by return or by raise, a meta tensor raises
    again, as any tensor on neither the CPU nor the card."""
    token = _META_TAKES_PLAIN.set(True)
    try:
        yield
    finally:
        _META_TAKES_PLAIN.reset(token)


def wrappers() -> dict:
    """Every hand-kernel wrapper by name (each counts its launches in
    ``.launches``), looked up at call time."""
    from ctrlora_tpu_torch.ops import flash_attention as fa
    from ctrlora_tpu_torch.ops import geglu_ffn, group_norm, unpack_rows

    fns = (group_norm.group_norm, group_norm.group_norm_onepass, fa.flash_attention_qkv,
           fa.flash_attention, fa.flash_attention_bshd, fa.flash_attention_hpack2,
           fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv, geglu_ffn.geglu_ffn,
           unpack_rows.unpack_rows)
    return {f.__name__: f for f in fns}
