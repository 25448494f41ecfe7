"""Kernel-variant flags of the port (counterpart of
``ctrlora_tpu/ops/kernel_flags.py``).

The same ``CTRLORA_KERNELS`` environment variable, a comma-separated token
list, with the tokens that choose between kernels the port has:

  gn1=0|1        one-pass GroupNorm (kernel A2) for samples of at most 3 MiB
                 instead of the two-pass kernel A (default off, as in JAX)
  hpack=N        N >= 2: the head-pair flash forward (kernel B6) at the BSHD
                 self-attention sites where 2*D <= 128 (default: no packing)
  qkvpack=0|1    self-attention reads the fused q|k|v projection output
                 (kernel B's qkv entry, default on); =0 splits it into
                 [B, S, H, D] views for the BSHD dispatcher
  fuse_qkv=0|1   one q|k|v projection product (default on); =0 issues three

Every other token warns that it does not apply to the port (a JAX token) or
is unknown, as JAX warns on unknown tokens; none is silently accepted.
:func:`override` and :func:`set_flags` set the same fields from code. The
flags are read at call time, so ``override`` switches kernels between two
runs in one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import Iterator, Optional


@dataclasses.dataclass(frozen=True)
class KernelFlags:
    gn_onepass: Optional[bool] = None  # None -> off
    head_pack: Optional[int] = None  # None -> 1 (no packing)
    attn_qkv_packed: Optional[bool] = None  # None -> on
    fuse_qkv: Optional[bool] = None  # None -> on


_ENV = "CTRLORA_KERNELS"
_BOOL_FIELDS = {"gn1": "gn_onepass", "qkvpack": "attn_qkv_packed", "fuse_qkv": "fuse_qkv"}
_INT_FIELDS = {"hpack": "head_pack"}
_parse_cache: dict[str, KernelFlags] = {}
_overrides: dict[str, object] = {}


def _parse(spec: str) -> KernelFlags:
    kw: dict[str, object] = {}
    for raw in spec.split(","):
        tok = raw.strip()
        if not tok:
            continue
        key, eq, val = tok.partition("=")
        if eq and key in _BOOL_FIELDS and val in ("0", "1"):
            kw[_BOOL_FIELDS[key]] = val == "1"
        elif eq and key in _INT_FIELDS:
            try:
                n = int(val)
            except ValueError:
                warnings.warn(f"ignoring malformed {_ENV} token {tok!r}")
                continue
            if n > 0:
                kw[_INT_FIELDS[key]] = n
            else:
                warnings.warn(f"ignoring non-positive {_ENV} token {tok!r}")
        else:
            warnings.warn(f"ignoring {_ENV} token {tok!r}: unknown, or a JAX kernel "
                          f"knob that does not apply to the PyTorch port")
    return KernelFlags(**kw)  # type: ignore[arg-type]


def flags() -> KernelFlags:
    """Current kernel flags: the env spec, then programmatic overrides."""
    spec = os.environ.get(_ENV, "")
    base = _parse_cache.get(spec)
    if base is None:
        base = _parse(spec)
        _parse_cache[spec] = base
    if _overrides:
        return dataclasses.replace(base, **_overrides)  # type: ignore[arg-type]
    return base


def set_flags(**kw) -> None:
    """Set process-wide overrides. Unknown fields raise."""
    names = {f.name for f in dataclasses.fields(KernelFlags)}
    for key in kw:
        if key not in names:
            raise TypeError(f"unknown kernel flag {key!r} (valid: {sorted(names)})")
    _overrides.update(kw)


def clear_flags() -> None:
    _overrides.clear()


@contextlib.contextmanager
def override(**kw) -> Iterator[None]:
    """Scoped flag overrides; nests, and restores the outer ones on exit."""
    saved = dict(_overrides)
    set_flags(**kw)
    try:
        yield
    finally:
        _overrides.clear()
        _overrides.update(saved)
