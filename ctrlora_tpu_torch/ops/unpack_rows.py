"""Per-step row unpack of the hoisted time-embedding tables.

Kernel D of the port (``csrc/unpack_rows.cu``, CUDA C++ for sm_90a) replaces
the TPU kernel ``ctrlora_tpu/ops/unpack_rows.py`` ``_unpack_kernel``
(launched from ``unpack_rows``), which splits one DDIM step's padded
[n, Cmax] block of emb_proj rows into n [1, C_i] rows in one launch.

What bounds it on the H100: pure data movement of ~70 KB, so the launch and
the host's time to issue it, not bandwidth. One launch per step copies
``block[i, :C_i]`` for every row into one flat buffer, one block a row in
16-byte pieces; the layout (the sizes and output offsets, in bytes) goes
into the kernel's parameters, so no device tensor holds it and nothing is
copied to the card before the first launch. The rows handed out are
[1, C_i] views of the flat buffer, made by one ``split``. The plain version
returns views of the block itself and launches nothing.
"""

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from ctrlora_tpu_torch.ops import _build, takes_plain

# rows the kernel's layout struct holds (csrc/unpack_rows.cu kUnpackMaxRows;
# the build phase of chip_smoke.py holds the two equal)
UNPACK_MAX_ROWS = 64
_ALIGN = 16  # bytes of one copy: every row's bytes and offset are multiples


def pack_row_tables(tables: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Tuple[str, ...], Tuple[int, ...]]:
    """Stack {name: [S, C_i]} into a zero-padded [S, n, Cmax] table, names
    sorted for a deterministic layout. Returns (table, names, sizes)."""
    names = tuple(sorted(tables))
    sizes = tuple(int(tables[k].shape[-1]) for k in names)
    cmax = max(sizes)
    cols = [torch.nn.functional.pad(tables[k], (0, cmax - c)) for k, c in zip(names, sizes)]
    return torch.stack(cols, dim=1), names, sizes


def unpack_rows_plain(block: torch.Tensor, sizes: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Views block[i, :C_i] as [1, C_i]; no copy, no launch."""
    return tuple(block[i, :c].reshape(1, c) for i, c in enumerate(sizes))


def unpack_rows_work(sizes: Sequence[int], itemsize: int = 2) -> tuple:
    """(flops, bytes): no arithmetic; each row's used prefix read once and
    written once."""
    return 0, 2 * sum(sizes) * itemsize


@functools.lru_cache(maxsize=None)
def unpack_rows_layout(sizes: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """The output offset of each row (in elements): the running sums of
    `sizes`. Raises ValueError where the kernel cannot take the layout: more
    rows than its layout struct holds (UNPACK_MAX_ROWS), or a row whose bytes
    are not a whole number of 16-byte copies."""
    sizes = tuple(int(s) for s in sizes)
    if not 0 < len(sizes) <= UNPACK_MAX_ROWS:
        raise ValueError(f"unpack_rows: {len(sizes)} rows; the kernel's layout holds 1 to "
                         f"{UNPACK_MAX_ROWS} (its capacity)")
    bad = [c for c in sizes if c <= 0 or c * itemsize % _ALIGN]
    if bad:
        raise ValueError(f"unpack_rows: rows of {bad} {itemsize}-byte elements are not whole "
                         f"numbers of {_ALIGN}-byte copies")
    offsets, off = [], 0
    for c in sizes:
        offsets.append(off)
        off += c
    return tuple(offsets)


@functools.lru_cache(maxsize=None)
def _c_layout(sizes: Tuple[int, ...], itemsize: int):
    """The layout in bytes as the C entry takes it: two int arrays (kept
    alive by the cache) and the total elements."""
    offsets = unpack_rows_layout(sizes, itemsize)
    n = len(sizes)
    return ((ctypes.c_int * n)(*(c * itemsize for c in sizes)),
            (ctypes.c_int * n)(*(o * itemsize for o in offsets)), sum(sizes), list(sizes))


def unpack_rows(block: torch.Tensor, sizes: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Split a padded [n, Cmax] row block into n [1, C_i] rows. Row i is
    block[i, :sizes[i]]; the padding is ignored. A CPU block takes the plain
    version; a CUDA block launches kernel D or raises."""
    sizes = tuple(sizes)
    n, cmax = block.shape
    if n != len(sizes) or max(sizes) > cmax:
        raise ValueError(f"unpack_rows: block {tuple(block.shape)} vs sizes {sizes}")
    if takes_plain(block):
        return unpack_rows_plain(block, sizes)
    item = block.element_size()
    if (block.device.type != "cuda" or block.stride(1) != 1 or block.data_ptr() % _ALIGN
            or block.stride(0) * item % _ALIGN):
        raise ValueError("unpack_rows: needs a 16-byte aligned CUDA block with unit column "
                         "stride and rows a whole number of 16 bytes apart")
    nbytes, offsets, total, split = _c_layout(sizes, item)
    out = torch.empty(total, device=block.device, dtype=block.dtype)
    code = _build.cuda_lib().ctrlora_unpack_rows(
        block.data_ptr(), out.data_ptr(), block.stride(0) * item, nbytes, offsets, n,
        _build.stream_ptr(block.device))
    _build.check(code, "unpack_rows")
    unpack_rows.launches += 1
    return out.view(1, total).split(split, dim=1)


unpack_rows.launches = 0
