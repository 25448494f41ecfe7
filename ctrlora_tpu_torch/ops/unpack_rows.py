"""Per-step row unpack of the hoisted time-embedding tables.

Kernel D of the port, in Triton. It replaces the TPU kernel
``ctrlora_tpu/ops/unpack_rows.py`` ``_unpack_kernel`` (launched from
``unpack_rows``), which splits one DDIM step's padded [n, Cmax] block of
emb_proj rows into n [1, C_i] rows in one launch.

What bounds it on the H100: pure data movement of ~70 rows x <= 1280
values, so launch latency, not bandwidth. One launch per step copies
``block[i, :C_i]`` for every row into one flat buffer; the rows handed out
are [1, C_i] views of that buffer. The plain version returns views of the
block itself and launches nothing.
"""

import functools
from typing import Dict, Sequence, Tuple

import torch

tl = None  # triton.language, bound at the first launch (the kernel's globals)

_layouts: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


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


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language as language

    tl = language

    @triton.jit
    def unpack(block_ptr, out_ptr, sizes_ptr, offsets_ptr, row_stride,
               BLOCK: tl.constexpr):
        i = tl.program_id(0)
        c = tl.load(sizes_ptr + i)
        off = tl.load(offsets_ptr + i)
        cols = tl.arange(0, BLOCK)
        m = cols < c
        v = tl.load(block_ptr + i * row_stride + cols, mask=m)
        tl.store(out_ptr + off + cols, v, mask=m)

    return unpack


def _layout(sizes: Tuple[int, ...], device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (sizes, str(device))
    if key not in _layouts:
        offsets = [0]
        for c in sizes[:-1]:
            offsets.append(offsets[-1] + c)
        _layouts[key] = (torch.tensor(sizes, dtype=torch.int32, device=device),
                         torch.tensor(offsets, dtype=torch.int32, device=device))
    return _layouts[key]


def unpack_rows(block: torch.Tensor, sizes: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Split a padded [n, Cmax] row block into n [1, C_i] rows. Row i is
    block[i, :sizes[i]]; the padding is ignored."""
    sizes = tuple(int(s) for s in sizes)
    n, cmax = block.shape
    if n != len(sizes) or max(sizes) > cmax:
        raise ValueError(f"unpack_rows: block {tuple(block.shape)} vs sizes {sizes}")
    if block.device.type == "cpu":
        return unpack_rows_plain(block, sizes)
    if block.device.type != "cuda" or block.stride(1) != 1:
        raise ValueError("unpack_rows: needs a CUDA block with unit column stride")
    import triton

    sizes_t, offsets_t = _layout(sizes, block.device)
    out = torch.empty(sum(sizes), device=block.device, dtype=block.dtype)
    _kernel()[(n,)](block, out, sizes_t, offsets_t, block.stride(0),
                    BLOCK=triton.next_power_of_2(cmax))
    unpack_rows.launches += 1
    rows, off = [], 0
    for c in sizes:
        rows.append(out[off:off + c].view(1, c))
        off += c
    return tuple(rows)


unpack_rows.launches = 0
