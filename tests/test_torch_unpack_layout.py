"""Kernel D's layout and the sampler's row table on the CPU (no GPU or nvcc).

``unpack_rows_layout`` gives the output offsets kernel D
(``csrc/unpack_rows.cu``) receives in its parameters: the running sums of
the row sizes, every one a whole number of 16-byte copies at the paths'
sizes (one step's rows of one-LoRA sampling, n = 32, and of the two-LoRA
path, n = 42), and a ValueError naming the capacity of the kernel's layout
beyond it. ``make_emb_row_tables``'s ``rows_of`` places each row by a table
worked out once when the tables are packed; it returns the same dict as a
build that parses every name at every step.
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.ops import unpack_rows as ur
from ctrlora_tpu_torch.sampling.common import make_emb_row_tables


def _path_sizes(n_conds):
    """One step's row widths: the UNet's and each condition's ControlNet's
    (chip_smoke.emb_row_sizes lists the UNet's and one ControlNet's)."""
    one = chip_smoke.emb_row_sizes(configs.ctrlora_inference_config(lora_num=1, lora_rank=128))
    control = one[len(one) - 10:]  # the ControlNet's 8 encoder ResBlocks and 2 mid
    return one + control * (n_conds - 1)


@pytest.mark.parametrize("n_conds, n", [(1, 32), (2, 42)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_offsets_are_running_sums_and_16_byte_aligned(n_conds, n, itemsize):
    sizes = tuple(_path_sizes(n_conds))
    assert len(sizes) == n
    offsets = ur.unpack_rows_layout(sizes, itemsize)
    assert offsets == tuple(itertools.accumulate((0,) + sizes[:-1]))
    assert all(o * itemsize % 16 == 0 for o in offsets)
    assert all(c * itemsize % 16 == 0 for c in sizes)


def test_layout_raises_beyond_its_capacity_and_off_alignment():
    cap = ur.UNPACK_MAX_ROWS
    assert len(ur.unpack_rows_layout((320,) * cap, 2)) == cap
    with pytest.raises(ValueError, match=f"{cap}"):
        ur.unpack_rows_layout((320,) * (cap + 1), 2)
    with pytest.raises(ValueError, match="16-byte"):
        ur.unpack_rows_layout((320, 324), 2)  # a 648-byte row
    with pytest.raises(ValueError):
        ur.unpack_rows_layout((), 2)


def test_cpu_block_takes_the_plain_version():
    sizes = (8, 24, 16)
    block = torch.arange(3 * 24, dtype=torch.float32).reshape(3, 24)
    ur.unpack_rows.launches = 0
    rows = ur.unpack_rows(block, sizes)
    assert ur.unpack_rows.launches == 0
    for got, want in zip(rows, ur.unpack_rows_plain(block, sizes)):
        assert got.shape == want.shape and torch.equal(got, want)
    with pytest.raises(ValueError):
        ur.unpack_rows(block, (8, 24))


class _TablePipe:
    """The one method make_emb_row_tables reads: per-branch emb_proj
    tables {name: [S, C]} for the UNet and each condition."""

    def __init__(self, rng, n_conds, steps):
        widths = {"input_blocks.1.0": 32, "input_blocks.4.0": 64, "middle_block.0": 128,
                  "output_blocks.3.0": 64}
        t = lambda c: torch.from_numpy(rng.standard_normal((steps, c)).astype(np.float32))
        self.tables = {"unet": {k: t(c) for k, c in widths.items()},
                       "control": [{k: t(c) for k, c in widths.items() if "output" not in k}
                                   for _ in range(n_conds)]}

    def emb_proj_tables(self, timesteps, conds, vector=None):
        return self.tables


def _rows_by_name(packed_step, names, sizes, n_conds):
    """The dict as it was built before: every name split at every step."""
    rows = ur.unpack_rows_plain(packed_step, sizes)
    out = {"unet": {}, "control": tuple({} for _ in range(n_conds))}
    for name, row in zip(names, rows):
        scope, key = name.split(".", 1)
        if scope == "u":
            out["unet"][key] = row
        else:
            out["control"][int(scope[1:])][key] = row
    return out


@pytest.mark.parametrize("n_conds", [1, 2, 3])
def test_rows_of_matches_the_per_name_build(n_conds):
    rng = np.random.default_rng(0)
    pipe = _TablePipe(rng, n_conds, steps=3)
    packed, rows_of = make_emb_row_tables(pipe, [None] * n_conds, torch.arange(3))
    flat = {f"u.{k}": v for k, v in pipe.tables["unet"].items()}
    for j, d in enumerate(pipe.tables["control"]):
        flat.update({f"c{j}.{k}": v for k, v in d.items()})
    _, names, sizes = ur.pack_row_tables(flat)
    for step in range(3):
        got, want = rows_of(packed[step]), _rows_by_name(packed[step], names, sizes, n_conds)
        assert set(got) == set(want) == {"unet", "control"}
        assert isinstance(got["control"], tuple) and len(got["control"]) == n_conds
        for g, w in zip((got["unet"], *got["control"]), (want["unet"], *want["control"])):
            assert list(g) == list(w)
            for key in w:
                assert torch.equal(g[key], w[key]) and g[key].shape == w[key].shape
        assert torch.equal(got["unet"]["middle_block.0"][0],
                           pipe.tables["unet"]["middle_block.0"][step])
