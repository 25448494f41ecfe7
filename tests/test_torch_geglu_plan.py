"""Kernel C's host side on the CPU: the tiling that ``geglu_plan`` hands the
two CUDA launches (``ctrlora_geglu_up``, ``ctrlora_geglu_down``) covers
every output tile of h [rows, F] and y [rows, C] exactly once (at the
SD1.5 widths, at the app's one-sample CFG batch of 2, and at ControlNet-XS's
64/128/256, whose down tiles are 64 and 128 columns wide), its split-K factor divides the F / 64 boxes of K, every
launch at the SD1.5 sites fills the H100's 132 SMs or its case says why
not, and the static dispatch admits what it admitted, and the XS widths.
The kernels themselves run only on the card (chip_smoke.py phase 3)."""

import numpy as np
import pytest
import torch

from ctrlora_tpu_torch.ops import geglu_ffn as geglu
from ctrlora_tpu_torch.ops.geglu_ffn import BM, DOWN_TILES, K_BOX, H100_SMS, geglu_plan

# rows x C at the sampling sites (CFG batch of 8 at 64^2, 32^2, 16^2, 8^2),
# the finetune step's (batch 4) and ragged counts (last tile part-filled)
SAMPLING = [(8 * 4096, 320), (8 * 1024, 640), (8 * 256, 1280), (8 * 64, 1280)]
FINETUNE = [(4 * 4096, 320), (4 * 1024, 640), (4 * 256, 1280), (4 * 64, 1280)]
RAGGED = [(1000, 320), (77 * 2, 640), (300, 1280)]
# the app's one-sample sampling: the CFG batch of 2 at the four sites
APP = [(2 * 4096, 320), (2 * 1024, 640), (2 * 256, 1280), (2 * 64, 1280)]
SHAPES = SAMPLING + FINETUNE + RAGGED + APP
# ControlNet-XS's control stream (0.2x: C = 64/128/256) at the same sites
XS = [(8 * 4096, 64), (8 * 1024, 128), (8 * 256, 256), (8 * 64, 256),
      (4 * 4096, 64), (4 * 1024, 128), (4 * 256, 256), (4 * 64, 256)]


def _units_of_blocks(units, grid):
    """Units each persistent block takes: b, b + grid, ..."""
    return [list(range(b, units, grid)) for b in range(grid)]


@pytest.mark.parametrize("rows, c", SHAPES + XS)
def test_plan_covers_every_tile_once(rows, c):
    f = 4 * c
    plan = geglu_plan(rows, c, f)
    m_tiles = -(-rows // BM)

    # up: unit u -> tile (u // n_up, u % n_up) of h, bn_up columns of F
    bn = plan.bn_up
    n_up = f // bn
    assert f % bn == 0 and plan.up_units == m_tiles * n_up
    cover = np.zeros((m_tiles, f // K_BOX), int)
    for units in _units_of_blocks(plan.up_units, plan.up_grid):
        assert units, "a block with no tile"
        for u in units:
            m, n = divmod(u, n_up)
            cover[m, n * bn // K_BOX:(n + 1) * bn // K_BOX] += 1
    assert (cover == 1).all()

    # down: unit u -> K part u % split of tile u // split of y, bn_down columns
    n_down = c // plan.bn_down
    nk = f // K_BOX
    assert plan.bn_down in DOWN_TILES and c % plan.bn_down == 0
    assert plan.down_tiles == m_tiles * n_down
    assert plan.down_units == plan.down_tiles * plan.split
    cover = np.zeros((m_tiles, n_down, nk), int)
    for units in _units_of_blocks(plan.down_units, plan.down_grid):
        assert units, "a block with no tile"
        for u in units:
            tile, part = divmod(u, plan.split)
            m, n = divmod(tile, n_down)
            k0 = part * nk // plan.split
            cover[m, n, k0:k0 + nk // plan.split] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("rows, c", SHAPES + XS)
def test_split_divides_the_k_boxes(rows, c):
    f = 4 * c
    plan = geglu_plan(rows, c, f)
    assert plan.split >= 1 and (f // K_BOX) % plan.split == 0


# launches with fewer units than SMs, and why no other plan does better
UNDER_A_WAVE = {
    ((8 * 256, 1280), "down"): "128 tiles of K = 5120; a split of 2 gives 256 units, two "
                               "rounds of half the work each and twice the fixed cost",
    ((8 * 64, 1280), "down"): "32 tiles split 4 ways, 128 units; the next divisor of 80 "
                              "boxes, 5, needs a second round",
    ((4 * 1024, 640), "down"): "128 tiles of K = 2560; splitting doubles the rounds",
    ((4 * 256, 1280), "down"): "64 tiles split 2 ways, 128 units; 4 ways needs two rounds",
    ((4 * 64, 1280), "up"): "80 tiles of 128 columns in one round; 160 of 64 take two",
    ((4 * 64, 1280), "down"): "16 tiles split 8 ways, 128 units; 10 ways needs two rounds",
    ((1000, 320), "up"): "8 row tiles x 10: one round; 64-column tiles need two",
    ((1000, 320), "down"): "16 tiles split 5 ways, one round; 10 ways needs two",
    ((77 * 2, 640), "up"): "154 rows make 2 row tiles: 80 tiles of 64 columns",
    ((77 * 2, 640), "down"): "2 row tiles x 4 split 10 ways, 80 units, one round",
    ((300, 1280), "up"): "3 row tiles x 40: one round; 64-column tiles need two",
    ((300, 1280), "down"): "24 tiles split 5 ways, 120 units; 8 ways needs two rounds",
    ((2 * 4096, 320), "down"): "128 tiles of K = 1280; a split of 2 gives 256 units, two "
                               "rounds of half the work each",
    ((2 * 1024, 640), "down"): "64 tiles split 2 ways, 128 units; 4 ways needs two rounds",
    ((2 * 256, 1280), "down"): "32 tiles split 4 ways, 128 units; 5 ways needs two rounds",
    ((2 * 64, 1280), "up"): "one row tile: 80 tiles of 64 columns, the narrowest up tile",
    ((2 * 64, 1280), "down"): "8 tiles split 16 ways, 128 units; 20 ways needs two rounds",
}


@pytest.mark.parametrize("rows, c", SHAPES)
def test_every_launch_fills_a_wave_or_says_why_not(rows, c):
    plan = geglu_plan(rows, c, 4 * c)
    for launch, units, grid in (("up", plan.up_units, plan.up_grid),
                                ("down", plan.down_units, plan.down_grid)):
        assert grid == min(units, H100_SMS)
        if units < H100_SMS:
            assert ((rows, c), launch) in UNDER_A_WAVE, f"{launch}: {units} units"
        else:
            assert ((rows, c), launch) not in UNDER_A_WAVE


def test_plan_at_the_sampling_sites():
    """The 8^2 site takes narrow up tiles and a split down product; the
    80.5-GFLOP sites take neither."""
    expect = {(8 * 4096, 320): (128, 1), (8 * 1024, 640): (128, 1), (8 * 256, 1280): (128, 1),
              (8 * 64, 1280): (64, 4)}
    for (rows, c), (bn_up, split) in expect.items():
        plan = geglu_plan(rows, c, 4 * c)
        assert (plan.bn_up, plan.split) == (bn_up, split)


def test_plan_at_the_app_sites():
    """One sample at CFG 2: the split-K deepens as the rows shrink, to 16
    at the 8^2 site's single 128-row tile (one tile a 160-column slice of
    C), and the up launch narrows its tiles to 64 columns from 16^2 down."""
    expect = {(2 * 4096, 320): (128, 1), (2 * 1024, 640): (128, 2),
              (2 * 256, 1280): (64, 4), (2 * 64, 1280): (64, 16)}
    for (rows, c), (bn_up, split) in expect.items():
        plan = geglu_plan(rows, c, 4 * c)
        assert (plan.bn_up, plan.split, plan.bn_down) == (bn_up, split, 160)


@pytest.mark.parametrize("rows, c", SAMPLING + XS + APP)
def test_down_tile_is_the_widest_that_divides_c(rows, c):
    """160 at the SD1.5 widths; 64 at C = 64 and 128 at 128 and 256, where
    160 does not divide C."""
    plan = geglu_plan(rows, c, 4 * c)
    assert plan.bn_down == {64: 64, 128: 128, 256: 128}.get(c, 160)
    assert c in geglu.KERNEL_WIDTHS


def _operands(c, f2, rows=4, w1_shape=None, b1_len=None, w2_shape=None, b2_len=None):
    return (torch.zeros(2, rows, c), torch.zeros(w1_shape or (f2, c)),
            torch.zeros(b1_len or f2), torch.zeros(w2_shape or (c, f2 // 2)),
            torch.zeros(b2_len or c))


@pytest.mark.parametrize("operands, admitted", [
    (_operands(320, 2560), True),
    (_operands(640, 5120), True),
    (_operands(1280, 10240), True),
    (_operands(1280, 10240, rows=1), True),
    (_operands(320, 128), True),            # F = 64: one box
    (_operands(640, 384), True),            # F = 192: no 128-wide up tile
    (_operands(320, 2560 + 64), False),     # F not a multiple of 64
    (_operands(64, 256), True),             # ControlNet-XS's 64^2 width (F = 4C)
    (_operands(32, 256), False),            # the tiny configuration's width
    (_operands(768, 6144), False),          # not an SD1.5 width
    (_operands(320, 2560, w1_shape=(2560, 640)), False),
    (_operands(320, 2560, b1_len=1280), False),
    (_operands(320, 2560, w2_shape=(1280, 320)), False),  # w2 transposed
    (_operands(320, 2560, b2_len=640), False),
])
def test_static_dispatch_admits_what_it_admitted(operands, admitted):
    assert geglu.geglu_shapes_ok(*operands) is admitted


def test_non_cuda_device_raises_before_any_launch():
    """Only CPU tensors take the plain version; any other device takes the
    kernels or raises."""
    args = [t.to("meta", torch.bfloat16) for t in _operands(320, 2560)]
    with pytest.raises(ValueError, match="CUDA"):
        geglu.geglu_ffn(*args)
    assert geglu.geglu_ffn.launches == 0
