"""Kernel B6's tiling on the CPU (no GPU, nvcc or Triton).

``hpack2_plan`` mirrors ``Hp2Cfg`` in ``csrc/flash_attention_hpack2.cu``
(chip_smoke.py holds it against the C side's report on the card): at D = 8,
16, 32 (ControlNet-XS's control stream), 40 and 64 the block fits the H100's shared memory, the consumers' registers fit
what the producer hands over and hold their fragments, the grid deals every
64-row query tile of both heads of every pair to one warpgroup, and each
head's TMA box is a whole number of 16-byte units within a 128-byte row.
Head dims without an instantiation raise; the dispatch rule sends only
instantiated head dims to B6.
"""

import pytest
import torch

from ctrlora_tpu_torch.ops import flash_attention as fa
from ctrlora_tpu_torch.ops import kernel_flags

H100_SMEM = 232448
H100_REGS = 65536  # 32-bit registers of one SM


@pytest.mark.parametrize("d", fa.HPACK2_HEAD_DIMS)
def test_plan_fits_shared_memory(d):
    plan = fa.hpack2_plan(d)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.stages >= 3
    # the ring holds K and V of both heads, four boxes of 128-byte rows
    assert plan.smem_bytes >= plan.stages * 4 * plan.keys * 128
    assert len(plan.as_list()) == 5


@pytest.mark.parametrize("d", fa.HPACK2_HEAD_DIMS)
def test_plan_fits_the_register_file(d):
    """The producer warpgroup keeps 24 registers a thread and the consumers
    take what the block got at launch; their fragments (S, two P buffers, O,
    the row sums, q) leave room for addresses and counters."""
    plan = fa.hpack2_plan(d)
    launch = H100_REGS // plan.threads // 8 * 8
    assert plan.consumers * 128 * plan.regs + 128 * 24 <= plan.threads * launch
    assert plan.regs <= 255
    assert plan.frag_regs + 24 <= plan.regs


@pytest.mark.parametrize("b, s, h, d", [(8, 4096, 8, 40), (4, 4096, 8, 40), (8, 1024, 8, 64),
                                        (1, 128, 2, 40), (2, 384, 4, 64), (8, 4096, 8, 8),
                                        (8, 1024, 8, 16), (8, 256, 8, 32), (4, 256, 8, 32)])
def test_grid_deals_every_query_tile_once(b, s, h, d):
    plan = fa.hpack2_plan(d)
    blocks, pairs = plan.grid(b, h, s)
    assert pairs == b * h // 2
    tiles = 2 * s // plan.rows  # 64-row tiles of the pair's two heads
    owner = [0] * tiles
    for x in range(blocks):
        for c in range(plan.consumers):
            t = x * plan.consumers + c
            if t < tiles:
                owner[t] += 1
    assert owner == [1] * tiles
    assert (blocks - 1) * plan.consumers < tiles
    assert s % (2 * plan.keys) == 0  # the loop walks key tiles two at a time


@pytest.mark.parametrize("d", fa.HPACK2_HEAD_DIMS)
def test_each_heads_box_is_whole_16_byte_units(d):
    assert d * 2 % 16 == 0 and d * 2 <= 128  # one box of D columns per head
    assert 2 * d <= 128  # the pair's row


@pytest.mark.parametrize("d", [24, 48, 80, 128])
def test_other_head_dims_raise(d):
    with pytest.raises(ValueError):
        fa.hpack2_plan(d)


def test_dispatch_sends_only_instantiated_head_dims_to_b6():
    with kernel_flags.override(head_pack=2):
        for d in fa.FORWARD_HEAD_DIMS:
            if fa._hpack_ok(8, d) and fa.flash_kernel_ok((torch.bfloat16,) * 3, 4096, 4096, d):
                assert d in fa.HPACK2_HEAD_DIMS


def test_non_cuda_device_raises_before_any_launch():
    q = torch.empty(2, 256, 4, 40, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_hpack2(q, q, q)
