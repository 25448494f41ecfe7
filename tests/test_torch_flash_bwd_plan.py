"""The host side of the flash backward kernels (B4 dQ, B5 dK/dV) on the CPU.

``flash_bwd_plan`` mirrors the tiling of ``csrc/flash_attention_bwd.cu``
(chip_smoke.py holds it against the C side's own report on the card): at
every instantiated head dim the block fits the H100's 232,448 bytes of
shared memory, the grid covers both sequences exactly, and every TMA box and
operand stride is a multiple of 16 bytes in the BHSD, BSHD and fused-qkv
layouts alike. A head dim without an instantiation raises on a non-CPU
tensor before any launch and takes the plain version on the CPU. The head
dims include ControlNet-XS's 8, 16 and 32 (rows of 16 to 64 bytes, one tail
box each). The kernels themselves run only on the card.
"""

import numpy as np
import pytest
import torch

from ctrlora_tpu_torch.ops import flash_attention as fa

H100_SMEM = 232448
# (B, H, S, D) of the finetune step's three sites at batch 4, 512^2, and of
# ControlNet-XS's control stream (8 heads of 8/16/32) at the same batch
SITES = [(4, 8, 4096, 40), (4, 8, 1024, 80), (4, 8, 256, 160)]
XS_SITES = [(4, 8, 4096, 8), (4, 8, 1024, 16), (4, 8, 256, 32)]
KINDS = [True, False]  # dK/dV, dQ


@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dkv", KINDS)
def test_plan_fits_shared_memory(d, dkv):
    plan = fa.flash_bwd_plan(d, dkv)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.stages >= 3  # a consumer waits for tile j+1 before freeing tile j-1
    # the owned rows and the ring, in 64-column boxes of 128-byte rows
    boxes = -(-d // fa.TMA_BOX)
    assert plan.smem_bytes >= 2 * boxes * 128 * (plan.rows + plan.stages * plan.tile)


@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dkv", KINDS)
def test_warpgroups_cover_the_owned_rows(d, dkv):
    """Each of the two consumer warpgroups owns 64 rows, except where dK
    and dV split over them (D = 160): then both share the block's 64."""
    plan = fa.flash_bwd_plan(d, dkv)
    assert plan.split == (dkv and d == 160)
    assert plan.rows == (64 if plan.split else 2 * 64)


@pytest.mark.parametrize("b, h, s, d", SITES + [(1, 2, 384, 40), (2, 1, 640, 80)] + XS_SITES)
@pytest.mark.parametrize("dkv", KINDS)
def test_grid_covers_both_sequences(b, h, s, d, dkv):
    plan = fa.flash_bwd_plan(d, dkv)
    blocks, bh = plan.grid(b, h, s)
    assert bh == b * h
    owned = np.zeros(s, int)
    for blk in range(blocks):
        owned[blk * plan.rows:(blk + 1) * plan.rows] += 1
    assert (owned == 1).all()
    assert s % plan.tile == 0  # every block walks the other sequence in whole tiles
    assert s % fa.BWD_SEQ_MULTIPLE == 0


def _layouts(b, h, s, d):
    """q, k, v, dout as the three callers hand them over: [B, H, S, D] views."""
    bhsd = [torch.empty(b, h, s, d, device="meta") for _ in range(4)]
    bshd = [torch.empty(b, s, h, d, device="meta").transpose(1, 2) for _ in range(4)]
    qkv = torch.empty(b, s, 3 * h * d, device="meta")
    fused = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
    fused.append(torch.empty(b, s, h, d, device="meta").transpose(1, 2))
    return {"bhsd": bhsd, "bshd": bshd, "qkv": fused}


@pytest.mark.parametrize("b, h, s, d", SITES + XS_SITES)
@pytest.mark.parametrize("layout", ["bhsd", "bshd", "qkv"])
def test_tma_boxes_and_strides_are_16_byte_multiples(b, h, s, d, layout):
    for width in fa.tma_box_widths(d) + (fa.TMA_BOX,):  # streamed boxes; owned rows
        assert width * 2 % 16 == 0 and 0 < width <= fa.TMA_BOX
    assert sum(fa.tma_box_widths(d)) == d
    strides = list(fa._strides(_layouts(b, h, s, d)[layout]))
    assert len(strides) == 12
    assert all(st * 2 % 16 == 0 for st in strides), strides


@pytest.mark.parametrize("d", [48, 64, 128, 512])
def test_other_head_dims_have_no_plan(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_bwd_plan(d, True)


@pytest.mark.parametrize("d", [48, 64])
def test_other_head_dims_raise_off_the_cpu(d):
    q, k, v, dout = (torch.empty(1, 2, 256, d, device="meta", dtype=torch.bfloat16)
                     for _ in range(4))
    lse, delta = (torch.empty(1, 2, 256, device="meta") for _ in range(2))
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_bwd_dq(q, k, v, lse, dout, delta, d ** -0.5)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_bwd_dkv(q, k, v, lse, dout, delta, d ** -0.5)
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == before


def test_untiled_sequences_raise_off_the_cpu():
    q, k, v, dout = (torch.empty(1, 2, 320, 40, device="meta", dtype=torch.bfloat16)
                     for _ in range(4))
    lse, delta = (torch.empty(1, 2, 320, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="multiples of 128"):
        fa.flash_attention_bwd_dkv(q, k, v, lse, dout, delta, 40 ** -0.5)


@pytest.mark.parametrize("d", [32, 64, 40, 8])
def test_cpu_tensors_take_the_plain_version_at_any_head_dim(d):
    rng = np.random.default_rng(d)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(1, 2, 96, d)).astype(np.float32))
                     for _ in range(4))
    out, lse = fa.attention_plain(q, k, v)
    delta = (out * dout).sum(-1)
    args = (q, k, v, lse, dout, delta, d ** -0.5)
    torch.testing.assert_close(fa.flash_attention_bwd_dq(*args),
                               fa.flash_attention_bwd_dq_plain(*args))
    for got, want in zip(fa.flash_attention_bwd_dkv(*args),
                         fa.flash_attention_bwd_dkv_plain(*args)):
        torch.testing.assert_close(got, want)
    assert fa.flash_attention_bwd_dq.launches == fa.flash_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("b, h, s, d", XS_SITES)
def test_xs_head_dims_have_plans_like_the_narrowest_finetune_site(b, h, s, d):
    """D = 8/16/32 tile as D = 40 does: 64-row streamed tiles, 128 owned
    rows, no split, one box a row; the fused projection's heads are D
    apart."""
    for dkv in KINDS:
        plan = fa.flash_bwd_plan(d, dkv)
        assert (plan.rows, plan.tile, plan.split) == (128, 64, False)
        assert plan == fa.flash_bwd_plan(40, dkv)
    assert fa.tma_box_widths(d) == (d,)
    assert fa.flash_kernel_ok((torch.bfloat16,) * 3, s, s, d, grad=True)
