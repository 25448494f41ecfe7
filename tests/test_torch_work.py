"""The work counts beside each kernel wrapper of the port, and the bound that
chip_smoke.py computes from them, at the main path's shapes against hand
numbers: forward attention 4*B*H*Sq*Sk*D flops, dQ 6x and dK/dV 8x the
product B*H*Sq*Sk*D, GEGLU 2*rows*C*2F + 2*rows*F*C, GroupNorm and the row
unpack bytes only (each input read once, each output written once). The
bound is the larger of flops over 989 TFLOP/s and bytes over 3.35 TB/s
(the H100 SXM's published dense bf16 and HBM rates).
"""

import pytest

import chip_smoke
from ctrlora_tpu_torch.ops import flash_attention as fa
from ctrlora_tpu_torch.ops import geglu_ffn as geglu
from ctrlora_tpu_torch.ops import group_norm as gn
from ctrlora_tpu_torch.ops import unpack_rows as unpack

GB = 1e9
MB = 1e6

# kernel -> (work, hand flops, hand bytes, hand bound ms, bound by)
CASES = {
    # [8, 4096, 3*8*40]: 4 * 8 * 8 * 4096^2 * 40
    "flash_attention_qkv": (fa.flash_forward_work(8, 8, 4096, 4096, 40),
                            171.8 * GB, 84.9 * MB, 0.1737, "operations"),
    # the VAE's [4, 1, 4096, 512]
    "flash_attention": (fa.flash_forward_work(4, 1, 4096, 4096, 512),
                        137.4 * GB, 67.2 * MB, 0.1390, "operations"),
    # [4, 4096, 8, 40]: half the qkv site's batch
    "flash_attention_bshd": (fa.flash_forward_work(4, 8, 4096, 4096, 40),
                             85.9 * GB, 42.5 * MB, 0.0869, "operations"),
    "flash_attention_hpack2": (fa.flash_forward_work(8, 8, 4096, 4096, 40),
                               171.8 * GB, 84.9 * MB, 0.1737, "operations"),
    # [4, 8, 4096, 40]: 6 and 8 times 4 * 8 * 4096^2 * 40
    "flash_attention_bwd_dq": (fa.flash_bwd_dq_work(4, 8, 4096, 4096, 40),
                               128.8 * GB, 53.5 * MB, 0.1303, "operations"),
    "flash_attention_bwd_dkv": (fa.flash_bwd_dkv_work(4, 8, 4096, 4096, 40),
                                171.8 * GB, 64.0 * MB, 0.1737, "operations"),
    # C = 320, rows 8 * 4096, F = 1280
    "geglu_ffn": (geglu.geglu_ffn_work(8 * 4096, 320, 1280),
                  80.5 * GB, 44.4 * MB, 0.0814, "operations"),
    # [8, 64, 64, 320] bf16 with one added row: x read, y written
    "group_norm": (gn.group_norm_work(8, 4096, 320, row_rows=1),
                   0.0, 41.9 * MB, 0.01252, "bytes"),
    "group_norm_onepass": (gn.group_norm_work(8, 4096, 320, row_rows=8),
                           0.0, 41.9 * MB, 0.01252, "bytes"),
    # the 32 emb_proj rows of one DDIM step, 1280 wide at most
    "unpack_rows": (unpack.unpack_rows_work([1280] * 32),
                    0.0, 0.164 * MB, 4.9e-5, "bytes"),
}


def test_every_kernel_has_a_case():
    assert set(CASES) == set(chip_smoke.KERNELS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_work_and_bound_match_hand_numbers(name):
    (flops, nbytes), hand_flops, hand_bytes, hand_ms, by = CASES[name]
    assert flops == pytest.approx(hand_flops, rel=2e-3, abs=0)
    assert nbytes == pytest.approx(hand_bytes, rel=5e-3)
    ms, bound_by = chip_smoke.bound_ms(flops, nbytes)
    assert ms == pytest.approx(hand_ms, rel=5e-3)
    assert bound_by == by


@pytest.mark.parametrize("c", [320, 640, 1280])
def test_geglu_work_is_the_same_at_every_width(c):
    """Each halving of the latent side doubles C: rows * C^2 is the same at
    the 64^2, 32^2 and 16^2 sites, 80.5 GFLOP each."""
    rows = 8 * 4096 * 320 ** 2 // c ** 2
    assert geglu.geglu_ffn_work(rows, c, 4 * c)[0] == pytest.approx(80.5 * GB, rel=2e-3)
