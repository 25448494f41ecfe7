"""The yardstick's frozen arithmetic: the chip's peaks and the operations
and bytes of each kernel's function, from the shapes of one call.

The work counts are copies of ``flash_forward_work``,
``flash_bwd_dq_work`` and ``flash_bwd_dkv_work`` in
``ctrlora_tpu_torch/ops/flash_attention.py`` and of ``geglu_ffn_work`` in
``ctrlora_tpu_torch/ops/geglu_ffn.py`` at commit a86232d, frozen here so
that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

# one NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def flash_forward_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int = 2) -> tuple:
    """(flops, bytes) of the forward: the two products, 4*B*H*Sq*Sk*D;
    q, k, v read once, out and the fp32 lse written once."""
    return (4 * b * h * sq * sk * d,
            b * h * ((2 * sq + 2 * sk) * d * itemsize + sq * 4))


def flash_bwd_dq_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int = 2) -> tuple:
    """(flops, bytes) of dQ: S = QK^T, dP = dO V^T and dS K, 6*B*H*Sq*Sk*D;
    q, k, v, dO, lse and Delta read once, dQ written once."""
    return (6 * b * h * sq * sk * d,
            b * h * ((3 * sq + 2 * sk) * d * itemsize + 2 * sq * 4))


def flash_bwd_dkv_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int = 2) -> tuple:
    """(flops, bytes) of dK/dV: S, dP, P^T dO and dS^T Q, 8*B*H*Sq*Sk*D;
    q, k, v, dO, lse and Delta read once, dK and dV written once."""
    return (8 * b * h * sq * sk * d,
            b * h * ((2 * sq + 4 * sk) * d * itemsize + 2 * sq * 4))


def geglu_ffn_work(rows: int, c: int, f: int, itemsize: int = 2,
                   weight_itemsize: int = 2) -> tuple:
    """(flops, bytes) the function needs: both projections (2*rows*C*2F and
    2*rows*F*C); x and the weights and biases read once, y written once."""
    flops = 2 * rows * c * 2 * f + 2 * rows * f * c
    weights = (2 * f * c + 2 * f + c * f + c) * weight_itemsize
    return flops, 2 * rows * c * itemsize + weights


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
