"""Arithmetic the per-layer metric readers share (``benchmark/metrics/``)."""

from __future__ import annotations

from typing import Optional

from benchmark import work

# span kind -> (flops, bytes) of one call from its recorded shape
WORK = {
    "attn_fwd": lambda b, h, sq, sk, d, isz: work.flash_forward_work(b, h, sq, sk, d, isz),
    "attn_bwd": lambda b, h, sq, sk, d, isz: tuple(
        x + y for x, y in zip(work.flash_bwd_dq_work(b, h, sq, sk, d, isz),
                              work.flash_bwd_dkv_work(b, h, sq, sk, d, isz))),
    "geglu": lambda rows, c, f, isz: work.geglu_ffn_work(rows, c, f, isz, isz),
}


def roofline_share(trace, kind: str) -> Optional[float]:
    """100 x the least time of every call of the spans of `kind` over the
    device time launched inside them; None where no such span ran or none
    launched device work."""
    least, device = 0.0, 0.0
    for shape, calls, dev_s in trace.spans_of(kind):
        least += calls * work.least_seconds(*WORK[kind](*shape))
        device += dev_s
    if device <= 0.0:
        return None
    return 100.0 * least / device


def peak_share(ctx) -> Optional[float]:
    """100 x the reference's FLOPs of the traced work over the seconds the
    same work took untraced, at the card's bf16 peak."""
    seconds = ctx.units.get("untraced_s", 0.0)
    if not ctx.flops or seconds <= 0:
        return None
    return 100.0 * ctx.flops / seconds / work.PEAK_BF16_FLOPS


def idle_share(ctx) -> Optional[float]:
    """100 x the share of the untraced run of the work in which no device
    operation ran: its seconds less the device's busy seconds over the
    same work (from the pass that records the device alone; tracing
    slows the host, not the kernels), over its seconds."""
    seconds, busy = ctx.units.get("untraced_s", 0.0), ctx.trace.busy_s
    if seconds <= 0 or busy <= 0:
        return None
    return 100.0 * max(0.0, seconds - busy) / seconds
