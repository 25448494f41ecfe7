"""Time kernel A (GroupNorm) and kernel B6 (the head-pair flash forward) per
call and back to back, with their library yardsticks (on the card):

    python3 ctrlora_tpu_torch/tools/time_gn_hpack2.py LABEL [--json OUT]

It times whichever ``ctrlora_tpu_torch`` is first on the path, so one tree's
copy of it can time another tree's kernels (``env PYTHONPATH=<tree>``): two
trees compared in turns in one call. Each row is one JSON line with the
median ms of 10 calls by CUDA events (``ms``; below ~0.15 ms this reads the
host's launch time too), the ms per call of 20 calls queued behind a sleep
kernel between one pair of events (``b2b_ms``), and for GroupNorm the
wrapper's host microseconds per call at the 8x8 site (``host_us``: the time
to issue it, the step being host-bound). Yardsticks in the same rows:
F.group_norm where there is no row and no SiLU, and for B6
F.scaled_dot_product_attention and kernel B's BSHD entry on the same
inputs.
"""

from __future__ import annotations

import json
import sys
import time

# (shape, SiLU, add_row) at the sampling path's busiest GroupNorm sites
GN_CASES = (((8, 64, 64, 320), True, True), ((8, 64, 64, 320), False, False),
            ((8, 32, 32, 640), True, True), ((8, 16, 16, 1280), True, True),
            ((8, 8, 8, 1280), True, True), ((4, 64, 64, 320), True, True))
HPACK2_CASES = ((8, 4096, 8, 40),)


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import flash_attention as fa
    from ctrlora_tpu_torch.ops import group_norm as gn

    if not torch.cuda.is_available():
        print("time_gn_hpack2: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    label = argv[0] if argv and not argv[0].startswith("--") else "tree"
    _build.cuda_lib()

    # self-contained (no helper of the package): the package on the path may
    # be another tree's, older than these tools
    def per_call(fn, n=10):
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(n):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in events)
        return times[len(times) // 2]

    def back_to_back(fn, n=20):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        spent = time.perf_counter() - t0
        torch.cuda.synchronize()
        return spent / n * 1e6

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0, dt=torch.bfloat16: (
        torch.randn(s, generator=gen, device="cuda") * std).to(dt)
    rows = []
    for shape, silu, add in GN_CASES:
        c = shape[-1]
        x = rn(*shape, std=2.0) + 0.5
        sc, bi = rn(c, std=0.1, dt=torch.float32) + 1, rn(c, std=0.1, dt=torch.float32)
        args = (x, sc, bi, 32, 1e-5, silu, rn(1, c, std=0.5) if add else None)
        fn = lambda: gn.group_norm(*args)
        row = {"tree": label, "kernel": "group_norm", "shape": list(shape), "silu": silu,
               "add_row": add, "ms": per_call(fn), "b2b_ms": back_to_back(fn)}
        if not silu and not add:
            xc, scb, bib = x.permute(0, 3, 1, 2), sc.to(x.dtype), bi.to(x.dtype)
            lib = lambda: F.group_norm(xc, 32, scb, bib, 1e-5)
            row.update(library_ms=per_call(lib), library_b2b_ms=back_to_back(lib))
        if shape[1] == 8:
            row["host_us"] = host_us(fn)
        print(json.dumps(row), flush=True)
        rows.append(row)
    for b, s, h, d in HPACK2_CASES:
        q, k, v = (rn(b, s, h, d) for _ in range(3))
        fn = lambda: fa.flash_attention_hpack2(q, k, v)
        bshd = lambda: fa.flash_attention_bshd(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        row = {"tree": label, "kernel": "flash_attention_hpack2", "shape": [b, s, h, d],
               "ms": per_call(fn), "b2b_ms": back_to_back(fn), "bshd_ms": per_call(bshd),
               "bshd_b2b_ms": back_to_back(bshd), "library_ms": per_call(sdpa),
               "library_b2b_ms": back_to_back(sdpa)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
