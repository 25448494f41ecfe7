"""Time the flash backward kernels (B4 dQ, B5 dK/dV) at the finetune step's
three sites, per call and back to back (on the card):

    python3 ctrlora_tpu_torch/tools/time_flash_bwd.py LABEL [--json OUT]

It times whichever ``ctrlora_tpu_torch`` is first on the path, so one tree's
copy of it can time another tree's kernels (``env PYTHONPATH=<tree>``): two
trees compared in turns in one call. For [4, 8, S, D] = [4, 8, 4096, 40],
[4, 8, 1024, 80] and [4, 8, 256, 160] (seeded bf16 inputs, lse from the
forward kernel) it prints one JSON line with each kernel's median ms of 10
calls by CUDA events (``ms``; below ~0.15 ms this reads the host's launch
time too) and the ms per call of 20 calls queued behind a sleep kernel
between one pair of events (``b2b_ms``; ``chip_smoke.time_b2b``).
"""

from __future__ import annotations

import json
import sys

SHAPES = ((4, 8, 4096, 40), (4, 8, 1024, 80), (4, 8, 256, 160))


def main(argv) -> int:
    import torch

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_flash_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    label = argv[0] if argv and not argv[0].startswith("--") else "tree"
    _build.cuda_lib()

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, s, d in SHAPES:
        q, k, v, dout = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                         .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention(q, k, v)
        delta = (out.float() * dout.float()).sum(-1)
        args = (q, k, v, lse, dout, delta, d ** -0.5)
        row = {"tree": label, "shape": [b, h, s, d]}
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            fn = getattr(fa, name)
            row[name] = {"ms": per_call(lambda: fn(*args)),
                         "b2b_ms": back_to_back(lambda: fn(*args))}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
