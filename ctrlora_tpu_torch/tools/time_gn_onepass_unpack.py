"""Time kernel A2 (the one-pass GroupNorm) and kernel D (the row unpack) per
call and back to back, with their yardsticks (on the card):

    python3 ctrlora_tpu_torch/tools/time_gn_onepass_unpack.py LABEL [--json OUT]

It times whichever ``ctrlora_tpu_torch`` is first on the path, so one tree's
copy of it can time another tree's kernels (``env PYTHONPATH=<tree>``): two
trees compared in turns in one call. Each row is one JSON line with the
median ms of 10 calls by CUDA events (``ms``; below ~0.15 ms this reads the
host's launch time too) and the ms per call of 20 calls queued behind a
sleep kernel between one pair of events (``b2b_ms``). A2 runs at the five
shapes ``gn1=1`` admits on the sampling path (batch 8, bf16), with row and
SiLU and without, beside kernel A (``group_norm``) and, without row and
SiLU, F.group_norm on the same inputs. D runs at one step's block of
one-LoRA sampling (32 rows), with the wrapper's host microseconds per call
(``host_us``) beside its plain version's, and torch.take with a cached
flat index, one PyTorch call that computes the same concatenated rows.
"""

from __future__ import annotations

import json
import sys
import time

# A2's [8, H, W, C] shapes at the sampling path's gn1=1 sites
GN_SHAPES = ((8, 64, 64, 320), (8, 32, 32, 640), (8, 32, 32, 960), (8, 32, 32, 1280),
             (8, 16, 16, 2560))


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    from ctrlora_tpu_torch import configs
    from ctrlora_tpu_torch.models.unet import decoder_plan, encoder_plan
    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import group_norm as gn
    from ctrlora_tpu_torch.ops import unpack_rows as ur

    if not torch.cuda.is_available():
        print("time_gn_onepass_unpack: needs an NVIDIA GPU", file=sys.stderr)
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
    for shape in GN_SHAPES:
        c = shape[-1]
        x = rn(*shape, std=2.0) + 0.5
        sc, bi = rn(c, std=0.1, dt=torch.float32) + 1, rn(c, std=0.1, dt=torch.float32)
        for silu, add in ((True, True), (False, False)):
            args = (x, sc, bi, 32, 1e-5, silu, rn(1, c, std=0.5) if add else None)
            fn = lambda: gn.group_norm_onepass(*args)
            a = lambda: gn.group_norm(*args)
            row = {"tree": label, "kernel": "group_norm_onepass", "shape": list(shape),
                   "silu": silu, "add_row": add, "ms": per_call(fn), "b2b_ms": back_to_back(fn),
                   "kernel_a_b2b_ms": back_to_back(a)}
            if not silu and not add:
                xc, scb, bib = x.permute(0, 3, 1, 2), sc.to(x.dtype), bi.to(x.dtype)
                lib = lambda: F.group_norm(xc, 32, scb, bib, 1e-5)
                row["library_b2b_ms"] = back_to_back(lib)
            print(json.dumps(row), flush=True)
            rows.append(row)
        del x

    ucfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128).unet
    enc = [s.out_ch for s in encoder_plan(ucfg)[0] if s.kind == "res"]
    mid = [encoder_plan(ucfg)[2]] * 2
    sizes = tuple(enc + mid + [s.out_ch for s in decoder_plan(ucfg)] + enc + mid)
    block = rn(len(sizes), max(sizes))
    index = torch.cat([torch.arange(c, device="cuda") + i * block.stride(0)
                       for i, c in enumerate(sizes)])
    fn = lambda: ur.unpack_rows(block, sizes)
    plain = lambda: ur.unpack_rows_plain(block, sizes)
    take = lambda: torch.take(block, index)
    row = {"tree": label, "kernel": "unpack_rows", "shape": [len(sizes), max(sizes)],
           "ms": per_call(fn), "b2b_ms": back_to_back(fn), "host_us": host_us(fn),
           "plain_ms": per_call(plain), "plain_host_us": host_us(plain),
           "library": "torch.take", "library_ms": per_call(take),
           "library_b2b_ms": back_to_back(take), "library_host_us": host_us(take)}
    print(json.dumps(row), flush=True)
    rows.append(row)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
