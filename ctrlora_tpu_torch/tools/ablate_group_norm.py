"""Time kernel A (the one-launch GroupNorm) against variants of its design
(on the card; it needs nvcc and a GPU):

    python3 -m ctrlora_tpu_torch.tools.ablate_group_norm [--json OUT]

Each variant is a copy of ``csrc/group_norm.cu`` with text edits, built
alone into ``_build/ablate/`` (as ``ablate_flash`` does) and swapped in for
the kernel library while ``group_norm`` runs at the sampling path's sites.
Every variant computes the same function: each is held against the plain
version. Prints one JSON line per variant and shape (ms per call of 20
calls queued back to back, as ``chip_smoke.time_b2b``), with the plan the
variant's C side chose.

- ``full``: the kernel as it is;
- ``reread``: never staged: every block reads its rows a second time;
- ``threads512``: 512 threads a block instead of 256;
- ``ahead5``: five chunks in flight instead of three (a ring of six);
- ``silu_exp``: the bf16 SiLU by exp and a divide (two MUFU ops), not tanh.
"""

from __future__ import annotations

import ctypes
import json
import sys

from ctrlora_tpu_torch.tools.ablate_flash import build, time_b2b

ABLATIONS = {
    "full": [],
    "reread": [("(units * k >= target || k == kMaxCluster) && bytes <= kSmemLimit",
                "(units * k >= target || k == kMaxCluster) && bytes < 0")],
    "threads512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "ahead5": [("constexpr int kRing = 4; ", "constexpr int kRing = 6; "),
               ("constexpr int kAhead = 3; ", "constexpr int kAhead = 5; ")],
    "silu_exp": [("  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(t) : \"f\"(0.5f * v));\n"
                  "  return 0.5f * v * (1.f + t);",
                  "  t = 0.f;\n  return __fdividef(v, 1.f + __expf(-v)) + t;")],
}
ENTRIES = ("ctrlora_group_norm", "ctrlora_group_norm_config")
# (shape, SiLU, add_row) at the sampling path's sites, the decoder's widest
# concat sites, the finetune batch's 64^2 site and the VAE at 512^2
CASES = (((8, 64, 64, 320), True, True), ((8, 64, 64, 320), False, False),
         ((8, 32, 32, 640), True, True), ((8, 16, 16, 1280), True, True),
         ((8, 64, 64, 960), True, False), ((8, 32, 32, 1920), True, False),
         ((4, 64, 64, 320), True, True), ((4, 512, 512, 128), True, False))


def main(argv) -> int:
    import torch

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import group_norm as gn

    if not torch.cuda.is_available():
        print("ablate_group_norm: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0, dt=torch.bfloat16: (
        torch.randn(s, generator=gen, device="cuda") * std).to(dt)
    cases = []
    for shape, silu, row in CASES:
        c = shape[-1]
        args = (rn(*shape, std=2.0) + 0.5, rn(c, std=0.1, dt=torch.float32) + 1,
                rn(c, std=0.1, dt=torch.float32), 32, 1e-5, silu,
                rn(1, c, std=0.5) if row else None)
        cases.append((shape, silu, row, args))

    out = []
    for name, edits in ABLATIONS.items():
        lib = build(f"gn_{name}", edits, "group_norm.cu", ENTRIES)
        _build._lib = lib
        for shape, silu, row, args in cases:
            got = gn.group_norm(*args)
            err = (got.float() - gn.group_norm_plain(*args).float()).abs().max().item()
            plan = (ctypes.c_int * 9)()
            _build.check(lib.ctrlora_group_norm_config(
                shape[0], shape[1] * shape[2], shape[-1], 32, 2, sms, plan), "config")
            res = {"ablation": name, "shape": list(shape), "silu": silu, "add_row": row,
                   "b2b_ms": time_b2b(lambda: gn.group_norm(*args)), "max_abs_err_vs_plain": err,
                   "cluster": plan[0], "staged": plan[3], "smem": plan[4]}
            out.append(res)
            print(json.dumps(res), flush=True)
    _build._lib = None
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
