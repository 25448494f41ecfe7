"""Time the flash backward kernels (B4 dQ, B5 dK/dV) with parts of their work
cut out, to see which part bounds them (on the card; it needs nvcc and a
GPU):

    python3 -m ctrlora_tpu_torch.tools.ablate_flash_bwd [--json OUT]

Each ablation is a copy of ``csrc/flash_attention_bwd.cu`` with text edits,
built alone by nvcc into ``_build/ablate/`` (all at once, in parallel) and
swapped in for the kernel library while both kernels run at the finetune
step's 64x64 site, [4, 8, 4096, 40] (the forward that gives them lse runs on
the real library first). The edited kernels compute garbage (that is the
point): only the unedited one is held against the plain versions. Prints one
JSON line per ablation with each kernel's median ms of 20 by CUDA events.

- ``full``: the kernels as they are;
- ``loads_only``: the TMA ring and the barriers, no products, no P/dS math
  (the bf16 packing stays);
- ``products_only``: the four products, no loads after the first ring, no
  P/dS math (the bf16 packing stays);
- ``math_only``: the P/dS math (exp2 and all) and the bf16 packing, no products,
  no loads;
- ``no_exp2``: everything, with exp2 replaced by its argument;
- ``no_loads``: everything but the loads after the first ring.

Then the split at D = 160 ([4, 8, 256, 160], time per call of 20 queued
back to back): ``d160_split`` (the kernel as it is: the dK/dV kernel's two
warpgroups share 64 keys, one holding dV and one dK) against
``d160_unsplit`` (each warpgroup owns 64 keys and both accumulators, 128
keys a block, as at D = 40 and 80), whose register spills are printed.
"""

from __future__ import annotations

import concurrent.futures
import json
import sys

from ctrlora_tpu_torch.tools.ablate_flash import build, time_ms

SOURCE = "flash_attention_bwd.cu"
ENTRIES = ("ctrlora_flash_bwd_dq", "ctrlora_flash_bwd_dkv")

_LOADS = [("    mbar_expect_tx(&full[s], 2 * T * D * 2 + C::VEC_BYTES);\n",
           "    if (j >= ST) {\n      mbar_arrive(&full[s]);\n      continue;\n    }\n"
           "    mbar_expect_tx(&full[s], 2 * T * D * 2 + C::VEC_BYTES);\n")]
_PRODUCTS = [
    ("Gmma<C::T>::rs_k(s, a1[kk], b1, kk > 0);", "(void)0;"),
    ("Gmma<C::T>::rs_k(dp, a2[kk], b2, kk > 0);", "(void)0;"),
    ("Gmma<C::T>::ss(s, gmma_desc(x1 + off_r, 16), b1, kk > 0);", "(void)0;"),
    ("Gmma<C::T>::ss(dp, gmma_desc(x2 + off_r, 16), b2, kk > 0);", "(void)0;"),
    ("Gmma<D>::rs(acc_p, pf[kk], gmma_desc(y + NB * C::BOX_T + kk * 16 * W * 2, C::BOX_T));",
     "(void)0;"),
    ("Gmma<D>::rs(acc_s, df[kk], gmma_desc(y + kk * 16 * W * 2, C::BOX_T));", "(void)0;"),
]
_MATH = [("        p[c] = fast_exp2(fmaf(s[e], sl2, -le));\n"
           "        if constexpr (S_PROD) ds[c] = p[c] * (dp[e] - (DKV ? dl[c] : dr[r]));",
           "        p[c] = s[e];\n        if constexpr (S_PROD) ds[c] = dp[e];")]
_EXP2 = [("        p[c] = fast_exp2(fmaf(s[e], sl2, -le));",
          "        p[c] = fmaf(s[e], sl2, -le);")]
_UNSPLIT = [("  static constexpr bool SPLIT = DKV && D > 128;",
             "  static constexpr bool SPLIT = false;")]

ABLATIONS = {
    "full": [],
    "loads_only": _PRODUCTS + _MATH,
    "products_only": _MATH + _LOADS,
    "math_only": _LOADS + _PRODUCTS,
    "no_exp2": _EXP2,
    "no_loads": _LOADS,
}


def time_b2b(fn, calls=20) -> float:
    """Device ms per call of fn(), `calls` calls queued behind a sleep
    kernel between one pair of CUDA events (chip_smoke.time_b2b)."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / calls


def main(argv) -> int:
    import torch

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("ablate_flash_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    variants = {**ABLATIONS, "d160_unsplit": _UNSPLIT}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(
            lambda kv: build(f"bwd_{kv[0]}", kv[1], SOURCE, ENTRIES, keep_log=True),
            variants.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (b, h, s, d), names in (((4, 8, 4096, 40), {n: n for n in ABLATIONS}),
                                ((4, 8, 256, 160), {"d160_split": "full",
                                                    "d160_unsplit": "d160_unsplit"})):
        q, k, v, dout = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                         .to(torch.bfloat16) for _ in range(4))
        _build._lib = None
        out, lse = fa.flash_attention(q, k, v)  # the real library
        delta = (out.float() * dout.float()).sum(-1)
        args = (q, k, v, lse, dout, delta, d ** -0.5)
        want = (fa.flash_attention_bwd_dq_plain(*args), *fa.flash_attention_bwd_dkv_plain(*args))
        timer = time_ms if d == 40 else time_b2b
        for name, variant in names.items():
            lib, log = libs[variant]
            _build._lib = lib
            got = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
            torch.cuda.synchronize()
            row = {"ablation": name, "shape": [b, h, s, d],
                   "dq_ms": timer(lambda: fa.flash_attention_bwd_dq(*args)),
                   "dkv_ms": timer(lambda: fa.flash_attention_bwd_dkv(*args)),
                   "spills": _build.spilling_kernels(report=log)}
            if name in ("full", "d160_split", "d160_unsplit"):
                row["rel_l2_vs_plain"] = [((g.float() - w.float()).norm() / w.float().norm())
                                          .item() for g, w in zip(got, want)]
            rows.append(row)
    _build._lib = None
    for row in rows:
        print(json.dumps(row), flush=True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
