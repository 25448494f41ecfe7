"""Time kernel C's up launch (``ctrlora_geglu_up``: x W1, the gate, the h
store) with parts of its work cut out, to see which part bounds it (on the
card; it needs nvcc and a GPU):

    python3 -m ctrlora_tpu_torch.tools.ablate_geglu [--json OUT]

Each ablation is a copy of ``csrc/geglu_ffn.cu`` with text edits, built
alone into ``_build/ablate/`` (as ``ablate_flash`` does) and swapped in for
the kernel library while the up launch runs at the sampling sites' shapes
under their plans.
The edited kernels compute garbage (that is the point): only the unedited
one is held against the plain version. Prints one JSON line per ablation
and shape (median ms of 20 by CUDA events).

- ``full``: the kernel as it is;
- ``no_erf``: the gate without its erf (g stands in for erf(g / sqrt 2));
- ``no_gate``: h = a * g, no erf, no bf16 rounding of the factors;
- ``no_store``: the gate computed into shared memory, h never stored;
- ``products_only``: the loads and products; the epilogue only sums the
  accumulator (so that the products stay live), no gate, no store;
- ``loads_only``: the TMA ring and the barriers, no products, no gate.
"""

from __future__ import annotations

import json
import sys

from ctrlora_tpu_torch.tools.ablate_flash import build, time_ms

_ERF = [("erf_as(gv * 0.70710678118654752f)", "gv")]
_GATE = [("        v[e] = round_bf16(av) * round_bf16(0.5f * gv * (1.f + erf_as(gv * "
          "0.70710678118654752f)));", "        v[e] = av * gv;")]
_STORE = [("tma_store_2d(&th,", "if (rows < 0) tma_store_2d(&th,")]
# the gate replaced by a sum of the accumulator, stored once to shared
# memory so that the products stay live
_EPILOGUE = [("                                             int F, int n0, uint32_t slot) {\n",
              "                                             int F, int n0, uint32_t slot) {\n"
              "  float sink = 0.f;\n  for (int i = 0; i < BN; ++i) sink += d[i];\n"
              "  asm volatile(\"st.shared.f32 [%0], %1;\" ::\"r\"(slot), \"f\"(sink));\n"
              "  return;\n")]
_PRODUCTS = [("      Gmma<N>::ss(d, gmma_desc(a + s * STAGE + kk * 32, 16), gmma_desc(b + s * STAGE "
              "+ kk * 32, 16),\n                  kb > 0 || kk > 0);", "      ;"),
]

ABLATIONS = {
    "full": [],
    "no_erf": _ERF,
    "no_gate": _GATE,
    "no_store": _STORE,
    "products_only": _EPILOGUE,
    "loads_only": _EPILOGUE + _PRODUCTS,
}
ENTRIES = ("ctrlora_geglu_up", "ctrlora_geglu_down")


def main(argv) -> int:
    import torch

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import geglu_ffn as geglu

    if not torch.cuda.is_available():
        print("ablate_geglu: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: (torch.randn(s, generator=gen, device="cuda") * std).to(
        torch.bfloat16)
    cases = []
    for rows, c in ((8 * 4096, 320), (8 * 1024, 640), (8 * 256, 1280), (8 * 64, 1280)):
        f = 4 * c
        args = (rn(rows, c), rn(2 * f, c, std=c ** -0.5), rn(2 * f, std=0.1),
                rn(c, f, std=f ** -0.5), rn(c, std=0.1))
        h = torch.empty((rows, f), dtype=torch.bfloat16, device="cuda")
        plan = geglu.geglu_plan(rows, c, f, sms)
        cases.append((f"rows={rows} C={c} bn_up={plan.bn_up}", args, h, plan))
    out = []
    for name, edits in ABLATIONS.items():
        _build._lib = build(name, edits, "geglu_ffn.cu", ENTRIES)
        for label, (x, w1, b1, w2, b2), h, plan in cases:
            row = {"ablation": name, "shape": label,
                   "up_ms": time_ms(lambda: geglu.launch_up(x, w1, b1, h, plan))}
            if name == "full":
                got = geglu.geglu_ffn(x, w1, b1, w2, b2)
                want = geglu.geglu_ffn_plain(x, w1, b1, w2, b2)
                row["max_abs_err_vs_plain"] = (got.float() - want.float()).abs().max().item()
            out.append(row)
            print(json.dumps(row), flush=True)
    _build._lib = None
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
