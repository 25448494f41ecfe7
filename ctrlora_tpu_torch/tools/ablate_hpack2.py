"""Time kernel B6 (the head-pair skip-max flash forward) with parts of its
work cut out, to see which part bounds it (on the card; it needs nvcc and a
GPU):

    python3 -m ctrlora_tpu_torch.tools.ablate_hpack2 [--json OUT]

Each ablation is a copy of ``csrc/flash_attention_hpack2.cu`` with text
edits, built alone into ``_build/ablate/`` (as ``ablate_flash`` does) and
swapped in for the kernel library while ``flash_attention_hpack2`` runs at
the 64x64 sites' shape [8, 4096, 8, 40]. The edited kernels compute garbage
(that is the point): only the unedited one is held against the plain
version. Prints one JSON line per ablation (median ms of 20 by CUDA events).

- ``full``: the kernel as it is;
- ``no_exp2``: P packed from S itself, no clamp and no exp2;
- ``no_pv``: no PV and row-sum products;
- ``loads_only``: the TMA ring and the barriers, no products, no exp2.
"""

from __future__ import annotations

import json
import sys

from ctrlora_tpu_torch.tools.ablate_flash import build, time_ms

_EXP2 = [("        p[kk][2 * half + r] = as_u32(__floats2bfloat162_rn(fast_exp2(fminf(s[e], 110.f)),\n"
          "                                                           fast_exp2(fminf(s[e + 1], 110.f))));",
          "        p[kk][2 * half + r] = as_u32(__floats2bfloat162_rn(s[e], s[e + 1]));")]
_PV = [("      Gmma<D>::rs(o, pb[kk], gmma_desc(vb + kk * 16 * W * 2, C::BOX));\n"
        "      Gmma<8>::rs(l, pb[kk], ones);\n", "")]
_QK = [("        Gmma<BK>::rs_k(s, qf[kk], gmma_desc(kb + kk * 32, 16), kk > 0);", "        ;")]

ABLATIONS = {
    "full": [],
    "no_exp2": _EXP2,
    "no_pv": _PV,
    "loads_only": _EXP2 + _PV + _QK,
}


def main(argv) -> int:
    import torch

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("ablate_hpack2: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    b, s, h, d = 8, 4096, 8, 40
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    want, _ = fa.flash_attention_hpack2_plain(q, k, v)
    rows = []
    for name, edits in ABLATIONS.items():
        _build._lib = build(name, edits, "flash_attention_hpack2.cu", ("ctrlora_flash_hpack2",))
        got, _ = fa.flash_attention_hpack2(q, k, v)
        torch.cuda.synchronize()
        row = {"ablation": name, "shape": f"[{b}, {s}, {h}, {d}]",
               "ms": time_ms(lambda: fa.flash_attention_hpack2(q, k, v))}
        if name == "full":
            row["max_abs_err_vs_plain"] = (got.float() - want.float()).abs().max().item()
        rows.append(row)
        print(json.dumps(row), flush=True)
    _build._lib = None
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
