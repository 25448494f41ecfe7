"""Time the D <= 160 flash forward with parts of its work cut out, to see
which part bounds it (on the card; it needs nvcc and a GPU):

    python3 -m ctrlora_tpu_torch.tools.ablate_flash [--json OUT]

Each ablation is a copy of ``csrc/flash_attention.cu`` with text edits,
built alone by nvcc into ``_build/ablate/`` and swapped in for the kernel
library while ``flash_attention_qkv`` runs at the 64x64 sites' shape
[8, 4096, 3*8*40]. The edited kernels compute garbage (that is the point):
only the unedited one is held against the plain version. Prints one JSON
line per ablation (median ms of 20 by CUDA events); chip_smoke.py's phase 3
times the library yardstick at the same shape.

- ``full``: the kernel as it is;
- ``loads_only``: the TMA ring and the barriers, no products, no softmax;
- ``products_only``: the QK and PV products, no loads after the first
  ring, no softmax;
- ``softmax_only``: the softmax, no products, no loads;
- ``no_loads``: everything but the loads.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

_SOFTMAX = [("      softmax_exp<BK>(s, m, alpha, scale_log2);\n", ""),
            ("    softmax_pack<BK, false>(s, p, o, l, alpha);\n", "")]
_LOADS = [("    mbar_expect_tx(&full[s], 2 * BK * D * 2);\n",
           "    if (j >= ST) {\n      mbar_arrive(&full[s]);\n      continue;\n    }\n"
           "    mbar_expect_tx(&full[s], 2 * BK * D * 2);\n")]
_QK = [("        Gmma<BK>::ss(s, gmma_desc(q_rows + off, 16), gmma_desc(kb + koff, 16), kk > 0);",
        "        ;")]
_PV = [("        Gmma<NPV>::rs(o, p[kk], gmma_desc(vb + kk * 16 * W * 2, C::BOX_KV));", "        ;")]

ABLATIONS = {
    "full": [],
    "loads_only": _SOFTMAX + _QK + _PV,
    "products_only": _SOFTMAX + _LOADS,
    "softmax_only": _LOADS + _QK + _PV,
    "no_loads": _LOADS,
}


def build(name: str, edits, source: str = "flash_attention.cu",
          entries=("ctrlora_flash_fwd",), keep_log: bool = False):
    """`source` with `edits` applied, built alone into _build/ablate/, with
    the argument types of its C `entries` set; with `keep_log`, returns
    (library, nvcc's output, ptxas's report included)."""
    from ctrlora_tpu_torch.ops import _build

    src = (_build.CSRC / source).read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablation {name}: the source no longer holds {old.strip()!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                          "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"ablation {name}: nvcc failed\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for entry in entries:
        getattr(lib, entry).argtypes = _build._ENTRIES[entry]
        getattr(lib, entry).restype = ctypes.c_int
    return (lib, res.stdout + res.stderr) if keep_log else lib


def time_ms(fn, iters=20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def time_b2b(fn, calls=20) -> float:
    """Device ms per call of fn(), `calls` calls queued behind a sleep kernel
    between one pair of CUDA events: the host's launch time stays out."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
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
        print("ablate_flash: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    b, s, h, d = 8, 4096, 8, 40
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    want, _ = fa.flash_attention_qkv_plain(qkv, h, d)
    rows = []
    for name, edits in ABLATIONS.items():
        _build._lib = build(name, edits)
        got, _ = fa.flash_attention_qkv(qkv, h, d)
        torch.cuda.synchronize()
        row = {"ablation": name, "ms": time_ms(lambda: fa.flash_attention_qkv(qkv, h, d))}
        if name == "full":
            row["max_abs_err_vs_plain"] = (got.float() - want.float()).abs().max().item()
        rows.append(row)
    _build._lib = None
    for row in rows:
        print(json.dumps({"shape": f"[{b}, {s}, 3*{h}*{d}]", **row}), flush=True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
