"""Kernel A2's plan space on the card: every staged cluster size and slab at
A2's shapes, with how many clusters the card holds at once and the time of
each (it needs nvcc and a GPU):

    python3 -m ctrlora_tpu_torch.tools.ablate_gn_onepass [--json OUT]

A copy of ``csrc/group_norm.cu`` with one more C entry, which launches the
kernel under an explicit plan (``onepass_plan_k``: cluster size k of 1..16
blocks, a slab of gps groups, always staged), is built alone into
``_build/ablate/``. For each shape, slab (A's, and two and four times as
many groups where one block's threads still cover it) and k whose rows fit
shared memory, one JSON line gives the plan, the launch's
``cudaOccupancyMaxActiveClusters``, the waves that makes at this batch
(``ceil(clusters of the grid / max active)``), the ms per call of 20 calls
queued back to back (as ``chip_smoke.time_b2b``), and the max error against
the plain version; ``rule`` marks the plan ``group_norm_onepass_plan``
picks, and kernel A's back-to-back time at the same inputs stands in each
shape's first line.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys

from ctrlora_tpu_torch.tools.ablate_flash import build, time_b2b

# an entry that takes the plan's cluster size and slab from its caller
_PROBE = r'''
static int g_k = 1, g_gps = 1;
static bool probe_plan(int B, int HW, int C, int G, int itemsize, int, ctrlora::GnPlan* p) {
  return ctrlora::onepass_plan_k(B, HW, C, G, itemsize, g_k, g_gps, p);
}

extern "C" int ctrlora_gn_probe(const void* x, const void* scale, const void* bias,
                                const void* row, void* y, int B, int HW, int C, int G,
                                long long row_stride, int row_f32, float eps, int silu,
                                int dtype, int k, int gps, void* stream) {
  g_k = k;
  g_gps = gps;
  return run(probe_plan, x, scale, bias, row, y, B, HW, C, G, row_stride, row_f32, eps, silu,
             dtype, 0, stream);
}

extern "C" int ctrlora_gn_probe_config(int B, int HW, int C, int G, int itemsize, int k,
                                       int gps, int* out) {
  g_k = k;
  g_gps = gps;
  return config(probe_plan, B, HW, C, G, itemsize, 0, out);
}
'''
_LAST = "  return config(ctrlora::gn_onepass_plan, B, HW, C, G, itemsize, sms, out);\n}\n"

# (shape, dtype name): A2's five sampling shapes at the CFG batch of 8, the
# 64^2 site at the finetune batch of 4, and the two fp32 shapes gn1 admits
CASES = (((8, 64, 64, 320), "bfloat16"), ((8, 32, 32, 640), "bfloat16"),
         ((8, 32, 32, 960), "bfloat16"), ((8, 32, 32, 1280), "bfloat16"),
         ((8, 16, 16, 2560), "bfloat16"), ((4, 64, 64, 320), "bfloat16"),
         ((8, 32, 32, 640), "float32"), ((8, 16, 16, 2560), "float32"))


def main(argv) -> int:
    import torch

    from ctrlora_tpu_torch.ops import _build
    from ctrlora_tpu_torch.ops import group_norm as gn

    if not torch.cuda.is_available():
        print("ablate_gn_onepass: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build("gn_onepass_probe", [(_LAST, _LAST + _PROBE)], "group_norm.cu",
                ("ctrlora_group_norm",))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ctrlora_gn_probe.argtypes = [P] * 5 + [I] * 4 + [ctypes.c_longlong, I, ctypes.c_float,
                                                         I, I, I, I, P]
    lib.ctrlora_gn_probe_config.argtypes = [I] * 7 + [ctypes.POINTER(I)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0, dt=torch.bfloat16: (
        torch.randn(s, generator=gen, device="cuda") * std).to(dt)
    out = []
    for shape, dname in CASES:
        dt = getattr(torch, dname)
        b, hw, c = shape[0], shape[1] * shape[2], shape[-1]
        item = torch.empty((), dtype=dt).element_size()
        x = rn(*shape, std=2.0, dt=dt) + 0.5
        sc, bi = rn(c, std=0.1, dt=torch.float32) + 1, rn(c, std=0.1, dt=torch.float32)
        row = rn(1, c, std=0.5, dt=dt)
        args = (x, sc, bi, 32, 1e-5, True, row)
        want = gn.group_norm_plain(*args).float()
        rule = gn.group_norm_onepass_plan(b, hw, c, 32, item, sms)
        a_ms = time_b2b(lambda: gn.group_norm(*args))
        gps0 = gn._slab_groups(c, 32, item)
        stream = _build.stream_ptr(x.device)
        first = True
        for gps in (gps0, 2 * gps0, 4 * gps0):
            if gps > 32 or 32 % gps:
                continue
            for k in range(1, gn.GN_ONEPASS_MAX_CLUSTER + 1):
                plan = gn._onepass_plan_k(b, hw, c, 32, item, k, gps)
                if plan is None:
                    continue
                cfg = (ctypes.c_int * 9)()
                code = lib.ctrlora_gn_probe_config(b, hw, c, 32, item, k, gps, cfg)
                res = {"shape": list(shape), "dtype": dname, "cluster": k, "groups": gps,
                       "slabs": plan.slabs, "smem": plan.smem, "rows": plan.rows,
                       "blocks": plan.blocks(b), "config_code": code,
                       "max_active_clusters": cfg[8] if code == 0 else None,
                       "rule": plan == rule}
                if code == 0 and cfg[8] > 0:
                    y = torch.empty_like(x)

                    def launch():
                        _build.check(lib.ctrlora_gn_probe(
                            x.data_ptr(), sc.data_ptr(), bi.data_ptr(), row.data_ptr(),
                            y.data_ptr(), b, hw, c, 32, 0, int(item == 4), 1e-5, 1,
                            int(item == 4), k, gps, stream), "probe")

                    launch()
                    torch.cuda.synchronize()
                    res.update(waves=math.ceil(b * plan.slabs / cfg[8]),
                               b2b_ms=time_b2b(launch),
                               max_abs_err_vs_plain=(y.float() - want).abs().max().item())
                if first:
                    res["kernel_a_b2b_ms"], first = a_ms, False
                out.append(res)
                print(json.dumps(res), flush=True)
        del x, args, want
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
