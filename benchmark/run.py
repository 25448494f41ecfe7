"""The benchmark of ctrlora_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It reads ``BENCHMARK.json``, builds the cell's
configuration from seeded weights on the card, warms up the shapes the
cell's traffic uses, and measures for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or profiles a fixed piece of work (``--trace
1``: its per-layer metrics). Then it frees the program, holds what the
timed path produced against the plain float32 reference, prints each
number compared beside its limit as the last lines of standard error, and
prints one JSON line as the last line of standard output.

It fails, printing no result, where torch sees no CUDA card or fewer than
the cell asks for, and where the process holds a module of JAX or of the
JAX package once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ctrlora_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What a per-layer metric's reader takes: the trace, the units of work
    in the traced window (``steps``, ``images``, ``requests``), the
    reference's FLOPs of that work, and the cell's names."""

    def __init__(self, workload: str, kind: str, trace, units: Dict[str, int], flops: float):
        self.workload, self.kind, self.trace, self.flops = workload, kind, trace, flops
        self.steps = units.get("steps", 0)
        self.units = units


def limits_of(spec, workload: str) -> Dict[str, float]:
    with open(spec.find("limits", workload)) as f:
        return json.load(f)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> List[List]:
    """[[name, reading, limit], ...] for every limit of the cell; a missing
    or non-finite reading fails."""
    return [[name, readings.get(name, math.inf), lim] for name, lim in limits.items()]


def main(argv: Optional[Sequence[str]] = None, root: Optional[str] = None,
         device: Optional[str] = None, chip_check: bool = True) -> int:
    """One run; `root`, `device` and `chip_check` let a test run a tiny
    benchmark on the CPU."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    from benchmark.spec import Spec

    spec = Spec(root)
    work = spec.workload(args.workload)
    cfg = spec.config(work["config"])
    traffic = spec.traffic(work["traffic"])
    limits = limits_of(spec, args.workload)
    import torch

    if chip_check and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < work["chips"]):
        print(f"benchmark: {args.workload} needs {work['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = spec.driver(traffic["kind"]).Cell(cfg, traffic, args.seed, device or "cuda")
    return run_cell(spec, args, work, traffic, limits, cell)


def run_cell(spec, args, work, traffic, limits, cell) -> int:
    import torch

    from benchmark import common

    torch.set_num_threads(min(2, torch.get_num_threads()))  # one process, few threads
    cell.setup()
    setup_s = process_age()
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(cell.device)
    if args.trace:
        tr, units = cell.traced()
        ctx = Context(args.workload, traffic["kind"], tr, units, cell.flops(units))
        metrics = {}
        for m in spec.metrics_of(args.workload, trace=True) if on_card else ():
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {"attempted": units.get("requests", units["steps"]), "failed": 0,
                  "metrics": metrics}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    else:
        result = cell.window(args.seconds)
        result["metrics"] = {k: {"value": v, "unit": _unit(spec, k)}
                             for k, v in result["metrics"].items()}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        extra, breakdown = {}, None
    peak = cell.memory_peak() if on_card else 0
    device_rec = common.device_record(work["chips"], cell.device, peak) if on_card else \
        {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    device_rec.update(extra)
    cell.release()
    readings = cell.check()["program"]
    found = forbidden_modules()  # after the window, the reference and the check
    if found:
        print(f"benchmark: the process holds {found} after the window", file=sys.stderr)
        return 3
    checks = judge(readings, limits)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": device_rec}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _unit(spec, metric: str) -> str:
    for m in spec.data["end_to_end"]:
        if m["name"] == metric:
            return m["unit"]
    raise KeyError(metric)


if __name__ == "__main__":
    sys.exit(main())
