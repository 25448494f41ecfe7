"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size: for each seed, the cell's set-up and a short run of
its timed path, then the program against the float32 reference and, with
``--control 1``, the control (the reference in the nearest precision below
the configuration's, in the program's place) and, for a training cell, the
half-batch fault, all against the same reference. One JSON line a seed.

    python3 -m benchmark.tools.readings --workload sample.b8.ddim50 \\
        --seeds 11,12,13 --units 2 --control 1 --out readings.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import common
from benchmark.spec import Spec


def main(argv=None, root=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--units", type=int, default=2,
                   help="requests (sampling) or window steps (training) a seed")
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    spec = Spec(root)
    work = spec.workload(args.workload)
    traffic = spec.traffic(work["traffic"])
    cfg = spec.config(work["config"])
    driver = spec.driver(traffic["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = driver.Cell(cfg, traffic, seed, device or "cuda")
        cell.setup()
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for i in range(args.units):
            cell.request(i) if traffic["kind"] == "sample" else cell.step()
        common.sync(cell.device)
        unit_s = (time.perf_counter() - t1) / max(1, args.units)
        on_card = cell.device.type == "cuda"
        peak = cell.memory_peak() if on_card else 0
        cell.release()
        t2 = time.perf_counter()
        readings = cell.check(control=bool(args.control))
        line = {"workload": args.workload, "seed": seed, "setup_s": setup_s, "unit_s": unit_s,
                "memory_peak_bytes": peak, "check_s": time.perf_counter() - t2, **readings}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(json.dumps(line) + "\n")
        del cell
        if on_card:
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
