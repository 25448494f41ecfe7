"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root names the cells; each cell names a
configuration (its ``file``) and a traffic mix. Everything else is found by
name under the benchmark's directories (``paths``), so a later change adds a
file and never edits one:

- ``<dir>/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the driver that runs it, ``<dir>/drivers/<kind>.py``;
- ``<dir>/metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ROOT = os.path.dirname(HERE)


class Spec:
    """``BENCHMARK.json`` under `root`, with the lookups by name."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(root or DEFAULT_ROOT)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        dirs = [os.path.join(self.root, p) for p in self.data["paths"]]
        self.dirs: List[str] = dirs + ([HERE] if HERE not in dirs else [])

    def find(self, kind: str, name: str, exts=(".json",)) -> str:
        for d in self.dirs:
            for ext in exts:
                path = os.path.join(d, kind, name + ext)
                if os.path.isfile(path):
                    return path
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} under {self.dirs}")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"BENCHMARK.json has no configuration {name!r}")

    def traffic(self, name: str) -> dict:
        with open(self.find("traffic", name)) as f:
            return json.load(f)

    def driver(self, kind: str) -> ModuleType:
        return load_module(self.find("drivers", kind, (".py",)), f"benchmark_driver_{kind}")

    def metrics_of(self, workload: str, trace: bool) -> List[dict]:
        """The cell's metrics of the run: its end-to-end ones (trace 0) or
        its per-layer ones (trace 1), those whose ``workloads`` list it or
        that have none."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.find("metrics", metric, (".py",)),
                           "benchmark_metric_" + metric.replace(".", "_"))


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
