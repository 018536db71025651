"""Finding the benchmark's parts by name.

`BENCHMARK.json` names the cells, configurations and metrics. Each part
lives in a file of its own under this package, found by its name:

  configs/<config>.json    a deployment: gadget, operator params, stream
  traffic/<traffic>.json   a traffic mix: the feed's kind and parameters
  cells/<cell>.json        a cell's configuration, traffic and limits
  metrics/<metric>.py      a metric's reader, ``read(obs) -> float | None``

so a later change adds a deployment, a mix, a cell or a metric by adding
files and entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """`BENCHMARK.json` and the package directory its parts live in."""

    def __init__(self, bench_path: Path, root: Path = PKG):
        self.bench = load_json(bench_path)
        self.root = root

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                out = dict(w)
                out.update(load_json(self.root / "cells" / f"{name}.json"))
                return out
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.root / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.root / "traffic" / f"{name}.json")

    def metrics_for(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (true): those whose ``workloads`` list names it, or that
        have none."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.root / "metrics" / f"{metric}.py"
        sp = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        return mod.read
