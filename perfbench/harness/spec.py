"""BENCHMARK.json and the files it names, found by name.

A configuration is the JSON file that its `configs` entry names; a traffic
mix is `traffic/<mix>.json` beside this package; a metric is
`metrics/<metric>.py`, a module with `read(run) -> float | None`. Adding a
configuration, a mix, a metric or a cell is adding files and entries: no
file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries that this cell reports in this kind of run."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """`read` of metrics/<metric>.py."""
        if metric not in self._readers:
            path = self.dir / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                "perfbench_metric_" + "".join(
                    ch if ch.isalnum() else "_" for ch in metric), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._readers[metric] = module.read
        return self._readers[metric]
