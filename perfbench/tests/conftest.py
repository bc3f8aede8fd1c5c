"""Tiny cells for the benchmark's CPU tests: the real configuration and
traffic files, cut to a few hundred vertices and a few dozen edges a batch,
run on the CPU with the port's plain versions."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.harness import cell as runner  # noqa: E402
from perfbench.harness.spec import Bench  # noqa: E402

CPU = torch.device("cpu")


def tiny(bench: Bench, workload: str, **over):
    """(cfg, traffic, cell) of a workload cut to a CPU test's size."""
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    cfg.update(n_vertices=256, edge_capacity=1 << 14, n_walks_per_vertex=4,
               length=12, max_pending=2, graph={"kind": "er", "mean_degree": 12})
    cfg["check"]["law_samples"] = 2000
    if cfg["model"]["order"] == 2:
        cfg["model"]["dmax"] = 16
        cfg["check"]["law_samples"] = 20000
    traffic = bench.traffic(cell["traffic"])
    traffic.update(inserts=20, deletes=4 if traffic["deletes"] else 0)
    cfg.update(over)
    return cfg, traffic, cell


def run_tiny(bench, cfg, traffic, cell, seed=123456789012, seconds=0.0,
             trace=False, variant=None):
    """execute + result on the CPU -> the result line as a dict."""
    run, checks, peak = runner.execute(cfg, traffic, cell, seed, seconds, trace,
                                       CPU, time.perf_counter(), variant)
    return runner.result(bench, run, checks, peak, trace, CPU, 1)


@pytest.fixture(scope="session")
def bench():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return Bench(ROOT)


@pytest.fixture
def card():
    """Skip unless an NVIDIA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (sm_90a) and nvcc")
    return torch.device("cuda", 0)
