"""The command on the card: one short run of each cell reads correct, and
a traced run reports the cell's per-layer metrics. Run on a machine with
an H100: `python -m pytest -m cuda perfbench/tests/test_perfbench_card.py`."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.cuda


def _cli(workload: str, trace: int) -> dict:
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
         str((1 << 31) + 101), "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["deepwalk.rmat10k", "node2vec.rmat10k",
                                      "deepwalk.rmat1k"])
def test_cell_on_the_card(card, workload):
    res = _cli(workload, 0)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["metrics"]["edge_updates_per_s"]["value"] > 0


def test_traced_run_on_the_card(card):
    res = _cli("node2vec.rmat10k", 1)
    assert res["correct"], res["checks"]
    for name in ("rewalk_ms", "prefix_ms", "k5_roofline_pct",
                 "device_idle_pct", "device_kernels_per_batch"):
        assert name in res["metrics"], name
    assert 0 < res["metrics"]["k5_roofline_pct"]["value"] <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
