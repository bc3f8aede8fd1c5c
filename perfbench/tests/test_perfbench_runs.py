"""The harness end to end at a tiny size on the CPU, with the port's plain
versions: sound runs read correct, the controls and the faults do not, a
configuration, mix or metric added as a file is found by name, and the
command refuses to run without a card."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny, tiny
from perfbench.harness import faults
from perfbench.harness.spec import Bench

E2E = {"edge_updates_per_s", "batch_latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", ["deepwalk.rmat10k", "node2vec.rmat10k",
                                      "deepwalk.rmat1k"])
def test_sound_run_is_correct(bench, workload):
    cfg, mix, cell = tiny(bench, workload)
    out = run_tiny(bench, cfg, mix, cell, seconds=0.5)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] % cfg["max_pending"] == 0
    names = set(out["metrics"])
    want = E2E if "deepwalk" in workload else E2E - {"batch_latency_p95_ms"}
    assert names == want          # peak_mem_gb is the card's alone
    assert list(out)[-1] == "checks"
    assert out["metrics"]["edge_updates_per_s"]["unit"] == "edges/s"
    checks = set(out["checks"])
    assert {"graph_diff", "walk_invalid", "mav_diff", "prefix_diff",
            "stale_walks", "store_diff"} <= checks
    assert ("law_z" in checks) == (cfg["model"]["order"] == 2)
    assert ("rank_law_z" in checks) == (cfg["model"]["order"] == 1)


def test_traced_run_reports_counters(bench):
    cfg, mix, cell = tiny(bench, "node2vec.rmat10k")
    out = run_tiny(bench, cfg, mix, cell, trace=True)
    assert out["correct"]
    # on the CPU the device records are empty: only the counters read
    assert set(out["metrics"]) == {"affected_walks", "corpus_packed_mb"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}


def test_same_seed_same_run(bench):
    cfg, mix, cell = tiny(bench, "deepwalk.rmat10k")
    a = run_tiny(bench, cfg, mix, cell, seed=(1 << 31) + 7)
    b = run_tiny(bench, cfg, mix, cell, seed=(1 << 31) + 7)
    assert a["checks"] == b["checks"] and a["attempted"] == b["attempted"]


# ------------------------------------------------------------- controls


def test_deepwalk_control_fails(bench):
    """The capacity cut drops affected walks: the MAV comparison sees it."""
    cfg, mix, cell = tiny(bench, "deepwalk.rmat10k")
    out = run_tiny(bench, cfg, mix, cell, variant={"rewalk_capacity": 128})
    assert not out["correct"]
    assert out["checks"]["mav_diff"]["value"] > 0


def test_node2vec_control_fails(bench):
    """The rejection sampler in place of the exact one: the law sees it, at
    a size where 4 x 10^5 steps separate the two laws."""
    cfg, mix, cell = tiny(bench, "node2vec.rmat10k", n_walks_per_vertex=128,
                          length=24, graph={"kind": "er", "mean_degree": 16})
    cfg["model"]["dmax"] = 32
    cfg["check"]["law_samples"] = 400_000
    mix["inserts"] = 40
    sound = run_tiny(bench, cfg, mix, cell, seed=5)
    control = run_tiny(bench, cfg, mix, cell, seed=5, variant=cfg["control"])
    assert sound["correct"], sound["checks"]
    assert not control["correct"]
    assert control["checks"]["law_z"]["value"] > cfg["check"]["limits"]["law_z"]
    assert sound["checks"]["law_z"]["value"] < cfg["check"]["limits"]["law_z"] / 2


# ------------------------------------------------------------- faults


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "next_vertex_altered", "walks_not_rewalked"])
@pytest.mark.parametrize("workload", ["deepwalk.rmat10k", "node2vec.rmat10k"])
def test_fault_reads_not_correct(bench, workload, fault):
    """The timed path broken underneath the harness: `correct` is false."""
    cfg, mix, cell = tiny(bench, workload)
    with faults.planted(fault):
        out = run_tiny(bench, cfg, mix, cell)
    assert not out["correct"], out["checks"]
    if fault == "walks_not_rewalked":
        checks = {k: c["value"] for k, c in out["checks"].items()}
        assert checks["stale_walks"] > out["checks"]["stale_walks"]["limit"]
        if not mix["deletes"]:
            # stale walks stay walks of the graph and keep their prefixes:
            # with inserts alone the stale count is what sees them
            assert checks["walk_invalid"] == 0 and checks["prefix_diff"] == 0


@pytest.mark.parametrize("fault", ["off_by_one", "first_neighbor"])
def test_deepwalk_law_faults_read_not_correct(bench, fault):
    """A DeepWalk step that is no uniform draw: the rank law sees it, at a
    size where 4 x 10^5 steps separate the laws; the sound run reads under
    half the limit."""
    cfg, mix, cell = tiny(bench, "deepwalk.rmat10k", n_walks_per_vertex=128,
                          length=24, graph={"kind": "er", "mean_degree": 16})
    cfg["check"]["law_samples"] = 400_000
    mix.update(inserts=40, deletes=8)
    limit = cfg["check"]["limits"]["rank_law_z"]
    sound = run_tiny(bench, cfg, mix, cell, seed=6)
    with faults.planted(fault):
        broken = run_tiny(bench, cfg, mix, cell, seed=6)
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["rank_law_z"]["value"] < limit / 2
    assert not broken["correct"]
    assert broken["checks"]["rank_law_z"]["value"] > limit


# ------------------------------------------------------------- discovery


def test_added_files_are_found_by_name(bench, tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries run with no other file edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg, mix, _ = tiny(bench, "deepwalk.rmat10k")
    cfg["name"] = "deepwalk-tiny"
    (tmp_path / "perfbench/configs/deepwalk-tiny.json").write_text(json.dumps(cfg))
    mix.update(name="rmat_tiny", inserts=30, deletes=2)
    (tmp_path / "perfbench/traffic/rmat_tiny.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench/metrics/batches_in_window.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    spec["configs"].append({"name": "deepwalk-tiny", "source": "test",
                            "file": "perfbench/configs/deepwalk-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "deepwalk.tiny", "config": "deepwalk-tiny",
                              "traffic": "rmat_tiny", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "batches_in_window", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "Harness", "moves": "edge_updates_per_s",
                              "workloads": ["deepwalk.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b2 = Bench(tmp_path)
    cell = b2.cell("deepwalk.tiny")
    out = run_tiny(b2, b2.config("deepwalk-tiny"), b2.traffic("rmat_tiny"), cell,
                   trace=True)
    assert out["correct"]
    assert out["metrics"]["batches_in_window"]["value"] == out["attempted"]
    assert [m["name"] for m in b2.metrics("deepwalk.rmat10k", True)] == \
        [m["name"] for m in bench.metrics("deepwalk.rmat10k", True)]


def test_metric_lists_follow_the_cells(bench):
    def names(workload, trace):
        return {m["name"] for m in bench.metrics(workload, trace)}
    assert names("node2vec.rmat10k", False) == {"edge_updates_per_s",
                                                "peak_mem_gb", "setup_s"}
    assert {"prefix_ms", "k5_roofline_pct"} <= names("node2vec.rmat10k", True)
    assert "merge_ms" not in names("node2vec.rmat10k", True)
    for w in ("deepwalk.rmat10k", "deepwalk.rmat1k"):
        assert "merge_ms" in names(w, True)
        assert not {"prefix_ms", "k5_roofline_pct"} & names(w, True)


# ------------------------------------------------------------- the command


def _run_cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "deepwalk.rmat10k",
         "--seed", "3", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def test_command_refuses_without_a_card(tmp_path):
    out = _run_cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_leaves_no_jax_module_loaded(bench):
    code = ("import sys; sys.path[:0] = [sys.argv[1] + '/perfbench/tests']; "
            "from conftest import ROOT, Bench, run_tiny, tiny; "
            "b = Bench(ROOT); cfg, mix, cell = tiny(b, 'node2vec.rmat10k'); "
            "out = run_tiny(b, cfg, mix, cell); "
            "from perfbench.harness.cell import forbidden_modules; "
            "print(out['correct'], forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "True []", out.stderr[-2000:]
