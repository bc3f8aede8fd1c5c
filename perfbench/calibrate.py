#!/usr/bin/env python3
"""Readings that set a cell's check limits: the program on many seeds and
its control on a few, each a short window (one merge cycle) at the cell's
own sizes and load, then the same check as a run, all in one process.

    python3 perfbench/calibrate.py --workload node2vec.rmat10k \\
        --seeds 11,12,13 --control-seeds 21,22,23 \\
        [--faults walks_not_rewalked:31,half_batch:32] [--out FILE]

The control is the program with the path of its configuration's `control`
entry switched on: a guarantee of the configuration broken (walks dropped
by a rewalk capacity below the affected count; the approximate rejection
sampler in place of the exact one). A fault is one of
`perfbench/harness/faults.py`, planted in the program for one run with the
seed after its colon. A sound run must read within every limit and the
control and each fault must not. One JSON line a run, also appended to
`--out` if given.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _environment  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def faults(text: str) -> list:
    return [(name, int(seed)) for name, seed in
            (item.split(":") for item in text.split(",") if item)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", type=faults, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()

    import torch
    from perfbench.harness import cell as runner
    from perfbench.harness.faults import planted
    from perfbench.harness.spec import Bench

    torch.set_num_threads(1)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else None
    if dev is None:
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    jobs = ([("program", s, None, None) for s in args.seeds]
            + [("control", s, cfg["control"], None) for s in args.control_seeds]
            + [(f"fault:{f}", s, None, f) for f, s in args.faults])
    for kind, seed, variant, fault in jobs:
        t0 = time.perf_counter()
        try:
            with planted(fault) if fault else contextlib.nullcontext():
                run, checks, peak = runner.execute(cfg, traffic, cell, seed,
                                                   0.0, False, dev, t0, variant)
        except Exception as e:     # a control that crashes gives no number
            line = {"workload": cell["name"], "kind": kind, "seed": seed,
                    "error": repr(e)}
            print(json.dumps(line), flush=True)
            runner.free(dev)
            continue
        line = {"workload": cell["name"], "kind": kind, "seed": seed,
                "batches": len(run.batches), "failed": run.failed,
                "correct": runner.is_correct(run, checks),
                "checks": {k: v for k, (v, _) in checks.items()},
                "limits": {k: lim for k, (_, lim) in checks.items()},
                "setup_s": run.setup_s, "seconds": time.perf_counter() - t0,
                "peak_bytes": peak}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
