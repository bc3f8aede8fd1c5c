#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print one JSON line.

    python3 perfbench/run.py --workload deepwalk.rmat10k --seed 7 \\
        --seconds 40 --trace 0

Run from the root of a checkout: BENCHMARK.json names the cells, their
configurations, traffic mixes and metrics; the system under test is the
PyTorch/CUDA port under `src/repro_torch`. With `--trace 0` the result
carries the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a profiled cycle of the window. Every run checks what
the window produced against the plain reference (`perfbench/reference`)
and prints each number compared, with its limit, as the last lines of
standard error and under `checks`, the last key of the result.

Exit codes: 0 with a result; 1 on an error; 2 without a card (or fewer
cards than the cell asks for); 3 when a module of the JAX stack or of the
JAX package `repro` is loaded. Only exit 0 prints a result.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def _environment() -> None:
    """Keep every build and kernel cache in the checkout, at fixed paths,
    and the process to one host thread of CPU math: the card's work is
    launched by one thread, and idle math threads only contend with it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from perfbench.harness import cell as runner
    from perfbench.harness.spec import Bench

    torch.set_num_threads(1)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    try:
        run, checks, peak = runner.execute(
            cfg, traffic, cell, args.seed, args.seconds, bool(args.trace), dev,
            T_PROCESS)
    except runner.ForbiddenModules as e:
        print(f"perfbench: modules loaded that the port must not load: {e}",
              file=sys.stderr)
        return 3
    out = runner.result(bench, run, checks, peak, bool(args.trace), dev,
                        cell["chips"])
    leftover = runner.forbidden_modules()
    if leftover:
        print(f"perfbench: modules loaded that the port must not load: "
              f"{', '.join(leftover)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    if run.failed:
        print(f"check failed_batches {run.failed} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
