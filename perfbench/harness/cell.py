"""One run of one cell: set-up, the measured window, the check.

The window is a closed loop with one client: a batch is sent as one
`[1, batch]` slice of the stream, and the next one after the device has
finished it, so each batch's walks are readable when its call returns. The
window ends at the first boundary of the merge schedule (a cycle of
`max_pending` batches under on-demand merges, the last one leaving every
pending block full) once `seconds` have passed, so every run measures whole
cycles, each with its one merge. A traced run profiles the window's second
cycle, whose first batch merges the first cycle's blocks, and runs at
least two cycles.

After the window: the walks read back, one more batch of the same stream
through the same engine and entry (asking for its affected walks), the
walks read back again, the engine's merge and a read of the merged store.
Then the engine is freed and the plain reference judges all of it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from perfbench.harness import traffic as gen
from perfbench.harness.system import WalkSystem, build_kernels
from perfbench.harness.trace import Trace
from perfbench.harness.work import Kernel5Work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Batch:
    seconds: float
    edges: int
    affected: int
    merged: bool


@dataclass
class Run:
    """What a run measured: what the metric readers read."""

    cell: dict
    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    batches: list = field(default_factory=list)
    failed: int = 0                # raised, or left the MAV overflow flag set
    raised: int = 0
    peak_bytes: int = None         # the window's; None off the card
    trace: Trace = None
    traced_s: float = 0.0
    traced_batches: int = 0
    traced_merges: int = 0
    counters: dict = field(default_factory=dict)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cycle(cfg: dict) -> int:
    return cfg["max_pending"] if cfg["merge_policy"] == "on-demand" else 1


def window(system, stream, run: Run, seconds: float, dev, trace: bool):
    """The measured window over stream batches 1, 2, ...; -> the number of
    window batches sent."""
    cfg = run.config
    c = cycle(cfg)
    cap = (stream.n_batches - 2) // c * c
    traced = range(1 + c, 1 + 2 * c) if trace else range(0)
    stack = contextlib.ExitStack()
    work = Kernel5Work() if trace else None
    prof = None
    counts, flags = [], []
    sync(dev)
    t_start = time.perf_counter()
    t_end = t_start
    i = 1
    while i <= cap:
        if traced and i == traced.start:
            prof = _profiler(dev)
            stack.enter_context(prof)
            from repro_torch.kernels._observe import observe
            stack.enter_context(observe(work))
            t_tr = time.perf_counter()
        merged = (cfg["merge_policy"] == "on-demand"
                  and system.n_pending >= cfg["max_pending"])
        t0 = time.perf_counter()
        try:
            counts.append(system.step(*stream.batch(i)))
            flags.append(system.overflow_flag())
            sync(dev)
        except Exception:
            traceback.print_exc()
            run.raised += 1
            run.failed += 1
            break
        t_end = time.perf_counter()
        run.batches.append(Batch(t_end - t0, stream.edges_per_batch, 0, merged))
        if traced and i == traced.stop - 1:
            run.traced_s = time.perf_counter() - t_tr
            run.traced_batches = len(traced)
            run.traced_merges = sum(b.merged for b in run.batches[-len(traced):])
            stack.close()
        i += 1
        if (t_end - t_start >= seconds and (i - 1) % c == 0
                and i >= traced.stop):
            break
    stack.close()
    run.window_s = t_end - t_start
    for b, n in zip(run.batches, counts):
        b.affected = int(n)
    print("batch_s " + " ".join(f"{b.seconds:.4f}{'m' if b.merged else ''}"
                                for b in run.batches), file=sys.stderr)
    run.failed += sum(bool(f) for f in flags)
    if prof is not None and run.traced_batches:
        t = time.perf_counter()
        run.trace = Trace.from_profiler(prof)
        print(f"trace_read_s {time.perf_counter() - t:.3f} records {run.trace.kinds}",
              file=sys.stderr)
        run.counters["k5_calls"] = work.calls
        run.counters["k5_bound_s"] = work.bound_seconds()
    return len(run.batches)


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def prepare(cfg: dict, traffic: dict, seed: int, dev, variant: dict = None):
    """Set-up: the kernels, the graph, the corpus, the engine, the stream
    and the warm-up (one batch and one merge on the cell's shapes). Each
    part's seconds go to standard error."""
    parts = []
    t = time.perf_counter()

    def done(name):
        nonlocal t
        sync(dev)
        now = time.perf_counter()
        parts.append(f"{name} {now - t:.3f}")
        t = now

    build_kernels(dev)
    done("kernels")
    src, dst = gen.graph_edges(cfg, seed, dev)
    stream = gen.update_stream(cfg, traffic, seed, gen.max_batches(cfg, traffic),
                               dev)
    done("inputs")
    variant = variant or {}
    system = WalkSystem(cfg, src, dst, gen.corpus_key(seed, dev), dev,
                        capacity=variant.get("rewalk_capacity"),
                        model_override=variant.get("model"))
    done("graph_and_corpus")
    system.step(*stream.batch(0))
    done("warmup_batch")
    system.merge()
    done("warmup_merge")
    print("setup_parts_s " + ", ".join(parts), file=sys.stderr)
    return system, (src, dst), stream


def collect(system, stream, n_window: int, last_affected: int) -> dict:
    """The system's outputs that the reference judges (see the module
    docstring), read after the window."""
    port = dict(walks_end=system.walks(), affected_last=last_affected)
    count, walk_ids, p_min = system.step_with_masks(*stream.batch(n_window + 1))
    port.update(affected_check=count, check_walks=walk_ids, check_p_min=p_min)
    port["walks_check"] = system.walks()
    port.update(system.graph())
    port["walks_merged"] = system.merged_walks()
    port.update(system.store_rows())
    return port


def judge(cfg: dict, seed: int, pairs, stream, n_window: int, port: dict,
          dev) -> dict:
    """{number: (value, limit)} of the configuration's reference."""
    ref = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    batches = [tuple(t[i] for t in (stream.ins_src, stream.ins_dst,
                                    stream.del_src, stream.del_dst))
               for i in range(n_window + 2)]
    values = ref.judge(pairs, batches, n_window, port, cfg,
                       gen.generator(seed, "law-sample", dev))
    limits = cfg.get("check", {}).get("limits", {})
    return {k: (v, limits.get(k, 0)) for k, v in values.items()}


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def execute(cfg: dict, traffic: dict, cell: dict, seed: int, seconds: float,
            trace: bool, dev, t_process: float, variant: dict = None):
    """Set-up, window and check of one run. -> (Run, checks, device peak)."""
    run = Run(cell=cell, config=cfg)
    system, pairs, stream = prepare(cfg, traffic, seed, dev, variant)
    peak_setup = 0
    if dev.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t_process
    n = window(system, stream, run, seconds, dev, trace)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    leftover = forbidden_modules()
    if leftover:
        raise ForbiddenModules(", ".join(leftover))
    peak = max(peak_setup, run.peak_bytes or 0)
    checks = {}
    if not run.failed and n:
        run.counters["corpus_packed_bytes"] = system.packed_bytes()
        t = time.perf_counter()
        port = collect(system, stream, n, run.batches[-1].affected)
        del system
        free(dev)
        t_judge = time.perf_counter()
        checks = judge(cfg, seed, pairs, stream, n, port, dev)
        del port
        print(f"check_s collect {t_judge - t:.3f}, judge "
              f"{time.perf_counter() - t_judge:.3f}", file=sys.stderr)
    free(dev)
    return run, checks, peak


def is_correct(run: Run, checks: dict) -> bool:
    """Every batch came back, and every number is within its limit."""
    return (not run.failed and bool(checks)
            and all(v <= lim for v, lim in checks.values()))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result(bench, run: Run, checks: dict, peak: int, trace: bool, dev,
           chips: int) -> dict:
    """The run's result line (`checks` last)."""
    metrics = {}
    for m in bench.metrics(run.cell["name"], trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = is_correct(run, checks)
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": chips, "memory_peak_bytes": peak,
                  "power": card_line()}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    out = {"correct": correct, "attempted": len(run.batches) + run.raised,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        busy = run.trace.busy_s() if run.trace else 0.0
        device.update(busy_s=busy, window_s=run.traced_s)
        if run.trace:
            out["breakdown"] = {"device_ops": run.trace.top_ops(),
                                "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
