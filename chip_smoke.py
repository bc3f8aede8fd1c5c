"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
  1. the card's name and power limit; build the kernels (nvcc, in parallel)
  2. small end to end: the engine on the card (kernels) against the same
     engine on the CPU (plain versions), same keys, mixed stream: the
     states must be bit-identical; order 1, and order 2 with the rejection
     sampler, the factorized sampler unfused, and fused (hub vertices of
     degree > dmax make the rejection fallback run)
  3. full width, the `wharf-stream` configuration (configs/wharf_stream.py)
     at 2^18 vertices: corpus, 8 mixed batches through run_stream, merge,
     packed decode, traverse, point FINDNEXT — the order-1 main path, with
     the kernel launch counts read just after it; a host copy of the
     merged engine is kept for phase 3b
 3b. full width, the downstream maintainer over phase 3's configuration:
     the same graph, corpus and update keys through
     `EmbeddingMaintainer.run_stream`, SGNS at dim 128, window 5, 5
     negatives, 2^20 pairs a batch; its merged engine must equal phase 3's
     bit for bit, the first batch's loss per pair must be 6 ln 2 and leave
     the input table unchanged (the output table starts at 0); one more
     batch under torch.profiler
 3c. full width, serving: a `WalkQueryService` over phase 3b's maintainer
     (`engine_view()`, a pending block live): next_vertices on 2^16
     queries (kernel = plain backend, = the plain pair, unpair and
     FINDNEXT on a CPU copy of the overlay, every query on a stored walk
     found), walks_of on 1,024 vertices at capacity 1,024, the overlay
     walk matrix, neighborhoods and embedding neighbors (k = 10, f32 with
     TF32 off, card ids = CPU ids) — the serve path,
     counts read just after it, kernels 1-4 launched; a pin, then a
     merge, two more batches and a merge: the pinned answers stay
     bit-identical, the walk matrix = the post-merge traverse and = the
     merged store read with the plain unpair, walks_of = the post-merge
     segments as sets (plain decode and unpair); ppr_rows on an
     engine of its own at 2^15 vertices (the dense [n, n] table), built
     twice bit-identical and = the CPU's within rtol 1e-5; per query kind
     the synced time a query, batched (B = 1,024) and per call; the SLO
     summary and the service's counters
  4. full width, `wharf-stream` order 2 (node2vec, factorized, dmax 128)
     at 2^18 vertices, insert-only batches: one corpus, then the batches
     unfused and again fused from the same corpus and keys; the two runs'
     stores, slot_epoch and pending blocks must be bit-identical; merge,
     overlay traverse = post-merge traverse; one more batch of each path
     under torch.profiler — the order-2 main paths, counts read just after:
     the corpus and the unfused batches launch the CSR intersect kernel,
     the fused batches the fused step and no intersect kernel, and no path
     builds a neighbor window (`intersect.neighbor_window` is never called)
  5. each kernel against its plain PyTorch version on the card, on the
     main paths' tensors plus edge cases, timed with CUDA events beside its
     bound (bytes at 3.35 TB/s or operations at 67 T/s; the bytes count
     each input read once, so a chunk or CSR segment that many queries or
     rows read counts once, and what the data needs): kernels 1-6 bit
     for bit; kernel 7 (the f32 SGNS step) within loss rtol 1e-5 and
     gradients rtol 1e-5 / atol 1e-6, its sums being taken in another order.
     `ms` is the mean of back-to-back runs on the same buffers (which may
     hit the 50 MB L2), `ms_cold` the median of 30 single runs, each after
     a 256 MB write and read that evict L2. Kernel 4 is also held and timed
     on the operands of the first prefix-read call of phase 4's profiled
     unfused batch. Kernels 5 and 6 are also timed in turns against the composition
     they replaced: the two neighbor windows built in torch (plus, for
     kernel 5, the windowed kernel, which no main path launches any more)
  6. the paper's comparison (§7.1, Figs. 7-8) on the card: `wharf-stream`
     (`configs.get_arch`) and its stream_10k_mixed shape at 2^18 vertices,
     an er graph (mean degree ~100) and the paper's R-MAT update stream
     (a = 0.5, b = c = 0.1, d = 0.3) drawn on the card by the port's
     generators (= the CPU's draws: the stream, the graph's first 2^16
     edges); Wharf, the inverted-index (II) and the tree baselines one
     after another from one corpus key, stream and key, each freed before
     the next: per-batch synced ms, affected walks, `nbytes` beside the
     peak device memory, launches by path. Checks: batch 1's affected
     count equal across the three; at order 1 the tree's walks = Wharf's
     stored triplets after every batch (and after the last, Wharf's
     overlay traverse of every walk = its triplets); the II = the tree at creation, and after batch 1
     the II's rewritten columns are the tree's shifted by the one column
     the reference's II writes ahead; every tree slot stored once, the
     columns lexsorted, each next = the owner of the next slot, every step
     an edge; every pair the II rewrote (from its first new vertex) an
     edge. Then II and tree over 2 order-2 batches of the
     stream_10k_n2v_factorized shape (kernel 5), and both on a 2^12-vertex
     graph on the card against the CPU, order 1 and order 2
Phase 2 also runs a small maintainer on the card against the CPU and
against a plain engine, and the order-1 stream with `WalkConfig(metrics=
True)` on the card: its state equals the plain run's, its counters equal
the CPU's, and the metrics-OFF run calls the plain step loop's kernels;
it prints the exported summary. Each phase prints one JSON line.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch import random as jr  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import baseline_to_numpy, state_to_numpy  # noqa: E402
from repro_torch.core.baselines import IIEngine, TreeEngine  # noqa: E402
from repro_torch.data.streams import edge_batch_stream, er_edges, mixed_edge_stream  # noqa: E402
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus  # noqa: E402
from repro_torch.core import pairing  # noqa: E402
from repro_torch.core.corpus import walk_start_vertex  # noqa: E402
from repro_torch.core.packed_store import CHUNK  # noqa: E402
from repro_torch.core.update import WalkEngine  # noqa: E402
from repro_torch.core.store import PAD_EPOCH  # noqa: E402
from repro_torch.core.utils import seg_searchsorted  # noqa: E402
from repro_torch.core.walkers import WalkModel  # noqa: E402
from repro_torch.downstream import EmbeddingMaintainer, MaintainerConfig  # noqa: E402
from repro_torch.kernels import _build, delta, intersect, megakernel, ops  # noqa: E402
from repro_torch.kernels import range_search, sgns, szudzik  # noqa: E402
from repro_torch.core import update  # noqa: E402
from repro_torch.obs import export, slo  # noqa: E402
from repro_torch.serve import WalkQueryService, batched  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12      # H100 float32 outside the tensor cores
FLUSH_BYTES = 256 << 20       # a write this large evicts the H100's 50 MB L2
COLD_REPS = 30

# the wharf-stream configuration (src/repro/configs/wharf_stream.py:17-42)
# and its stream_10k_mixed traffic, cut in scale only
CONFIG = dict(n_vertices=1 << 18, edge_capacity=1 << 25, n_walks_per_vertex=10,
              length=80, chunk_b=128, mean_degree=100, batch_inserts=10_000,
              batch_deletes=2_000, n_batches=8, merge_policy="on-demand",
              merge_impl="interleave", max_pending=4)
REDUCED = {"n_vertices": "2^20 -> 2^18 (8 pending blocks of a 2^20 corpus exceed 80 GB)",
           "edge_capacity": "2^27 -> 2^25 (mean degree 100 at 2^18 vertices)",
           "max_pending": "8 -> 4 (device memory)",
           "rewalk_capacity": "2^20 -> n_walks (a batch affects most walks; "
                              "2^20 would drop affected walks unflagged)"}

# wharf-stream order 2: the stream_10k_n2v_factorized / _megakernel shapes
# (src/repro/configs/wharf_stream.py:26-32, 178-194), cut as CONFIG
N2V = dict(CONFIG, batch_deletes=0, n_batches=3, p=1.0, q=1.0,
           sampler="factorized", dmax=128)
N2V_REDUCED = dict(REDUCED, n_batches="3 timed batches and 1 profiled batch "
                   "per path (the profiled one with 3 pending blocks; the run's "
                   "time limit)")
ORDER1_KERNELS = ("szudzik_pair", "szudzik_unpair", "delta_decode",
                  "find_next_packed")

# the maintainer over CONFIG's engine: the repo's SGNSConfig widths
# (src/repro/models/embeddings.py:28-35; DeepWalk/node2vec's d = 128)
MAINT = dict(dim=128, window=5, n_negative=5, lr=0.01, skip_stale_prefix=True,
             max_pairs=1 << 20)
MAINT_REDUCED = dict(REDUCED, max_pairs="0 (every live pair: ~2.6M affected walks x 770 "
                     "pairs a batch) -> 2^20 pairs a batch (1,362 walks)",
                     n_batches="8 timed batches and 1 profiled batch")
# phase 3c: the service over the maintainer's engine; PPR on its own engine
SERVE = dict(next_queries=1 << 16, batch=1024, walks_of_capacity=1024, hops=2,
             k=10, pin_traverse_walks=1 << 14, per_call_reps=16, extra_batches=2,
             ppr_vertices=1 << 15, restart_prob=0.2, ppr_rtol=1e-5)
SERVE_REDUCED = dict(MAINT_REDUCED, ppr_vertices=(
    "2^18 -> 2^15 for ppr_rows only: the reference's dense [n, n] f32 table is "
    "275 GB at 2^18 and 4.3 GB at 2^15 (its own engine, the same config and a "
    "batch of 1,250 inserts and 250 deletes, the per-vertex rate of CONFIG)"))
SGNS_LOSS_RTOL = 1e-5
SGNS_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)

# phase 6: the paper's comparison on `wharf-stream` (configs/wharf_stream.py)
# and its stream_10k_mixed / stream_10k_n2v_factorized shapes, cut as CONFIG;
# an er graph of 2^18 * 50 undirected edges, the R-MAT stream at the
# generators' defaults (a = 0.5, b = c = 0.1, d = 0.3)
PAPER = dict(log2_n=18, edge_capacity=1 << 25, max_pending=4,
             graph_edges=(1 << 18) * 50, n2v_batches=2, cpu_prefix=1 << 16,
             seeds=dict(graph=2024, stream=2025, n2v_stream=2026, corpus=0,
                        update=1),
             small=dict(log2_n=12, graph_edges=(1 << 12) * 10, n_batches=2,
                        n_ins=200, n_del=40, n_walks_per_vertex=4, length=16))
PAPER_REDUCED = dict(REDUCED, n2v_batches=(
    "8 -> 2 order-2 batches (stream_10k_n2v_factorized), II and tree only "
    "(the run's time limit)"))

KERNEL_META = {
    "szudzik_pair": ("src/repro_torch/kernels/csrc/szudzik.cu",
                     "src/repro/kernels/szudzik.py:109"),
    "szudzik_unpair": ("src/repro_torch/kernels/csrc/szudzik.cu",
                       "src/repro/kernels/szudzik.py:115"),
    "delta_decode": ("src/repro_torch/kernels/csrc/delta.cu",
                     "src/repro/kernels/delta.py:78"),
    "find_next_packed": ("src/repro_torch/kernels/csrc/range_search.cu",
                         "src/repro/kernels/range_search.py:42"),
    "intersect_next": ("src/repro_torch/kernels/csrc/intersect.cu",
                       "src/repro/kernels/intersect.py:199"),
    "intersect_csr": ("src/repro_torch/kernels/csrc/intersect.cu",
                      "src/repro/kernels/intersect.py:199"),
    "fused_rewalk_step": ("src/repro_torch/kernels/csrc/megakernel.cu",
                          "src/repro/kernels/megakernel.py:217"),
    "sgns_step": ("src/repro_torch/kernels/csrc/sgns.cu",
                  "src/repro/kernels/sgns.py:113"),
}
# the windowed intersect kernel serves the reference's windowed API; the
# samplers take the CSR kernel, so no main path launches it (phase 5 still
# holds it against its plain version and times it)
OFF_MAIN_PATH = ("intersect_next",)


_T0 = time.perf_counter()


def log(tag, **kw):
    """One JSON line per phase, with the seconds since the run started."""
    print(json.dumps({"phase": tag, "elapsed_s": time.perf_counter() - _T0, **kw}),
          flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int = COLD_REPS) -> float:
    """Median device time of fn() over `reps` single runs, after one
    warm-up. Before each run (not timed) FLUSH_BYTES are written, which
    evicts L2, then read back, which evicts the write's dirty lines: the run
    finds none of its operands in L2 and writes back no line of the flush."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for i in range(reps):
        flush.fill_(i & 0xFF)
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def sm_clock_mhz(cycles: int = 2_000_000) -> float:
    """The SM clock the card runs at now (MHz), from the device time of a
    spin of `cycles` SM clock cycles (`torch.cuda._sleep`): a latency-bound
    kernel slows with the clock, a bandwidth-bound one barely."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) * 1e3)


# ---------------------------------------------------------------- phase 2


def hub_edges(rng, n, m, hubs, hub_degree):
    """m uniform pairs plus `hubs` vertices of degree ~hub_degree."""
    src, dst = rng.integers(0, n, size=(2, m))
    hs = np.repeat(np.arange(hubs), hub_degree)
    return (np.concatenate([src, hs]),
            np.concatenate([dst, rng.integers(0, n, size=hs.shape[0])]))


def phase_small_e2e(dev):
    rng = np.random.default_rng(3)
    n = 512
    src, dst = hub_edges(rng, n, 6000, hubs=4, hub_degree=300)
    ins = rng.integers(0, n, size=(2, 6, 60))
    dels = rng.integers(0, n, size=(2, 6, 20))
    n2v = dict(order=2, p=0.5, q=2.0, dmax=128)
    runs = {"order1": (WalkModel(), "off"),
            "n2v_rejection": (WalkModel(sampler="rejection", **n2v), "off"),
            "n2v_factorized": (WalkModel(sampler="factorized", **n2v), "off"),
            "n2v_factorized_fused": (WalkModel(sampler="factorized", **n2v),
                                     "fused")}
    fields = {}
    for name, (model, mk) in runs.items():
        states = []
        ops.reset_launches()
        for d in (dev, torch.device("cpu")):
            megak = mk if mk == "off" else ("cuda" if d.type == "cuda" else "torch")
            cfg = WalkConfig(n_walks_per_vertex=4, length=16, model=model,
                             megakernel=megak)
            with (window_calls() if d.type == "cuda" else contextlib.nullcontext()) as wins:
                g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
                store = generate_corpus(jr.PRNGKey(1, d), g, cfg)
                eng = WalkEngine(graph=g, store=store, cfg=cfg,
                                 rewalk_capacity=n * 4, max_pending=4)
                eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
            if wins is not None:
                assert wins[0] == 0, f"{name}: the card path built neighbor windows"
            st = state_to_numpy(eng.state)
            st["walk_matrix"] = eng.walk_matrix().cpu().numpy()
            states.append(st)
        for k in states[0]:
            if not np.array_equal(states[0][k], states[1][k]):
                raise AssertionError(f"{name}: cuda vs cpu engine differ in {k}")
        assert ops.launches["intersect_next"] == 0, name
        if model.sampler == "factorized":     # the corpus, and unfused steps
            assert ops.launches["intersect_csr"] > 0, name
        if mk == "fused":
            assert ops.launches["fused_rewalk_step"] > 0, name
        fields[name] = len(states[0])
    log("small_e2e", ok=True, n_vertices=n, batches=6, hub_degree=300,
        fields_compared=fields)


def phase_small_maintainer(dev):
    """The maintainer on the card against the same maintainer on the CPU,
    from the same key (the card draws the CPU's tables bit for bit), and
    against a plain engine on the same update keys: the engines bit for bit, the pair and affected counts equal, the
    summed loss within rtol 1e-5 and the tables within rtol 2e-4 / atol
    1e-5 (the reference's tolerance; the card's scatter-add uses atomics).
    Under a pair budget, as at full width (the lane subsample): training
    every live pair at this size puts ~470 pairs a batch on each input
    row, where lr 0.01 diverges (tests/test_torch_cuda.py runs that case
    at lr 0.001)."""
    rng = np.random.default_rng(4)
    n = 512
    src, dst = hub_edges(rng, n, 6000, hubs=4, hub_degree=300)
    ins = rng.integers(0, n, size=(2, 6, 60))
    dels = rng.integers(0, n, size=(2, 6, 20))
    wcfg = WalkConfig(n_walks_per_vertex=4, length=16)
    mcfg = MaintainerConfig(walk=wcfg, n_vertices=n, rewalk_capacity=n * 4, max_pending=4,
                            **dict(MAINT, max_pairs=4096))
    runs = []
    for d in (torch.device("cpu"), dev):
        ops.reset_launches()    # the card's run comes last
        g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
        store = generate_corpus(jr.PRNGKey(1, d), g, wcfg)
        mt = EmbeddingMaintainer(graph=g, store=store, cfg=mcfg, key=jr.PRNGKey(3, d))
        init = {k: v.clone() for k, v in mt.params.items()}
        if d.type == "cuda":   # `normal` on the card = on the CPU, bit for bit
            for k, v in init.items():
                assert torch.equal(v.cpu(), runs[0]["init"][k]), f"initial {k} table"
        m = mt.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1],
                          train_key=jr.PRNGKey(5, d))
        plain = WalkEngine(graph=g, store=store, cfg=wcfg, rewalk_capacity=n * 4,
                           max_pending=4)
        plain.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        st, st_plain = state_to_numpy(mt.state.engine), state_to_numpy(plain.state)
        for k in st:
            if not np.array_equal(st[k], st_plain[k]):
                raise AssertionError(f"maintainer engine != plain engine in {k} ({d})")
        runs.append(dict(state=st, metrics=[t.cpu() for t in m], init=init,
                         params=mt.params))
    cpu, card = runs
    for k in cpu["state"]:
        if not np.array_equal(cpu["state"][k], card["state"][k]):
            raise AssertionError(f"maintainer: cuda vs cpu engine differ in {k}")
    (loss_c, pairs_c, aff_c), (loss_d, pairs_d, aff_d) = cpu["metrics"], card["metrics"]
    assert torch.equal(pairs_c, pairs_d) and torch.equal(aff_c, aff_d), "pair counts"
    torch.testing.assert_close(loss_d, loss_c, rtol=1e-5, atol=0)
    for k in ("in", "out"):
        torch.testing.assert_close(card["params"][k].cpu(), cpu["params"][k],
                                   rtol=2e-4, atol=1e-5)
    assert ops.launches["sgns_step"] == 6, ops.launches
    log("small_maintainer", ok=True, n_vertices=n, batches=6, max_pairs=4096,
        n_pairs=pairs_d.tolist(), n_affected=aff_d.tolist(),
        loss_rel_diff=float(((loss_d - loss_c).abs() / loss_c.abs()).max()))


def phase_small_metrics(dev):
    """The order-1 stream with `WalkConfig(metrics=True)` on the card: its
    state equals the plain (metrics OFF) run's, its counters the CPU's;
    the OFF run launches exactly the kernels of the plain step loop
    (`update.stream_step_aux` without metrics), in count."""
    rng = np.random.default_rng(5)
    n = 512
    src, dst = rng.integers(0, n, size=(2, 6000))
    ins = rng.integers(0, n, size=(2, 6, 60))
    dels = rng.integers(0, n, size=(2, 6, 20))

    def engine(d, metrics):
        cfg = WalkConfig(n_walks_per_vertex=4, length=16, metrics=metrics)
        g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
        return WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(1, d), g, cfg),
                          cfg=cfg, rewalk_capacity=n * 4, max_pending=4)

    out, launches = {}, {}
    for name, d, metrics in (("off", dev, False), ("on", dev, True),
                             ("on_cpu", torch.device("cpu"), True)):
        eng = engine(d, metrics)
        ops.reset_launches()
        eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        launches[name] = dict(ops.launches)
        out[name] = eng
    plain = engine(dev, False)
    keys = jr.split(jr.PRNGKey(2, dev), ins.shape[1])
    state = plain.state
    ops.reset_launches()
    for i in range(ins.shape[1]):
        state, _ = update.stream_step_aux(
            state, keys[i], *(torch.from_numpy(a[i]).to(dev) for a in
                              (ins[0], ins[1], dels[0], dels[1])),
            plain.cfg, plain.rewalk_capacity, plain._mav_capacity(),
            plain.max_pending, plain.merge_policy, plain.merge_impl)
    launches["plain"] = dict(ops.launches)
    assert launches["off"] == launches["plain"], launches
    a, b = state_to_numpy(out["off"].state), state_to_numpy(out["on"].state)
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"metrics ON != OFF in {k}")
    summ = export.summary(out["on"].metrics)
    assert summ == export.summary(out["on_cpu"].metrics), "metrics: card != CPU"
    assert summ["steps"] == ins.shape[1] and summ["staleness"]["audit"]["invalid"] == 0
    log("small_metrics", ok=True, n_vertices=n, batches=ins.shape[1],
        state_equals_metrics_off=True, counters_equal_cpu=True,
        launches_off=launches["off"], launches_on=launches["on"], summary=summ)


# ---------------------------------------------------------------- phase 3


def uniform_pairs(gen, n, m, dev):
    return (torch.randint(0, n, (m,), generator=gen, device=dev),
            torch.randint(0, n, (m,), generator=gen, device=dev))


def phase_full(dev):
    c = CONFIG
    n = c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"])
    n_walks = n * cfg.n_walks_per_vertex
    gen = torch.Generator(device=dev)
    gen.manual_seed(2022)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni, nd = c["n_batches"], c["batch_inserts"], c["batch_deletes"]
    # nb batches for the main path and one more for the profiled batch
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    dels = [x.reshape(nb + 1, nd) for x in uniform_pairs(gen, n, (nb + 1) * nd, dev)]
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the main path, counted from here
    graph, t_graph = sync_time(lambda: StreamingGraph.from_edges(
        src, dst, n, c["edge_capacity"], device=dev))
    del src, dst
    store, t_corpus = sync_time(lambda: generate_corpus(
        jr.PRNGKey(0, dev), graph, cfg))
    eng = WalkEngine(graph=graph, store=store, cfg=cfg,
                     merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                     rewalk_capacity=n_walks, max_pending=c["max_pending"])
    del store
    key = jr.PRNGKey(1, dev)
    batch_ms, affected, batch_launches = [], [], []
    for i in range(nb):
        before = dict(ops.launches)
        aff, dt = sync_time(lambda: eng.run_stream(
            jr.fold_in(key, i), ins[0][i:i + 1], ins[1][i:i + 1],
            dels[0][i:i + 1], dels[1][i:i + 1]))
        batch_ms.append(dt * 1e3)
        affected.append(int(aff[0]))
        batch_launches.append({k: ops.launches[k] - before[k] for k in ORDER1_KERNELS})
    _, t_merge = sync_time(eng.merge)
    # the merged engine, for phase 3b's maintainer to equal bit for bit
    host_state = {k: v.to("cpu", copy=True)
                  for k, v in state_tensors(eng, pending=False).items()}
    store = eng.store
    decoded, t_decode = sync_time(lambda: store.packed_view().decode())
    g2 = torch.Generator(device=dev)
    g2.manual_seed(7)
    w = torch.randint(0, n_walks, (1 << 16,), generator=g2, device=dev)
    start = walk_start_vertex(w, cfg.n_walks_per_vertex)
    paths, t_trav = sync_time(lambda: store.traverse(w, start, cfg.length - 1))
    qp = torch.randint(0, cfg.length - 1, (1 << 16,), generator=g2, device=dev)
    qv = paths[torch.arange(1 << 16, device=dev), qp]
    (fn_v, fn_found), t_point = sync_time(lambda: store.find_next(qv, w, qp))
    launches = dict(ops.launches)   # ---- read just after the main path
    peak = torch.cuda.max_memory_allocated()

    assert not eng.mav_overflowed, "MAV gather overflow"
    assert all(a <= n_walks for a in affected), affected
    f, _ = ops.szudzik_unpair(store.code)
    assert torch.equal(torch.sort(f).values,
                       torch.arange(store.size, device=dev)), \
        "a slot f = w*l+p is not stored exactly once"
    del f
    assert torch.equal(decoded[:store.size], store.code), "packed decode != code"
    del decoded
    a, b = paths[:, :-1].reshape(-1), paths[:, 1:].reshape(-1)
    deg = eng.graph.degrees().to(torch.int64)
    ok = eng.graph.has_edge(a, b) | ((a == b) & (deg[a] == 0))
    assert bool(ok.all()), "a traversed step is not a graph edge"
    assert bool(fn_found.all()), "a point FINDNEXT on a stored walk missed"
    assert torch.equal(fn_v, paths[torch.arange(1 << 16, device=dev), qp + 1])
    pv, pf = store.find_next(qv, w, qp, backend="torch")
    assert torch.equal(pv, fn_v) and torch.equal(pf, fn_found), \
        "point FINDNEXT: kernel != plain"
    for k in ORDER1_KERNELS:
        assert launches[k] > 0, f"kernel {k} was not launched on the main path"
    prof = profile_batch(lambda: eng.run_stream(
        jr.fold_in(key, nb), ins[0][nb:], ins[1][nb:], dels[0][nb:], dels[1][nb:]))
    res = dict(config=CONFIG, n_walks=n_walks, triplets=store.size,
               chunks=store.n_chunks, edges=int(eng.graph.num_edges),
               graph_build_s=t_graph, corpus_build_s=t_corpus,
               batch_update_ms=batch_ms,
               affected_share=[x / n_walks for x in affected],
               merge_s=t_merge, decode_s=t_decode,
               traverse_2p16_walks_s=t_trav, point_findnext_2p16_s=t_point,
               peak_mem_gb=peak / 1e9, launches=launches,
               launches_per_batch=batch_launches, profiled_batch=prof)
    log("reduced", **REDUCED)
    log("full_width", **res)
    return res, dict(store=store, queries=(qv, w, qp), n_walks=n_walks, gen=g2,
                     host_state=host_state)


def phase_maintainer(dev, host_state):
    """Phase 3b: the downstream maintainer over phase 3's graph, corpus and
    update keys (the same generator draws), SGNS at MAINT's widths. The
    counts are set to 0 before the timed batches and read just after
    them; the operands of the last timed batch's SGNS call are kept for
    phase 5."""
    c = CONFIG
    n = c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"])
    n_walks = n * cfg.n_walks_per_vertex
    gen = torch.Generator(device=dev)
    gen.manual_seed(2022)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni, nd = c["n_batches"], c["batch_inserts"], c["batch_deletes"]
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    dels = [x.reshape(nb + 1, nd) for x in uniform_pairs(gen, n, (nb + 1) * nd, dev)]
    torch.cuda.reset_peak_memory_stats()
    graph = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"], device=dev)
    edges = int(graph.num_edges)
    del src, dst
    mcfg = MaintainerConfig(walk=cfg, n_vertices=n, rewalk_capacity=n_walks,
                            max_pending=c["max_pending"], merge_policy=c["merge_policy"],
                            merge_impl=c["merge_impl"], **MAINT)
    mt = EmbeddingMaintainer(graph=graph, store=generate_corpus(jr.PRNGKey(0, dev), graph, cfg),
                             cfg=mcfg, key=jr.PRNGKey(5, dev))
    del graph
    in0 = mt.params["in"].clone()
    key, tkey = jr.PRNGKey(1, dev), jr.PRNGKey(6, dev)   # key: phase 3's update key

    def batch(i):
        return mt.run_stream(jr.fold_in(key, i), ins[0][i:i + 1], ins[1][i:i + 1],
                             dels[0][i:i + 1], dels[1][i:i + 1],
                             train_key=jr.fold_in(tkey, i))

    batch_ms, n_pairs, n_affected, loss_per_pair = [], [], [], []
    ops.reset_launches()    # ---- the maintainer's batches, counted from here
    for i in range(nb):
        with (keep_operands("sgns_step", 0) if i == nb - 1
              else contextlib.nullcontext()) as got:
            m, dt = sync_time(lambda: batch(i))
        if i == 0:
            in_unchanged = torch.equal(mt.params["in"], in0)
        batch_ms.append(dt * 1e3)
        n_pairs.append(int(m.n_pairs[0]))
        n_affected.append(int(m.n_affected[0]))
        loss_per_pair.append(float(m.loss_sum[0]) / max(n_pairs[-1], 1))
    launches = dict(ops.launches)   # ---- read just after them
    peak = torch.cuda.max_memory_allocated() / 1e9
    del in0
    kept = got.pop()

    assert launches["sgns_step"] == nb, launches
    assert not mt.mav_overflowed, "MAV gather overflow"
    assert all(np.isfinite(loss_per_pair)), loss_per_pair
    assert all(0 < p <= mcfg.pair_batch for p in n_pairs), (n_pairs, mcfg.pair_batch)
    assert in_unchanged, "the input table changed in the first batch (out = 0, so du = 0)"
    six_ln2 = 6 * float(np.log(2.0))
    assert abs(loss_per_pair[0] / six_ln2 - 1) <= SGNS_LOSS_RTOL, (loss_per_pair[0], six_ln2)
    # merge; the engine must equal phase 3's plain engine bit for bit
    view = mt.engine_view()
    _, t_merge = sync_time(view.merge)
    for k, v in state_tensors(view, pending=False).items():
        if not torch.equal(v.cpu(), host_state[k]):
            raise AssertionError(f"maintainer engine != phase 3's engine in {k}")
    mt.load_state(mt.state._replace(engine=view.state))
    del view
    tables_finite = all(bool(torch.isfinite(t).all()) for t in mt.params.values())
    assert tables_finite, "a table holds a non-finite value"
    prof = profile_batch(lambda: batch(nb), kernel="sgns_kernel")
    res = dict(config=dict(CONFIG, **MAINT), n_walks=n_walks,
               pairs_per_walk=mcfg.pairs_per_walk, pair_batch=mcfg.pair_batch,
               lanes_trained=-(-mcfg.pair_batch // mcfg.pairs_per_walk),
               batch_ms=batch_ms, n_pairs=n_pairs, n_affected=n_affected,
               loss_per_pair=loss_per_pair, first_loss_per_pair_over_6ln2=loss_per_pair[0] / six_ln2,
               in_table_unchanged_after_batch_1=in_unchanged,
               engine_equals_phase3=True, merge_s=t_merge, peak_mem_gb=peak,
               launches=launches, profiled_batch=prof)
    log("reduced_maintainer", **MAINT_REDUCED)
    log("maintainer", **res)
    return res, kept, mt


# ---------------------------------------------------------------- phase 3c


def timed_queries(svc, kind: str, batch_args, call_args) -> dict:
    """Synced host time a query of one kind: one batched call of B queries
    (after a warm-up call of the same shape), then `per_call_reps` single
    calls -> {"batched_us_per_query", "per_call_us"}."""
    fn = getattr(svc, kind)
    fn(*batch_args)
    _, t_b = sync_time(lambda: fn(*batch_args))
    times = []
    for args in call_args:
        _, t = sync_time(lambda: fn(*args))
        times.append(t)
    b = SERVE["batch"]
    return {"batched_us_per_query": t_b / b * 1e6, "batch": b,
            "per_call_us": float(np.mean(times)) * 1e6, "calls": len(times)}


def pinned_answers(svc, snap, q, verts, w, start) -> dict:
    """What a pinned snapshot answers, read anew (no cache): FINDNEXT, the
    walks of some vertices, and the overlay's own traverse of walks w."""
    nxt, found = svc.next_vertices(*q, snapshot=snap)
    return {"next": nxt, "found": found,
            "walks_of": svc.walks_of(verts, capacity=SERVE["walks_of_capacity"],
                                     snapshot=snap),
            "traverse": snap.overlay.traverse(w, start, svc.engine.store.length - 1)}


def row_sets(rows) -> list:
    return [set(r[r >= 0].tolist()) for r in rows.cpu()]


def overlay_on_cpu(ov):
    """The overlay's tensors copied to the CPU, where every read takes the
    kernels' plain versions (pair, unpair and the packed FINDNEXT)."""
    st = ov.base
    base = st.replace(**{f.name: getattr(st, f.name).cpu()
                         for f in dataclasses.fields(st)
                         if torch.is_tensor(getattr(st, f.name))})
    return ov.replace(base=base, **{f.name: getattr(ov, f.name).cpu()
                                    for f in dataclasses.fields(ov)
                                    if f.name != "base"})


def walk_matrix_plain(st, slab: int = 1 << 24):
    """The walk matrix read off a merged store, with the plain unpair: the
    entry of slot f = w * l + p is owned by walk w's vertex at position p.
    Every slot must hold exactly one live entry."""
    t = st.n_walks * st.length
    assert st.size == t, (st.size, t)
    out = torch.full((t,), -1, dtype=torch.int64, device=st.device)
    for s in range(0, t, slab):
        f, _ = szudzik.unpair_plain(st.code[s:s + slab])
        assert bool(((f >= 0) & (f < t)).all()), "a merged code names no slot"
        assert torch.equal(st.epoch[s:s + slab], st.slot_epoch[f]), \
            "a merged entry is not live"
        out[f] = st.owner[s:s + slab].to(torch.int64)
    assert bool((out >= 0).all()), "a slot holds no entry after the merge"
    return out.reshape(st.n_walks, st.length)


def segment_walks_plain(st, verts):
    """The walk ids of each vertex's segment in a merged store, -1 padded:
    its chunks decoded by the plain FOR decode, its codes unpaired by the
    plain unpair."""
    lo, hi = st.offsets[verts].to(torch.int64), st.offsets[verts + 1].to(torch.int64)
    idx = lo[:, None] + torch.arange(int((hi - lo).max()), device=lo.device)[None]
    pos = idx.clamp(max=st.size - 1)
    chunks, inv = torch.unique(pos // CHUNK, return_inverse=True)
    codes = delta.decode_rows_plain(st.packed, st.widths, st.anchors_hi,
                                    st.anchors_lo, chunks)[inv, pos % CHUNK]
    f, _ = szudzik.unpair_plain(codes)
    return torch.where(idx < hi[:, None], f // st.length, -1)


def walks_of_vertices(eng, gen, cap: int):
    """B vertices drawn at random among those whose every walk walks_of at
    capacity `cap` returns: the base segment (live and stale entries) and
    the pending rows (not dead) of the vertex both fit in `cap` (the
    query's contract returns the first `cap` of each) -> (vertices,
    vertices that fit, max base segment)."""
    store, n = eng.store, eng.store.n_vertices
    seg = (store.offsets[1:] - store.offsets[:-1]).to(torch.int64)
    pend = eng.overlay()
    owners = pend.owner[pend.epoch != PAD_EPOCH].to(torch.int64)
    per_v = torch.bincount(owners, minlength=n)
    fits = torch.nonzero((seg <= cap) & (per_v <= cap)).reshape(-1)
    pick = torch.randperm(fits.numel(), generator=gen, device=fits.device)
    return fits[pick[:SERVE["batch"]]].sort().values, int(fits.numel()), int(seg.max())


def phase_serve(dev, mt):
    """Phase 3c: a WalkQueryService over phase 3b's maintainer, pending
    block live. The counts are set to 0 before the serve path (the live
    queries of every kind and the pinned reads) and read just after it;
    the checks against plain versions, merges and timings come after."""
    c, s = CONFIG, SERVE
    cap, b = s["walks_of_capacity"], s["batch"]
    eng = mt.engine_view()
    pending_at_first_query = eng.n_pending
    assert pending_at_first_query >= 1, "no pending block is live"
    svc = WalkQueryService(engine=eng)
    n, n_w, length = eng.store.n_vertices, eng.cfg.n_walks_per_vertex, eng.store.length
    n_walks = n * n_w
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    verts, fitting, max_seg = walks_of_vertices(eng, gen, cap)
    qw = torch.randint(0, n_walks, (s["next_queries"],), generator=gen, device=dev)
    qp = torch.randint(0, length - 1, (s["next_queries"],), generator=gen, device=dev)
    tw = torch.randint(0, n_walks, (s["pin_traverse_walks"],), generator=gen, device=dev)
    collector = slo.install(slo.ServeSLO())
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the serve path, counted from here
    wm, t_wm = sync_time(svc.walk_matrix)
    q = (wm[qw, qp], qw, qp)
    (nxt, found), t_next = sync_time(lambda: svc.next_vertices(*q))
    wof, t_wof = sync_time(lambda: svc.walks_of(verts, capacity=cap))
    nbh, t_nbh = sync_time(lambda: svc.neighborhoods(verts, hops=s["hops"]))
    svc.set_embedding_table(mt.embeddings)
    (e_ids, e_sc), t_emb = sync_time(lambda: svc.embedding_neighbors(verts, k=s["k"]))
    snap, t_pin = sync_time(svc.pin)
    pinned = pinned_answers(svc, snap, q, verts, tw, walk_start_vertex(tw, n_w))
    torch.cuda.synchronize()
    launches = dict(ops.launches)   # ---- read just after it
    for kname in ORDER1_KERNELS:
        assert launches[kname] > 0, f"kernel {kname} was not launched on the serve path"

    assert bool(found.all()), "a FINDNEXT on a stored walk missed"
    assert torch.equal(nxt, wm[qw, qp + 1]), "next_vertices != the walk matrix"
    plain = WalkQueryService(engine=eng, backend="torch")
    pn, pf = plain.next_vertices(*q)
    assert torch.equal(pn, nxt) and torch.equal(pf, found), \
        "next_vertices: kernel != plain backend"
    # one batch with the plain pair, unpair and FINDNEXT: a CPU copy
    cpu_ov = overlay_on_cpu(eng.overlay())
    (cn, cf), t_cpu_next = sync_time(lambda: batched.find_next_batch(
        cpu_ov, *(x.cpu() for x in q), backend="torch"))
    assert torch.equal(nxt.cpu(), cn) and torch.equal(found.cpu(), cf), \
        "next_vertices: card != the plain versions on the CPU"
    del cpu_ov, cn, cf
    assert torch.equal(nbh, wm[(verts[:, None] * n_w + torch.arange(n_w, device=dev))
                               .reshape(-1), :s["hops"] + 1].reshape(len(verts), n_w, -1)), \
        "neighborhoods != a gather of the walk matrix"
    table = mt.embeddings.cpu()
    c_ids, c_sc = batched.embedding_topk(batched.normalize_rows(table),
                                         verts.cpu(), s["k"])
    assert torch.equal(e_ids.cpu(), c_ids), "embedding_neighbors: card ids != CPU ids"
    emb_err = float((e_sc.cpu() - c_sc).abs().max())
    assert emb_err <= 1e-5, emb_err
    del table

    # the post-merge answers of the pinned state
    _, t_merge = sync_time(eng.merge)
    w_all = torch.arange(n_walks, device=dev)
    post, t_trav = sync_time(lambda: eng.store.traverse(
        w_all, walk_start_vertex(w_all, n_w), length - 1))
    assert torch.equal(post, wm), "overlay walk matrix != post-merge traverse"
    del post
    assert torch.equal(walk_matrix_plain(eng.store), wm), \
        "overlay walk matrix != the merged store read with the plain unpair"
    assert row_sets(wof) == row_sets(segment_walks_plain(eng.store, verts)), \
        "walks_of != the post-merge segments"

    # two more batches and a merge: the pinned answers stay bit-identical
    g2 = torch.Generator(device=dev)
    g2.manual_seed(2025)
    key = jr.PRNGKey(1, dev)
    nb = s["extra_batches"]
    ins = [x.reshape(nb, -1) for x in uniform_pairs(g2, n, nb * c["batch_inserts"], dev)]
    dels = [x.reshape(nb, -1) for x in uniform_pairs(g2, n, nb * c["batch_deletes"], dev)]
    for i in range(nb):
        eng.run_stream(jr.fold_in(key, c["n_batches"] + 1 + i), ins[0][i:i + 1],
                       ins[1][i:i + 1], dels[0][i:i + 1], dels[1][i:i + 1])
    eng.merge()
    again = pinned_answers(svc, snap, q, verts, tw, walk_start_vertex(tw, n_w))
    for k in pinned:
        if not torch.equal(again[k], pinned[k]):
            raise AssertionError(f"pinned {k} changed after {nb} batches and a merge")
    pin_bytes = snap.nbytes
    snap.release()
    assert eng.pins_active == 0
    del again, pinned, snap

    # per query kind: synced time a query, batched (B) and per call
    reps = s["per_call_reps"]
    single = [([int(v)],) for v in verts[:reps].tolist()]
    q1 = [(q[0][i:i + 1], q[1][i:i + 1], q[2][i:i + 1]) for i in range(reps)]
    timing = {
        "next_vertices": timed_queries(svc, "next_vertices",
                                       tuple(x[:b] for x in q), q1),
        "walks_of": timed_queries(svc, "walks_of", (verts, cap),
                                  [(v, cap) for (v,) in single]),
        "neighborhoods": timed_queries(svc, "neighborhoods", (verts, s["hops"]),
                                       [(v, s["hops"]) for (v,) in single]),
        "embedding_neighbors": timed_queries(svc, "embedding_neighbors",
                                             (verts, s["k"]),
                                             [(v, s["k"]) for (v,) in single]),
    }
    peak = torch.cuda.max_memory_allocated() / 1e9
    counters = svc.obs_counters()
    del svc, plain, wm, eng
    ppr = serve_ppr(dev, timing)
    summ = collector.summary()
    slo.uninstall()
    res = dict(n_vertices=n, n_walks=n_walks,
               pending_blocks_at_first_query=pending_at_first_query,
               launches=launches, walk_matrix_s=t_wm, next_vertices_2p16_s=t_next,
               walks_of_1024_s=t_wof, neighborhoods_1024_s=t_nbh,
               embedding_neighbors_1024_s=t_emb,
               walks_of_vertices_that_fit=fitting, max_base_segment=max_seg,
               pin=dict(bytes=pin_bytes, seconds=t_pin),
               merge_s=t_merge, post_merge_traverse_s=t_trav,
               next_vertices_kernel_equals_plain=True, pinned_bit_identical=True,
               walk_matrix_equals_post_merge=True, walks_of_equals_segments=True,
               next_vertices_plain_cpu_s=t_cpu_next,
               embedding_ids_equal_cpu=True, embedding_max_abs_err=emb_err,
               ppr=ppr, per_query=timing, peak_mem_gb=peak,
               obs_counters=counters, slo=summ)
    log("reduced_serve", **SERVE_REDUCED)
    log("serve", **res)
    return res


def serve_ppr(dev, timing):
    """ppr_rows on an engine of its own at SERVE's PPR vertex count (the
    dense table), a pending block live: the table built twice on the card
    is bit-identical and equals the CPU's within rtol 1e-5; its query times
    go into `timing`."""
    c, s = CONFIG, SERVE
    n = s["ppr_vertices"]
    scale = n / c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"], length=c["length"],
                     chunk_b=c["chunk_b"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    g = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"] // 8, device=dev)
    eng = WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(0, dev), g, cfg),
                     cfg=cfg, merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                     rewalk_capacity=n * cfg.n_walks_per_vertex,
                     max_pending=c["max_pending"])
    ins = uniform_pairs(gen, n, int(c["batch_inserts"] * scale), dev)
    dels = uniform_pairs(gen, n, int(c["batch_deletes"] * scale), dev)
    eng.run_stream(jr.PRNGKey(1, dev), ins[0][None], ins[1][None], dels[0][None],
                   dels[1][None])
    svc = WalkQueryService(engine=eng)
    verts = torch.randperm(n, generator=gen, device=dev)[:s["batch"]]
    rows, t_cold = sync_time(lambda: svc.ppr_rows(verts, s["restart_prob"]))
    wm = svc.walk_matrix()
    a, t_table = sync_time(lambda: batched.ppr_table(wm, n, s["restart_prob"]))
    b = batched.ppr_table(wm, n, s["restart_prob"])
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
        "the PPR table built twice on the card differs"
    del b
    assert torch.equal(rows, a[verts]), "ppr_rows != the table's rows"
    cpu = batched.ppr_table(wm.cpu(), n, s["restart_prob"]).to(dev)
    rel = ((a - cpu).abs() / cpu.abs().clamp(min=1e-30)).max().item()
    zeros_agree = bool(torch.equal(a == 0, cpu == 0))
    torch.testing.assert_close(a, cpu, rtol=s["ppr_rtol"], atol=0)
    bits_equal = bool(torch.equal(a.view(torch.int32), cpu.view(torch.int32)))
    del cpu, a
    timing["ppr_rows"] = timed_queries(svc, "ppr_rows", (verts, s["restart_prob"]),
                                       [([int(v)], s["restart_prob"])
                                        for v in verts[:s["per_call_reps"]].tolist()])
    return dict(n_vertices=n, n_walks=eng.store.n_walks, table_gb=n * n * 4 / 1e9,
                cold_rows_s=t_cold, table_build_s=t_table,
                deterministic_on_card=True, max_rel_diff_cpu=rel,
                zeros_agree_cpu=zeros_agree, bit_equal_cpu=bits_equal)


def n2v_stream(dev):
    """Phase 4's walk config and data from its seeded generator: the
    graph's edges, then the inserts of the timed batches and the profiled
    one -> (cfg, src, dst, ins, the generator)."""
    c = N2V
    n = c["n_vertices"]
    model = WalkModel(order=2, p=c["p"], q=c["q"], sampler=c["sampler"],
                      dmax=c["dmax"])
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"], model=model,
                     megakernel="off")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2023)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni = c["n_batches"], c["batch_inserts"]
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    return cfg, src, dst, ins, gen


def n2v_graph(src, dst, dev):
    """Phase 4's graph from its edges."""
    return StreamingGraph.from_edges(src, dst, N2V["n_vertices"], N2V["edge_capacity"],
                                     device=dev)


def n2v_corpus(graph, cfg, dev):
    """Phase 4's corpus under its key."""
    return generate_corpus(jr.PRNGKey(0, dev), graph, cfg)


def n2v_engine(graph, store, cfg, megakernel: str):
    """Phase 4's engine over this graph and corpus."""
    c = N2V
    return WalkEngine(graph=graph, store=store, cfg=cfg._replace(megakernel=megakernel),
                      merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                      rewalk_capacity=c["n_vertices"] * cfg.n_walks_per_vertex,
                      max_pending=c["max_pending"])


def n2v_batch(eng, ins, i: int):
    """Batch i of phase 4's stream under its key: the timed batches i <
    n_batches one insert row each, then (i = n_batches) the profiled batch,
    the remaining rows and an empty delete list -> the affected counts."""
    dev, nb = ins[0].device, N2V["n_batches"]
    key = jr.fold_in(jr.PRNGKey(1, dev), i)
    if i < nb:
        return eng.run_stream(key, ins[0][i:i + 1], ins[1][i:i + 1])
    no_dels = [torch.zeros((1, 0), dtype=torch.int64, device=dev)] * 2
    return eng.run_stream(key, ins[0][nb:], ins[1][nb:], *no_dels)


def phase_full_n2v(dev):
    """wharf-stream order 2 at full width: the corpus once, then the
    batches unfused and again fused from the same corpus and keys. The
    counts are set to 0 before the corpus and before each path's batches
    and read just after them."""
    c = N2V
    n = c["n_vertices"]
    cfg, src, dst, ins, gen = n2v_stream(dev)
    n_walks = n * cfg.n_walks_per_vertex
    nb = c["n_batches"]
    w = torch.randint(0, n_walks, (1 << 14,), generator=gen, device=dev)
    start = walk_start_vertex(w, cfg.n_walks_per_vertex)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the corpus, counted from here
    with window_calls() as wins:
        graph, t_graph = sync_time(lambda: n2v_graph(src, dst, dev))
        del src, dst
        store0, t_corpus = sync_time(lambda: n2v_corpus(graph, cfg, dev))
    launches = {"corpus": dict(ops.launches)}
    windows = {"corpus": wins[0]}
    peak = {"corpus": torch.cuda.max_memory_allocated() / 1e9}
    deg = graph.degrees().to(torch.int64)
    triplets = store0.size
    runs, saved, kept = {}, None, {}
    for path, mk in (("unfused", "off"), ("fused", "cuda")):
        eng = n2v_engine(graph, store0, cfg, mk)
        if path == "fused":
            del store0
        batch_ms, affected, batch_launches = [], [], []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()    # ---- this path's batches, counted from here
        with window_calls() as wins:
            for i in range(nb):
                before = dict(ops.launches)
                aff, dt = sync_time(lambda: n2v_batch(eng, ins, i))
                batch_ms.append(dt * 1e3)
                affected.append(int(aff[0]))
                batch_launches.append({k: ops.launches[k] - before[k]
                                       for k in ops.KERNELS})
        launches[path] = dict(ops.launches)   # ---- read just after them
        windows[path] = wins[0]
        peak[path] = torch.cuda.max_memory_allocated() / 1e9
        assert not eng.mav_overflowed, "MAV gather overflow"
        state = state_tensors(eng)
        if saved is None:
            saved = {k: v.to("cpu", copy=True) for k, v in state.items()}
        else:
            for k, v in state.items():
                if not torch.equal(v.cpu(), saved[k]):
                    raise AssertionError(f"order 2: fused != unfused in {k}")
            del saved
        del state
        # one more batch under the profiler, with 3 pending blocks; the
        # operands of one call of each kernel named here are kept for
        # phase 5 (unfused: a rewalk step's kernel 5, and the first
        # prefix-read call's kernel 4, whose device time and share of the
        # prefix read the profile reports)
        if path == "unfused":
            keep = {"intersect_csr": cfg.length // 2, "find_next_packed": 0}
            watch = dict(kernel="search_kernel", layer="wharf.prefix")
        else:
            keep, watch = {"fused_rewalk_step": 5}, {}
        with contextlib.ExitStack() as stack:
            got = {name: stack.enter_context(keep_operands(name, at))
                   for name, at in keep.items()}
            wins = stack.enter_context(window_calls())
            prof = profile_batch(lambda: n2v_batch(eng, ins, nb), **watch)
        windows[path] += wins[0]
        for name, g in got.items():
            assert g, f"{name}: operands not kept"
            kept[name] = g.pop()
            if path == "unfused":   # off the card while the fused path runs
                kept[name] = [t.cpu() if isinstance(t, torch.Tensor) else t
                              for t in kept[name]]
        # the overlay read (base + pending) = the read after the merge
        ov_paths, t_ov = sync_time(lambda: eng.overlay().traverse(
            w, start, cfg.length - 1))
        _, t_merge = sync_time(eng.merge)
        paths, t_trav = sync_time(lambda: eng.store.traverse(w, start, cfg.length - 1))
        assert torch.equal(ov_paths, paths), "overlay traverse != post-merge traverse"
        a, b = paths[:, :-1].reshape(-1), paths[:, 1:].reshape(-1)
        ok = eng.graph.has_edge(a, b) | ((a == b) & (eng.graph.degrees()[a] == 0))
        assert bool(ok.all()), "a traversed order-2 step is not a graph edge"
        runs[path] = dict(batch_update_ms=batch_ms,
                          affected_share=[x / n_walks for x in affected],
                          launches_per_batch=batch_launches, merge_s=t_merge,
                          overlay_traverse_2p14_s=t_ov,
                          traverse_2p14_walks_s=t_trav, profiled_batch=prof)
        if path == "fused":
            f, _ = ops.szudzik_unpair(eng.store.code)
            assert torch.equal(torch.sort(f).values,
                               torch.arange(eng.store.size, device=dev)), \
                "a slot f = w*l+p is not stored exactly once"
            del f
        del eng
    total = {k: sum(launches[p][k] for p in launches) for k in ops.KERNELS}
    assert launches["corpus"]["intersect_csr"] > 0
    assert launches["unfused"]["intersect_csr"] > 0
    assert launches["unfused"]["find_next_packed"] > 0
    assert launches["fused"]["fused_rewalk_step"] > 0
    assert launches["fused"]["intersect_csr"] == 0
    assert launches["unfused"]["fused_rewalk_step"] == 0
    assert total["intersect_next"] == 0, "a main path launched the windowed kernel"
    assert windows == dict.fromkeys(windows, 0), f"a card path built windows: {windows}"
    res = dict(config=N2V, n_walks=n_walks, triplets=triplets,
               edges=int(graph.num_edges), max_degree=int(deg.max()),
               vertices_over_dmax_share=float((deg > c["dmax"]).float().mean()),
               graph_build_s=t_graph, corpus_build_s=t_corpus, runs=runs,
               fused_equals_unfused=True, peak_mem_gb=peak,
               launches=launches, launches_total=total,
               neighbor_window_calls=windows)
    log("reduced_n2v", **N2V_REDUCED)
    log("full_width_n2v", **res)
    return res, kept


@contextlib.contextmanager
def keep_operands(name: str, k: int):
    """Within the block, `ops.<name>` keeps the operands of its k-th call
    (k = 0: the first) in the list it yields; every call goes to the
    wrapper itself, which counts its launch. The engine looks the wrapper
    up on `ops` at each call."""
    wrapped = getattr(ops, name)
    kept, calls = [], [0]

    def keep(*args):
        if calls[0] == k:
            kept.append(args)
        calls[0] += 1
        return wrapped(*args)

    setattr(ops, name, keep)
    try:
        yield kept
    finally:
        setattr(ops, name, wrapped)


@contextlib.contextmanager
def window_calls():
    """Within the block, count the calls of `intersect.neighbor_window`, the
    torch window builder that no card path of order 2 may call, in the
    one-element list it yields (`walkers._neighbor_window` goes through
    it)."""
    build = intersect.neighbor_window
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return build(*args, **kw)

    intersect.neighbor_window = counted
    try:
        yield calls
    finally:
        intersect.neighbor_window = build


def state_tensors(eng, pending: bool = True) -> dict:
    """Every tensor of an engine's state that the comparisons hold equal:
    graph codes, every store array (slot_epoch included), the counters and
    (unless `pending=False`) the pending blocks."""
    st = eng.state
    out = {"graph.codes": st.graph.codes, "total_affected": st.total_affected}
    for f in ("owner", "code", "epoch", "offsets", "vmin", "vmax", "packed",
              "widths", "anchors_hi", "anchors_lo", "last_hi", "last_lo",
              "slot_epoch"):
        out["store." + f] = getattr(st.store, f)
    if pending:
        for f in ("owner", "code", "epoch", "slot"):
            out["pending." + f] = getattr(st.pending, f)
    return out


LAYERS = ("wharf.", "maintainer.")   # the record_function scopes of the port


def profile_batch(run, kernel: str = None, layer: str = None):
    """One more batch, `run()`, under torch.profiler: wall time, the
    device's busy and idle share, the device and host time of each layer
    scope, the top operators by device time and, if named, the device
    time of the kernels whose name holds `kernel` and their share of the
    busy time and of the device time of the scope `layer`.

    Device time comes from the device's own records: every kernel counts
    toward busy time, and a layer's device time is that of the kernels
    that ran inside the layer's span on the device. (The port's kernels are
    launched through ctypes, inside no PyTorch operator, so the profiler
    links them to no host event: a sum of the host events' kernels leaves
    most of them out.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, kerns = {}, []   # layer -> device spans; (start, end, name) a kernel
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(LAYERS):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
        else:
            kerns.append((e.time_range.start, e.time_range.end, e.name))
    busy_ms = sum(t - s for s, t, _ in kerns) / 1e3
    if not busy_ms:
        return dict(wall_ms=wall * 1e3, device_busy="not measured")

    def inside(name, span_list):
        return sum(t - s for s, t, n in kerns if name in n
                   and any(a <= s and t <= b for a, b in span_list)) / 1e3

    layers = {name: inside("", sp) for name, sp in spans.items()}
    layers_host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(LAYERS):
            layers_host[e.name] = layers_host.get(e.name, 0.0) + e.cpu_time_total / 1e3
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.key.startswith(LAYERS)),
                 key=lambda e: -e.self_device_time_total)[:8]
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / (wall * 1e3),
               layer_kernel_ms=layers, layer_host_ms=layers_host,
               top_kernels_ms={e.key[:100]: e.self_device_time_total / 1e3
                               for e in top})
    if kernel:
        k_ms = sum(t - s for s, t, n in kerns if kernel in n) / 1e3
        out[kernel] = dict(device_ms=k_ms, share_of_busy=k_ms / busy_ms)
        if layer:
            out[kernel]["share_of_" + layer] = inside(kernel, spans[layer]) / layers[layer]
    return out


# ---------------------------------------------------------------- phase 4


def bound(bytes_moved: float, ops_done: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def used_words(widths: torch.Tensor) -> torch.Tensor:
    w = widths.to(torch.int64)
    return torch.where(w == 64, 2 * delta.CHUNK, delta.CHUNK * w // 32)


def exact(a, b, what: str) -> float:
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: kernel != plain")
    return 0.0


def kernel_row(rows, name, err, fn, ms, plain_ms, bytes_moved, ops_done, shape,
               **extra):
    """One entry of the `kernels` line for the kernel call `fn`, timed warm
    by the caller (`ms`) and cold here (`ms_cold`), with the SM clock
    measured just after; `launches` is filled in by main() from the main
    paths' counts."""
    b_ms, b_by = bound(bytes_moved, ops_done)
    src, rep = KERNEL_META[name]
    rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=None, max_abs_err=err, ms=ms, ms_cold=cold_ms(fn),
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=shape, sm_clock_mhz=sm_clock_mhz(), **extra))


def search_work(pk, wd, ah, al, cidx, f_t, slab: int = 1 << 16):
    """Bytes and operations of a packed FINDNEXT call on these operands:
    each query's K indices (u32) and target and outputs (u32 v, found);
    each chunk that a query visits (up to and including its first chunk
    with a hit, all K on a miss) read once however many queries visit it
    (used words, width, anchor); per visited code of a query a decode
    step, an unpair and a compare (14 operations). Counted in slabs of
    queries -> (bytes, operations, visited chunks, distinct chunks)."""
    k = cidx.shape[1]
    dev = cidx.device
    seen = torch.zeros(pk.shape[0], dtype=torch.bool, device=dev)
    visited_total = 0
    for s in range(0, cidx.shape[0], slab):
        ci, ft = cidx[s:s + slab].to(torch.int64), f_t[s:s + slab]
        codes = delta.decode_rows_plain(pk, wd, ah, al, ci.reshape(-1))
        fk, _ = pairing.szudzik_unpair(codes)
        hit_k = (fk.reshape(-1, k, delta.CHUNK) == ft[:, None, None]).any(-1)
        visited = torch.where(hit_k.any(-1), hit_k.to(torch.int8).argmax(-1) + 1, k)
        vis_mask = torch.arange(k, device=dev)[None] < visited[:, None]
        seen[ci[vis_mask]] = True
        visited_total += int(visited.sum())
    nbytes = (cidx.numel() * 4.0 + f_t.numel() * 9.0
              + float((used_words(wd)[seen] * 4 + 12).sum()))
    return nbytes, 14.0 * delta.CHUNK * visited_total, visited_total, int(seen.sum())


def phase_kernels(dev, tensors):
    store = tensors["store"]
    rows = []

    def row(*args, **extra):
        kernel_row(rows, *args, **extra)

    # Bytes are counted at the reference's types, which the function needs:
    # vertex ids, slots, positions and epochs are u32 (4 B), codes u64.
    # pair: the rewalk emit shape (one code per lane, n_walks lanes), plus
    # operands at 0 and 2^32-1
    n_walks = tensors["n_walks"]
    f = torch.arange(n_walks, device=dev) * store.length + store.length - 1
    v = torch.randint(0, store.n_vertices, (n_walks,), generator=tensors["gen"],
                      device=dev)
    edge = torch.tensor([0, 2**32 - 1, 2**32 - 1, 0], device=dev)
    f = torch.cat([f, edge])
    v = torch.cat([v, edge.flip(0)])
    err = exact([szudzik.pair_cuda(f, v)], [pairing.szudzik_pair(f, v)], "pair")
    # views off a 16-byte boundary (both operands, or one), odd lengths
    for a, b in ((f[1:], v[1:]), (f[1:], v[:-1]), (f[:-1], v[1:]), (f[2:-1], v[2:-1])):
        exact([szudzik.pair_cuda(a, b)], [pairing.szudzik_pair(a, b)], "pair (views)")
    # the port's types: two int64 operands read, one int64 code written
    run = lambda: szudzik.pair_cuda(f, v)  # noqa: E731
    row("szudzik_pair", err, run, event_ms(run, 20),
        event_ms(lambda: pairing.szudzik_pair(f, v), 3), 16 * f.numel(),
        6 * f.numel(), list(f.shape),
        bound_ms_port_types=24 * f.numel() / HBM_BYTES_PER_S * 1e3)

    # unpair: the MAV gather's share of the store (2^24 codes) plus edge codes
    z = torch.cat([store.code[: 1 << 24], torch.tensor(
        [-(1 << 63), -(1 << 63) + 1, (1 << 63) - 1, (1 << 63) - 2,
         (2**32 - 1) ** 2 - (1 << 63)], device=dev)])
    err = exact(szudzik.unpair_cuda(z), pairing.szudzik_unpair(z), "unpair")
    run = lambda: szudzik.unpair_cuda(z)  # noqa: E731
    row("szudzik_unpair", err, run, event_ms(run, 20),
        event_ms(lambda: pairing.szudzik_unpair(z), 3), 16 * z.numel(),
        12 * z.numel(), list(z.shape))
    t_full = event_ms(lambda: szudzik.unpair_cuda(store.code), 3)
    rows[-1]["ms_full_store"] = t_full
    rows[-1]["bound_ms_full_store"] = 16 * store.size / HBM_BYTES_PER_S * 1e3

    # decode: every chunk of the store (PackedWalkStore.decode)
    pk, wd, ah, al = store.packed, store.widths, store.anchors_hi, store.anchors_lo
    idx = torch.arange(store.n_chunks, device=dev)
    err = exact([delta.decode_rows_cuda(pk, wd, ah, al, idx)],
                [delta.decode_rows_plain(pk, wd, ah, al, idx)], "decode")
    nbytes = float((used_words(wd) * 4 + 4 + 8 + 8 + 8 * delta.CHUNK).sum())
    run = lambda: delta.decode_rows_cuda(pk, wd, ah, al, idx)  # noqa: E731
    row("delta_decode", err, run, event_ms(run, 10),
        event_ms(lambda: delta.decode_rows_plain(pk, wd, ah, al, idx), 1),
        nbytes, 8.0 * delta.CHUNK * store.n_chunks, [store.n_chunks, delta.CHUNK])

    # search: the point-FINDNEXT windows of phase 3 (2^16 queries, K=8)
    qv, w, qp = tensors["queries"]
    f_t = w * store.length + qp
    lb = pairing.szudzik_pair(f_t, (store.vmin[qv].to(torch.int64) & 0xFFFFFFFF))
    lo = seg_searchsorted(store.code, store.offsets[qv], store.offsets[qv + 1],
                          lb, side="left")
    k = 8
    cidx = ((lo // delta.CHUNK)[:, None] + torch.arange(k, device=dev)[None]
            ).clamp(0, store.n_chunks - 1).to(torch.int32)
    # an edge case: the target's chunk last in the window (a hit at k = K-1)
    cidx_late = torch.roll(cidx, -1, dims=1)
    args = (pk, wd, ah, al)
    err = exact(range_search.find_next_packed_cuda(*args, cidx, f_t),
                range_search.find_next_packed_plain(*args, cidx, f_t), "search")
    exact(range_search.find_next_packed_cuda(*args, cidx_late, f_t),
          range_search.find_next_packed_plain(*args, cidx_late, f_t), "search K-1")
    # K = 1 and K = 32 windows (the kernel's bounds)
    for kk in (1, range_search.MAX_WINDOW):
        ck = ((lo // delta.CHUNK)[:, None] + torch.arange(kk, device=dev)[None]
              ).clamp(0, store.n_chunks - 1).to(torch.int32)
        exact(range_search.find_next_packed_cuda(*args, ck, f_t),
              range_search.find_next_packed_plain(*args, ck, f_t), f"search K={kk}")
    nbytes, nops, visited, distinct = search_work(*args, cidx, f_t)
    run = lambda: range_search.find_next_packed_cuda(*args, cidx, f_t)  # noqa: E731
    row("find_next_packed", err, run, event_ms(run, 20),
        event_ms(lambda: range_search.find_next_packed_plain(*args, cidx, f_t), 2),
        nbytes, nops, list(cidx.shape), visited_chunks=visited, distinct_chunks=distinct)
    return rows


def intersect_edge_rows(d, dev):
    """Empty windows, prev absent from v's window, prev v's only neighbor,
    u_group just below 1, rows with no common neighbor."""
    s = intersect.SENT
    nv = torch.full((6, d), s, dtype=torch.int64)
    npv = torch.full((6, d), s, dtype=torch.int64)
    nv[1, :3], npv[1, :2] = torch.tensor([4, 9, 11]), torch.tensor([9, 30])
    nv[2, :1], npv[2, :1] = 7, 3
    nv[3, :5], npv[3, :5] = torch.arange(1, 6), torch.tensor([2, 3, 8, 9, 10])
    nv[4, :], npv[4, :] = torch.arange(d), torch.arange(d) * 2
    nv[5, :2] = torch.tensor([100, 200])
    prev = torch.tensor([5, 2, 7, 3, 6, 1])
    u_g = torch.tensor([0.5, 0.3, 0.9, float(np.nextafter(np.float32(1), np.float32(0))),
                        0.99, 0.0], dtype=torch.float32)
    u_r = torch.tensor([0.5, 0.99, 0.2, 0.999, 0.0, 0.7], dtype=torch.float32)
    return [t.to(dev) for t in (nv, npv, prev, u_g, u_r)]


def csr_edge_case(dmax, dev):
    """A 512-vertex graph with four hubs of degree ~2 dmax (> dmax) and 16
    isolated vertices, and 4,096 rows: v and prev both hubs, v isolated,
    prev isolated, prev == v, prev a neighbor of v, and uniform pairs ->
    (codes, offsets, v, prev, u f32 [4096, 2])."""
    rng = np.random.default_rng(dmax)
    n, b = 512, 4096
    src, dst = rng.integers(0, n - 16, size=(2, 8000))
    hs = np.repeat(np.arange(4), 2 * dmax)
    src = np.concatenate([src, hs])
    dst = np.concatenate([dst, rng.integers(4, n - 16, size=hs.shape[0])])
    g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=dev)
    v, prev = rng.integers(0, n, size=(2, b))
    v[:8], prev[:8] = np.arange(8) % 4, (np.arange(8) + 1) % 4
    v[8:16] = n - 1 - np.arange(8)
    prev[16:24] = n - 1 - np.arange(8)
    prev[24:40] = v[24:40]
    for i in range(40, 72):
        nb = dst[src == v[i]]
        prev[i] = nb[i % nb.shape[0]] if nb.shape[0] else prev[i]
    u = rng.random((b, 2)).astype(np.float32)
    return [g.codes, g.offsets] + [torch.from_numpy(x).to(dev) for x in (v, prev, u)]


def segment_entries(offsets, verts, dmax):
    """min(deg, dmax) of each vertex: the codes its CSR row reads."""
    deg = (offsets[1:] - offsets[:-1]).to(torch.int64).clamp(max=dmax)
    return deg[verts]


def segment_bytes(offsets, dmax, *verts):
    """The CSR bytes rows of these vertices read, each segment once however
    many rows read it: 8 B a code (min(deg, dmax) codes) and its two
    offsets (u32)."""
    seen = torch.zeros(offsets.shape[0] - 1, dtype=torch.bool, device=offsets.device)
    for v in verts:
        seen[v] = True
    return float((segment_entries(offsets, seen.nonzero()[:, 0], dmax) * 8 + 8).sum())


def csr_work(offsets, v, prev, dmax):
    """Bytes and operations of the CSR step on these rows: the segments of
    the rows' v and prev (`segment_bytes`), each row's v and prev (u32) and
    two f32 uniforms, and the outputs (u32 nxt, found, overflow), each read
    or written once; ~30 operations (a binary search and a few ballots) per
    v entry of a row."""
    nv, np_ = segment_entries(offsets, v, dmax), segment_entries(offsets, prev, dmax)
    nbytes = segment_bytes(offsets, dmax, v, prev) + 22.0 * v.shape[0]
    return nbytes, 30.0 * float(nv.sum()), float((nv + np_).sum()) / (2 * v.shape[0])


def fused_work(store, step, nxt):
    """Bytes and operations one fused step needs on these inputs: every
    lane's scalars (two flags; lo, hi, ft, cur, slot_epoch as u32) and
    outputs (u32 nxt, u64 code, overflow); a pending hit's u32 next; the
    chunks FINDNEXT lanes visit, each once (a lane's run up to the chunk
    holding its hit, all K or up to hi if it misses), and a FINDNEXT
    lane's epoch; the CSR segments of the emitting lanes' cur and prev
    (`segment_bytes`) and an emitting lane's u32 prev and two f32
    uniforms."""
    k, dev = step.window, step.cur.device
    b = step.cur.shape[0]
    need = step.is_prefix & ~step.pend_hit & (step.lo < step.hi)
    emit = ~step.is_prefix
    c0 = step.lo // delta.CHUNK
    # the hit, if any, is the entry (cur, <ft, nxt>) of cur's segment
    code = pairing.szudzik_pair(step.ft, nxt)
    seg_hi = store.offsets[step.cur + 1].to(torch.int64)
    pos = seg_searchsorted(store.code, store.offsets[step.cur], seg_hi, code)
    hit = (pos < seg_hi) & (store.code[pos.clamp(max=store.size - 1)] == code)
    span = torch.minimum(torch.full_like(c0, k), torch.minimum(
        (step.hi - 1) // delta.CHUNK - c0 + 1, store.n_chunks - c0))
    last = pos // delta.CHUNK - c0 + 1
    visited = torch.where(hit & (last >= 1) & (last <= span), last, span)
    visited = torch.where(need, visited, 0)
    c = (c0[:, None] + torch.arange(k, device=dev)[None]).clamp(0, store.n_chunks - 1)
    in_v = torch.arange(k, device=dev)[None] < visited[:, None]
    seen = torch.zeros(store.n_chunks, dtype=torch.bool, device=dev)
    seen[c[in_v]] = True
    nv = segment_entries(step.offsets, step.cur[emit], step.dmax)
    nbytes = (35.0 * b + 4.0 * float(step.pend_hit.sum())
              + float((used_words(store.widths)[seen] * 4 + 12).sum())
              + 4.0 * float(need.sum())
              + segment_bytes(step.offsets, step.dmax, step.cur[emit], step.prev[emit])
              + 12.0 * float(emit.sum()))
    nops = 14.0 * delta.CHUNK * float(visited.sum()) + 30.0 * float(nv.sum())
    return nbytes, nops, int(need.sum()), int(emit.sum())


def in_turns(a, b, reps_a: int, reps_b: int):
    """Mean device times of a and b, timed a, b, b, a -> ([a1, a2], [b1, b2])."""
    t = [event_ms(f, r) for f, r in ((a, reps_a), (b, reps_b), (b, reps_b), (a, reps_a))]
    return [t[0], t[3]], [t[1], t[2]]


def prefix_read_search(dev, kept):
    """Kernel 4 on the operands of the first prefix-read call of phase 4's
    profiled unfused batch: held against its plain version, timed warm and
    cold beside its bound (`search_work`)."""
    args = [t.to(dev) for t in kept.pop("find_next_packed")]
    err = exact(range_search.find_next_packed_cuda(*args),
                range_search.find_next_packed_plain(*args), "search (prefix read)")
    nbytes, nops, visited, distinct = search_work(*args)
    b_ms, b_by = bound(nbytes, nops)

    def run():
        return range_search.find_next_packed_cuda(*args)

    return dict(shape=list(args[4].shape), max_abs_err=err, ms=event_ms(run, 10),
                ms_cold=cold_ms(run), sm_clock_mhz=sm_clock_mhz(), bound_ms=b_ms,
                bound_by=b_by, visited_chunks=visited, distinct_chunks=distinct,
                found_share=float(run()[1].float().mean()))


def phase_kernels_n2v(dev, kept):
    """Kernels 5 and 6 against their plain versions on the operands the
    order-2 main paths formed (kept in phase 4), plus edge cases, each
    timed in turns against the composition it replaced; and the windowed
    kernel 5 on the windows of the same rows."""
    rows = []
    codes, offsets, v, prev, u, dmax, inv_p, inv_q = [
        t.to(dev) if isinstance(t, torch.Tensor) else t for t in kept.pop("intersect_csr")]
    b = v.shape[0]
    csr = (codes, offsets, v, prev, u)
    got = intersect.factorized_csr_cuda(*csr, dmax, inv_p, inv_q)
    err = exact(got, intersect.factorized_csr_plain(*csr, dmax, inv_p, inv_q),
                "intersect_csr")
    cases = {"head": (csr[:2] + tuple(t[:1 << 16] for t in csr[2:]), dmax),
             "hubs-128": (csr_edge_case(128, dev), 128),
             "hubs-256": (csr_edge_case(256, dev), 256)}
    for p, q in ((0.25, 4.0), (4.0, 0.25), (1.0, 1.0)):
        w = intersect.inverse_weights(p, q)
        for name, (case, dm) in cases.items():
            exact(intersect.factorized_csr_cuda(*case, dm, *w),
                  intersect.factorized_csr_plain(*case, dm, *w),
                  f"intersect_csr {name} p={p} q={q}")
    del cases

    # the windowed kernel on the windows of the same rows (bytes: two u32
    # windows, u32 prev, two f32 uniforms; u32 nxt, found)
    def windows():
        return (intersect.neighbor_window(codes, offsets, v, dmax)[0],
                intersect.neighbor_window(codes, offsets, prev, dmax)[0])

    ug, ur = u[:, 0].contiguous(), u[:, 1].contiguous()
    wargs = (*windows(), prev, ug, ur)
    d = wargs[0].shape[1]
    got_w = intersect.factorized_cuda(*wargs, inv_p, inv_q)
    err_w = exact(got_w, intersect.factorized_plain(*wargs, inv_p, inv_q), "intersect")
    exact(got_w, got[:2], "windowed kernel != CSR kernel")
    edge = intersect_edge_rows(d, dev)
    head = [t[:1 << 16] for t in wargs]
    for p, q in ((0.25, 4.0), (4.0, 0.25), (1.0, 1.0)):
        w = intersect.inverse_weights(p, q)
        for case in (edge, head):
            exact(intersect.factorized_cuda(*case, *w),
                  intersect.factorized_plain(*case, *w), f"intersect p={p} q={q}")
    run = lambda: intersect.factorized_cuda(*wargs, inv_p, inv_q)  # noqa: E731
    kernel_row(rows, "intersect_next", err_w, run, event_ms(run, 20),
               event_ms(lambda: intersect.factorized_plain(*wargs, inv_p, inv_q), 1),
               8.0 * b * d + 17.0 * b, 30.0 * b * d, [b, d])
    del wargs, head, got_w

    def old_composition():
        nv, npv = windows()
        return intersect.factorized_cuda(nv, npv, prev, ug, ur, inv_p, inv_q)

    run = lambda: intersect.factorized_csr_cuda(*csr, dmax, inv_p, inv_q)  # noqa: E731
    t_csr, t_old = in_turns(run, old_composition, 20, 5)
    nbytes, nops, mean_entries = csr_work(offsets, v, prev, dmax)
    kernel_row(rows, "intersect_csr", err, run, sum(t_csr) / 2,
               event_ms(lambda: intersect.factorized_csr_plain(*csr, dmax, inv_p, inv_q), 1),
               nbytes, nops, [b, dmax], ms_turns=t_csr, old_composition_ms=t_old,
               mean_entries_per_segment=mean_entries,
               overflow_rows=int(got[2].sum()))
    del csr, got

    store, step = kept.pop("fused_rewalk_step")
    assert bool(step.pend_hit.any()) and bool((step.is_prefix & ~step.pend_hit).any()), \
        "the kept fused step has no pending hit or no FINDNEXT lane"
    got = megakernel.fused_step_cuda(store, step)
    err = exact(got, megakernel.fused_step_plain(store, step), "fused step")
    # every lane sampling; every FINDNEXT lane's window starting K-1 chunks
    # early (a hit in the first chunk moves to k = K-1); no pending hit
    z = torch.zeros_like(step.is_prefix)
    late = step._replace(lo=torch.where(step.is_prefix, (step.lo - (
        step.window - 1) * delta.CHUNK).clamp(min=0), step.lo))
    all_emit = step._replace(is_prefix=z)
    for name, var in (("all-emit", all_emit), ("hit-at-K-1", late),
                      ("no-pending", step._replace(pend_hit=z))):
        exact(megakernel.fused_step_cuda(store, var),
              megakernel.fused_step_plain(store, var), f"fused step {name}")
    nbytes, nops, n_find, n_emit = fused_work(store, step, got[0])
    nb_e, no_e, _, _ = fused_work(store, all_emit, got[0])

    def windows_of_lanes():   # what the fused scan built before every launch
        return (intersect.neighbor_window(step.codes, step.offsets, step.cur, step.dmax),
                intersect.neighbor_window(step.codes, step.offsets, step.prev, step.dmax))

    run = lambda: megakernel.fused_step_cuda(store, step)  # noqa: E731
    t_new, t_win = in_turns(run, windows_of_lanes, 10, 3)
    kernel_row(rows, "fused_rewalk_step", err, run, sum(t_new) / 2,
               event_ms(lambda: megakernel.fused_step_plain(store, step), 1),
               nbytes, nops, [step.cur.shape[0], step.dmax],
               findnext_lanes=n_find, emit_lanes=n_emit,
               overflow_lanes=int(got[2].sum()), k_window=step.window, ms_turns=t_new,
               window_build_ms=t_win,
               ms_all_emit=event_ms(lambda: megakernel.fused_step_cuda(store, all_emit), 10),
               bound_ms_all_emit=bound(nb_e, no_e)[0])
    return rows


def sgns_edge_cases(dev):
    """Rows with logits of exactly ±100 and all-zero rows (K = 5, D = 128),
    and random rows at B = 1, B = 13, K = 1, D = 64 and D = 256, entries
    N(0, 4/D) (rows of norm ~2, as in a maintained table; at unit entries
    the f32 roundings of the plain version alone exceed atol 1e-6)."""
    g = torch.Generator()
    g.manual_seed(11)

    def rnd(b, k, d):
        return [torch.randn(s, generator=g) * (2 / d ** 0.5)
                for s in ((b, d), (b, d), (b, k, d))]
    u, vp, vn = (torch.zeros(s) for s in ((6, 128), (6, 128), (6, 5, 128)))
    u[:4, 0] = 10.0
    vp[0, 0], vn[0, :, 0] = 10.0, -10.0                  # pos +100, negs -100
    vp[1, 0], vn[1, :, 0] = -10.0, 10.0                  # pos -100, negs +100
    vp[2, 0], vn[2, :, 0] = 10.0, 10.0
    vn[3, ::2, 0] = 10.0                                  # v+ zero, mixed negs
    cases = {"logits_pm100_and_zero_rows": [u, vp, vn], "B=1": rnd(1, 5, 128),
             "B=13": rnd(13, 5, 128), "K=1": rnd(4096, 1, 128),
             "D=64": rnd(4096, 5, 64), "D=256": rnd(4096, 5, 256)}
    return {k: [t.to(dev) for t in v] for k, v in cases.items()}


def sgns_err(got, want, what: str) -> float:
    """Hold kernel 7 to its plain version (loss rtol 1e-5; gradients rtol
    1e-5 / atol 1e-6: the kernel sums its dot products by warp shuffles,
    torch in another order) -> the largest absolute difference."""
    err = 0.0
    for name, g, w in zip(("loss", "du", "dvp", "dvn"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        tol = (dict(rtol=SGNS_LOSS_RTOL, atol=0.0) if name == "loss"
               else SGNS_GRAD_TOL)
        torch.testing.assert_close(g, w, msg=f"{what}: kernel != plain in {name}",
                                   **tol)
        err = max(err, float((g - w).abs().max()))
    return err


def phase_kernels_sgns(dev, kept):
    """Kernel 7 against its plain version on the operands the maintainer
    formed in its last timed batch (phase 3b), plus edge cases."""
    u, vp, vn = kept
    b, k, d = vn.shape
    err = sgns_err(sgns.sgns_cuda(u, vp, vn), sgns.sgns_plain(u, vp, vn), "sgns")
    edge = {name: sgns_err(sgns.sgns_cuda(*case), sgns.sgns_plain(*case), f"sgns {name}")
            for name, case in sgns_edge_cases(dev).items()}
    rows = []
    # bytes: u, v+ and K rows v- read once, du, dv+ and K rows dv- and the
    # loss written once (f32); operations a row: the K + 1 dot products,
    # du, dv+ and dv- ((5K + 4) D)
    run = lambda: sgns.sgns_cuda(u, vp, vn)  # noqa: E731
    kernel_row(rows, "sgns_step", err, run, event_ms(run, 20),
               event_ms(lambda: sgns.sgns_plain(u, vp, vn), 3),
               8.0 * (k + 2) * d * b + 4.0 * b, (5.0 * k + 4) * d * b, [b, k, d],
               edge_case_max_abs_err=edge)
    return rows


# ---------------------------------------------------------------- phase 6


def paper_setup():
    """Phase 6's configuration: wharf-stream's own config and shapes ->
    (config, stream_10k_mixed, order-1 WalkConfig, order-2 WalkConfig). The
    n2v shape overrides `order` and `sampler`, as the reference's cells."""
    arch = get_arch("wharf-stream")
    wcfg = arch.make_config()
    mixed = arch.shapes["stream_10k_mixed"]
    n2v = arch.shapes["stream_10k_n2v_factorized"]
    cfg2 = dataclasses.replace(wcfg, order=n2v["order"],
                               sampler=n2v["sampler"]).walk_config()
    return wcfg, mixed, wcfg.walk_config(), cfg2


def paper_engine(kind: str, graph, cfg, key, capacity: int, max_pending: int,
                 mixed=None):
    """One engine of the comparison on `graph`, its corpus from `key`."""
    if kind == "wharf":
        return WalkEngine(graph=graph, store=generate_corpus(key, graph, cfg),
                          cfg=cfg, merge_policy=mixed["merge_policy"],
                          merge_impl=mixed["merge_impl"],
                          rewalk_capacity=capacity, max_pending=max_pending)
    eng = {"ii": IIEngine, "tree": TreeEngine}[kind].create(key, graph, cfg)
    eng.rewalk_capacity = capacity
    return eng


def paper_batch(eng, stream, key, i: int) -> int:
    """Batch i of a stacked stream under fold_in(key, i) -> affected."""
    return int(eng.run_stream(jr.fold_in(key, i),
                              *(x[i:i + 1] for x in stream))[0])


def walk_matrix_of(eng) -> torch.Tensor:
    """The engine's walks as an int32 [n_walks, l] matrix: the II's
    sequences, the tree's owners by (walk, pos), Wharf's owners by slot
    f = w*l + p: every base triplet (f from its code, kernel 2), then the
    live pending row of each rewritten slot over it (no merge)."""
    if isinstance(eng, IIEngine):
        return eng.walks
    if isinstance(eng, TreeEngine):
        n_walks = eng.walk.shape[0] // eng.cfg.length
        m = torch.empty((n_walks, eng.cfg.length), dtype=torch.int32,
                        device=eng.walk.device)
        m[eng.walk.long(), eng.pos.long()] = eng.owner
        return m
    ov = eng.overlay()
    m = torch.empty(ov.row_of_slot.shape[0], dtype=torch.int32,
                    device=ov.base.device)
    m[ops.szudzik_unpair(ov.base.code)[0]] = ov.base.owner
    live = ov.row_of_slot >= 0
    m[live] = ov.owner[ov.row_of_slot[live].long()]
    return m.reshape(ov.base.n_walks, ov.base.length)


def overlay_walks(eng) -> torch.Tensor:
    """Wharf's walks read through the overlay (FINDNEXT from every walk's
    start, base and pending; kernels 1, 2 and 4), int32."""
    w = torch.arange(eng.store.n_walks, device=eng.store.device)
    start = walk_start_vertex(w, eng.cfg.n_walks_per_vertex)
    return eng.overlay().traverse(w, start, eng.cfg.length - 1).to(torch.int32)


def steps_are_edges(graph, a, b, what: str):
    """Every step a -> b an edge of `graph`, or an isolated vertex's
    self-step (the samplers' rule)."""
    a, b = a.reshape(-1).long(), b.reshape(-1).long()
    ok = graph.has_edge(a, b) | ((a == b) & (graph.degrees().long()[a] == 0))
    if not bool(ok.all()):
        raise AssertionError(f"{what}: {int((~ok).sum())} steps are not graph edges")


def tree_checks(tr) -> torch.Tensor:
    """Every (walk, pos) slot stored once; the columns lexsorted by
    (owner, walk, pos); each row's next the owner of its walk's next slot,
    the terminal slot pointing to itself; every step an edge -> the walk
    matrix."""
    length = tr.cfg.length
    slot = tr.walk.long() * length + tr.pos.long()
    if not torch.equal(torch.sort(slot).values,
                       torch.arange(slot.shape[0], device=slot.device)):
        raise AssertionError("tree: a (walk, pos) slot is not stored exactly once")
    key = tr.owner.long() * slot.shape[0] + slot
    if not bool((key[1:] > key[:-1]).all()):
        raise AssertionError("tree: the columns are not lexsorted")
    del slot, key
    m = walk_matrix_of(tr)
    nx = torch.empty_like(m)
    nx[tr.walk.long(), tr.pos.long()] = tr.nxt
    if not (torch.equal(nx[:, :-1], m[:, 1:]) and torch.equal(nx[:, -1], m[:, -1])):
        raise AssertionError("tree: a next is not the owner of the next slot")
    steps_are_edges(tr.graph, m[:, :-1], m[:, 1:], "tree")
    return m


def first_touched(walks, stream, i: int, n_vertices: int) -> torch.Tensor:
    """p_min of every walk for batch i's touched vertices (length where the
    walk has none): the II's MAV, scanning from the front."""
    touched = torch.zeros(n_vertices, dtype=torch.bool, device=walks.device)
    for x in stream:
        touched[x[i].long()] = True
    cols = torch.arange(walks.shape[1], device=walks.device)
    return torch.where(touched[walks.long()], cols, walks.shape[1]).amin(dim=1)


def ii_checks(before, ii, pm):
    """The walks the batch rewrote (p_min < l, every one of them: capacity
    = n_walks) keep columns 0..p_min, the others stay whole; every pair from
    the first rewritten column on is an edge of the current graph."""
    after, length = ii.walks, ii.walks.shape[1]
    cols = torch.arange(length, device=after.device)
    if not torch.equal(torch.where(cols <= pm[:, None], after, 0),
                       torch.where(cols <= pm[:, None], before, 0)):
        raise AssertionError("II: a column before a walk's p_min changed")
    new = cols[:-1] > pm[:, None]
    steps_are_edges(ii.graph, after[:, :-1][new], after[:, 1:][new], "II")


def ii_shifted_equal(ii_walks, tree_walks, pm) -> bool:
    """The reference's II writes at column p the vertex it samples at step p
    (the successor of p), the tree at p + 1: after one batch from one
    corpus and key at order 1, the II's row is the tree's up to p_min and
    the tree's shifted by one column after it."""
    length = ii_walks.shape[1]
    cols = torch.arange(length, device=ii_walks.device)
    src = torch.where(cols > pm[:, None], cols + 1, cols).clamp(max=length - 1)
    want = tree_walks.gather(1, src)
    keep = (cols < length - 1) | (pm[:, None] >= length - 1)
    return torch.equal(torch.where(keep, ii_walks, 0), torch.where(keep, want, 0))


def phase_paper(dev):
    """Phase 6 (see the module docstring). The counts are set to 0 before
    each engine is built and read just after its last batch."""
    c = PAPER
    wcfg, mixed, cfg1, cfg2 = paper_setup()
    n, log2_n = 1 << c["log2_n"], c["log2_n"]
    n_walks = n * cfg1.n_walks_per_vertex
    nb = mixed["n_batches"]
    seeds = c["seeds"]
    key_c, key_u = jr.PRNGKey(seeds["corpus"], dev), jr.PRNGKey(seeds["update"], dev)

    (src, dst), t_graph_draw = sync_time(lambda: er_edges(
        jr.PRNGKey(seeds["graph"], dev), c["graph_edges"], log2_n))
    stream, t_stream_draw = sync_time(lambda: mixed_edge_stream(
        jr.PRNGKey(seeds["stream"], dev), nb, mixed["batch_edges"],
        mixed["del_edges"], log2_n))
    n2v = edge_batch_stream(jr.PRNGKey(seeds["n2v_stream"], dev),
                            c["n2v_batches"], mixed["batch_edges"], log2_n)
    n2v = (*n2v, *[torch.zeros((c["n2v_batches"], 0), dtype=torch.int32,
                               device=dev)] * 2)
    # the card's draws = the CPU's: the whole stream, the graph's prefix
    cpu = torch.device("cpu")
    want = mixed_edge_stream(jr.PRNGKey(seeds["stream"], cpu), nb,
                             mixed["batch_edges"], mixed["del_edges"], log2_n)
    want += er_edges(jr.PRNGKey(seeds["graph"], cpu), c["cpu_prefix"], log2_n)
    got = (*stream, src[:c["cpu_prefix"]], dst[:c["cpu_prefix"]])
    for w, g in zip(want, got):
        if not torch.equal(w, g.cpu()):
            raise AssertionError("a generator's card draws != its CPU draws")
    graph = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"], device=dev)
    edges = int(graph.num_edges)
    del src, dst

    def run(kind, cfg, data, batches, path):
        """One engine over `batches` batches of `data`, freed on return ->
        (results, its walk matrices: at creation, then after each batch
        (the II: after batch 1 only), the II's p_min of batch 1)."""
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()    # ---- this engine, counted from here
        eng, t_create = sync_time(lambda: paper_engine(
            kind, graph, cfg, key_c, n_walks, c["max_pending"], mixed))
        mats, ms, affected, pm1 = [walk_matrix_of(eng)], [], [], None
        for i in range(batches):
            before = eng.walks if kind == "ii" else None
            aff, dt = sync_time(lambda: paper_batch(eng, data, key_u, i))
            ms.append(dt * 1e3)
            affected.append(aff)
            if kind == "ii":
                pm = first_touched(before, data, i, n)
                ii_checks(before, eng, pm)
                pm1 = pm if i == 0 else pm1
            if kind != "ii" or i == 0:
                mats.append(walk_matrix_of(eng))
        res = dict(create_s=t_create, batch_update_ms=ms, affected=affected)
        if kind == "wharf":
            # the read path: the overlay traverse = the triplets by slot
            if not torch.equal(overlay_walks(eng), mats[-1]):
                raise AssertionError("wharf: overlay traverse != the stored triplets")
            _, res["merge_s"] = sync_time(eng.merge)
            decoded = eng.store.packed_view().decode()
            if not torch.equal(decoded[:eng.store.size], eng.store.code):
                raise AssertionError("wharf: packed decode != code")
            del decoded
            res["nbytes"] = eng.store.nbytes_packed()
            res["nbytes_uncompressed"] = eng.store.nbytes_uncompressed()
        else:
            res["nbytes"] = eng.nbytes()
        launches[path] = dict(ops.launches)   # ---- read just after it
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if kind == "tree":
            tree_checks(eng)
        return res, mats, pm1

    launches, engines, checks = {}, {}, {}
    engines["wharf"], wharf_mats, _ = run("wharf", cfg1, stream, nb, "paper_wharf")
    engines["ii"], mats, pm = run("ii", cfg1, stream, nb, "paper_ii")
    checks["ii_equals_wharf_at_creation"] = torch.equal(mats[0], wharf_mats[0])
    checks["ii_shifted_equals_wharf_after_batch1"] = ii_shifted_equal(
        mats[1], wharf_mats[1], pm)
    engines["tree"], mats, _ = run("tree", cfg1, stream, nb, "paper_tree")
    checks["tree_equals_wharf_every_batch"] = all(
        torch.equal(a, b) for a, b in zip(mats, wharf_mats))
    del mats, wharf_mats
    checks["batch1_affected_equal"] = len({e["affected"][0] for e in engines.values()}) == 1
    checks["tree_affected_equals_wharf"] = (engines["tree"]["affected"]
                                            == engines["wharf"]["affected"])

    order2 = {}
    order2["ii"], ii_mats, _ = run("ii", cfg2, n2v, c["n2v_batches"], "paper_ii_n2v")
    order2["tree"], mats, _ = run("tree", cfg2, n2v, c["n2v_batches"], "paper_tree_n2v")
    checks["n2v_ii_equals_tree_at_creation"] = torch.equal(ii_mats[0], mats[0])
    del ii_mats, mats, graph
    checks["n2v_batch1_affected_equal"] = (order2["ii"]["affected"][0]
                                           == order2["tree"]["affected"][0])
    checks["small_card_equals_cpu"] = paper_small(dev, cfg1, cfg2)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 6 checks failed: {failed}")
    for k in ORDER1_KERNELS:
        assert launches["paper_wharf"][k] > 0, f"kernel {k} was not launched on Wharf's path"
    for p in ("paper_ii_n2v", "paper_tree_n2v"):
        assert launches[p]["intersect_csr"] > 0, f"kernel 5 was not launched on {p}"
    for p in launches:
        assert launches[p]["intersect_next"] == 0 and launches[p]["fused_rewalk_step"] == 0
    wb = engines["wharf"]["nbytes"]
    res = dict(config=dataclasses.asdict(wcfg), shape=mixed,
               n_vertices=n, n_walks=n_walks, edges=edges,
               graph_draw_s=t_graph_draw, stream_draw_s=t_stream_draw,
               engines=engines, order2=order2,
               nbytes_ratio={"tree_over_wharf": engines["tree"]["nbytes"] / wb,
                             "ii_over_wharf": engines["ii"]["nbytes"] / wb},
               checks=checks, launches=launches)
    log("reduced_paper", **PAPER_REDUCED)
    log("paper", **res)
    return res


def paper_small(dev, cfg1, cfg2) -> bool:
    """II and tree on a 2^12-vertex er graph, on the card and on the CPU
    from the same keys, order 1 and order 2: the same affected counts and
    state."""
    s = PAPER["small"]
    n = 1 << s["log2_n"]
    states = {}
    for d in (dev, torch.device("cpu")):
        src, dst = er_edges(jr.PRNGKey(7, d), s["graph_edges"], s["log2_n"])
        stream = mixed_edge_stream(jr.PRNGKey(8, d), s["n_batches"], s["n_ins"],
                                   s["n_del"], s["log2_n"])
        for kind, cls in (("ii", IIEngine), ("tree", TreeEngine)):
            for name, cfg in (("order1", cfg1), ("order2", cfg2)):
                cfg = cfg._replace(n_walks_per_vertex=s["n_walks_per_vertex"],
                                   length=s["length"])
                g = StreamingGraph.from_edges(src, dst, n, 1 << 17, device=d)
                eng = cls.create(jr.PRNGKey(9, d), g, cfg)
                eng.rewalk_capacity = n * cfg.n_walks_per_vertex
                aff = eng.run_stream(jr.PRNGKey(10, d), *stream).cpu().numpy()
                st = baseline_to_numpy(eng)
                st["affected"] = aff
                states.setdefault((kind, name), []).append(st)
    for key, (a, b) in states.items():
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"small {key}: card != cpu in {k}")
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    _, t_build = sync_time(_build.lib)
    log("build", seconds=t_build, library=_build.library_path().name)
    phase_small_e2e(dev)
    phase_small_maintainer(dev)
    phase_small_metrics(dev)
    full, tensors = phase_full(dev)
    kernels = phase_kernels(dev, tensors)
    log("kernels_order1")
    host_state = tensors.pop("host_state")
    del tensors
    maint, kept, mt = phase_maintainer(dev, host_state)
    del host_state
    sgns_rows = phase_kernels_sgns(dev, kept)
    log("kernels_sgns")
    del kept
    serve = phase_serve(dev, mt)
    del mt
    n2v, kept = phase_full_n2v(dev)
    prefix_read = prefix_read_search(dev, kept)
    kernels += phase_kernels_n2v(dev, kept) + sgns_rows
    log("kernels_n2v")
    del kept
    paper = phase_paper(dev)
    next(r for r in kernels if r["name"] == "find_next_packed")["prefix_read"] = prefix_read
    # each kernel's launches on the main paths: order 1 (phase 3), the
    # maintainer (phase 3b), the serve path (phase 3c), and the order-2
    # corpus, unfused and fused batches (phase 4), and the paper's
    # comparison (phase 6: Wharf, II, tree; II and tree at order 2)
    for r in kernels:
        by_path = {"order1": full["launches"][r["name"]],
                   "maintainer": maint["launches"][r["name"]],
                   "serve": serve["launches"][r["name"]],
                   **{p: n2v["launches"][p][r["name"]] for p in n2v["launches"]},
                   **{p: paper["launches"][p][r["name"]] for p in paper["launches"]}}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        if r["name"] in OFF_MAIN_PATH:
            assert r["launches"] == 0, f"kernel {r['name']} was launched on a main path"
        else:
            assert r["launches"] > 0, f"kernel {r['name']} was not launched on a main path"
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
