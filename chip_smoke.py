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
  4. full width, `wharf-stream` order 2 (node2vec, factorized, dmax 128)
     at 2^18 vertices, insert-only batches: one corpus, then the batches
     unfused and again fused from the same corpus and keys; the two runs'
     stores, slot_epoch and pending blocks must be bit-identical; merge,
     overlay traverse = post-merge traverse; one more batch of each path
     under torch.profiler — the order-2 main paths, counts read just after
  5. each kernel against its plain PyTorch version on the card, on the
     main paths' tensors plus edge cases, timed with CUDA events beside its
     bound (bytes at 3.35 TB/s or operations at 67 T/s): kernels 1-6 bit
     for bit; kernel 7 (the f32 SGNS step) within loss rtol 1e-5 and
     gradients rtol 1e-5 / atol 1e-6, its sums being taken in another order
Phase 2 also runs a small maintainer on the card against the CPU and
against a plain engine. Each phase prints one JSON line.
"""
import contextlib
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
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus  # noqa: E402
from repro_torch.core import pairing  # noqa: E402
from repro_torch.core.corpus import walk_start_vertex  # noqa: E402
from repro_torch.core.update import WalkEngine  # noqa: E402
from repro_torch.core.utils import seg_searchsorted  # noqa: E402
from repro_torch.core.walkers import WalkModel  # noqa: E402
from repro_torch.downstream import EmbeddingMaintainer, MaintainerConfig  # noqa: E402
from repro_torch.kernels import _build, delta, intersect, megakernel, ops  # noqa: E402
from repro_torch.kernels import range_search, sgns, szudzik  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12      # H100 float32 outside the tensor cores

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
SGNS_LOSS_RTOL = 1e-5
SGNS_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)

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
    "fused_rewalk_step": ("src/repro_torch/kernels/csrc/megakernel.cu",
                          "src/repro/kernels/megakernel.py:217"),
    "sgns_step": ("src/repro_torch/kernels/csrc/sgns.cu",
                  "src/repro/kernels/sgns.py:113"),
}


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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


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
            g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
            store = generate_corpus(jr.PRNGKey(1, d), g, cfg)
            eng = WalkEngine(graph=g, store=store, cfg=cfg,
                             rewalk_capacity=n * 4, max_pending=4)
            eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
            st = state_to_numpy(eng.state)
            st["walk_matrix"] = eng.walk_matrix().cpu().numpy()
            states.append(st)
        for k in states[0]:
            if not np.array_equal(states[0][k], states[1][k]):
                raise AssertionError(f"{name}: cuda vs cpu engine differ in {k}")
        if model.sampler == "factorized" and mk == "off":
            assert ops.launches["intersect_next"] > 0, name
        if mk == "fused":
            assert ops.launches["fused_rewalk_step"] > 0, name
        fields[name] = len(states[0])
    log("small_e2e", ok=True, n_vertices=n, batches=6, hub_degree=300,
        fields_compared=fields)


def phase_small_maintainer(dev):
    """The maintainer on the card against the same maintainer on the CPU,
    from the same tables, and against a plain engine on the same update
    keys: the engines bit for bit, the pair and affected counts equal, the
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
        if d.type == "cuda":   # the CPU run's tables (normal's log1p differs by ulps)
            mt.load_state(mt.state._replace(
                params={k: v.to(d) for k, v in runs[0]["init"].items()}))
        init = {k: v.clone() for k, v in mt.params.items()}
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
    return res, kept


def phase_full_n2v(dev):
    """wharf-stream order 2 at full width: the corpus once, then the
    batches unfused and again fused from the same corpus and keys. The
    counts are set to 0 before the corpus and before each path's batches
    and read just after them."""
    c = N2V
    n = c["n_vertices"]
    model = WalkModel(order=2, p=c["p"], q=c["q"], sampler=c["sampler"],
                      dmax=c["dmax"])
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"], model=model,
                     megakernel="off")
    n_walks = n * cfg.n_walks_per_vertex
    gen = torch.Generator(device=dev)
    gen.manual_seed(2023)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni = c["n_batches"], c["batch_inserts"]
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    no_dels = [torch.zeros((1, 0), dtype=torch.int64, device=dev)] * 2
    w = torch.randint(0, n_walks, (1 << 14,), generator=gen, device=dev)
    start = walk_start_vertex(w, cfg.n_walks_per_vertex)
    key = jr.PRNGKey(1, dev)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the corpus, counted from here
    graph, t_graph = sync_time(lambda: StreamingGraph.from_edges(
        src, dst, n, c["edge_capacity"], device=dev))
    del src, dst
    store0, t_corpus = sync_time(lambda: generate_corpus(
        jr.PRNGKey(0, dev), graph, cfg))
    launches = {"corpus": dict(ops.launches)}
    peak = {"corpus": torch.cuda.max_memory_allocated() / 1e9}
    deg = graph.degrees().to(torch.int64)
    triplets = store0.size
    runs, saved, kept = {}, None, {}
    for path, mk in (("unfused", "off"), ("fused", "cuda")):
        eng = WalkEngine(graph=graph, store=store0, cfg=cfg._replace(megakernel=mk),
                         merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                         rewalk_capacity=n_walks, max_pending=c["max_pending"])
        if path == "fused":
            del store0
        batch_ms, affected, batch_launches = [], [], []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()    # ---- this path's batches, counted from here
        for i in range(nb):
            before = dict(ops.launches)
            aff, dt = sync_time(lambda: eng.run_stream(
                jr.fold_in(key, i), ins[0][i:i + 1], ins[1][i:i + 1]))
            batch_ms.append(dt * 1e3)
            affected.append(int(aff[0]))
            batch_launches.append({k: ops.launches[k] - before[k] for k in ops.KERNELS})
        launches[path] = dict(ops.launches)   # ---- read just after them
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
        # operands of one kernel call are kept for phase 5
        name, at = (("intersect_next", cfg.length // 2) if path == "unfused"
                    else ("fused_rewalk_step", 5))
        with keep_operands(name, at) as got:
            prof = profile_batch(lambda: eng.run_stream(
                jr.fold_in(key, nb), ins[0][nb:], ins[1][nb:], *no_dels))
        assert got, f"{name}: operands not kept"
        kept[name] = got.pop()
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
    assert launches["corpus"]["intersect_next"] > 0
    assert launches["unfused"]["intersect_next"] > 0
    assert launches["unfused"]["find_next_packed"] > 0
    assert launches["fused"]["fused_rewalk_step"] > 0
    assert launches["fused"]["intersect_next"] == 0
    assert launches["unfused"]["fused_rewalk_step"] == 0
    res = dict(config=N2V, n_walks=n_walks, triplets=triplets,
               edges=int(graph.num_edges), max_degree=int(deg.max()),
               vertices_over_dmax_share=float((deg > c["dmax"]).float().mean()),
               graph_build_s=t_graph, corpus_build_s=t_corpus, runs=runs,
               fused_equals_unfused=True, peak_mem_gb=peak,
               launches=launches, launches_total=total)
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


def profile_batch(run, kernel: str = None):
    """One more batch, `run()`, under torch.profiler: wall time, the
    device's busy and idle share, the device and host time of each layer
    scope, the top operators by device time and, if named, the device
    time of the kernels whose name holds `kernel` and their share of the
    busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel time from the launching ops (user-annotation ranges, which the
    # trace also reports on the device, are spans and are not summed)
    ops_ = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    busy_ms = sum(k.duration for e in ops_ for k in e.kernels) / 1e3
    if not busy_ms:
        return dict(wall_ms=wall * 1e3, device_busy="not measured")
    layers, layers_host = {}, {}
    for e in ops_:
        if e.name.startswith(LAYERS):
            layers[e.name] = layers.get(e.name, 0.0) + e.device_time_total / 1e3
            layers_host[e.name] = layers_host.get(e.name, 0.0) + e.cpu_time_total / 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith(LAYERS)]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / (wall * 1e3),
               layer_kernel_ms=layers, layer_host_ms=layers_host,
               top_kernels_ms={e.key[:100]: e.self_device_time_total / 1e3
                               for e in top})
    if kernel:
        k_ms = sum(e.self_device_time_total for e in kernels if kernel in e.key) / 1e3
        out[kernel] = dict(device_ms=k_ms, share_of_busy=k_ms / busy_ms)
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


def kernel_row(rows, name, err, ms, plain_ms, bytes_moved, ops_done, shape,
               **extra):
    """One entry of the `kernels` line; `launches` is filled in by main()
    from the main paths' counts."""
    b_ms, b_by = bound(bytes_moved, ops_done)
    src, rep = KERNEL_META[name]
    rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                     **extra))


def phase_kernels(dev, tensors):
    store = tensors["store"]
    rows = []

    def row(*args):
        kernel_row(rows, *args)

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
    row("szudzik_pair", err, event_ms(lambda: szudzik.pair_cuda(f, v), 20),
        event_ms(lambda: pairing.szudzik_pair(f, v), 3), 16 * f.numel(),
        6 * f.numel(), list(f.shape))

    # unpair: the MAV gather's share of the store (2^24 codes) plus edge codes
    z = torch.cat([store.code[: 1 << 24], torch.tensor(
        [-(1 << 63), -(1 << 63) + 1, (1 << 63) - 1, (1 << 63) - 2,
         (2**32 - 1) ** 2 - (1 << 63)], device=dev)])
    err = exact(szudzik.unpair_cuda(z), pairing.szudzik_unpair(z), "unpair")
    row("szudzik_unpair", err, event_ms(lambda: szudzik.unpair_cuda(z), 20),
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
    row("delta_decode", err,
        event_ms(lambda: delta.decode_rows_cuda(pk, wd, ah, al, idx), 10),
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
    # bytes: indices, target and outputs (u32 f and v, found), and the
    # chunks visited up to the hit
    codes = delta.decode_rows_plain(pk, wd, ah, al, cidx.reshape(-1).to(torch.int64))
    fk, _ = pairing.szudzik_unpair(codes)
    hit_k = (fk.reshape(-1, k, delta.CHUNK) == f_t[:, None, None]).any(-1)
    visited = torch.where(hit_k.any(-1), hit_k.to(torch.int8).argmax(-1) + 1, k)
    vis_mask = torch.arange(k, device=dev)[None] < visited[:, None]
    chunk_bytes = used_words(wd)[cidx.to(torch.int64)] * 4 + 12
    nbytes = float((chunk_bytes * vis_mask).sum()) + cidx.numel() * 4 + f_t.numel() * 9
    row("find_next_packed", err,
        event_ms(lambda: range_search.find_next_packed_cuda(*args, cidx, f_t), 20),
        event_ms(lambda: range_search.find_next_packed_plain(*args, cidx, f_t), 2),
        nbytes, 14.0 * delta.CHUNK * float(vis_mask.sum()), list(cidx.shape))
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


def fused_work(store, step, nxt):
    """Bytes and operations one fused step needs on these inputs: every
    lane's scalars (two flags; lo, hi, ft, cur, slot_epoch as u32) and
    outputs (u32 nxt, u64 code); a pending hit's u32 next; a FINDNEXT
    lane's chunks up to the one holding its hit (all K, or up to hi, if it
    misses) and one epoch; an emitting lane's u32 windows, prev and two
    f32 uniforms."""
    k, dev = step.window, step.cur.device
    b = step.cur.shape[0]
    d = step.nbrs_v.shape[1]
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
    per_chunk = used_words(store.widths)[c] * 4 + 12
    in_v = torch.arange(k, device=dev)[None] < visited[:, None]
    nbytes = (34.0 * b + 4.0 * float(step.pend_hit.sum())
              + float((per_chunk * in_v).sum()) + 4.0 * float(need.sum())
              + float(emit.sum()) * (8.0 * d + 12.0))
    nops = 14.0 * delta.CHUNK * float(visited.sum()) + 30.0 * d * float(emit.sum())
    return nbytes, nops, int(need.sum()), int(emit.sum())


def phase_kernels_n2v(dev, kept):
    """Kernels 5 and 6 against their plain versions on the operands the
    order-2 main path formed (kept in phase 4), plus edge cases."""
    rows = []
    nv, npv, prev, ug, ur, inv_p, inv_q = [
        t.to(dev) if isinstance(t, torch.Tensor) else t
        for t in kept["intersect_next"]]
    b, d = nv.shape
    args = (nv, npv, prev, ug, ur)
    err = exact(intersect.factorized_cuda(*args, inv_p, inv_q),
                intersect.factorized_plain(*args, inv_p, inv_q), "intersect")
    edge = intersect_edge_rows(d, dev)
    head = [t[:1 << 16] for t in args]
    for p, q in ((0.25, 4.0), (4.0, 0.25), (1.0, 1.0)):
        w = intersect.inverse_weights(p, q)
        for case in (edge, head):
            exact(intersect.factorized_cuda(*case, *w),
                  intersect.factorized_plain(*case, *w), f"intersect p={p} q={q}")
    # bytes: two u32 windows, u32 prev, two f32 uniforms; u32 nxt, found
    kernel_row(rows, "intersect_next", err,
               event_ms(lambda: intersect.factorized_cuda(*args, inv_p, inv_q), 20),
               event_ms(lambda: intersect.factorized_plain(*args, inv_p, inv_q), 1),
               8.0 * b * d + 17.0 * b, 30.0 * b * d, [b, d])
    del args, head, nv, npv, kept["intersect_next"]

    store, step = kept["fused_rewalk_step"]
    assert bool(step.pend_hit.any()) and bool((step.is_prefix & ~step.pend_hit).any()), \
        "the kept fused step has no pending hit or no FINDNEXT lane"
    got = megakernel.fused_step_cuda(store, step)
    err = exact(got, megakernel.fused_step_plain(store, step), "fused step")
    # every lane sampling; every FINDNEXT lane's window starting K-1 chunks
    # early (a hit in the first chunk moves to k = K-1); no pending hit
    z = torch.zeros_like(step.is_prefix)
    late = step._replace(lo=torch.where(step.is_prefix, (step.lo - (
        step.window - 1) * delta.CHUNK).clamp(min=0), step.lo))
    for name, var in (("all-emit", step._replace(is_prefix=z)),
                      ("hit-at-K-1", late),
                      ("no-pending", step._replace(pend_hit=z))):
        exact(megakernel.fused_step_cuda(store, var),
              megakernel.fused_step_plain(store, var), f"fused step {name}")
    nbytes, nops, n_find, n_emit = fused_work(store, step, got[0])
    all_emit = step._replace(is_prefix=z)
    nb_e, no_e, _, _ = fused_work(store, all_emit, got[0])
    kernel_row(rows, "fused_rewalk_step", err,
               event_ms(lambda: megakernel.fused_step_cuda(store, step), 10),
               event_ms(lambda: megakernel.fused_step_plain(store, step), 1),
               nbytes, nops, [step.cur.shape[0], d],
               findnext_lanes=n_find, emit_lanes=n_emit, k_window=step.window,
               ms_all_emit=event_ms(
                   lambda: megakernel.fused_step_cuda(store, all_emit), 10),
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
    kernel_row(rows, "sgns_step", err, event_ms(lambda: sgns.sgns_cuda(u, vp, vn), 20),
               event_ms(lambda: sgns.sgns_plain(u, vp, vn), 3),
               8.0 * (k + 2) * d * b + 4.0 * b, (5.0 * k + 4) * d * b, [b, k, d],
               edge_case_max_abs_err=edge)
    return rows


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
    full, tensors = phase_full(dev)
    kernels = phase_kernels(dev, tensors)
    host_state = tensors.pop("host_state")
    del tensors
    maint, kept = phase_maintainer(dev, host_state)
    del host_state
    sgns_rows = phase_kernels_sgns(dev, kept)
    del kept
    n2v, kept = phase_full_n2v(dev)
    kernels += phase_kernels_n2v(dev, kept) + sgns_rows
    del kept
    # each kernel's launches on the main paths: order 1 (phase 3), the
    # maintainer (phase 3b), and the order-2 corpus, unfused and fused
    # batches (phase 4)
    for r in kernels:
        by_path = {"order1": full["launches"][r["name"]],
                   "maintainer": maint["launches"][r["name"]],
                   **{p: n2v["launches"][p][r["name"]] for p in n2v["launches"]}}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        assert r["launches"] > 0, f"kernel {r['name']} was not launched on a main path"
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
