"""The `stats` tier's numpy harness (tests/test_walk_stats.py's helpers) on
the port's graph and samplers: chi-square goodness-of-fit of empirical
order-2 transition counts, conditioned on (prev, v), against the exact
alpha-weighted probabilities. It imports no JAX, so the card's tests use it
too.

Contexts enter the statistic only when every category's expected count is
>= 5; df sums (k-1) over the included contexts. The critical value is the
Wilson-Hilferty cube approximation (accurate to ~1% at these df).
"""
import numpy as np
import torch

from repro_torch import random as jr
from repro_torch._u64 import to_u64_numpy
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus
from repro_torch.core.update import WalkEngine
from repro_torch.core.walkers import WalkModel, sample_next
from repro_torch.data.streams import mixed_edge_stream, rmat_edges


def chi2_crit(df: int, alpha: float = 1e-3) -> float:
    """Chi-square critical value via the Wilson-Hilferty approximation."""
    z = {1e-2: 2.3263, 1e-3: 3.0902, 1e-4: 3.7190}[alpha]
    return df * (1.0 - 2.0 / (9.0 * df) + z * np.sqrt(2.0 / (9.0 * df))) ** 3


def adjacency(graph):
    """dict vertex -> sorted np array of neighbors (live prefix only)."""
    codes = to_u64_numpy(graph.codes)[: int(graph.num_edges)]
    src = (codes >> np.uint64(32)).astype(np.int64)
    dst = (codes & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return {int(v): np.sort(dst[src == v]) for v in np.unique(src)}


def alpha_probs(adj, prev: int, v: int, p: float, q: float):
    """(neighbors of v, exact alpha-weighted transition probabilities)."""
    nbrs = adj.get(v, np.zeros((0,), np.int64))
    prev_set = set(adj.get(prev, np.zeros((0,), np.int64)).tolist())
    w = np.asarray([1.0 / p if x == prev
                    else (1.0 if x in prev_set else 1.0 / q)
                    for x in nbrs], np.float64)
    return nbrs, w / w.sum()


def chi2_tv_against_exact(counts_by_ctx, adj, p, q, min_expected=5.0):
    """Aggregate (chi2, df, weighted mean TV) of empirical next-vertex
    counts per (prev, v) context against the exact alpha probabilities.
    Contexts where any expected cell < min_expected are excluded from chi2
    but still contribute to the TV summary."""
    chi2, df = 0.0, 0
    tv_num, tv_den = 0.0, 0.0
    for (prev, v), cnt in counts_by_ctx.items():
        nbrs, probs = alpha_probs(adj, prev, v, p, q)
        if nbrs.size < 2:
            continue
        m = float(sum(cnt.values()))
        obs = np.asarray([cnt.get(int(x), 0) for x in nbrs], np.float64)
        assert obs.sum() == m, "empirical next outside N(v)"
        exp = m * probs
        tv = 0.5 * np.abs(obs / m - probs).sum()
        tv_num += m * tv
        tv_den += m
        if (exp >= min_expected).all():
            chi2 += (((obs - exp) ** 2) / exp).sum()
            df += nbrs.size - 1
    assert df > 0, "no context had enough samples for chi-square"
    return chi2, df, tv_num / tv_den


def edge_contexts(adj, max_contexts: int):
    """(prev, v) pairs along edges: the contexts a walk can reach."""
    out = []
    for prev in sorted(adj):
        for v in adj[prev]:
            if int(v) in adj:
                out.append((int(prev), int(v)))
    return out[:max_contexts]


def sampler_counts(graph, model: WalkModel, contexts, reps: int,
                   rounds: int, seed: int):
    """Empirical next-vertex counts: `reps` lanes per context, `rounds`
    independent SAMPLENEXT batches (a fresh key each round), on the graph's
    device."""
    dev = graph.device
    prev = torch.tensor(np.repeat([c[0] for c in contexts], reps), device=dev)
    v = torch.tensor(np.repeat([c[1] for c in contexts], reps), device=dev)
    ctx_of = np.repeat(np.arange(len(contexts)), reps)
    counts = {c: {} for c in contexts}
    for r in range(rounds):
        out = sample_next(jr.PRNGKey(seed + r, dev), graph, v, prev, model).cpu().numpy()
        for lane, x in enumerate(out):
            cnt = counts[contexts[ctx_of[lane]]]
            cnt[int(x)] = cnt.get(int(x), 0) + 1
    return counts


def sampler_graph(dev="cpu", seed=0):
    """The sampler-level tests' graph: 120 R-MAT edges over 32 vertices."""
    src, dst = rmat_edges(jr.PRNGKey(seed, dev), 120, 5)
    return StreamingGraph.from_edges(src, dst, 32, 1024, device=dev)


def stream_engine(sampler: str, p: float, q: float, seed=3, n_w=48, length=8,
                  dev="cpu", dmax=32, megakernel="auto"):
    """The stream-level tests' engine: 40 R-MAT edges over 16 vertices,
    n_w walks per vertex of `length`, order 2."""
    src, dst = rmat_edges(jr.PRNGKey(seed, dev), 40, 4)
    g = StreamingGraph.from_edges(src, dst, 16, 2048, device=dev)
    model = WalkModel(order=2, p=p, q=q, sampler=sampler, dmax=dmax)
    cfg = WalkConfig(n_walks_per_vertex=n_w, length=length, model=model,
                     megakernel=megakernel)
    store = generate_corpus(jr.PRNGKey(seed + 1, dev), g, cfg)
    return WalkEngine(graph=g, store=store, cfg=cfg,
                      rewalk_capacity=16 * n_w, max_pending=3)


def stream_transition_counts(eng: WalkEngine, with_deletes: bool, seed=9,
                             n_batches=4):
    """Drive an insert(+delete) stream, return conditioned transition counts
    of the final corpus: dict (prev, v) -> dict next -> count. Every stored
    transition was re-sampled against a graph whose N(v) and N(prev) equal
    the final ones, so the counts fit the final graph's weights."""
    dev = eng.store.device
    n_del = 3 if with_deletes else 0
    ins_s, ins_d, del_s, del_d = mixed_edge_stream(
        jr.PRNGKey(seed, dev), n_batches, 6, n_del, 4)
    if with_deletes:
        eng.run_stream(jr.PRNGKey(seed + 1, dev), ins_s, ins_d, del_s, del_d)
    else:
        eng.run_stream(jr.PRNGKey(seed + 1, dev), ins_s, ins_d)
    assert not eng.mav_overflowed
    wm = eng.walk_matrix().cpu().numpy()
    degs = eng.graph.degrees().cpu().numpy()
    counts = {}
    for p_pos in range(1, wm.shape[1] - 1):
        for prev, v, nxt in zip(wm[:, p_pos - 1], wm[:, p_pos], wm[:, p_pos + 1]):
            if degs[int(v)] == 0:
                continue
            cnt = counts.setdefault((int(prev), int(v)), {})
            cnt[int(nxt)] = cnt.get(int(nxt), 0) + 1
    return counts
