"""The benchmark's parts on their own: the generators, the metric
arithmetic, the reference's arithmetic, kernel 5's work count and the trace
reader."""
from __future__ import annotations

import statistics
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import CPU, ROOT
from perfbench.harness import cell as runner
from perfbench.harness import stats, traffic, work
from perfbench.harness.trace import Trace
from perfbench.reference import wharf as ref

CFG = {"n_vertices": 1 << 10, "edge_capacity": 1 << 16,
       "graph": {"kind": "er", "mean_degree": 8}}
MIX = {"inserts": 50, "deletes": 10, "rmat": [0.5, 0.1, 0.1, 0.3]}
BIG_SEED = (1 << 31) + 12345


# ------------------------------------------------------------- generators


@pytest.mark.parametrize("kind", ["er", "rmat"])
def test_graph_repeats_under_a_seed(kind):
    cfg = dict(CFG, graph={"kind": kind, "mean_degree": 8,
                           "rmat": [0.57, 0.19, 0.19, 0.05]})
    a = traffic.graph_edges(cfg, BIG_SEED, CPU)
    b = traffic.graph_edges(cfg, BIG_SEED, CPU)
    c = traffic.graph_edges(cfg, BIG_SEED + 1, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (CFG["n_vertices"] * 4,)
    assert int(a[0].max()) < CFG["n_vertices"] and int(a[1].min()) >= 0


def test_stream_repeats_and_has_the_mix():
    s1 = traffic.update_stream(CFG, MIX, BIG_SEED, 7, CPU)
    s2 = traffic.update_stream(CFG, MIX, BIG_SEED, 7, CPU)
    s3 = traffic.update_stream(CFG, MIX, 3, 7, CPU)
    for x, y in zip(vars(s1).values(), vars(s2).values()):
        assert torch.equal(x, y)
    assert not torch.equal(s1.ins_src, s3.ins_src)
    assert s1.ins_src.shape == (7, 50) and s1.del_src.shape == (7, 10)
    assert s1.edges_per_batch == 60 and s1.keys.shape == (7, 2)
    assert int(s1.keys.max()) < 1 << 32 and int(s1.keys.min()) >= 0
    k, ins_s, ins_d, del_s, del_d = s1.batch(3)
    assert ins_s.shape == (1, 50) and torch.equal(ins_s[0], s1.ins_src[3])


def test_rmat_quadrant_law():
    gen = traffic.generator(5, "law", CPU)
    src, dst = traffic.rmat(gen, 200_000, 1, [0.5, 0.1, 0.1, 0.3], CPU)
    q = (src * 2 + dst).bincount(minlength=4).double() / 200_000
    assert torch.allclose(q, torch.tensor([0.5, 0.1, 0.1, 0.3], dtype=torch.float64),
                          atol=0.005)


def test_parts_have_their_own_generators():
    """Asking for more batches leaves the first ones as they were."""
    short = traffic.update_stream(CFG, MIX, 9, 3, CPU)
    long = traffic.update_stream(CFG, MIX, 9, 6, CPU)
    assert torch.equal(long.keys[:3], short.keys)
    assert traffic.sub_seed(9, "graph") != traffic.sub_seed(9, "inserts")


def test_max_batches_keeps_every_insert():
    cfg = {"n_vertices": 1 << 18, "edge_capacity": 1 << 25,
           "graph": {"kind": "er", "mean_degree": 100}}
    n = traffic.max_batches(cfg, {"inserts": 10_000})
    assert 2 * (1 << 18) * 50 + 2 * 10_000 * n <= 1 << 25
    assert n == 367


# ------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(q).exponential(size=37))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_rate_is_all_work_over_all_time():
    assert stats.rate(12_000 * 40, 48.0) == 10_000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_seconds():
    assert stats.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


# ------------------------------------------------------------- reference


def szudzik(x, y):
    return np.where(x < y, y * y + x, x * x + x + y)


def test_unpair_inverts_szudzik():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 28, 100_000)
    y = rng.integers(0, 1 << 18, 100_000)
    x[:4], y[:4] = [0, 7, (1 << 28) - 1, 3], [0, 7, (1 << 18) - 1, 9]
    z = torch.from_numpy(szudzik(x, y).astype(np.int64))
    a, b = ref.unpair(ref.unbias(ref.unbias(z)))
    assert torch.equal(a, torch.from_numpy(x)) and torch.equal(b, torch.from_numpy(y))


def test_reference_graph_set_semantics():
    g = ref.Graph.from_pairs(torch.tensor([0, 1, 1, 2]), torch.tensor([1, 0, 2, 2]), 4)
    assert g.codes.tolist() == [1, (1 << 32), (1 << 32) | 2, (2 << 32) | 1, (2 << 32) | 2]
    g2 = g.apply(torch.tensor([3]), torch.tensor([0]), torch.tensor([2, 3]),
                 torch.tensor([1, 3]))
    assert g2.has_edge(torch.tensor([0, 3, 1, 2]), torch.tensor([3, 0, 2, 2])).tolist() == \
        [True, True, False, True]
    assert g2.deg.tolist() == [2, 1, 1, 1]


def brute_law(adj, prev, cur, p, q):
    nb = sorted(adj[cur])
    w = [1 / p if x == prev else (1.0 if x in adj[prev] else 1 / q) for x in nb]
    cls = [0 if x == prev else (1 if x in adj[prev] else 2) for x in nb]
    out = np.zeros(3)
    for c, wi in zip(cls, w):
        out[c] += wi / sum(w)
    return out


def test_node2vec_probs_match_enumeration():
    rng = np.random.default_rng(1)
    n = 30
    pairs = rng.integers(0, n, (2, 200))
    g = ref.Graph.from_pairs(torch.from_numpy(pairs[0]), torch.from_numpy(pairs[1]), n)
    adj = {v: set() for v in range(n)}
    for a, b in pairs.T:
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))
    prev, cur = [], []
    for a, b in pairs.T[:60]:
        if a != b:
            prev.append(int(a))
            cur.append(int(b))
    prev, cur = torch.tensor(prev), torch.tensor(cur)
    _, n0, n1, n2 = ref.node2vec_classes(g, prev, cur, cur)
    pr = ref.node2vec_probs(g, prev, cur, n0, n1, n2, 0.5, 2.0, 1024, 8)
    want = np.stack([brute_law(adj, int(a), int(b), 0.5, 2.0)
                     for a, b in zip(prev, cur)])
    assert np.allclose(pr.numpy(), want)
    # above dmax: the 8-trial rejection law, still a distribution
    hub = ref.node2vec_probs(g, prev, cur, n0, n1, n2, 0.5, 2.0, 1, 8)
    assert torch.allclose(hub.sum(dim=1), torch.ones(len(prev), dtype=torch.float64))
    assert not torch.allclose(hub, pr)


def test_law_z_small_for_the_law_large_against_it():
    rng = np.random.default_rng(2)
    n = 64
    pairs = rng.integers(0, n, (2, 600))
    g = ref.Graph.from_pairs(torch.from_numpy(pairs[0]), torch.from_numpy(pairs[1]), n)
    model = {"p": 0.5, "q": 2.0, "dmax": 1024, "n_trials": 8}
    gen = torch.Generator().manual_seed(3)

    def walks(uniform: bool):
        w = torch.empty((3000, 6), dtype=torch.int64)
        w[:, 0] = torch.arange(3000) % n
        prev = w[:, 0].clone()
        for t in range(1, 6):
            cur = w[:, t - 1]
            d = g.deg[cur]
            nbrs = [g.codes[g.offsets[c]:g.offsets[c] + d[i]] & ref.LOW32
                    for i, c in enumerate(cur.tolist())]
            nxt = []
            for i, nb in enumerate(nbrs):
                if uniform or t == 1:
                    wt = torch.ones(len(nb), dtype=torch.float64)
                else:
                    wt = torch.where(nb == prev[i], 2.0,
                                     torch.where(g.has_edge(prev[i].expand_as(nb), nb),
                                                 1.0, 0.5)).double()
                nxt.append(nb[torch.multinomial(wt, 1, generator=gen)])
            prev = cur.clone()
            w[:, t] = torch.cat(nxt)
        return w

    w_idx = torch.arange(3000).repeat_interleave(3)
    pos = torch.tensor([2, 3, 4]).repeat(3000)
    assert ref.law_z(g, walks(False), w_idx, pos, model) < 4.0
    assert ref.law_z(g, walks(True), w_idx, pos, model) > 8.0


@pytest.mark.parametrize("pick", ["uniform", "off_by_one", "first"])
def test_rank_law_z_small_for_uniform_steps_large_otherwise(pick):
    rng = np.random.default_rng(4)
    n = 128
    pairs = rng.integers(0, n, (2, 3000))
    g = ref.Graph.from_pairs(torch.from_numpy(pairs[0]), torch.from_numpy(pairs[1]), n)
    gen = torch.Generator().manual_seed(5)
    cur = torch.randint(0, n, (200_000,), generator=gen)
    d = g.deg[cur]
    span = {"uniform": d, "off_by_one": (d - 1).clamp(min=1),
            "first": torch.ones_like(d)}[pick]
    r = (torch.rand(cur.shape, generator=gen, dtype=torch.float64) * span).long()
    nxt = g.codes[g.offsets[cur] + r] & ref.LOW32
    walks = torch.stack([cur, nxt], dim=1)
    idx = torch.arange(len(cur))
    z = ref.rank_law_z(g, walks, idx, torch.zeros_like(idx))
    assert (z < 4.5) if pick == "uniform" else (z > 20.0)


def test_stale_walks_counts_unchanged_suffixes():
    before = torch.arange(40).reshape(4, 10)
    after = before.clone()
    after[0, 3:] += 100          # re-walked from p_min 2
    after[3, 8:] += 100          # re-walked, but only 1 position after p_min
    p_min = torch.tensor([2, 2, 10, 7])
    # walk 1: affected at 2, nothing after it changed -> stale; walk 2:
    # unaffected; walk 3: too few positions after p_min to judge
    assert ref.stale_walks(before, after, p_min) == 1
    after[1, 9] += 100
    assert ref.stale_walks(before, after, p_min) == 0


def test_store_diff_counts_every_slot_once():
    walks = torch.tensor([[0, 1, 2], [1, 2, 1]], dtype=torch.int32)
    f = torch.arange(6)
    nxt = torch.tensor([1, 2, 2, 2, 1, 1])
    code = torch.from_numpy(szudzik(f.numpy(), nxt.numpy())).to(torch.int64) ^ ref.FLIP
    owner = walks.reshape(-1)
    epoch = torch.zeros(6, dtype=torch.int32)
    assert ref.store_diff(owner, code, epoch, epoch.clone(), walks) == 0
    dup = code.clone()
    dup[5] = dup[4]
    assert ref.store_diff(owner, dup, epoch, epoch.clone(), walks) >= 2


# ------------------------------------------------------------- work, trace


def test_kernel5_work_counts_each_segment_once():
    offsets = torch.tensor([0, 3, 203, 205, 205], dtype=torch.int32)
    v, prev = torch.tensor([0, 1, 1, 2]), torch.tensor([1, 0, 0, 3])
    nbytes, ops = work.csr_call_work(offsets, v, prev, 128)
    # segments 0 (3), 1 (min(200, 128)), 2 (2), 3 (0) once each
    assert float(nbytes) == (3 + 128 + 2 + 0) * 8 + 4 * 8 + 22 * 4
    assert float(ops) == 30 * (3 + 128 + 128 + 2)
    w = work.Kernel5Work()
    with w.kernel("szudzik_pair", ()):
        pass
    with w.kernel("intersect_csr", (None, offsets, v, prev, None, 128, 1.0, 1.0)):
        pass
    assert w.calls == 1
    assert w.bound_seconds() == pytest.approx(
        max(float(nbytes) / work.HBM_BYTES_PER_S, float(ops) / work.SCALAR_OPS_PER_S))


def test_trace_reader_layers_busy_and_gaps():
    t = Trace()
    t.ops = [(0, 10, "a"), (5, 20, "b"), (40, 50, "a"), (60, 70, "intersect_rows<1>")]
    t.spans = {"wharf.rewalk": [(0, 30)], "wharf.merge": [(35, 80)]}
    t.host = [(20, 40, "wharf.rewalk", 1), (22, 38, "aten::item", 1),
              (50, 60, "aten::nonzero", 1), (0, 100, "other", 2)]
    t.host_spans = [(20, 40, "wharf.rewalk")]
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.layer_s("wharf.rewalk") == pytest.approx(25e-6)
    assert t.layer_s("wharf.merge") == pytest.approx(20e-6)
    assert t.op_s("intersect_rows") == pytest.approx(10e-6)
    assert t.top_ops(1) == [["a", pytest.approx(20e-6)]]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == {"wharf.rewalk / aten::item": pytest.approx(20e-6),
                    "- / aten::nonzero": pytest.approx(10e-6)}


# ------------------------------------------------------------- modules


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "repro_torch" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert runner.forbidden_modules() == ["jaxlib", "repro"]


def test_reference_loads_nothing_of_the_system():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "import perfbench.reference.wharf; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
