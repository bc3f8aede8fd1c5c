"""The II and tree baselines (repro_torch/core/baselines.py) against the
JAX package's, bit for bit: the II's walks, index codes and offsets, the
tree's four columns, the affected counts and `nbytes()`, on
tests/test_downstream.py's graph and a 4-batch mixed stream; and the
cross-checks chip_smoke's phase 6 makes at full width on the card.

What the cross-checks rest on (held here in JAX and in the port): from one
create key, Wharf, the II and the tree sample the same corpus, and a
batch's touched vertices give each the same affected walks. At order 1
the tree's update draws what Wharf's does, so its walks equal Wharf's
after every batch. The reference's II writes at column p the vertex it
samples at step p, one column ahead of the tree, so after a batch the II
equals the tree only shifted by that column; it does not equal it as
triplets. At order 2 the tree's first resampled step takes prev = cur
(`prev0 = vm`), so there only batch 1's affected counts agree.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64, as the reference draws)
from repro.core import StreamingGraph, WalkConfig, generate_corpus
from repro.core import baselines as ref
from repro.core.update import WalkEngine
from repro.core.walkers import WalkModel
from repro.data.streams import mixed_edge_stream, rmat_edges
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.core import baselines
from repro_torch.core import generate_corpus as port_corpus
from repro_torch.core.graph import StreamingGraph as PortGraph
from repro_torch.core.update import WalkEngine as PortWalkEngine

import chip_smoke

N2V = dict(order=2, p=0.5, q=2.0, dmax=64)
# name -> (walk model, log2 vertices, walks a vertex, rewalk capacity);
# capacity None keeps the default 1024, below the 2,048-walk corpus's
# affected count: the truncating case
CASES = {
    "order1": (WalkModel(), 6, 2, "2N"),
    "order1-default-capacity": (WalkModel(), 8, 8, None),
    "order2-rejection": (WalkModel(sampler="rejection", **N2V), 6, 2, "2N"),
    "order2-factorized": (WalkModel(sampler="factorized", **N2V), 6, 2, "2N"),
}
KINDS = {"ii": (ref.IIEngine, baselines.IIEngine),
         "tree": (ref.TreeEngine, baselines.TreeEngine)}
FIELDS = {"ii": convert.II_FIELDS, "tree": convert.TREE_FIELDS}


def setup(model=WalkModel(), log2_n=6, n_w=2, length=8, n_batches=4):
    """tests/test_downstream.py's graph and stream, scaled with log2_n ->
    (JAX graph maker, port graph maker, JAX config, port config, stream
    as numpy arrays)."""
    n, scale = 1 << log2_n, 1 << (log2_n - 6)
    src, dst = rmat_edges(jax.random.PRNGKey(0), 300 * scale, log2_n)
    cap = 4096 * scale
    cfg = WalkConfig(n_walks_per_vertex=n_w, length=length, model=model)
    stream = [np.asarray(a) for a in mixed_edge_stream(
        jax.random.PRNGKey(7), n_batches, 10 * scale, 4 * scale, log2_n)]
    return (lambda: StreamingGraph.from_edges(src, dst, n, cap),
            lambda: PortGraph.from_edges(np.asarray(src), np.asarray(dst), n,
                                         cap, device="cpu"),
            cfg, convert.config_from(cfg), stream)


def as_torch(stream):
    """A numpy u32 stream -> the port's int32 tensors."""
    return [torch.from_numpy(s.astype(np.int32)) for s in stream]


def jax_to_numpy(eng, kind) -> dict:
    """A JAX baseline -> the dict of `convert.baseline_to_numpy`."""
    out = {"graph.n_vertices": eng.graph.n_vertices}
    for k in list(convert.GRAPH_FIELDS) + list(FIELDS[kind]):
        obj, _, name = k.rpartition(".")
        out[k] = np.asarray(getattr(getattr(eng, obj) if obj else eng, name))
    return out


def assert_same(jeng, teng, kind):
    want, got = jax_to_numpy(jeng, kind), convert.baseline_to_numpy(teng)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
    assert teng.nbytes() == jeng.nbytes()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", list(CASES))
def test_baseline_matches_jax(case, kind):
    model, log2_n, n_w, cap = CASES[case]
    jgraph, tgraph, cfg, tcfg, stream = setup(model, log2_n, n_w)
    jcls, tcls = KINDS[kind]
    jeng = jcls.create(jax.random.PRNGKey(1), jgraph(), cfg)
    teng = tcls.create(jr.PRNGKey(1, device="cpu"), tgraph(), tcfg)
    assert_same(jeng, teng, kind)
    if cap == "2N":
        jeng.rewalk_capacity = teng.rewalk_capacity = 2 << log2_n
    want = np.asarray(jeng.run_stream(jax.random.PRNGKey(8), *stream))
    got = teng.run_stream(jr.PRNGKey(8, device="cpu"), *stream)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if cap is None:
        assert want.max() > teng.rewalk_capacity == 1024   # it truncates
    assert_same(jeng, teng, kind)


@pytest.mark.parametrize("kind", list(KINDS))
def test_run_stream_is_per_batch_replay(kind):
    """The port's counterpart of tests/test_downstream.py::
    test_baselines_accept_stacked_streams: run_stream = update_batch under
    split(key, n_batches)[i], batch by batch."""
    _, tgraph, _, tcfg, stream = setup()
    tcls = KINDS[kind][1]
    e1, e2 = (tcls.create(jr.PRNGKey(1, device="cpu"), tgraph(), tcfg)
              for _ in range(2))
    e1.rewalk_capacity = e2.rewalk_capacity = 128
    key = jr.PRNGKey(8, device="cpu")
    aff = e1.run_stream(key, *stream)
    keys = jr.split(key, 4)
    aff2 = [e2.update_batch(keys[i], *(s[i] for s in stream)) for i in range(4)]
    assert aff.tolist() == aff2
    a, b = convert.baseline_to_numpy(e1), convert.baseline_to_numpy(e2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_state_carries_across_from_jax(kind):
    """A JAX baseline after one batch, carried across with
    `convert.baseline_from_numpy`, goes on as the JAX one does."""
    jgraph, _, cfg, tcfg, stream = setup(WalkModel(sampler="factorized", **N2V))
    jeng = KINDS[kind][0].create(jax.random.PRNGKey(1), jgraph(), cfg)
    jeng.rewalk_capacity = 128
    jeng.run_stream(jax.random.PRNGKey(3), *(s[:1] for s in stream))
    teng = convert.baseline_from_numpy(jax_to_numpy(jeng, kind), tcfg,
                                       device="cpu", rewalk_capacity=128)
    assert isinstance(teng, KINDS[kind][1])
    rest = [s[1:] for s in stream]
    want = np.asarray(jeng.run_stream(jax.random.PRNGKey(4), *rest))
    got = teng.run_stream(jr.PRNGKey(4, device="cpu"), *rest)
    np.testing.assert_array_equal(got.numpy(), want)
    assert_same(jeng, teng, kind)


def _jax_matrix(eng):
    if isinstance(eng, ref.IIEngine):
        return np.asarray(eng.walks).astype(np.int64)
    if isinstance(eng, ref.TreeEngine):
        m = np.zeros((eng.walk.shape[0] // eng.cfg.length, eng.cfg.length), np.int64)
        m[np.asarray(eng.walk), np.asarray(eng.pos)] = np.asarray(eng.owner)
        return m
    return np.asarray(eng.walk_matrix()).astype(np.int64)


@pytest.mark.parametrize("order", [1, 2])
def test_wharf_ii_tree_cross_checks(order):
    """Phase 6's cross-checks, in JAX and in the port, batch by batch under
    fold_in(key, i) as phase 6 drives them: batch 1's affected counts equal
    across Wharf, the II and the tree, the port's equal JAX's; at order 1
    the tree = Wharf after every batch, and after batch 1 the II = the tree
    shifted by one column past p_min but not as it stands."""
    model = WalkModel() if order == 1 else WalkModel(sampler="factorized", **N2V)
    jgraph, tgraph, cfg, tcfg, stream = setup(model)
    cap = 128
    jkey, tkey = jax.random.PRNGKey(8), jr.PRNGKey(8, device="cpu")
    g = jgraph()
    jeng = {"wharf": WalkEngine(graph=g, store=generate_corpus(
        jax.random.PRNGKey(1), g, cfg), cfg=cfg, rewalk_capacity=cap,
        max_pending=3)}
    tg = tgraph()
    teng = {"wharf": PortWalkEngine(graph=tg, store=port_corpus(
        jr.PRNGKey(1, device="cpu"), tg, tcfg), cfg=tcfg, rewalk_capacity=cap,
        max_pending=3)}
    for kind, (jcls, tcls) in KINDS.items():
        jeng[kind] = jcls.create(jax.random.PRNGKey(1), jgraph(), cfg)
        teng[kind] = tcls.create(jr.PRNGKey(1, device="cpu"), tgraph(), tcfg)
        jeng[kind].rewalk_capacity = teng[kind].rewalk_capacity = cap
    tstream = as_torch(stream)
    t0 = {k: chip_smoke.walk_matrix_of(e) for k, e in teng.items()}
    assert torch.equal(t0["ii"], t0["tree"]) and torch.equal(t0["ii"], t0["wharf"])
    for i in range(4):
        ja = {k: int(e.run_stream(jax.random.fold_in(jkey, i),
                                  *(s[i:i + 1] for s in stream))[0])
              for k, e in jeng.items()}
        ta = {k: chip_smoke.paper_batch(e, tstream, tkey, i) for k, e in teng.items()}
        assert ta == ja
        jm = {k: _jax_matrix(e) for k, e in jeng.items()}
        tm = {k: chip_smoke.walk_matrix_of(e) for k, e in teng.items()}
        for k in jm:
            np.testing.assert_array_equal(tm[k].numpy(), jm[k], err_msg=f"{k} {i}")
        if i == 0:
            assert len(set(ja.values())) == 1
            pm = chip_smoke.first_touched(t0["ii"], tstream, 0, tg.n_vertices)
            if order == 1:
                assert chip_smoke.ii_shifted_equal(tm["ii"], tm["tree"], pm)
                assert not np.array_equal(jm["ii"], jm["tree"])
        if order == 1:
            assert ja["tree"] == ja["wharf"]
            np.testing.assert_array_equal(jm["tree"], jm["wharf"])


@pytest.mark.parametrize("model", [WalkModel(), WalkModel(sampler="factorized", **N2V)],
                         ids=["order1", "order2-factorized"])
def test_phase6_invariants_hold_on_the_cpu(model):
    """chip_smoke's per-engine checks on the port's engines after every
    batch: the tree's slots once, lexsorted, next = the next slot's owner,
    steps edges; the II's rewritten pairs edges and its prefixes kept."""
    _, tgraph, _, tcfg, stream = setup(model)
    stream = as_torch(stream)
    ii = baselines.IIEngine.create(jr.PRNGKey(1, device="cpu"), tgraph(), tcfg)
    tree = baselines.TreeEngine.create(jr.PRNGKey(1, device="cpu"), tgraph(), tcfg)
    ii.rewalk_capacity = tree.rewalk_capacity = 128
    chip_smoke.tree_checks(tree)
    key = jr.PRNGKey(8, device="cpu")
    for i in range(4):
        before = ii.walks
        chip_smoke.paper_batch(ii, stream, key, i)
        chip_smoke.ii_checks(before, ii, chip_smoke.first_touched(
            before, stream, i, ii.graph.n_vertices))
        chip_smoke.paper_batch(tree, stream, key, i)
        chip_smoke.tree_checks(tree)
    # a broken tree is caught
    tree.nxt = tree.nxt.roll(1)
    with pytest.raises(AssertionError):
        chip_smoke.tree_checks(tree)


def test_inverted_index_build_matches_jax():
    rng = np.random.default_rng(0)
    walks = rng.integers(0, 50, size=(37, 9)).astype(np.uint32)
    want = ref.InvertedIndex.build(jax.numpy.asarray(walks), 53)
    got = baselines.InvertedIndex.build(torch.from_numpy(walks.astype(np.int32)), 53)
    from repro_torch._u64 import to_u64_numpy
    np.testing.assert_array_equal(to_u64_numpy(got.vw), np.asarray(want.vw))
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    assert got.offsets.dtype == torch.int32
