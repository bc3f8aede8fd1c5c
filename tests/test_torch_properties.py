"""tests/test_properties.py's six hypothesis properties on the port, under
the same @settings: `StreamingGraph` algebra (insert and delete inverse,
CSR offsets partition the edges, `has_edge` complete), the delta codec's
width classes round-trip, `search_range` encloses any code, and the stream
fuzz: hypothesis-generated mixed insert/delete streams replayed through the
port's `WalkEngine.run_stream` against a pure-Python engine (corpus and
graph bit for bit, every stored walk valid in the final graph).

The port alone runs here: the Python engine shares only the port's
SAMPLENEXT, so the engine's store, overlay, merge and stream machinery is
held against transparent code."""
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import random as jr
from repro_torch._u64 import from_u64_numpy, to_u64_numpy
from repro_torch.core import StreamingGraph, WalkConfig, corpus_to_store, pairing
from repro_torch.core.corpus import generate_walk_matrix
from repro_torch.core.update import WalkEngine
from repro_torch.core.walkers import WalkModel, sample_next
from repro_torch.kernels import ops
from repro_torch.kernels.delta import CHUNK, encode_chunks

CPU = "cpu"

edge_lists = st.lists(
    st.tuples(st.integers(0, 31), st.integers(0, 31)).filter(
        lambda e: e[0] != e[1]),
    min_size=1, max_size=24)


def _ids(values) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.int64)


def _graph(edges):
    src = _ids(e[0] for e in edges)
    dst = _ids(e[1] for e in edges)
    return StreamingGraph.from_edges(src, dst, 32, 512, device=CPU), src, dst


@given(edge_lists)
@settings(max_examples=40, deadline=None)
def test_graph_insert_delete_inverse(edges):
    """delete(insert(G, E), E) == G for fresh E (set semantics)."""
    g0 = StreamingGraph.empty(32, 512, device=CPU)
    g1, src, dst = _graph(edges)
    g2 = g1.delete_edges(src, dst)
    assert int(g2.num_edges) == 0
    assert torch.equal(g2.offsets, g0.offsets)
    assert torch.equal(g2.codes, g0.codes)


@given(edge_lists)
@settings(max_examples=40, deadline=None)
def test_graph_offsets_partition_edges(edges):
    """offsets form a valid CSR partition: deg sums to num_edges and every
    neighbor slot belongs to its claimed source segment."""
    g, _, _ = _graph(edges)
    offs = g.offsets.numpy()
    assert offs[-1] == int(g.num_edges)
    codes = to_u64_numpy(g.codes)[: int(g.num_edges)]
    srcs = (codes >> np.uint64(32)).astype(np.int64)
    for v in range(32):
        seg = srcs[offs[v]:offs[v + 1]]
        assert (seg == v).all()
    # sortedness => dedup: codes strictly increasing
    assert (np.diff(codes.astype(np.uint64)) > 0).all() or len(codes) <= 1


@given(edge_lists)
@settings(max_examples=40, deadline=None)
def test_graph_has_edge_complete(edges):
    g, src, dst = _graph(edges)
    assert bool(g.has_edge(src, dst).all())
    assert bool(g.has_edge(dst, src).all())  # undirected


@given(st.integers(1, 3), st.sampled_from([4, 200, 60_000, 2**20, 2**40]))
@settings(max_examples=40, deadline=None)
def test_delta_codec_width_class_roundtrip(n_chunks, scale):
    rng = np.random.default_rng(scale % 977)
    base = rng.integers(0, 2**50, size=(n_chunks, 1)).astype(np.uint64)
    deltas = rng.integers(0, scale, size=(n_chunks, CHUNK)).astype(np.uint64)
    codes = base + np.cumsum(deltas, axis=1)
    packed, widths, ahi, alo = encode_chunks(from_u64_numpy(codes))
    # width class is minimal for the observed deltas
    w = widths.numpy()
    dmax = deltas[:, 1:].max(axis=1) if CHUNK > 1 else np.zeros(n_chunks)
    for i in range(n_chunks):
        if dmax[i] < 256:
            assert w[i] == 8
        elif dmax[i] < 65536:
            assert w[i] == 16
    out = ops.delta_decode(packed, widths, ahi, alo, torch.arange(n_chunks))
    np.testing.assert_array_equal(to_u64_numpy(out), codes)


@given(st.integers(0, 2**31), st.integers(0, 2**20),
       st.integers(1, 100))
@settings(max_examples=60, deadline=None)
def test_search_range_encloses_any_code(f, v, spread):
    """[<f,vmin>,<f,vmax>] encloses <f,v'> for every v' in [vmin, vmax]
    (biased codes: signed order is the u64 order)."""
    vmin, vmax = v, v + spread
    lb, ub = pairing.search_range(_ids([f]), _ids([vmin]), _ids([vmax]))
    mid = v + spread // 2
    z = pairing.szudzik_pair(_ids([f]), _ids([mid]))
    assert int(lb[0]) <= int(z[0]) <= int(ub[0])


# --------------------------------------------------------------- stream fuzz
#
# tests/test_properties.py's pure-Python/numpy reference engine on the port:
# graph algebra on an edge SET, MAV / p_min / lane compaction / re-walk as
# explicit loops over a dense walk matrix. It shares only the SAMPLENEXT
# primitive (same keys, same lane shapes), so the `run_stream` corpus must
# be bit-equal to the reference matrix, the graph bit-equal to the
# reference edge set, and every stored walk valid in the final graph.

_FN = 16         # vertices (log2 4)
_FCAP = 512      # edge capacity (never overflows at these sizes)
_FBATCHES = 3    # fixed stream shape
_FINS, _FDEL = 4, 2


class _PyRefEngine:
    def __init__(self, walks, edges, cfg: WalkConfig):
        self.m = walks.numpy().astype(np.int64).copy()
        self.edges = set(edges)            # DIRECTED (src, dst) pairs
        self.cfg = cfg

    def graph(self) -> StreamingGraph:
        g = StreamingGraph.empty(_FN, _FCAP, device=CPU)
        if not self.edges:
            return g
        pairs = sorted(self.edges)
        return g.insert_edges(_ids(a for a, _ in pairs), _ids(b for _, b in pairs),
                              undirected=False)

    def update(self, key, ins, dels):
        """One Algorithm-2 update, replayed in plain python/numpy."""
        for a, b in dels:                  # deletions first (paper §3.1)
            self.edges.discard((a, b))
            self.edges.discard((b, a))
        for a, b in ins:
            self.edges.add((a, b))
            self.edges.add((b, a))
        g = self.graph()

        touched = {v for e in list(ins) + list(dels) for v in e}
        n_walks, length = self.m.shape
        p_min = np.full(n_walks, length, np.int64)
        v_min = np.zeros(n_walks, np.int64)
        for w in range(n_walks):
            for p in range(length):
                if int(self.m[w, p]) in touched:
                    p_min[w], v_min[w] = p, self.m[w, p]
                    break
        aff = np.nonzero(p_min < length)[0]

        # lane layout identical to _rewalk: compaction pads with id 0
        walk_ids = np.zeros(n_walks, np.int64)
        walk_ids[: aff.size] = aff
        lane_valid = np.arange(n_walks) < aff.size
        pm = p_min[walk_ids]
        vm = v_min[walk_ids]
        if self.cfg.model.order == 2:
            prev = self.m[walk_ids, np.maximum(pm - 1, 0)].copy()
        else:
            prev = vm.copy()

        keys = jr.split(key, length)
        cur = vm.copy()
        for p in range(length):
            cur = np.where(pm == p, vm, cur)
            nxt = sample_next(keys[p], g, torch.from_numpy(cur),
                              torch.from_numpy(prev), self.cfg.model).numpy()
            emit = lane_valid & (p >= pm)
            if p < length - 1:
                self.m[walk_ids[emit], p + 1] = nxt[emit]
            prev = np.where(p >= pm, cur, prev)
            if p < length - 1:
                cur = np.where(p >= pm, nxt, cur)


def assert_walks_valid(graph: StreamingGraph, wm):
    """tests/_walk_checks.py's walk-validity invariant on the port: each
    consecutive pair (a, b) of a walk is an edge of the graph, except the
    self-transitions of isolated vertices (deg(a) == 0: the walker stays)."""
    wm = np.asarray(wm)
    a = wm[:, :-1].reshape(-1)
    b = wm[:, 1:].reshape(-1)
    has = graph.has_edge(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    degs = graph.degrees().numpy()
    bad = ~(has | ((a == b) & (degs[a] == 0)))
    assert not bad.any(), \
        f"{int(bad.sum())} invalid walk transitions, e.g. " \
        f"{list(zip(a[bad][:5].tolist(), b[bad][:5].tolist()))}"


_fuzz_edges = st.lists(
    st.tuples(st.integers(0, _FN - 1), st.integers(0, _FN - 1)).filter(
        lambda e: e[0] != e[1]),
    min_size=1, max_size=16)
_fuzz_ins = st.lists(
    st.tuples(st.integers(0, _FN - 1), st.integers(0, _FN - 1)).filter(
        lambda e: e[0] != e[1]),
    min_size=_FBATCHES * _FINS, max_size=_FBATCHES * _FINS)
_fuzz_del = st.lists(
    st.tuples(st.integers(0, _FN - 1), st.integers(0, _FN - 1)).filter(
        lambda e: e[0] != e[1]),
    min_size=_FBATCHES * _FDEL, max_size=_FBATCHES * _FDEL)


# all three walk models replay the same drawn stream
_FUZZ_MODELS = (
    WalkModel(order=1),
    WalkModel(order=2, p=0.5, q=2.0),
    WalkModel(order=2, p=0.5, q=2.0, sampler="factorized", dmax=32),
)


@given(_fuzz_edges, _fuzz_ins, _fuzz_del, st.integers(0, 2**16))
@settings(max_examples=10, deadline=None)
def test_stream_fuzz_matches_python_reference(edges, ins, dels, seed):
    """run_stream == pure-python reference: corpus and graph bit-equal,
    every stored walk valid in the final graph (all three walk models)."""
    for model in _FUZZ_MODELS:
        _check_stream_fuzz(model, edges, ins, dels, seed)


def _batches(pairs, width: int, side: int):
    return _ids(e[side] for e in pairs).reshape(_FBATCHES, width)


def _check_stream_fuzz(model, edges, ins, dels, seed):
    cfg = WalkConfig(n_walks_per_vertex=1, length=5, model=model)
    g0 = StreamingGraph.from_edges(_ids(a for a, _ in edges),
                                   _ids(b for _, b in edges), _FN, _FCAP,
                                   device=CPU)
    walks0 = generate_walk_matrix(jr.PRNGKey(seed, CPU), g0, cfg)
    store = corpus_to_store(walks0, cfg, _FN)
    eng = WalkEngine(graph=g0, store=store, cfg=cfg, merge_policy="on-demand",
                     rewalk_capacity=_FN, max_pending=2)

    directed0 = {(int(a), int(b)) for a, b in edges}
    directed0 |= {(b, a) for a, b in directed0}
    ref = _PyRefEngine(walks0, directed0, cfg)

    stream_key = jr.PRNGKey(seed + 1, CPU)
    eng.run_stream(stream_key, _batches(ins, _FINS, 0), _batches(ins, _FINS, 1),
                   _batches(dels, _FDEL, 0), _batches(dels, _FDEL, 1))
    assert not eng.mav_overflowed

    keys = jr.split(stream_key, _FBATCHES)
    for i in range(_FBATCHES):
        ref.update(keys[i], ins[i * _FINS:(i + 1) * _FINS],
                   dels[i * _FDEL:(i + 1) * _FDEL])

    # corpus bit-equivalence (walk_matrix forces the on-demand merge, so the
    # merge path is validated too) + graph bit-equivalence
    np.testing.assert_array_equal(eng.walk_matrix().numpy(), ref.m)
    assert torch.equal(eng.graph.codes, ref.graph().codes)
    # final-graph validity of every stored walk
    assert_walks_valid(eng.graph, ref.m)
