"""The port's serving frontend against the JAX package's on the CPU:
`WalkQueryService` (tests/test_serve.py's engine: an R-MAT graph of 64
vertices, 2 walks of length 8), carried across with `convert` and driven
with the same keys and streams. Walks, ids, counters and pinned answers
are held bit for bit (walks_of as per-row walk-id sets, as the reference
holds it), PPR rows to the reference's rtol 1e-6, embedding neighbor
scores to rtol 1e-6 (the reference's f32 dot sums in its own order).

The 8-shard pinned-serving test is in tests/test_torch_distr_serve_obs.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_engine_like
from repro.core import StreamingGraph, WalkConfig, generate_corpus
from repro.core.ppr import ppr_scores as j_ppr_scores
from repro.core.ppr import smape as j_smape
from repro.core.update import WalkEngine
from repro.data.streams import mixed_edge_stream, rmat_edges
from repro.serve.walk_queries import WalkQueryService as JService
from repro_torch.core.ppr import ppr_scores, smape
from repro_torch.serve import EpochCache, WalkQueryService
from repro_torch.serve import batched

PPR_RTOL = 1e-6      # tests/test_serve.py:138


def make_pair(seed=0, merge_policy="on-demand"):
    """tests/test_serve.py's `make_service`, and the port's service over
    the same engine state."""
    src, dst = rmat_edges(jax.random.PRNGKey(seed), 300, 6)
    g = StreamingGraph.from_edges(src, dst, 64, 4096)
    cfg = WalkConfig(n_walks_per_vertex=2, length=8)
    store = generate_corpus(jax.random.PRNGKey(seed + 1), g, cfg)
    eng = WalkEngine(graph=g, store=store, cfg=cfg, rewalk_capacity=128,
                     merge_policy=merge_policy)
    return JService(engine=eng), WalkQueryService(engine=port_engine_like(eng))


def k(seed):
    return jax.random.PRNGKey(seed)


def tk(seed):
    return np.asarray(jax.random.PRNGKey(seed))


def id_sets(rows):
    return [frozenset(int(w) for w in row if w >= 0) for row in np.asarray(rows)]


def deletion_stream_pair(seed=0, n_batches=3):
    """Per-batch mixed insert+delete updates on both, pending NOT merged."""
    j, t = make_pair(seed)
    ins_s, ins_d, del_s, del_d = (np.asarray(a) for a in mixed_edge_stream(
        k(seed + 5), n_batches, 12, 6, 6))
    keys = jax.random.split(k(seed + 6), n_batches)
    for i in range(n_batches):
        j.engine.update_batch(keys[i], ins_s[i], ins_d[i], del_s[i], del_d[i])
        t.engine.update_batch(np.asarray(keys[i]), ins_s[i], ins_d[i],
                              del_s[i], del_d[i])
    assert j.engine.n_pending == t.engine.n_pending == n_batches
    return j, t


def test_ppr_scores_and_smape_match_jax():
    rng = np.random.default_rng(0)
    wm = rng.integers(0, 40, size=(80, 12))
    wm[:, 0] = np.repeat(np.arange(40), 2)
    for alpha in (0.2, 0.5):
        want = np.asarray(j_ppr_scores(jnp.asarray(wm), 40, alpha))
        got = ppr_scores(torch.from_numpy(wm), 40, alpha).numpy()
        np.testing.assert_allclose(got, want, rtol=PPR_RTOL)
        assert got.dtype == np.float32
    a = rng.random((8, 8)).astype(np.float32)
    b = rng.random((8, 8)).astype(np.float32) * (rng.random((8, 8)) > 0.3)
    for ms in (0.0, 0.2):
        np.testing.assert_allclose(
            float(smape(torch.from_numpy(a), torch.from_numpy(b), min_score=ms)),
            float(j_smape(jnp.asarray(a), jnp.asarray(b), min_score=ms)),
            rtol=1e-6)


def test_ppr_scores_deterministic_and_zero_rows():
    """A table built twice from one matrix is bit-identical; a vertex no
    walk starts at keeps a zero row."""
    rng = np.random.default_rng(1)
    wm = torch.from_numpy(rng.integers(0, 16, size=(30, 10)))
    wm[:, 0] = torch.arange(30) % 15          # vertex 15 starts no walk
    a, b = ppr_scores(wm, 16, 0.2), ppr_scores(wm, 16, 0.2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not a[15].any()
    torch.testing.assert_close(a[:15].sum(1), torch.ones(15), rtol=1e-6, atol=0)


def test_next_vertices_matches_corpus():
    j, t = make_pair()
    walks = np.asarray(j.engine.walk_matrix())
    np.testing.assert_array_equal(t.engine.walk_matrix().numpy(), walks)
    ws, ps = np.asarray([3, 17, 40]), np.asarray([0, 2, 5])
    vs = walks[ws, ps]
    jn, jf = j.next_vertices(vs, ws, ps)
    nxt, found = t.next_vertices(vs, ws, ps)
    assert bool(found.all())
    np.testing.assert_array_equal(nxt.numpy(), walks[ws, ps + 1])
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))


def test_walks_of_is_exact_inverted_index():
    j, t = make_pair()
    walks = np.asarray(j.engine.walk_matrix())
    t.engine.walk_matrix()
    got = id_sets(t.walks_of([5, 9], capacity=64))
    assert got == id_sets(j.walks_of([5, 9], capacity=64))
    for row, v in zip(got, (5, 9)):
        assert row == set(np.nonzero((walks == v).any(axis=1))[0].tolist()), v


def test_queries_consistent_across_updates():
    j, t = make_pair()
    isrc, idst = (np.asarray(a) for a in rmat_edges(k(9), 16, 6))
    j.engine.insert_edges(k(10), isrc, idst)
    t.engine.insert_edges(tk(10), isrc, idst)
    walks = np.asarray(j.engine.walk_matrix())
    got = id_sets(t.walks_of([int(isrc[0])], capacity=128))[0]
    assert got == set(np.nonzero((walks == int(isrc[0])).any(axis=1))[0].tolist())
    np.testing.assert_array_equal(t.engine.walk_matrix().numpy(), walks)


def test_neighborhoods_shape():
    j, t = make_pair()
    nb = t.neighborhoods(torch.tensor([1, 2, 3]), hops=2)
    assert nb.shape == (3, 2, 3)
    np.testing.assert_array_equal(nb[:, :, 0].numpy(), [[1, 1], [2, 2], [3, 3]])
    np.testing.assert_array_equal(
        nb.numpy(), np.asarray(j.neighborhoods(jnp.asarray([1, 2, 3], jnp.uint32),
                                                 hops=2)))


def test_neighborhoods_mergeless_equals_postmerge_under_deletions():
    j, t = deletion_stream_pair()
    seeds = [1, 5, 9, 23]
    nb_overlay = t.neighborhoods(seeds, hops=2).numpy()
    np.testing.assert_array_equal(nb_overlay,
                                  np.asarray(j.neighborhoods(seeds, hops=2)))
    t.engine.merge()
    np.testing.assert_array_equal(t.neighborhoods(seeds, hops=2).numpy(),
                                  nb_overlay)


def test_walks_of_mergeless_under_deletions():
    j, t = deletion_stream_pair(seed=1)
    got = id_sets(t.walks_of([3, 11], capacity=128))
    assert got == id_sets(j.walks_of([3, 11], capacity=128))
    walks = t.engine.walk_matrix().numpy()        # the port's own merge
    for row, v in zip(got, (3, 11)):
        assert row == set(np.nonzero((walks == v).any(axis=1))[0].tolist()), v


def test_ppr_row():
    j, t = make_pair()
    row = t.ppr_row(7)
    assert row.shape == (64,) and row.dtype == torch.float32
    assert abs(float(row.sum()) - 1.0) < 1e-3 and float(row[7]) > 0
    np.testing.assert_allclose(row.numpy(), np.asarray(j.ppr_row(7)),
                               rtol=PPR_RTOL)


def test_ppr_cache_epoch_keyed_invalidation():
    j, t = deletion_stream_pair(seed=2)
    row1 = t.ppr_row(9).numpy()
    np.testing.assert_allclose(row1, np.asarray(j.ppr_row(9)), rtol=PPR_RTOL)
    wm1 = t.walk_matrix()
    assert t.walk_matrix() is wm1
    t.engine.merge()
    assert t.walk_matrix() is wm1              # merge: contents unchanged
    codes = np.asarray(j.engine.graph.codes)[:4]   # a deletion-only update
    dsrc = (codes >> np.uint64(32)).astype(np.int64)
    ddst = (codes & np.uint64(0xFFFFFFFF)).astype(np.int64)
    j.engine.delete_edges(k(77), jnp.asarray(dsrc, jnp.uint32),
                          jnp.asarray(ddst, jnp.uint32))
    t.engine.delete_edges(tk(77), dsrc, ddst)
    wm2 = t.walk_matrix()
    assert wm2 is not wm1
    np.testing.assert_array_equal(wm2.numpy(), np.asarray(j.walk_matrix()))
    row2 = t.ppr_row(9).numpy()
    expect = ppr_scores(wm2, t.engine.store.n_vertices, 0.2)[9].numpy()
    np.testing.assert_array_equal(row2, expect)
    np.testing.assert_allclose(row2, np.asarray(j.ppr_row(9)), rtol=PPR_RTOL)


def _planted_table():
    """tests/test_serve.py's planted table, plus exact ties: rows 10-12
    copy row 9, so a query at 9 ties 10, 11 and 12."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 16)).astype(np.float32) * 0.01
    table[:4] += np.ones(16, np.float32)
    table[4:8] -= np.ones(16, np.float32)
    table[10:13] = table[9]
    return table


def test_embedding_neighbors_after_set_embedding_table():
    j, t = make_pair()
    with pytest.raises(ValueError):
        t.embedding_neighbors([0])
    table = _planted_table()
    j.set_embedding_table(jnp.asarray(table))
    t.set_embedding_table(torch.from_numpy(table))
    for q, kk in (([0, 4], 3), ([9, 10, 20], 5), (list(range(64)), 63)):
        ids, scores = t.embedding_neighbors(q, k=kk)
        jids, jscores = j.embedding_neighbors(q, k=kk)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   rtol=1e-6, atol=1e-6)
    ids, scores = t.embedding_neighbors([0, 4], k=3)
    ids, scores = ids.numpy(), scores.numpy()
    assert set(ids[0]) <= {1, 2, 3} and set(ids[1]) <= {5, 6, 7}
    assert (np.diff(scores, axis=1) <= 1e-6).all()
    ids, scores = t.embedding_neighbors([9, 11], k=3)   # planted ties
    assert ids.tolist() == [[10, 11, 12], [9, 10, 12]]
    assert len(set(scores[0].tolist())) == 1
    eye = np.eye(64, 16, dtype=np.float32)
    eye[0, :] = 0.0
    eye[0, 1] = 1.0
    t.set_embedding_table(torch.from_numpy(eye))
    ids2, scores2 = t.embedding_neighbors([0], k=1)
    assert int(ids2[0, 0]) == 1 and float(scores2[0, 0]) > 0.99


def test_topk_tie_rule_is_lax_top_k():
    """Ties (equal f32 scores, -0.0 against 0.0, -inf) rank as `lax.top_k`
    ranks them: the lower index first, by the float's total order."""
    s = np.asarray([[0.5, 0.5, -0.0, 0.0, -np.inf, 0.5, 1.0, -1.0]],
                   np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), 8)
    ids, vals = batched._topk_lower_index_first(torch.from_numpy(s), 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


def _answers(svc, snap=None, port=True):
    """One batched query of every kind (tests/test_serve.py's `_answers`),
    as numpy; walks_of as per-row id sets."""
    wm = np.asarray(svc.walk_matrix(snapshot=snap))
    ws, ps = np.asarray([3, 17, 40]), np.asarray([0, 2, 5])
    nxt, found = svc.next_vertices(wm[ws, ps], ws, ps, snapshot=snap)
    return {
        "walk_matrix": wm.astype(np.int64),
        "walks_of": id_sets(svc.walks_of([3, 11, 27], capacity=128,
                                         snapshot=snap)),
        "neighborhoods": np.asarray(svc.neighborhoods(
            [1, 5, 9], hops=2, snapshot=snap)).astype(np.int64),
        "ppr": np.asarray(svc.ppr_rows([2, 9, 33], snapshot=snap)),
        "next": np.asarray(nxt).astype(np.int64),
        "found": np.asarray(found),
    }


def _assert_same(a, b, ppr_rtol=None):
    assert a.keys() == b.keys()
    for key in a:
        if key == "walks_of":
            assert a[key] == b[key], key
        elif key == "ppr" and ppr_rtol is not None:
            np.testing.assert_allclose(a[key], b[key], rtol=ppr_rtol)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
def test_pinned_snapshot_survives_donated_stream(policy):
    """The pin contract: a pinned snapshot's answers stay bit-identical
    across later run_stream windows and equal the post-merge answers of
    the state at pin time; the port's pinned answers equal the
    reference's."""
    j, t = make_pair(seed=3, merge_policy=policy)
    i0, d0, x0, y0 = (np.asarray(a) for a in mixed_edge_stream(k(40), 2, 12, 4, 6))
    for i in range(2):
        j.engine.update_batch(k(41 + i), i0[i], d0[i], x0[i], y0[i])
        t.engine.update_batch(tk(41 + i), i0[i], d0[i], x0[i], y0[i])
    twin = port_engine_like(j.engine)     # the state at pin time, merged
    twin.merge()
    ref = _answers(WalkQueryService(engine=twin))

    jsnap, snap = j.pin(), t.pin()
    assert t.engine.pins_active == 1
    pre = _answers(t, snap=snap)
    _assert_same(pre, ref)                       # mergeless pin == post-merge
    _assert_same(pre, _answers(j, snap=jsnap, port=False), ppr_rtol=PPR_RTOL)

    i_s, i_d, d_s, d_d = (np.asarray(a) for a in mixed_edge_stream(k(50), 4, 16, 4, 6))
    j.engine.run_stream(k(51), i_s[:2], i_d[:2], d_s[:2], d_d[:2])
    t.engine.run_stream(tk(51), i_s[:2], i_d[:2], d_s[:2], d_d[:2])
    mid = _answers(t, snap=snap)
    j.engine.run_stream(k(52), i_s[2:], i_d[2:], d_s[2:], d_d[2:])
    t.engine.run_stream(tk(52), i_s[2:], i_d[2:], d_s[2:], d_d[2:])
    post = _answers(t, snap=snap)
    _assert_same(mid, pre)
    _assert_same(post, pre)
    assert t.engine.epoch_counter == snap.epoch + 4

    live = t.walks_of([3, 11, 27], capacity=128)
    assert live.shape == (3, 256)
    assert id_sets(live) == id_sets(j.walks_of([3, 11, 27], capacity=128))

    snap.release()
    jsnap.release()
    assert t.engine.pins_active == 0
    with pytest.raises(ValueError):
        t.walks_of([3], capacity=64, snapshot=snap)
    t.engine.run_stream(tk(53), i_s[:2], i_d[:2], d_s[:2], d_d[:2])
    assert t.ppr_row(9).shape == (64,)


def test_pinned_snapshot_survives_in_place_merge_and_streams():
    """The port writes its pending blocks in place: a pin taken with
    pending blocks live answers bit-identically (every query kind, the
    overlay's own traverse, its pending rows) after a merge that clears
    them and two more run_stream windows that write them again."""
    _, t = deletion_stream_pair(seed=4, n_batches=3)
    eng = t.engine
    snap = t.pin()
    ov = snap.overlay
    rows0 = [c.clone() for c in (ov.owner, ov.code, ov.epoch, ov.slot,
                                 ov.row_of_slot)]
    w = torch.arange(eng.store.n_walks)
    trav0 = ov.traverse(w, w // 2, eng.store.length - 1)
    pre = _answers(t, snap=snap)
    t._wm_cache.clear()                          # recompute, not a cache hit
    t._ppr_cache.clear()
    _assert_same(_answers(t, snap=snap), pre)
    assert snap.nbytes == sum(c.numel() * c.element_size() for c in rows0)

    eng.merge()                                  # clears the blocks in place
    i_s, i_d, d_s, d_d = (np.asarray(a) for a in mixed_edge_stream(k(60), 4, 16, 4, 6))
    eng.run_stream(tk(61), i_s[:2], i_d[:2], d_s[:2], d_d[:2])
    eng.run_stream(tk(62), i_s[2:], i_d[2:], d_s[2:], d_d[2:])
    assert eng.n_pending == 4 and eng.epoch_counter == snap.epoch + 4
    t._wm_cache.clear()
    t._ppr_cache.clear()
    _assert_same(_answers(t, snap=snap), pre)
    assert torch.equal(ov.traverse(w, w // 2, eng.store.length - 1), trav0)
    for a, b in zip(rows0, (ov.owner, ov.code, ov.epoch, ov.slot,
                            ov.row_of_slot)):
        assert torch.equal(a, b)
    snap.release()


def test_pin_refcount_and_context_manager():
    j, t = make_pair()
    with t.pin() as a:
        b = t.pin()
        assert t.engine.pins_active == 2
        b.release()
        b.release()
        assert t.engine.pins_active == 1
        assert not a.released
    assert a.released and t.engine.pins_active == 0
    with pytest.raises(RuntimeError):
        t.engine.unpin_buffers()
    c = t.obs_counters()
    assert c["pins_total"] == 2 and c["pins_active"] == 0
    with j.pin() as ja:
        j.pin().release()
    assert ja.released
    assert j.obs_counters() == c


def test_ppr_scores_cached_per_epoch_and_restart():
    """The full table is built once per (epoch, restart_prob): repeats are
    cache hits; an update invalidates, a merge does not. The counters
    equal the reference's after every step."""
    j, t = make_pair()
    isrc, idst = (np.asarray(a) for a in rmat_edges(k(9), 8, 6))
    steps = [
        (lambda s, key: s.ppr_row(7), (1, 0)),
        (lambda s, key: s.ppr_row(7), (1, 1)),
        (lambda s, key: s.ppr_row(9), (1, 2)),
        (lambda s, key: s.ppr_row(7, restart_prob=0.5), (2, 2)),
        (lambda s, key: s.engine.insert_edges(key(10), isrc, idst), (2, 2)),
        (lambda s, key: s.ppr_row(7), (3, 2)),
        (lambda s, key: s.engine.merge(), (3, 2)),
        (lambda s, key: s.ppr_row(7), (3, 3)),
    ]
    for fn, (miss, hit) in steps:
        out = fn(t, tk)
        want = fn(j, k)
        c = t.obs_counters()
        assert (c["ppr_table_cache_miss"], c["ppr_table_cache_hit"]) == (miss, hit)
        assert c == j.obs_counters()
        if isinstance(out, torch.Tensor):
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       rtol=PPR_RTOL)
    assert torch.equal(t.ppr_row(7), t.ppr_row(7))


def test_overlay_cache_rekeyed_on_epoch_and_pending():
    _, t = make_pair()
    ov1 = t.snapshot()
    assert t.snapshot() is ov1
    t.engine.state = t.engine.state.replace()   # new object, same content
    assert t.snapshot() is ov1
    assert t.obs_counters()["overlay_rebuilds"] == 1
    isrc, idst = (np.asarray(a) for a in rmat_edges(k(9), 8, 6))
    t.engine.insert_edges(tk(10), isrc, idst)
    ov2 = t.snapshot()
    assert ov2 is not ov1
    t.engine.merge()
    ov3 = t.snapshot()
    assert ov3 is not ov2
    assert t.obs_counters()["overlay_rebuilds"] == 3


def test_batched_equals_per_call_with_odd_batch():
    j, t = make_pair()
    vs = [3, 11, 27, 40, 63]                      # 5 -> bucket 8
    assert batched.bucket_size(5) == 8 and batched.bucket_size(9) == 16
    padded, n = batched.pad_ids(torch.tensor(vs))
    assert padded.shape == (8,) and n == 5 and padded[5:].tolist() == [0, 0, 0]
    batch = t.walks_of(vs, capacity=64).numpy()
    for i, v in enumerate(vs):
        np.testing.assert_array_equal(batch[i], t.walks_of([v], capacity=64)[0].numpy())
    assert id_sets(batch) == id_sets(j.walks_of(vs, capacity=64))
    nb = t.neighborhoods(vs, hops=3).numpy()
    for i, v in enumerate(vs):
        np.testing.assert_array_equal(nb[i], t.neighborhoods([v], hops=3)[0].numpy())
    np.testing.assert_array_equal(nb, np.asarray(j.neighborhoods(vs, hops=3)))
    pr = t.ppr_rows(vs).numpy()
    for i, v in enumerate(vs):
        np.testing.assert_array_equal(pr[i], t.ppr_row(v).numpy())
    table = np.array(jax.random.normal(k(0), (64, 16)))   # f64 under x64
    t.set_embedding_table(torch.from_numpy(table))
    j.set_embedding_table(jnp.asarray(table))
    ids, sc = t.embedding_neighbors(vs, k=3)
    jids, _ = j.embedding_neighbors(vs, k=3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for i, v in enumerate(vs):
        i1, s1 = t.embedding_neighbors([v], k=3)
        np.testing.assert_array_equal(ids[i].numpy(), i1[0].numpy())
        np.testing.assert_array_equal(sc[i].numpy(), s1[0].numpy())


def test_input_validation_errors():
    """Out-of-range ids, bad hops / restart_prob / k raise ValueError with
    the reference's messages, and count as the reference counts them."""
    j, t = make_pair()
    n = t.engine.store.n_vertices
    table = np.array(jax.random.normal(k(0), (n, 8)))
    j.set_embedding_table(jnp.asarray(table))
    t.set_embedding_table(torch.from_numpy(table))
    cases = [("ppr", lambda s: s.ppr_row(n)),
             ("ppr", lambda s: s.ppr_rows([0, -1])),
             ("restart_prob", lambda s: s.ppr_row(0, restart_prob=1.5)),
             ("walks_of", lambda s: s.walks_of([n + 3], capacity=64)),
             ("seed", lambda s: s.neighborhoods([n], hops=2)),
             ("hops", lambda s: s.neighborhoods([0], hops=0)),
             ("hops", lambda s: s.neighborhoods([0], hops=s.engine.store.length)),
             ("k must be", lambda s: s.embedding_neighbors([0], k=n)),
             ("k must be", lambda s: s.embedding_neighbors([0], k=0)),
             ("embedding", lambda s: s.embedding_neighbors([n - 1, n], k=2))]
    for match, fn in cases:
        with pytest.raises(ValueError, match=match) as te:
            fn(t)
        with pytest.raises(ValueError, match=match) as je:
            fn(j)
        assert str(te.value) == str(je.value)
    assert t.obs_counters() == j.obs_counters()
    assert t.obs_counters()["serve_validation_errors"] == len(cases)
    with pytest.raises(ValueError, match="max_entries"):
        EpochCache("bad", max_entries=0)


def test_service_backend_serves_the_same_answers():
    """The service's FINDNEXT backend changes how a query is answered, not
    its answer; an unknown backend, or "cuda" for tensors on the CPU,
    raises."""
    _, t = deletion_stream_pair(seed=5)
    wm = t.walk_matrix().numpy()
    ws = np.arange(0, 128, 3)
    ps = ws % 7
    want = [x.numpy() for x in t.next_vertices(wm[ws, ps], ws, ps)]
    np.testing.assert_array_equal(want[0], wm[ws, ps + 1])
    for backend in ("ref", "torch", "auto"):
        svc = WalkQueryService(engine=t.engine, backend=backend)
        got = svc.next_vertices(wm[ws, ps], ws, ps)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    for backend in ("pallas", "cuda"):
        with pytest.raises(ValueError):
            WalkQueryService(engine=t.engine, backend=backend).next_vertices(
                wm[ws, ps], ws, ps)
