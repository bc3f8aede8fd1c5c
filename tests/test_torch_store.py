"""The port's WalkStore against `repro.core.store`: build / from_sorted
(all 13 tensor fields), the dirty-chunk invariant, FINDNEXT and traverse,
bit for bit, on stores carried across with `repro_torch.convert`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (STORE_FIELDS, make_jax_engine, make_stream,
                           port_engine_like, store_dict)
from repro.core import pairing as jp
from repro.core.corpus import walk_start_vertex
from repro.core.store import WalkStore as JStore
from repro.core.update import merge_interleave as j_merge_interleave
from repro_torch._u64 import from_u32_numpy, from_u64_numpy
from repro_torch.core import packed_store
from repro_torch.core.packed_store import CHUNK
from repro_torch.core.store import WalkStore
from repro_torch.core.update import merge_interleave

U32 = jnp.uint32


def _assert_stores_equal(jstore, tstore):
    a, b = store_dict(jstore), store_dict(tstore)
    for f in STORE_FIELDS:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.fixture(scope="module")
def mid_stream():
    """A JAX engine two batches into a stream (pending blocks, stale base
    entries) and the port's engine started from its state."""
    eng = make_jax_engine(n_w=4, length=10, max_pending=8)
    ins_s, ins_d, del_s, del_d = make_stream(n_batches=2)
    eng.run_stream(jax.random.PRNGKey(21), ins_s, ins_d, del_s, del_d)
    return eng, port_engine_like(eng)


def test_build_matches_reference(mid_stream):
    eng, _ = mid_stream
    s = eng.store
    perm = np.random.default_rng(0).permutation(s.size)
    owner, code, epoch = (np.asarray(a)[perm] for a in (s.owner, s.code, s.epoch))
    js = JStore.build(jnp.asarray(owner), jnp.asarray(code), jnp.asarray(epoch),
                      s.slot_epoch, s.length, s.n_walks, s.n_vertices)
    ts = WalkStore.build(from_u32_numpy(owner), from_u64_numpy(code),
                         from_u32_numpy(epoch),
                         from_u32_numpy(np.asarray(s.slot_epoch)),
                         s.length, s.n_walks, s.n_vertices)
    _assert_stores_equal(js, ts)
    assert ts.nbytes_packed() == js.nbytes_packed()
    assert ts.nbytes_uncompressed() == js.nbytes_uncompressed()
    assert ts.nbytes_packed_capacity() == js.nbytes_packed_capacity()


def test_dirty_chunk_reencode_invariant_matches_reference():
    """tests/test_packed_store.py's case: replace one triplet of the highest
    non-trivial vertex segment; clean chunks keep their packed rows, and
    the merged store equals the reference's."""
    eng = make_jax_engine()
    eng.merge()
    base = eng.store
    offs, vmin, vmax = (np.asarray(a) for a in (base.offsets, base.vmin, base.vmax))
    v_sel = max(v for v in range(base.n_vertices)
                if offs[v + 1] > offs[v] and vmin[v] != vmax[v] and offs[v] > CHUNK)
    pos = int(offs[v_sel + 1]) - 1
    f, vn = (int(x) for x in jp.szudzik_unpair(base.code[pos]))
    new_vn = int(vmin[v_sel]) if vn != int(vmin[v_sel]) else int(vmax[v_sel])
    new_code = jp.szudzik_pair(jnp.uint64(f), jnp.uint64(new_vn))
    jstore = base.replace(slot_epoch=base.slot_epoch.at[f].set(jnp.uint32(7)))
    jafter = j_merge_interleave(jstore, jnp.asarray([v_sel], U32),
                                jnp.asarray([new_code]), jnp.asarray([7], U32),
                                jnp.asarray([f], jnp.int32))
    tbase = port_engine_like(eng).store
    tstore = tbase.replace(slot_epoch=from_u32_numpy(np.asarray(jstore.slot_epoch)))
    tafter = merge_interleave(tstore, torch.tensor([v_sel], dtype=torch.int32),
                              from_u64_numpy(np.asarray([new_code])),
                              torch.tensor([7], dtype=torch.int32),
                              torch.tensor([f], dtype=torch.int32))
    _assert_stores_equal(jafter, tafter)
    old = packed_store.pad_chunk_codes(tbase.code)
    new = packed_store.pad_chunk_codes(tafter.code)
    clean = (old == new).all(dim=1)
    assert bool(clean[: int(offs[v_sel]) // CHUNK].all()) and not bool(clean.all())
    assert torch.equal(tafter.packed[clean], tbase.packed[clean])
    assert torch.equal(tafter.packed_view().decode()[: tafter.size], tafter.code)


@pytest.mark.parametrize("window", [None, 1])
def test_find_next_matches_reference_mid_stream(mid_stream, window):
    """Random (v, w, p) queries against a store with pending rewrites: hits,
    stale entries (slot rewritten by a pending block) and misses. window=1
    forces the over-window scan (test_small_window_falls_back_exactly)."""
    eng, teng = mid_stream
    s, ts = eng.store, teng.store
    w = np.arange(s.n_walks, dtype=np.uint32)
    starts = np.asarray(walk_start_vertex(jnp.asarray(w), eng.cfg.n_walks_per_vertex))
    paths = np.asarray(s.traverse(jnp.asarray(w), jnp.asarray(starts), s.length - 1))
    rng = np.random.default_rng(1)
    q = 96
    ws = rng.integers(0, s.n_walks, q).astype(np.uint32)
    ps = rng.integers(0, s.length - 1, q).astype(np.uint32)
    vs = paths[ws, ps].astype(np.uint32)
    vs[:16] = rng.integers(0, s.n_vertices, 16)
    ref_backend = "xla-ref" if window else None
    jv, jf = s.find_next(jnp.asarray(vs), jnp.asarray(ws), jnp.asarray(ps),
                         backend=ref_backend)
    tv, tf = ts.find_next(*(torch.from_numpy(a.astype(np.int64)) for a in (vs, ws, ps)),
                          window=window)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    rv, rf = ts.find_next(*(torch.from_numpy(a.astype(np.int64)) for a in (vs, ws, ps)),
                          backend="ref")
    assert torch.equal(rv, tv) and torch.equal(rf, tf)
    sv, sf = ts.find_next_simple(*(torch.from_numpy(a.astype(np.int64)) for a in (vs, ws, ps)))
    jsv, jsf = s.find_next_simple(jnp.asarray(vs[:24]), jnp.asarray(ws[:24]),
                                  jnp.asarray(ps[:24]))
    np.testing.assert_array_equal(sf.numpy()[:24], np.asarray(jsf))
    np.testing.assert_array_equal(sv.numpy()[:24], np.asarray(jsv).astype(np.int64))


def test_traverse_matches_reference(mid_stream):
    eng, teng = mid_stream
    s = eng.store
    w = np.arange(s.n_walks, dtype=np.uint32)
    starts = np.asarray(walk_start_vertex(jnp.asarray(w), eng.cfg.n_walks_per_vertex))
    want = np.asarray(s.traverse(jnp.asarray(w), jnp.asarray(starts), s.length - 1))
    got = teng.store.traverse(torch.from_numpy(w.astype(np.int64)),
                              torch.from_numpy(starts.astype(np.int64)), s.length - 1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_backend_registry(mid_stream):
    _, teng = mid_stream
    view = teng.store.packed_view()
    cidx = torch.arange(12, dtype=torch.int32).reshape(4, 3) % view.n_chunks
    f = torch.tensor([0, 5, 17, 1 << 40])
    assert all(torch.equal(a, b) for a, b in zip(view.search(cidx, f),
                                                 view.search(cidx, f, "ref")))
    dev = torch.device("cpu")
    assert packed_store.resolve_backend(None, dev) == "torch"
    assert packed_store.resolve_backend("ref", dev) == "ref"
    with pytest.raises(ValueError):
        packed_store.resolve_backend("cuda", dev)
    with pytest.raises(ValueError):
        packed_store.resolve_backend("pallas", dev)
