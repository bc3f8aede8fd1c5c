"""The port's Overlay (base + pending reads) against the JAX package's, on
tests/test_stream.py's mid-stream engines: traverse = post-merge walk
matrix (orders 1 and 2), point FINDNEXT (corrupted owners must miss), the
empty overlay, `pending_walks_of` and `copy_pending`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (drive_per_batch, make_jax_engine, make_stream,
                           port_engine_like)
from repro.core.corpus import walk_start_vertex as j_start
from repro_torch.core.corpus import walk_start_vertex

U32 = jnp.uint32


_MID = {}


def _mid_stream(order=1, n_batches=3):
    """A JAX engine mid-stream (built once per order: the reads below leave
    it as it is) and a port engine started from its state."""
    if order not in _MID:
        eng = make_jax_engine(order=order, length=6 if order == 2 else 8,
                              max_pending=8)
        drive_per_batch(eng, jax.random.PRNGKey(21),
                        make_stream(n_batches=n_batches))
        assert eng.n_pending == n_batches
        _MID[order] = eng
    return _MID[order], port_engine_like(_MID[order])


@pytest.mark.parametrize("order", [1, 2])
def test_overlay_traverse_equals_reference_and_post_merge(order):
    eng, teng = _mid_stream(order)
    ov, tov = eng.overlay(), teng.overlay()
    n_walks, length = eng.store.n_walks, eng.store.length
    w = jnp.arange(n_walks, dtype=U32)
    want = np.asarray(ov.traverse(w, j_start(w, eng.cfg.n_walks_per_vertex),
                                  length - 1)).astype(np.int64)
    tw = torch.arange(n_walks)
    got = tov.traverse(tw, walk_start_vertex(tw, teng.cfg.n_walks_per_vertex),
                       length - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(teng.walk_matrix().numpy(), want)


def test_overlay_find_next_and_pending_walks_of_match_reference():
    eng, teng = _mid_stream()
    ov, tov = eng.overlay(), teng.overlay()
    wm = np.asarray(eng.overlay().traverse(
        jnp.arange(eng.store.n_walks, dtype=U32),
        j_start(jnp.arange(eng.store.n_walks, dtype=U32),
                eng.cfg.n_walks_per_vertex), eng.store.length - 1))
    rng = np.random.default_rng(1)
    ws = rng.integers(0, eng.store.n_walks, 64)
    ps = rng.integers(0, eng.store.length - 1, 64)
    vs = wm[ws, ps].astype(np.int64)
    vs[:8] = (vs[:8] + 1) % 64          # corrupted owners must miss
    want_v, want_f = ov.find_next(jnp.asarray(vs, U32), jnp.asarray(ws, U32),
                                  jnp.asarray(ps, U32))
    got_v, got_f = tov.find_next(torch.from_numpy(vs), torch.from_numpy(ws),
                                 torch.from_numpy(ps))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v).astype(np.int64))
    assert got_f[8:].all() and not got_f[:8].any()
    verts = np.arange(64)
    for cap in (1, 4, 16):
        want = np.asarray(ov.pending_walks_of(jnp.asarray(verts, U32), cap))
        got = tov.pending_walks_of(torch.from_numpy(verts), cap)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (want >= 0).any()
    # a copy survives the engine's next in-place update of its pending rows
    cp = tov.copy_pending()
    before = tov.find_next(torch.from_numpy(vs), torch.from_numpy(ws),
                           torch.from_numpy(ps))
    teng.run_stream(np.asarray(jax.random.PRNGKey(3)),
                    *make_stream(seed=8, n_batches=1))
    after = cp.find_next(torch.from_numpy(vs), torch.from_numpy(ws),
                         torch.from_numpy(ps))
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])


def test_overlay_without_pending_is_the_base():
    eng = make_jax_engine()
    teng = port_engine_like(eng)
    tov = teng.overlay()
    assert tov.n_pending_entries == 0
    tw = torch.arange(teng.store.n_walks)
    start = walk_start_vertex(tw, teng.cfg.n_walks_per_vertex)
    got = tov.traverse(tw, start, teng.store.length - 1)
    np.testing.assert_array_equal(got.numpy(), teng.walk_matrix().numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(eng.walk_matrix()).astype(np.int64))
    assert (tov.pending_walks_of(torch.arange(8), 4) == -1).all()
