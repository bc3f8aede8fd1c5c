"""The port's order-2 samplers against the JAX package's, bit for bit: the
whole-batch rejection step, the per-lane keyed step, the compacted
rejection fallback (overflow counts below, at and above the reference's
side batch), the factorized step, and order-2 corpus generation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401
from repro.core import StreamingGraph as JGraph
from repro.core import WalkConfig as JConfig
from repro.core import walkers as jw
from repro.core.corpus import generate_walk_matrix as j_walk_matrix
from repro.data.streams import rmat_edges
from repro_torch.convert import config_from
from repro_torch.core import StreamingGraph, walkers
from repro_torch.core.corpus import generate_walk_matrix

LOG2_N = 6
N = 2 ** LOG2_N


def _graphs(seed=3, n_edges=300, hubs=0):
    src, dst = (np.asarray(a) for a in rmat_edges(jax.random.PRNGKey(seed),
                                                  n_edges, LOG2_N))
    if hubs:   # vertices of degree > 8, to overflow small windows
        h = np.repeat(np.arange(hubs), 20)
        src = np.concatenate([src, h])
        dst = np.concatenate([dst, (h * 7 + np.arange(h.shape[0])) % N])
    jg = JGraph.from_edges(jnp.asarray(src, jnp.uint32),
                           jnp.asarray(dst, jnp.uint32), N, 4096)
    tg = StreamingGraph.from_edges(src, dst, N, 4096, device="cpu")
    return jg, tg


def _lanes(key, b):
    kv, kp = jax.random.split(key)
    v = jax.random.randint(kv, (b,), 0, N).astype(jnp.uint32)
    prev = jax.random.randint(kp, (b,), 0, N).astype(jnp.uint32)
    return v, prev, torch.from_numpy(np.asarray(v).astype(np.int64)), \
        torch.from_numpy(np.asarray(prev).astype(np.int64))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("p,q,n_trials", [(0.5, 2.0, 8), (0.25, 4.0, 3),
                                          (4.0, 0.25, 1)])
def test_rejection_steps_match_reference(p, q, n_trials):
    jg, tg = _graphs()
    key = jax.random.PRNGKey(5)
    v, prev, tv, tp = _lanes(key, 200)
    kt = torch.from_numpy(np.asarray(key).astype(np.int64))
    want = jw._node2vec_step(key, jg, v, prev, p, q, n_trials)
    got = walkers._node2vec_step(kt, tg, tv, tp, p, q, n_trials)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lanes = jnp.arange(200, dtype=jnp.int32) * 3 + 1
    want = jw._node2vec_step_perlane(key, jg, v, prev, p, q, n_trials, lanes)
    got = walkers._node2vec_step_perlane(kt, tg, tv, tp, p, q, n_trials,
                                         _t(lanes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_over", [0, 3, 8, 20])
def test_rejection_fallback_matches_reference(n_over):
    """b = 64: the reference's side batch holds ceil(64/8) = 8 lanes, so 3
    fit it, 8 fill it and 20 take its whole-batch tier; all equal the
    port's compaction."""
    jg, tg = _graphs()
    key = jax.random.PRNGKey(9)
    v, prev, tv, tp = _lanes(jax.random.PRNGKey(1), 64)
    nxt0 = jnp.arange(64, dtype=jnp.uint32) + 1000
    over = np.zeros(64, bool)
    over[np.random.default_rng(n_over).choice(64, n_over, replace=False)] = True
    want = jw.rejection_fallback(key, jg, v, prev, jnp.asarray(over), nxt0,
                                 0.5, 2.0, 8)
    got = walkers.rejection_fallback(
        torch.from_numpy(np.asarray(key).astype(np.int64)), tg, tv, tp,
        torch.from_numpy(over), _t(nxt0), 0.5, 2.0, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dmax", [8, 64, 128])
def test_factorized_step_matches_reference(dmax):
    jg, tg = _graphs(hubs=4)
    key = jax.random.PRNGKey(12)
    v, prev, tv, tp = _lanes(jax.random.PRNGKey(2), 96)
    kt = torch.from_numpy(np.asarray(key).astype(np.int64))
    nv, deg = walkers._neighbor_window(tg, tv, dmax)
    jnv, jdeg = jw._neighbor_window(jg, v, dmax)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv).astype(np.int64))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    assert (deg > 8).any()
    for backend in (None, "xla-ref"):
        want = jw._node2vec_factorized_step(key, jg, v, prev, 0.5, 2.0, 8,
                                            dmax, backend)
        got = walkers._node2vec_factorized_step(
            kt, tg, tv, tp, 0.5, 2.0, 8, dmax,
            None if backend is None else "ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sampler", ["rejection", "factorized"])
def test_order2_walk_matrix_matches_reference(sampler):
    from repro.core.walkers import WalkModel
    jg, tg = _graphs(hubs=2)
    key = jax.random.PRNGKey(5)
    jcfg = JConfig(n_walks_per_vertex=2, length=7, model=WalkModel(
        order=2, p=0.5, q=2.0, sampler=sampler, dmax=8))
    want = np.asarray(j_walk_matrix(key, jg, jcfg))
    got = generate_walk_matrix(np.asarray(key), tg, config_from(jcfg))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
