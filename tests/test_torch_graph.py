"""The port's StreamingGraph against `repro.core.graph`: codes, offsets and
num_edges after inserts and deletes, membership, and neighbor draws on the
same keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core  # noqa: F401
from repro.core.graph import StreamingGraph as JGraph
from repro_torch import random as jr
from repro_torch._u64 import to_u64_numpy
from repro_torch.core.graph import StreamingGraph


def _same(jg, tg):
    np.testing.assert_array_equal(to_u64_numpy(tg.codes), np.asarray(jg.codes))
    np.testing.assert_array_equal(tg.offsets.numpy(), np.asarray(jg.offsets))
    assert int(tg.num_edges) == int(jg.num_edges)


@pytest.mark.parametrize("undirected", [True, False])
def test_apply_batch_matches_reference(undirected):
    rng = np.random.default_rng(0)
    n, cap = 50, 1024
    src, dst = rng.integers(0, n, size=(2, 300)).astype(np.uint32)
    jg = JGraph.from_edges(jnp.asarray(src), jnp.asarray(dst), n, cap, undirected)
    tg = StreamingGraph.from_edges(src, dst, n, cap, undirected, device="cpu")
    _same(jg, tg)
    for step in range(4):
        ins = rng.integers(0, n, size=(2, 20)).astype(np.uint32)
        # delete some existing edges and some absent ones
        dels = np.concatenate([np.stack([src[step * 7:step * 7 + 7],
                                         dst[step * 7:step * 7 + 7]]),
                               rng.integers(0, n, size=(2, 5)).astype(np.uint32)], axis=1)
        jg = jg.apply_batch(*(jnp.asarray(a) for a in (*ins, *dels)),
                            undirected=undirected)
        tg = tg.apply_batch(*ins, *dels, undirected=undirected)
        _same(jg, tg)
    q = rng.integers(0, n, size=(2, 200)).astype(np.uint32)
    np.testing.assert_array_equal(tg.has_edge(*q).numpy(),
                                  np.asarray(jg.has_edge(*(jnp.asarray(a) for a in q))))
    np.testing.assert_array_equal(tg.degrees().numpy(), np.asarray(jg.degrees()))
    np.testing.assert_array_equal(tg.neighbors.numpy(),
                                  np.asarray(jg.neighbors).astype(np.int64))


def test_sample_neighbor_matches_reference_same_key():
    """Isolated vertices (self-steps), a full graph and high-degree hubs."""
    rng = np.random.default_rng(1)
    n, cap = 64, 512
    src = rng.integers(0, 40, size=200).astype(np.uint32)   # 40..63 isolated
    dst = rng.integers(0, 40, size=200).astype(np.uint32)
    src[:30] = 0                                            # a hub at 0
    jg = JGraph.from_edges(jnp.asarray(src), jnp.asarray(dst), n, cap)
    tg = StreamingGraph.from_edges(src, dst, n, cap, device="cpu")
    v = rng.integers(0, n, size=777).astype(np.uint32)
    import torch
    for seed in range(5):
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(jg.sample_neighbor(kj, jnp.asarray(v)))
        got = tg.sample_neighbor(jr.as_key(np.asarray(kj), "cpu"),
                                 torch.from_numpy(v.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_empty_graph_and_empty_batches():
    jg = JGraph.empty(8, 16)
    tg = StreamingGraph.empty(8, 16, device="cpu")
    _same(jg, tg)
    e = np.zeros((0,), np.uint32)
    _same(jg.apply_batch(e, e, e, e), tg.apply_batch(e, e, e, e))
