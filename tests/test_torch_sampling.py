"""The port's neighbor samplers (repro_torch/models/sampling.py) against the
JAX package's on the CPU, bit for bit with the same keys: `sample_fanout`
and `sample_two_hop` on a graph with vertices of degree 0, and
`walk_based_neighborhood` on tests/test_stream.py's engine mid-stream,
through the overlay with its pending blocks live and through the merged
store, on each FINDNEXT backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import drive_per_batch, make_jax_engine, make_stream, port_engine_like
from repro.core.graph import StreamingGraph as JGraph
from repro.models import sampling as jsampling
from repro_torch.core.graph import StreamingGraph
from repro_torch.models import sampling

N = 64


def graphs(seed: int = 0):
    """The same undirected graph in both packages: 300 random edges among
    vertices 0..47, so 48..63 have degree 0."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 48, 300).astype(np.uint32)
    dst = rng.integers(0, 48, 300).astype(np.uint32)
    jg = JGraph.from_edges(jnp.asarray(src), jnp.asarray(dst), N, 1024)
    tg = StreamingGraph.from_edges(torch.from_numpy(src.astype(np.int64)),
                                   torch.from_numpy(dst.astype(np.int64)), N, 1024,
                                   device="cpu")
    np.testing.assert_array_equal(tg.offsets.numpy(), np.asarray(jg.offsets))
    return jg, tg


def seeds_with_isolated(b: int = 24, seed: int = 1) -> np.ndarray:
    s = np.random.default_rng(seed).integers(0, N, b).astype(np.uint32)
    s[:4] = [48, 55, 63, 0]
    return s


@pytest.mark.parametrize("fanout", [1, 5, 25])
def test_sample_fanout_bit_for_bit(fanout):
    jg, tg = graphs()
    seeds = seeds_with_isolated()
    key = jax.random.PRNGKey(7)
    want_n, want_m = jsampling.sample_fanout(key, jg, jnp.asarray(seeds), fanout)
    got_n, got_m = sampling.sample_fanout(np.asarray(key), tg, seeds, fanout)
    assert got_n.dtype == torch.int64 and got_m.dtype == torch.float32
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n).astype(np.int64))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    live = seeds < 48
    assert (got_m.numpy() == live[:, None]).all() and live[3] and not live[:3].any()
    # a masked row is its seed
    assert (got_n.numpy()[~live] == seeds[~live, None]).all()


@pytest.mark.parametrize("f1,f2", [(3, 2), (15, 10), (25, 10)])
def test_sample_two_hop_bit_for_bit(f1, f2):
    jg, tg = graphs(seed=2)
    seeds = seeds_with_isolated(b=16, seed=3)
    key = jax.random.PRNGKey(11)
    (jh1, jm1), (jh2, jm2) = jsampling.sample_two_hop(key, jg, jnp.asarray(seeds), f1, f2)
    (h1, m1), (h2, m2) = sampling.sample_two_hop(np.asarray(key), tg, seeds, f1, f2)
    assert h1.shape == (16, f1) and h2.shape == (16, f1, f2) and m2.shape == (16, f1, f2)
    for got, want in ((h1, jh1), (m1, jm1), (h2, jh2), (m2, jm2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))
    # a hop-2 row is masked where its hop-1 vertex is
    assert (m2.numpy()[:3] == 0).all() and (m2.numpy() <= m1.numpy()[..., None]).all()


_MID = {}


def mid_stream():
    """tests/test_stream.py's engine after 2 batches, both pending (no
    merge), and the port's engine started from its state."""
    if "eng" not in _MID:
        eng = make_jax_engine(max_pending=8)
        drive_per_batch(eng, jax.random.PRNGKey(21), make_stream(n_batches=2))
        assert eng.n_pending == 2
        _MID["eng"] = eng
    return _MID["eng"], port_engine_like(_MID["eng"])


@pytest.mark.parametrize("backend,jbackend", [(None, None), ("torch", "interpret"),
                                              ("ref", "xla-ref")])
def test_walk_based_neighborhood_bit_for_bit_with_pending_blocks(backend, jbackend):
    eng, teng = mid_stream()
    n_w, length = eng.cfg.n_walks_per_vertex, eng.cfg.length
    seeds = np.arange(0, N, 3).astype(np.uint32)
    for hops in (1, 2, length - 1):
        want = np.asarray(jsampling.walk_based_neighborhood(
            eng.overlay(), jnp.asarray(seeds), n_w, length, hops, backend=jbackend))
        got = sampling.walk_based_neighborhood(teng.overlay(), seeds, n_w, length, hops,
                                               backend=backend)
        assert got.shape == (len(seeds), n_w, hops + 1)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert (got.numpy()[:, :, 0] == seeds[:, None]).all()
    # the pending blocks are live: the stale base store walks otherwise
    stale = sampling.walk_based_neighborhood(teng.store, seeds, n_w, length, length - 1,
                                             backend=backend)
    assert not torch.equal(stale, got)
    # and the merged store gives the overlay's walks
    teng.merge()
    merged = sampling.walk_based_neighborhood(teng.store, seeds, n_w, length, length - 1,
                                              backend=backend)
    np.testing.assert_array_equal(merged.numpy(), got.numpy())
