"""The port's stream generators (repro_torch/data/streams.py) against the
JAX package's, bit for bit on the same keys.

The R-MAT quadrant draws take float64 gumbel noise, whose logs are torch's
and XLA's own: they differ in the last bit for a few draws in a thousand
(tests/test_torch_random.py::test_gumbel_matches_jax). An argmax over four
categories moves only where two noisy logits lie within an ulp or two,
~1e-16 relative a draw, against ~2.4e8 draws for an er graph at 2^18
vertices. So the ids are held exactly here; a flipped id would be a fault.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64, as the reference draws)
from repro.data import streams as ref
from repro_torch import random as jr
from repro_torch.data import streams


def _key(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")


def _eq(want, got):
    """A tuple of JAX arrays against the port's tensors (u32 ids as int32
    bits), value and dtype class."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == np.uint32:
            assert g.dtype == torch.int32
            w = w.view(np.int32)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("log2_n,n_edges", [(3, 1), (3, 1000), (6, 4097),
                                            (18, 1 << 16)])
def test_rmat_edges_match_jax(log2_n, n_edges):
    for seed in (0, 1, 2**32 + 5):
        kj, kt = _key(seed)
        _eq(ref.rmat_edges(kj, n_edges, log2_n), streams.rmat_edges(kt, n_edges, log2_n))


def test_rmat_prefix_is_a_smaller_draw():
    """Counters are per element, so the first m edges of a draw are the
    draw of m edges (chip_smoke holds a graph's prefix on the CPU so)."""
    kt = jr.PRNGKey(4, device="cpu")
    big = streams.er_edges(kt, 5000, 12)
    small = streams.er_edges(kt, 1024, 12)
    for b, s in zip(big, small):
        assert torch.equal(b[:1024], s)


def test_er_and_skewed_edges_match_jax():
    kj, kt = _key(11)
    _eq(ref.er_edges(kj, 3000, 10), streams.er_edges(kt, 3000, 10))
    for s in (1, 10):
        assert streams.skewed_params(s) == ref.skewed_params(s)
        _eq(ref.skewed_edges(kj, 2500, 9, s), streams.skewed_edges(kt, 2500, 9, s))


def test_edge_batches_and_stacked_stream_match_jax():
    kj, kt = _key(7)
    want = ref.edge_batches(kj, 3, 200, 8)
    got = streams.edge_batches(kt, 3, 200, 8)
    for w, g in zip(want, got):
        _eq(w, g)
    stacked = streams.edge_batch_stream(kt, 3, 200, 8)
    _eq(ref.edge_batch_stream(kj, 3, 200, 8), stacked)
    for i, (s, d) in enumerate(got):     # batch i = rmat_edges(split(key)[i])
        assert torch.equal(stacked[0][i], s) and torch.equal(stacked[1][i], d)
    _eq(ref.edge_batch_stream(kj, 4, 333, 7, 0.4, 0.2, 0.2, 0.2),
        streams.edge_batch_stream(kt, 4, 333, 7, 0.4, 0.2, 0.2, 0.2))


@pytest.mark.parametrize("n_del", [0, 4, 2000])
def test_mixed_edge_stream_matches_jax(n_del):
    kj, kt = _key(7)
    for n_batches, n_ins, log2_n in ((5, 10, 6), (2, 1000, 18)):
        if n_del == 2000 and log2_n == 6:
            continue
        _eq(ref.mixed_edge_stream(kj, n_batches, n_ins, n_del, log2_n),
            streams.mixed_edge_stream(kt, n_batches, n_ins, n_del, log2_n))


def test_cora_like_matches_jax():
    """Default sizes: 2,708 vertices, 5,429 edges, 7 classes, 1,433
    features; int64 labels and draws, float64 uniforms and bernoulli."""
    for seed in (0, 3):
        kj, kt = _key(seed)
        (ws, wd), wl, wf = ref.cora_like(kj)
        (gs, gd), gl, gf = streams.cora_like(kt)
        _eq((ws, wd, wl, wf), (gs, gd, gl, gf))
        assert gl.dtype == torch.int64 and gf.dtype == torch.float32


def test_token_stream_matches_jax():
    for seed, shape, vocab in ((0, (4, 33), 50_000), (9, (1, 7), 3)):
        kj, kt = _key(seed)
        _eq((ref.token_stream(kj, *shape, vocab),),
            (streams.token_stream(kt, *shape, vocab),))


def test_host_rmat_matches_numpy_reference():
    """A numpy copy: the same values and dtypes (the reference's dst comes
    out int64, `q % 2` promoting the u32 column)."""
    for seed, n, log2_n, params in ((0, 1000, 10, ()), (5, 77, 18, (0.25,) * 4)):
        want = ref.host_rmat(seed, n, log2_n, *params)
        got = streams.host_rmat(seed, n, log2_n, *params)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_generators_take_numpy_keys_on_the_named_device():
    kj, kt = _key(2)
    a = streams.rmat_edges(np.asarray(kj), 50, 5, device="cpu")
    b = streams.rmat_edges(kt, 50, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
