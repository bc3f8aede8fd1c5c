"""The card's order-2 route on the CPU: the kernel wrappers are made to take
their card branch (`ops._on_card` true, every backend registry resolving
for a device of type "cuda"), with each kernel's plain version standing in
for it. The engine then runs exactly the code it runs on the card: the
factorized sampler calls the CSR kernel (`ops.intersect_csr`) and the fused
scan passes the graph's CSR to the fused step, and neither builds a
neighbor window. Held against the JAX package bit for bit: the order-2
corpus and `run_stream`, unfused and fused (the JAX package holds its
fused path equal to its unfused one, tests/test_megakernel.py), on a
512-vertex graph with hubs of degree > dmax = 128, so that the rejection
fallback runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (STORE_FIELDS, assert_state_dicts_equal,
                           drive_per_batch, jax_state_to_numpy,
                           port_engine_like, store_dict)
from repro_torch import convert
from repro_torch.core import StreamingGraph, generate_corpus, packed_store, walkers
from repro_torch.kernels import (delta, intersect, megakernel, ops, range_search,
                                 sgns, szudzik)

N = 512
LENGTH = 12
DMAX = 128


def _edges():
    """Uniform pairs plus three hubs of degree ~160 (> DMAX)."""
    rng = np.random.default_rng(21)
    src, dst = rng.integers(0, N, size=(2, 3000))
    hs = np.repeat(np.arange(3), 160)
    return (np.concatenate([src, hs]),
            np.concatenate([dst, rng.integers(0, N, size=hs.shape[0])]))


def _stream(n_batches=3, n_ins=40, n_del=10):
    rng = np.random.default_rng(22)
    ins = rng.integers(0, N, size=(2, n_batches, n_ins))
    dels = rng.integers(0, N, size=(2, n_batches, n_del))
    return ins[0], ins[1], dels[0], dels[1]


def _jax_engine():
    from repro.core import StreamingGraph as JGraph
    from repro.core import WalkConfig, generate_corpus as j_corpus
    from repro.core.update import WalkEngine
    from repro.core.walkers import WalkModel
    src, dst = _edges()
    g = JGraph.from_edges(jnp.asarray(src, jnp.uint32), jnp.asarray(dst, jnp.uint32),
                          N, 1 << 14)
    cfg = WalkConfig(n_walks_per_vertex=2, length=LENGTH, megakernel="off",
                     model=WalkModel(order=2, p=0.5, q=2.0, sampler="factorized",
                                     dmax=DMAX))
    store = j_corpus(jax.random.PRNGKey(1), g, cfg)
    return WalkEngine(graph=g, store=store, cfg=cfg, merge_policy="on-demand",
                      merge_impl="interleave", rewalk_capacity=N * 2, max_pending=2)


@pytest.fixture
def card_route(monkeypatch):
    """Force the card's dispatch on the CPU; yields the window-build counts
    of `intersect.neighbor_window` and `walkers._neighbor_window`. The two
    stand-ins build their windows through a copy of `neighbor_window` taken
    before the counters were put on."""
    window = intersect.neighbor_window
    counts = {"intersect.neighbor_window": 0, "walkers._neighbor_window": 0}

    def counting(name, fn):
        def run(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return run

    def with_copy(fn):
        def run(*args):
            counted = intersect.neighbor_window
            intersect.neighbor_window = window
            try:
                return fn(*args)
            finally:
                intersect.neighbor_window = counted
        return run

    cuda = torch.device("cuda")
    for mod in (intersect, megakernel, packed_store, sgns):
        resolve = mod.resolve_backend
        monkeypatch.setattr(mod, "resolve_backend",
                            lambda name, device, resolve=resolve: resolve(name, cuda))
    monkeypatch.setattr(ops, "_on_card", lambda *tensors: True)
    for mod, name, plain in (
            (szudzik, "pair_cuda", szudzik.pair_plain),
            (szudzik, "unpair_cuda", szudzik.unpair_plain),
            (delta, "decode_rows_cuda", delta.decode_rows_plain),
            (range_search, "find_next_packed_cuda", range_search.find_next_packed_plain),
            (intersect, "factorized_cuda", intersect.factorized_plain),
            (intersect, "factorized_csr_cuda", with_copy(intersect.factorized_csr_plain)),
            (megakernel, "fused_step_cuda", with_copy(megakernel.fused_step_plain)),
            (sgns, "sgns_cuda", sgns.sgns_plain)):
        monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(intersect, "neighbor_window",
                        counting("intersect.neighbor_window", window))
    monkeypatch.setattr(walkers, "_neighbor_window",
                        counting("walkers._neighbor_window", walkers._neighbor_window))
    ops.reset_launches()
    yield counts
    ops.reset_launches()


def test_card_route_corpus_matches_reference(card_route):
    jeng = _jax_engine()
    src, dst = _edges()
    g = StreamingGraph.from_edges(src, dst, N, 1 << 14, device="cpu")
    assert int(g.degrees().max()) > DMAX
    store = generate_corpus(np.asarray(jax.random.PRNGKey(1)), g,
                            convert.config_from(jeng.cfg))
    a, b = store_dict(jeng.store), store_dict(store)
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert ops.launches["intersect_csr"] == LENGTH - 1, ops.launches
    assert ops.launches["intersect_next"] == 0
    assert card_route == dict.fromkeys(card_route, 0)


@pytest.mark.parametrize("megak", ["off", "cuda"])
def test_card_route_run_stream_matches_reference(card_route, megak):
    jeng = _jax_engine()
    teng = port_engine_like(jeng, cfg=convert.config_from(jeng.cfg)._replace(
        megakernel=megak))
    key, stream = jax.random.PRNGKey(11), _stream()
    want = drive_per_batch(jeng, key, stream)
    got = teng.run_stream(np.asarray(key), *stream)
    np.testing.assert_array_equal(got.numpy(), want)
    assert_state_dicts_equal(jax_state_to_numpy(jeng.state),
                             convert.state_to_numpy(teng.state))
    np.testing.assert_array_equal(teng.walk_matrix().numpy(),
                                  np.asarray(jeng.walk_matrix()).astype(np.int64))
    fused = megak == "cuda"
    assert (ops.launches["fused_rewalk_step"] > 0) == fused, ops.launches
    assert (ops.launches["intersect_csr"] > 0) != fused, ops.launches
    assert ops.launches["intersect_next"] == 0
    assert card_route == dict.fromkeys(card_route, 0)
