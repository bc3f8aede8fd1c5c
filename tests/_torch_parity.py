"""Shared helpers of the parity tests between the JAX package and the
PyTorch port: engine state as a flat dict of numpy arrays (the format of
`repro_torch.convert`), and comparisons with zero tolerance."""
from __future__ import annotations

import numpy as np

import repro.core  # noqa: F401  (enables x64 before any array is made)
from repro_torch import convert

STORE_FIELDS = ("owner", "code", "epoch", "offsets", "vmin", "vmax",
                "packed", "widths", "anchors_hi", "anchors_lo", "last_hi",
                "last_lo", "slot_epoch")


LOG2_N = 6
N = 2 ** LOG2_N


def make_jax_engine(seed=0, n_w=2, length=8, policy="on-demand",
                    merge_impl="interleave", max_pending=3):
    """tests/test_stream.py's `make_engine` sizes (order 1)."""
    import jax

    from repro.core import StreamingGraph, WalkConfig, generate_corpus
    from repro.core.update import WalkEngine
    from repro.data.streams import rmat_edges
    src, dst = rmat_edges(jax.random.PRNGKey(seed), 300, LOG2_N)
    g = StreamingGraph.from_edges(src, dst, N, 4096)
    cfg = WalkConfig(n_walks_per_vertex=n_w, length=length)
    store = generate_corpus(jax.random.PRNGKey(seed + 1), g, cfg)
    return WalkEngine(graph=g, store=store, cfg=cfg, merge_policy=policy,
                      merge_impl=merge_impl, rewalk_capacity=N * n_w,
                      max_pending=max_pending)


def make_stream(seed=7, n_batches=5, n_ins=10, n_del=4):
    """tests/test_stream.py's `make_stream`, as numpy arrays."""
    import jax

    from repro.data.streams import mixed_edge_stream
    return tuple(np.asarray(a) for a in mixed_edge_stream(
        jax.random.PRNGKey(seed), n_batches, n_ins, n_del, LOG2_N))


def port_engine_like(eng, **kw):
    """The port's WalkEngine on the CPU, started from a JAX engine's state."""
    from repro_torch.core.corpus import WalkConfig
    from repro_torch.core.update import WalkEngine
    st = convert.state_from_numpy(jax_state_to_numpy(eng.state), device="cpu")
    cfg = WalkConfig(n_walks_per_vertex=eng.cfg.n_walks_per_vertex,
                     length=eng.cfg.length)
    args = dict(merge_policy=eng.merge_policy, merge_impl=eng.merge_impl,
                rewalk_capacity=eng.rewalk_capacity,
                max_pending=eng.max_pending, mav_capacity=eng.mav_capacity)
    args.update(kw)
    return WalkEngine(graph=st.graph, store=st.store, cfg=cfg,
                      pending=st.pending, n_pending=st.n_pending,
                      epoch=st.epoch, **args)


def jax_state_to_numpy(state) -> dict:
    """A JAX `EngineState` -> the dict `convert.state_from_numpy` reads."""
    d = {}
    for obj in ("graph", "store", "pending"):
        part = getattr(state, obj)
        for k in convert.FIELDS:
            o, _, name = k.partition(".")
            if o == obj:
                d[k] = np.asarray(getattr(part, name))
    for k in ("last_affected", "total_affected"):
        d[k] = np.asarray(getattr(state, k))
    d["graph.n_vertices"] = state.graph.n_vertices
    for k in ("length", "n_walks", "n_vertices", "chunk_b"):
        d["store." + k] = getattr(state.store, k)
    d["n_pending"] = int(state.n_pending)
    d["epoch"] = int(state.epoch)
    d["overflow"] = bool(state.overflow)
    return d


def assert_state_dicts_equal(a: dict, b: dict, keys=None) -> None:
    for k in keys or convert.FIELDS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def store_dict(store, prefix="store.") -> dict:
    """A store (either package) -> {field: numpy}, via the port's FIELDS
    dtypes for the port and np.asarray for JAX."""
    if hasattr(store.code, "numpy"):   # torch
        return {f: convert._TO[convert.FIELDS[prefix + f]](getattr(store, f))
                for f in STORE_FIELDS}
    return {f: np.asarray(getattr(store, f)) for f in STORE_FIELDS}
