"""Shared helpers of the parity tests between the JAX package and the
PyTorch port: engine state as a flat dict of numpy arrays (the format of
`repro_torch.convert`), and comparisons with zero tolerance."""
from __future__ import annotations

import numpy as np
import torch

import repro.core  # noqa: F401  (enables x64 before any array is made)
from repro_torch import convert

# The parity tests run tiny tensors in several test processes at once: one
# intra-op thread a process keeps torch's thread pools from oversubscribing
# the cores (a third of the wall time at 6 processes on 8 cores).
torch.set_num_threads(1)

STORE_FIELDS = ("owner", "code", "epoch", "offsets", "vmin", "vmax",
                "packed", "widths", "anchors_hi", "anchors_lo", "last_hi",
                "last_lo", "slot_epoch")


LOG2_N = 6
N = 2 ** LOG2_N


def make_jax_engine(seed=0, n_w=2, length=8, policy="on-demand",
                    merge_impl="interleave", max_pending=3, order=1,
                    sampler="rejection", dmax=64, megakernel="auto"):
    """tests/test_stream.py's `make_engine` sizes and walk models (order 2:
    node2vec p=0.5, q=2.0)."""
    import jax

    from repro.core import StreamingGraph, WalkConfig, generate_corpus
    from repro.core.update import WalkEngine
    from repro.core.walkers import WalkModel
    from repro.data.streams import rmat_edges
    src, dst = rmat_edges(jax.random.PRNGKey(seed), 300, LOG2_N)
    g = StreamingGraph.from_edges(src, dst, N, 4096)
    model = (WalkModel(order=2, p=0.5, q=2.0, sampler=sampler, dmax=dmax)
             if order == 2 else WalkModel())
    cfg = WalkConfig(n_walks_per_vertex=n_w, length=length, model=model,
                     megakernel=megakernel)
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


def port_engine_like(eng, cfg=None, **kw):
    """The port's WalkEngine on the CPU, started from a JAX engine's state,
    with the JAX engine's config (walk model included) unless `cfg`."""
    from repro_torch.core.update import WalkEngine
    st = convert.state_from_numpy(jax_state_to_numpy(eng.state), device="cpu")
    cfg = cfg or convert.config_from(eng.cfg)
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


def drive_per_batch(eng, key, stream):
    """The JAX package's per-batch driver on the key split its `run_stream`
    uses (tests/test_stream.py holds the two bit-identical). Its update
    step compiles once for every merge policy and impl of a walk config,
    where `run_stream` compiles anew for each."""
    import jax

    ins_s, ins_d, del_s, del_d = stream
    keys = jax.random.split(key, ins_s.shape[0])
    return np.asarray([int(eng.update_batch(keys[i], ins_s[i], ins_d[i],
                                            del_s[i], del_d[i]))
                       for i in range(ins_s.shape[0])])


def check_order2_stream(sampler, policy, merge_impl):
    """tests/test_stream.py's order-2 engine (node2vec p=0.5, q=2, window
    64, length 6) and mixed stream through the JAX package and the port's
    `run_stream`, from the same state and key: the affected counts, every
    graph, store and pending field, slot_epoch, the counters, and the
    traversed corpus, bit for bit."""
    import jax

    from repro_torch.core.update import pending_after_stream
    eng = make_jax_engine(order=2, length=6, sampler=sampler, policy=policy,
                          merge_impl=merge_impl, max_pending=2)
    teng = port_engine_like(eng)
    key = jax.random.PRNGKey(11)
    stream = make_stream(n_batches=5)
    want = drive_per_batch(eng, key, stream)
    got = teng.run_stream(np.asarray(key), *stream)
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng.n_pending == eng.n_pending == pending_after_stream(
        0, 5, 2, policy)
    assert_state_dicts_equal(jax_state_to_numpy(eng.state),
                             convert.state_to_numpy(teng.state))
    assert not teng.mav_overflowed and teng.total_affected == eng.total_affected
    np.testing.assert_array_equal(teng.walk_matrix().numpy(),
                                  np.asarray(eng.walk_matrix()).astype(np.int64))
    assert_state_dicts_equal(jax_state_to_numpy(eng.state),
                             convert.state_to_numpy(teng.state))


# ------------------------------------------------- the downstream maintainer

# the reference's own tolerance for a scatter-added SGNS step
# (tests/test_sgns.py::test_masked_step_equals_grad_of_masked_loss)
TABLE_TOL = dict(rtol=2e-4, atol=1e-5)


def make_jax_maintainer(seed=0, n_w=2, length=8, policy="on-demand",
                        max_pending=3, dim=16, window=2, n_negative=3, **kw):
    """tests/test_downstream.py's `make_maintainer`."""
    import jax

    from repro.core import StreamingGraph, WalkConfig, generate_corpus
    from repro.data.streams import rmat_edges
    from repro.downstream import EmbeddingMaintainer, MaintainerConfig
    src, dst = rmat_edges(jax.random.PRNGKey(seed), 300, LOG2_N)
    g = StreamingGraph.from_edges(src, dst, N, 4096)
    wcfg = WalkConfig(n_walks_per_vertex=n_w, length=length)
    store = generate_corpus(jax.random.PRNGKey(seed + 1), g, wcfg)
    cfg = MaintainerConfig(walk=wcfg, n_vertices=N, dim=dim, window=window,
                           n_negative=n_negative, rewalk_capacity=N * n_w,
                           max_pending=max_pending, merge_policy=policy, **kw)
    return EmbeddingMaintainer(graph=g, store=store, cfg=cfg,
                               key=jax.random.PRNGKey(seed + 2))


def jax_maintainer_dict(mt) -> dict:
    d = jax_state_to_numpy(mt.state.engine)
    d["params.in"] = np.asarray(mt.state.params["in"])
    d["params.out"] = np.asarray(mt.state.params["out"])
    d["opt.step"] = int(mt.state.opt["step"])
    d["opt.pairs"] = int(mt.state.opt["pairs"])
    return d


def port_maintainer_like(jmt):
    """The port's maintainer on the CPU, in the JAX maintainer's state."""
    from repro_torch import downstream as tds
    from repro_torch import random as jr
    st = convert.maintainer_state_from_numpy(jax_maintainer_dict(jmt), "cpu")
    cfg = convert.maintainer_config_from(jmt.cfg)
    tmt = tds.EmbeddingMaintainer(graph=st.engine.graph, store=st.engine.store,
                                  cfg=cfg, key=jr.PRNGKey(0, "cpu"))
    tmt.load_state(st)
    return tmt


def assert_maintainers_match(jmt, tmt, jm, tm):
    """Engine bit for bit, pair and affected counts equal, loss and tables
    within the stated tolerances."""
    assert_state_dicts_equal(jax_state_to_numpy(jmt.state.engine),
                             convert.state_to_numpy(tmt.state.engine))
    np.testing.assert_array_equal(tm.n_pairs.numpy(), np.asarray(jm.n_pairs))
    np.testing.assert_array_equal(tm.n_affected.numpy(),
                                  np.asarray(jm.n_affected))
    assert tm.n_pairs.dtype == torch.int32
    np.testing.assert_allclose(tm.loss_sum.numpy(), np.asarray(jm.loss_sum),
                               rtol=1e-5)
    tables = convert.params_to_numpy(tmt.params)
    for k in ("in", "out"):
        np.testing.assert_allclose(tables[k], np.asarray(jmt.params[k]),
                                   err_msg=k, **TABLE_TOL)
    assert tmt.pairs_trained == jmt.pairs_trained
    assert int(tmt.state.opt["step"]) == int(jmt.state.opt["step"])
    assert tmt.epoch_counter == jmt.epoch_counter


def run_both_maintainers(jmt, n_batches=5, seed=7, key=42, train_key=None):
    """The JAX maintainer and its port twin through the same stream and
    keys -> (port maintainer, JAX metrics, port metrics, stream)."""
    import jax
    tmt = port_maintainer_like(jmt)
    stream = make_stream(seed=seed, n_batches=n_batches)
    k = jax.random.PRNGKey(key)
    tk = None if train_key is None else jax.random.PRNGKey(train_key)
    jm = jmt.run_stream(k, *stream, train_key=tk)
    tm = tmt.run_stream(np.asarray(k), *stream,
                        train_key=None if tk is None else np.asarray(tk))
    return tmt, jm, tm, stream
