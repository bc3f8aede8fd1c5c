"""The port's downstream maintainer against the JAX package's on the CPU:
`EmbeddingMaintainer` (tests/test_downstream.py's sizes, both merge
policies; the slice's SGNS width and the pair budget are in
test_torch_downstream_budget.py), `WalkEngine.run_stream(...,
return_masks=True)`, and the port's own contracts (per-batch = whole
stream, maintainer engine = plain engine).

The reference's SGNS tables are carried across with `convert`, so no
comparison depends on the port's `normal` draw. The engine half, the pair
counts and the affected counts must be bit-identical; the summed loss is
held to rtol 1e-5 and the tables to rtol 2e-4 / atol 1e-5, the
reference's own tolerance for a scatter-added SGNS step
(tests/test_sgns.py::test_masked_step_equals_grad_of_masked_loss): the
port's closed form sums its logits in another order than XLA's einsum.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (N, TABLE_TOL, assert_maintainers_match, assert_state_dicts_equal,
                           make_jax_maintainer, make_stream, port_engine_like,
                           jax_state_to_numpy, port_maintainer_like, run_both_maintainers)
from repro.core import StreamingGraph, WalkConfig, generate_corpus
from repro.core.update import WalkEngine
from repro.data.streams import rmat_edges
from repro_torch import convert
from repro_torch import downstream as tds
from repro_torch import random as jr


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
def test_maintainer_matches_jax(policy):
    jmt = make_jax_maintainer(policy=policy)
    tmt, jm, tm, _ = run_both_maintainers(jmt)
    assert_maintainers_match(jmt, tmt, jm, tm)
    assert int(tm.n_pairs.sum()) > 0
    # the engines also agree after the merge, walk for walk
    jv, tv = jmt.engine_view(), tmt.engine_view()
    np.testing.assert_array_equal(tv.walk_matrix().numpy(),
                                  np.asarray(jv.walk_matrix()).astype(np.int64))


def test_step_equals_run_stream_and_plain_engine():
    """Per-batch `step` on split keys = `run_stream` (bit for bit on the
    CPU), and the maintainer's engine = the port's plain engine."""
    jmt = make_jax_maintainer()
    a, b = port_maintainer_like(jmt), port_maintainer_like(jmt)
    plain = port_engine_like(jmt.engine_view())
    stream = make_stream(n_batches=4)
    key, tkey = jr.PRNGKey(9, "cpu"), jr.PRNGKey(99, "cpu")
    m = a.run_stream(key, *stream, train_key=tkey)
    uks, tks = jr.split(key, 4), jr.split(tkey, 4)
    losses = [b.step(uks[i], tks[i], *(s[i] for s in stream)).loss_sum
              for i in range(4)]
    assert torch.equal(m.loss_sum, torch.stack(losses))
    for k in ("in", "out"):
        assert torch.equal(a.params[k], b.params[k])
    affected = plain.run_stream(key, *stream)
    assert torch.equal(m.n_affected, affected)
    for mt in (a, b):
        assert_state_dicts_equal(convert.state_to_numpy(mt.state.engine),
                                 convert.state_to_numpy(plain.state))
    assert a.pairs_trained == int(m.n_pairs.sum())
    assert float(a.embeddings.abs().sum()) > 0


def test_run_stream_masks_match_jax():
    """`WalkEngine.run_stream(return_masks=True)`: the stacked UpdateAux
    equals the reference's, lane for lane."""
    src, dst = rmat_edges(jax.random.PRNGKey(0), 300, 6)
    g = StreamingGraph.from_edges(src, dst, N, 4096)
    wcfg = WalkConfig(n_walks_per_vertex=2, length=8)
    eng = WalkEngine(graph=g, store=generate_corpus(jax.random.PRNGKey(1), g, wcfg),
                     cfg=wcfg, rewalk_capacity=N * 2, max_pending=3)
    teng = port_engine_like(eng)
    stream = make_stream(n_batches=4)
    key = jax.random.PRNGKey(5)
    affected, aux = eng.run_stream(key, *stream, return_masks=True)
    t_aff, t_aux = teng.run_stream(np.asarray(key), *stream, return_masks=True)
    np.testing.assert_array_equal(t_aff.numpy(), np.asarray(affected))
    assert t_aux.walk_ids.shape == (4, N * 2)
    for name in ("walk_ids", "lane_valid", "p_min"):
        np.testing.assert_array_equal(
            getattr(t_aux, name).numpy(),
            np.asarray(getattr(aux, name)).astype(getattr(t_aux, name).numpy().dtype),
            err_msg=name)
    np.testing.assert_array_equal(t_aux.lane_valid.sum(1).numpy(), np.asarray(affected))


def test_metrics_and_unknown_backend_raise():
    jmt = make_jax_maintainer()
    tmt = port_maintainer_like(jmt)
    st = tmt.state.engine
    cfg = tmt.cfg.replace(walk=tmt.cfg.walk._replace(metrics=True))
    on = tds.EmbeddingMaintainer(graph=st.graph, store=st.store, cfg=cfg,
                                 key=jr.PRNGKey(0, "cpu"))
    assert on.metrics is not None and tmt.metrics is None
    bad = tmt.cfg.replace(sgns_backend="cuda")
    tmt2 = tds.EmbeddingMaintainer(graph=st.graph, store=st.store, cfg=bad,
                                   key=jr.PRNGKey(0, "cpu"))
    with pytest.raises(ValueError, match="needs tensors on the card"):
        tmt2.run_stream(jr.PRNGKey(1, "cpu"), *make_stream(n_batches=1))


def test_checkpoint_resume_matches_uninterrupted_and_jax(tmp_path):
    """tests/test_downstream.py::test_checkpoint_resumes_streaming_and_training
    on the port: 2 steps, a save of the whole MaintainerState, a restore
    into a fresh maintainer's state (the epoch and the pending count come
    back as the host ints the saver had), 2 more steps. The result equals
    the uninterrupted port run bit for bit in every leaf, and the JAX
    package's uninterrupted maintainer (engine bit for bit, tables within
    the reference's tolerance)."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import leaf_paths
    stream = make_stream(n_batches=4)
    uks = np.asarray(jax.random.split(jax.random.PRNGKey(11), 4))
    tks = np.asarray(jax.random.split(jax.random.PRNGKey(12), 4))

    jref = make_jax_maintainer()
    ref = port_maintainer_like(jref)
    for i in range(4):
        jref.step(uks[i], tks[i], *(s[i] for s in stream))
        ref.step(uks[i], tks[i], *(s[i] for s in stream))

    mt = port_maintainer_like(make_jax_maintainer())
    for i in range(2):
        mt.step(uks[i], tks[i], *(s[i] for s in stream))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, mt.state, blocking=True)

    mt2 = port_maintainer_like(make_jax_maintainer())   # a fresh process's template
    assert (mt2.epoch_counter, mt2.state.engine.n_pending) == (0, 0)
    restored, step = ckpt.restore(mt2.state)
    assert step == 1
    mt2.load_state(restored)
    assert mt2.epoch_counter == 2
    assert mt2.state.engine.n_pending == mt.state.engine.n_pending == 2
    for i in range(2, 4):
        mt2.step(uks[i], tks[i], *(s[i] for s in stream))

    want = leaf_paths(ref.state)
    for k, v in leaf_paths(mt2.state).items():
        assert type(v) is type(want[k]), k
        assert (torch.equal(v, want[k]) if isinstance(v, torch.Tensor)
                else v == want[k]), k
    assert_state_dicts_equal(jax_state_to_numpy(jref.state.engine),
                             convert.state_to_numpy(mt2.state.engine))
    tables = convert.params_to_numpy(mt2.params)
    for k in ("in", "out"):
        np.testing.assert_allclose(tables[k], np.asarray(jref.params[k]),
                                   err_msg=k, **TABLE_TOL)
    assert int(mt2.state.opt["step"]) == 4
    assert mt2.pairs_trained == jref.pairs_trained


def test_view_walk_matrix_then_stream_matches_jax():
    """tests/test_downstream.py::test_incremental_matches_full_retrain at
    its own sizes, in JAX and in the port on the same keys: the walks read
    through `engine_view().walk_matrix()` (a merge), the warm retrain
    installed, two snapshots of the incremental stream with the walks read
    through a view after each (the first read merges the three pending
    blocks of snapshot 0 mid-stream), and the full retrain. The view's
    merge is the maintainer's own (no pending block it still counts is
    reset), so every walk matrix,
    affected and pair count is exact, the tables are within the
    reference's tolerance and the losses within rtol 1e-5."""
    import jax.numpy as jnp

    from repro.data.streams import cora_like
    from repro.downstream import EmbeddingMaintainer, MaintainerConfig
    from repro.models import embeddings as jemb
    from repro_torch.core import StreamingGraph as TGraph
    from repro_torch.core import WalkConfig as TWalkConfig
    from repro_torch.core import generate_corpus as t_corpus
    from repro_torch.data.streams import cora_like as t_cora
    from repro_torch.models import embeddings as temb
    n, n_w, length = 128, 6, 10
    snapshots, n_batches, batch_edges = 2, 3, 12

    def run(jx: bool):
        emb = jemb if jx else temb
        key = jax.random.PRNGKey(0) if jx else jr.PRNGKey(0, "cpu")
        (src, dst), labels, _ = (cora_like if jx else t_cora)(
            key, n_vertices=n, n_edges=n * 4, n_classes=5)
        n0 = src.shape[0] - snapshots * n_batches * batch_edges
        wcfg = (WalkConfig if jx else TWalkConfig)(n_walks_per_vertex=n_w, length=length)
        scfg = emb.SGNSConfig(n_vertices=n, dim=32, window=3, n_negative=4)
        prng = jax.random.PRNGKey if jx else (lambda s: jr.PRNGKey(s, "cpu"))
        split = jax.random.split if jx else jr.split

        def retrain(walks, seed, epochs=4):
            p, k = emb.sgns_init(prng(seed), scfg), prng(seed)
            for _ in range(epochs):
                k, kk = split(k)
                p, _ = emb.train_epoch(kk, p, walks, scfg, batch=2048)
            return p

        if jx:
            g = StreamingGraph.from_edges(src[:n0], dst[:n0], n, edge_capacity=8192)
            store = generate_corpus(prng(1), g, wcfg)
            mcfg = MaintainerConfig(walk=wcfg, n_vertices=n, dim=32, window=3,
                                    n_negative=4, rewalk_capacity=n * n_w, lr=0.002)
            mt = EmbeddingMaintainer(graph=g, store=store, cfg=mcfg, key=prng(2))
        else:
            g = TGraph.from_edges(src[:n0], dst[:n0], n, edge_capacity=8192, device="cpu")
            store = t_corpus(prng(1), g, wcfg)
            mcfg = tds.MaintainerConfig(walk=wcfg, n_vertices=n, dim=32, window=3,
                                        n_negative=4, rewalk_capacity=n * n_w, lr=0.002)
            mt = tds.EmbeddingMaintainer(graph=g, store=store, cfg=mcfg, key=prng(2))
        w0 = mt.engine_view().walk_matrix()
        warm = retrain(w0, seed=3)
        to_np = (lambda t: np.asarray(t)) if jx else (lambda t: t.numpy().copy())
        warm_np = {k: to_np(v) for k, v in warm.items()}   # JAX donates them
        mt.state = mt.state._replace(
            params=jax.tree.map(jnp.asarray, warm) if jx else warm)
        metrics, walks = [], []
        for snap in range(snapshots):
            lo = n0 + snap * n_batches * batch_edges
            hi = lo + n_batches * batch_edges
            fold = jax.random.fold_in if jx else jr.fold_in
            metrics.append(mt.run_stream(fold(key, 10 + snap),
                                         src[lo:hi].reshape(n_batches, batch_edges),
                                         dst[lo:hi].reshape(n_batches, batch_edges)))
            walks.append(to_np(mt.engine_view().walk_matrix()).astype(np.int64))
        assert not mt.mav_overflowed
        w1 = walks[-1]
        acc_inc = emb.logistic_eval(np.asarray(mt.embeddings, np.float32)
                                    if jx else mt.embeddings, np.asarray(labels))
        full = retrain(torch.from_numpy(w1) if not jx else jnp.asarray(w1, jnp.uint32), seed=100)
        acc_full = emb.logistic_eval(np.asarray(full["in"], np.float32)
                                     if jx else full["in"], np.asarray(labels))
        return dict(w0=to_np(w0).astype(np.int64), walks=walks,
                    warm=warm_np,
                    tables={k: to_np(v) for k, v in mt.params.items()},
                    metrics=[{f: to_np(getattr(m, f)) for f in m._fields}
                             for m in metrics],
                    epoch=mt.epoch_counter, acc=(acc_inc, acc_full))

    want, got = run(True), run(False)
    np.testing.assert_array_equal(got["w0"], want["w0"])
    for k in ("in", "out"):
        np.testing.assert_allclose(got["warm"][k], want["warm"][k], err_msg=k, **TABLE_TOL)
    for tm, jm in zip(got["metrics"], want["metrics"]):
        np.testing.assert_array_equal(tm["n_affected"], jm["n_affected"])
        np.testing.assert_array_equal(tm["n_pairs"], jm["n_pairs"])
        np.testing.assert_allclose(tm["loss_sum"], jm["loss_sum"], rtol=1e-5)
    assert sum(int(m["n_pairs"].sum()) for m in got["metrics"]) > 0
    for tw, jw in zip(got["walks"], want["walks"]):
        np.testing.assert_array_equal(tw, jw)
    assert not np.array_equal(got["walks"][0], got["w0"])
    for k in ("in", "out"):
        np.testing.assert_allclose(got["tables"][k], want["tables"][k], err_msg=k, **TABLE_TOL)
    assert got["epoch"] == want["epoch"] == snapshots * n_batches
    acc_inc, acc_full = got["acc"]
    assert acc_inc >= acc_full - 0.10, got["acc"]
    assert got["acc"] == want["acc"]
