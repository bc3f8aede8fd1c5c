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

from _torch_parity import (N, assert_maintainers_match, assert_state_dicts_equal,
                           make_jax_maintainer, make_stream, port_engine_like,
                           port_maintainer_like, run_both_maintainers)
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
    with pytest.raises(NotImplementedError, match="obs/"):
        tds.EmbeddingMaintainer(graph=st.graph, store=st.store, cfg=cfg,
                                key=jr.PRNGKey(0, "cpu"))
    bad = tmt.cfg.replace(sgns_backend="cuda")
    tmt2 = tds.EmbeddingMaintainer(graph=st.graph, store=st.store, cfg=bad,
                                   key=jr.PRNGKey(0, "cpu"))
    with pytest.raises(ValueError, match="needs tensors on the card"):
        tmt2.run_stream(jr.PRNGKey(1, "cpu"), *make_stream(n_batches=1))
