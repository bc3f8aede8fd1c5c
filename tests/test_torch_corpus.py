"""The port's corpus generation and MAV against the JAX package: the walk
matrix for the same key and graph, the store built from it, and the MAV
(dense, indexed, segment gather) on a mid-stream store."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (STORE_FIELDS, make_jax_engine, make_stream,
                           port_engine_like, store_dict)
from repro.core import StreamingGraph as JGraph
from repro.core import WalkConfig as JConfig
from repro.core import mav as jmav
from repro.core.corpus import generate_corpus as j_generate_corpus
from repro.core.corpus import generate_walk_matrix as j_walk_matrix
from repro.data.streams import rmat_edges
from repro_torch import random as jr
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus, mav
from repro_torch.core.corpus import generate_walk_matrix
from repro_torch.core.walkers import WalkModel


@pytest.mark.parametrize("n_w,length", [(2, 8), (3, 11)])
def test_walk_matrix_and_corpus_match_reference(n_w, length):
    src, dst = (np.asarray(a) for a in rmat_edges(jax.random.PRNGKey(0), 200, 6))
    jg = JGraph.from_edges(jnp.asarray(src), jnp.asarray(dst), 70, 2048)
    tg = StreamingGraph.from_edges(src, dst, 70, 2048, device="cpu")
    key = jax.random.PRNGKey(5)
    jcfg = JConfig(n_walks_per_vertex=n_w, length=length)
    tcfg = WalkConfig(n_walks_per_vertex=n_w, length=length)
    want = np.asarray(j_walk_matrix(key, jg, jcfg))
    got = generate_walk_matrix(np.asarray(key), tg, tcfg)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    a = store_dict(j_generate_corpus(key, jg, jcfg))
    b = store_dict(generate_corpus(jr.as_key(np.asarray(key), "cpu"), tg, tcfg))
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_unported_options_raise():
    """An unknown sampler or megakernel name (the reference's "pallas" is
    "cuda" here) raises; the stream metrics are ported and leave the
    corpus as it is without them."""
    g = StreamingGraph.empty(4, 8, device="cpu")
    key = jr.PRNGKey(0, "cpu")
    assert torch.equal(generate_walk_matrix(key, g, WalkConfig(metrics=True)),
                       generate_walk_matrix(key, g, WalkConfig()))
    for cfg in (WalkConfig(model=WalkModel(order=2, sampler="alias")),
                WalkConfig(model=WalkModel(order=3)),
                WalkConfig(megakernel="pallas")):
        with pytest.raises(ValueError):
            generate_walk_matrix(key, g, cfg)


def test_mav_matches_reference_mid_stream():
    eng = make_jax_engine(max_pending=8)
    ins_s, ins_d, del_s, del_d = make_stream(n_batches=2)
    eng.run_stream(jax.random.PRNGKey(4), ins_s, ins_d, del_s, del_d)
    store, tstore = eng.store, port_engine_like(eng).store
    b_ins = make_stream(seed=9, n_batches=1, n_ins=12, n_del=3)
    j_args = [jnp.asarray(a[0]) for a in b_ins]
    t_args = [a[0] for a in b_ins]
    for fn, tfn in ((jmav.mav_dense, mav.mav_dense),
                    (jmav.mav_indexed, mav.mav_indexed)):
        want = fn(store, *j_args)
        got = tfn(tstore, *t_args)
        np.testing.assert_array_equal(got.p_min.numpy(), np.asarray(want.p_min))
        np.testing.assert_array_equal(got.v_min.numpy(), np.asarray(want.v_min))
        assert (np.asarray(want.p_min) < store.length).any()
    touched = np.zeros(store.n_vertices, bool)
    touched[np.concatenate(t_args)] = True
    cap = 100
    jo, jc, je, jv, jt = jmav.gather_touched_segments(store, jnp.asarray(touched), cap)
    to, tc, te, tv, tt = mav.gather_touched_segments(
        tstore, torch.from_numpy(touched), cap)
    assert int(jt) == int(tt) and int(jt) > cap   # an overflowing gather
    n = int(tv.sum())
    assert n == cap == int(np.asarray(jv).sum())
    np.testing.assert_array_equal(to.numpy().astype(np.uint32), np.asarray(jo)[:n])
    np.testing.assert_array_equal(te.numpy().astype(np.uint32), np.asarray(je)[:n])
