"""The port's DLRM (repro_torch/models/dlrm.py) against the JAX package's
on the CPU: `dlrm_init` bit for bit (outside jit, as the reference calls
it) and the converter's round trip; `embedding_bag` with an offsets mask,
`dlrm_forward`, `dlrm_loss` and its gradients and `retrieval_score` of the
jitted reference within rtol 1e-5 / atol 1e-6, at the smoke config and at
a bag of 3 lookups a field (`multi_hot` 3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import assert_trees_close, bits, jax_tree_to_numpy, torch_value_and_grad
from repro.configs import get_arch as jax_arch
from repro.models import dlrm as jdlrm
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.models import dlrm

TOL = dict(rtol=1e-5, atol=1e-6)


def configs(multi_hot: int):
    jcfg = dataclasses.replace(jax_arch("dlrm-rm2").make_config(True), multi_hot=multi_hot)
    cfg = dataclasses.replace(get_arch("dlrm-rm2").make_config(True), multi_hot=multi_hot)
    return jcfg, cfg


def inputs(cfg, b=32, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, cfg.table_rows, (b, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
    labels = rng.integers(0, 2, (b,)).astype(np.float32)
    return dense, sparse, labels


def test_init_bit_for_bit_and_round_trip():
    jcfg, cfg = jax_arch("dlrm-rm2").make_config(True), get_arch("dlrm-rm2").make_config(True)
    want = jax_tree_to_numpy(jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg))
    got = dlrm.dlrm_init(jr.PRNGKey(0, "cpu"), cfg)
    wb, gb = bits(want), bits(convert.dlrm_params_to_numpy(got))
    assert set(wb) == set(gb)
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    back = convert.dlrm_params_to_numpy(convert.dlrm_params_from_numpy(want, cfg, "cpu"))
    for k, v in bits(back).items():
        np.testing.assert_array_equal(v, wb[k], err_msg=k)
    full = get_arch("dlrm-rm2").make_config()
    assert (full.d_interact, full.n_sparse * full.table_rows * full.embed_dim) == \
        (415, 1_664_000_000)


def test_tables_drawn_in_slabs_equal_one_draw():
    """The tables' `normal` in slabs of the flat index (as at full width)
    is one draw's bits: a slab smaller than a table and not a divisor."""
    key = jr.PRNGKey(7, "cpu")
    one = (jr.normal(key, (4, 100, 8)) * 0.01)
    assert torch.equal(jr.scaled_normal(key, (4, 100, 8), 0.01, torch.float32, slab=333), one)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (4, 100, 8), jnp.float32) * 0.01)
    np.testing.assert_array_equal(one.numpy(), want)


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_forward_loss_gradients_and_retrieval_match_jax(multi_hot):
    jcfg, cfg = configs(multi_hot)
    jp = jdlrm.dlrm_init(jax.random.PRNGKey(1), jcfg)
    tp = convert.dlrm_params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    dense, sparse, labels = inputs(cfg)
    td, ts, tl = (torch.from_numpy(a) for a in (dense, sparse, labels))
    want = jax.jit(lambda p, d, s: jdlrm.dlrm_forward(p, d, s, jcfg))(jp, dense, sparse)
    got = dlrm.dlrm_forward(tp, td, ts, cfg)
    assert got.shape == (32,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, d, s, y: jdlrm.dlrm_loss(p, d, s, y, jcfg)))(jp, dense, sparse, labels)
    loss, grads = torch_value_and_grad(lambda p, d, s, y: dlrm.dlrm_loss(p, d, s, y, cfg),
                                       tp, td, ts, tl)
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    assert_trees_close(grads, jax_tree_to_numpy(jgrads), "dlrm grads", **TOL)
    cand = np.random.default_rng(3).standard_normal((500, cfg.embed_dim)).astype(np.float32)
    want = jax.jit(lambda p, d, s, c: jdlrm.retrieval_score(p, d, s, c, jcfg))(
        jp, dense[:1], sparse[:1], cand)
    got = dlrm.retrieval_score(tp, td[:1], ts[:1], torch.from_numpy(cand), cfg)
    assert got.shape == (1, 500)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_embedding_bag_with_mask():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, (16, 3)).astype(np.int32)
    mask = rng.integers(0, 2, (16, 3)).astype(np.float32)
    for m in (None, mask):
        want = jax.jit(jdlrm.embedding_bag)(table, idx, m)
        got = dlrm.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_interaction_order_is_jax_triu():
    iu, ju = jnp.triu_indices(27, k=1)
    t = torch.triu_indices(27, 27, offset=1)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(ju))
