"""The port's `models/embeddings.py` against the JAX package's on the CPU:
pair extraction exactly, and the SGNS steps within the reference's own
tolerance (tables rtol 2e-4 / atol 1e-5, summed loss rtol 1e-5:
tests/test_sgns.py::test_masked_step_equals_grad_of_masked_loss).
Inputs come from seeded numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64, as the reference runs)
from repro.models import embeddings as jemb
from repro_torch import random as jr
from repro_torch.models import embeddings as temb

TABLE_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("length,window", [(8, 2), (6, 5), (3, 4), (80, 5), (2, 1)])
def test_window_pair_index_and_counts_match_jax(length, window):
    jc, jx = jemb.window_pair_index(length, window)
    tc, tx = temb.window_pair_index(length, window)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert temb.n_window_pairs(length, window) == jemb.n_window_pairs(length, window)
    assert tc.shape[0] == temb.n_window_pairs(length, window)


def test_window_pairs_match_jax():
    walks = np.random.default_rng(0).integers(0, 50, size=(7, 9))
    for window in (1, 3):
        jc, jx = jemb.window_pairs(jnp.asarray(walks), window)
        tc, tx = temb.window_pairs(torch.from_numpy(walks), window)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("skip", [True, False])
def test_affected_pairs_match_jax(skip):
    rng = np.random.default_rng(1)
    w, length, window = 11, 10, 3
    walks = rng.integers(0, 2**31, size=(w, length))
    lane_valid = rng.random(w) < 0.7
    p_min = rng.integers(0, length, size=w).astype(np.int32)
    jc, jx, jm = jemb.affected_pairs(jnp.asarray(walks, jnp.uint32),
                                     jnp.asarray(lane_valid), jnp.asarray(p_min),
                                     window, skip_stale_prefix=skip)
    tc, tx, tm = temb.affected_pairs(torch.from_numpy(walks),
                                     torch.from_numpy(lane_valid),
                                     torch.from_numpy(p_min), window,
                                     skip_stale_prefix=skip)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tc.dtype == torch.int64 and tm.dtype == torch.bool


def sgns_case(n=20, d=32, b=24, k=3, seed=5):
    """Tables and index batches with repeated rows (scatter-add collisions)."""
    rng = np.random.default_rng(seed)
    params = {"in": rng.standard_normal((n, d)).astype(np.float32),
              "out": rng.standard_normal((n, d)).astype(np.float32)}
    centers = rng.integers(0, n, size=b)
    contexts = rng.integers(0, n, size=b)
    negs = rng.integers(0, n, size=(b, k))
    return params, centers, contexts, negs


def to_jax(params, *idx):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            *(jnp.asarray(i, jnp.int32) for i in idx))


def to_torch(params, *idx):
    return ({k: torch.from_numpy(v.copy()) for k, v in params.items()},
            *(torch.from_numpy(np.asarray(i, np.int64)) for i in idx))


def assert_tables_close(tp, jp):
    for k in ("in", "out"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **TABLE_TOL)


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("shape", [(20, 32, 24, 3), (300, 128, 64, 5)])
def test_masked_sgns_step_matches_jax(backend, shape):
    n, d, b, k = shape
    params, centers, contexts, negs = sgns_case(n, d, b, k)
    mask = np.arange(b) % 3 != 0
    lr = 0.05
    jp, jl, jn = jemb.masked_sgns_step(*to_jax(params, centers, contexts, negs),
                                       jnp.asarray(mask), lr, backend="interpret")
    tparams, tc, tx, tn = to_torch(params, centers, contexts, negs)
    tp, tl, tn_pairs = temb.masked_sgns_step(tparams, tc, tx, tn,
                                             torch.from_numpy(mask), lr,
                                             backend=backend)
    assert_tables_close(tp, jp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert int(tn_pairs) == int(jn) == int(mask.sum())
    # the given tables are not written
    np.testing.assert_array_equal(tparams["in"].numpy(), params["in"])


def test_masked_step_equals_autograd_step_on_the_live_pairs():
    """The scatter-added closed form = SGD through autograd on the mask's
    pair subset (the reference's contract, on the port alone)."""
    params, centers, contexts, negs = sgns_case(seed=8)
    mask = np.arange(24) % 4 != 1
    tparams, tc, tx, tn = to_torch(params, centers, contexts, negs)
    got, loss_sum, _ = temb.masked_sgns_step(tparams, tc, tx, tn,
                                             torch.from_numpy(mask), 0.05)
    live = torch.from_numpy(np.nonzero(mask)[0])
    want, mean_loss = temb.sgns_step(tparams, tc[live], tx[live], tn[live], 0.05)
    for k in ("in", "out"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TABLE_TOL)
    np.testing.assert_allclose(loss_sum.item(), mean_loss.item() * len(live),
                               rtol=1e-5)


def test_sgns_step_and_loss_match_jax():
    params, centers, contexts, negs = sgns_case(n=40, d=64, b=32, k=4, seed=3)
    jargs = to_jax(params, centers, contexts, negs)
    np.testing.assert_allclose(
        temb.sgns_loss(*to_torch(params, centers, contexts, negs)).item(),
        float(jemb.sgns_loss(*jargs)), rtol=1e-5)
    jp, jl = jemb.sgns_step(*jargs, 0.05)
    tp, tl = temb.sgns_step(*to_torch(params, centers, contexts, negs), 0.05)
    assert_tables_close(tp, jp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


def test_sgns_init_matches_jax():
    """The normal input table bit for bit (0 ulp: the port's `normal` is
    the reference's), the output table zero, on the key's device."""
    import jax
    cfg_j = jemb.SGNSConfig(n_vertices=300, dim=128)
    cfg_t = temb.SGNSConfig(n_vertices=300, dim=128)
    assert (cfg_t.window, cfg_t.n_negative, cfg_t.lr) == (5, 5, 0.05)
    jp = jemb.sgns_init(jax.random.PRNGKey(4), cfg_j)
    tp = temb.sgns_init(jr.PRNGKey(4, "cpu"), cfg_t)
    want = np.asarray(jp["in"])
    np.testing.assert_array_equal(tp["in"].numpy().view(np.int32),
                                  want.view(np.int32))
    assert not tp["out"].any() and tp["out"].shape == (300, 128)


def record_steps(monkeypatch, module):
    """Wrap `module.sgns_step` so that every call's pair batch and
    negatives are kept (the reference's `train_epoch` calls its module's
    `sgns_step`, the port's its own)."""
    calls = []
    inner = module.sgns_step

    def wrapped(params, centers, contexts, negatives, lr):
        calls.append(tuple(np.asarray(a).astype(np.int64)
                           for a in (centers, contexts, negatives)))
        return inner(params, centers, contexts, negatives, lr)

    monkeypatch.setattr(module, "sgns_step", wrapped)
    return calls


@pytest.mark.parametrize("incremental,batch", [(False, 256), (True, 256), (False, 16)])
def test_train_epoch_matches_jax(monkeypatch, incremental, batch):
    """`train_epoch` in full and incremental mode (mask of 9 of 30 walks:
    the reference pads the kept walks with 21 copies of walk 0): every
    batch's permuted pairs and negatives exactly, the tables within rtol
    2e-4 / atol 1e-5 and the mean loss within rtol 1e-5; a tail shorter
    than the batch is dropped (1,080 pairs: 4 batches of 256, 56 left; or
    67 batches of 16, past one slab of negatives, `NEG_SLAB` = 64)."""
    import jax
    rng = np.random.default_rng(11)
    n, w, length = 40, 30, 8
    walks = rng.integers(0, n, size=(w, length))
    mask = np.zeros(w, bool)
    mask[rng.choice(w, 9, replace=False)] = True
    p0 = {"in": (rng.normal(size=(n, 16)) * 0.25).astype(np.float32),
          "out": (rng.normal(size=(n, 16)) * 0.1).astype(np.float32)}
    kw = dict(n_vertices=n, dim=16, window=3, n_negative=4)
    key = jax.random.PRNGKey(21)
    j_calls = record_steps(monkeypatch, jemb)
    t_calls = record_steps(monkeypatch, temb)
    jp, jl = jemb.train_epoch(
        key, {k: jnp.asarray(v) for k, v in p0.items()},
        jnp.asarray(walks, jnp.uint32), jemb.SGNSConfig(**kw), batch=batch,
        walk_mask=jnp.asarray(mask) if incremental else None)
    tp, tl = temb.train_epoch(
        jr.as_key(np.asarray(key), "cpu"),
        {k: torch.from_numpy(v.copy()) for k, v in p0.items()},
        torch.from_numpy(walks), temb.SGNSConfig(**kw), batch=batch,
        walk_mask=torch.from_numpy(mask) if incremental else None)
    assert len(t_calls) == len(j_calls) == 1080 // batch
    assert batch == 256 or len(t_calls) > temb.NEG_SLAB
    for (tc, tx, tn), (jc, jx, jn) in zip(t_calls, j_calls):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tn, jn)
    if incremental:    # the padding rows are walk 0's: its pairs dominate
        zero = set(walks[0].tolist())
        assert np.isin(t_calls[0][0], list(zero)).mean() > 0.5
    assert_tables_close(tp, jp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


def test_logistic_eval_matches_jax():
    """The probe's accuracy equal to the reference's (its f32 mean too),
    and its weights within rtol 1e-4 / atol 1e-6 of the reference's steps
    (the same f32 gradient descent, written out here in JAX)."""
    import jax
    rng = np.random.default_rng(12)
    labels = rng.integers(0, 5, size=300)
    centres = rng.normal(size=(5, 16))
    emb = (centres[labels] + 1.5 * rng.normal(size=(300, 16))).astype(np.float32)
    want = jemb.logistic_eval(emb, labels)
    got = temb.logistic_eval(emb, labels, device="cpu")
    assert got == want and 0.3 < got < 1.0
    assert temb.logistic_eval(torch.from_numpy(emb), torch.from_numpy(labels)) == want
    # the probe's weights
    perm = np.random.default_rng(0).permutation(300)
    tr = perm[:210]
    x = jnp.asarray(emb)
    x = x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-6)
    y = jnp.asarray(labels, jnp.int32)

    def loss(w):
        logits = x[tr] @ w
        return -jnp.take_along_axis(jax.nn.log_softmax(logits, -1),
                                    y[tr, None], axis=1).mean()

    step = jax.jit(lambda w: w - 0.5 * jax.grad(loss)(w))
    w_j = jnp.zeros((16, 5), jnp.float32)
    for _ in range(300):
        w_j = step(w_j)
    xt = torch.from_numpy(np.array(x))
    w_t = temb.logistic_probe(xt, torch.from_numpy(labels), torch.from_numpy(tr))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-6)
