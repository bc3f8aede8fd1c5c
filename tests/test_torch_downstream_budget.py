"""The port's maintainer against the JAX package's on the CPU at the
slice's SGNS width (dim 128, window 5, 5 negatives) and under a pair
budget (the lane subsample). Same contract as test_torch_downstream.py:
engine, pair and affected counts bit for bit; loss rtol 1e-5; tables
rtol 2e-4 / atol 1e-5 (the reference's own tolerance)."""
from _torch_parity import (assert_maintainers_match, make_jax_maintainer,
                           run_both_maintainers)


def test_maintainer_matches_jax_at_width_128():
    """The slice's SGNS shape: dim 128, window 5, 5 negatives (the
    reference's SGNSConfig defaults), walks of length 12, an explicit
    train key."""
    jmt = make_jax_maintainer(length=12, dim=128, window=5, n_negative=5)
    assert jmt.cfg.pair_batch % 8 == 0
    tmt, jm, tm, _ = run_both_maintainers(jmt, n_batches=3, key=5, train_key=55)
    assert_maintainers_match(jmt, tmt, jm, tm)


def test_max_pairs_budget_matches_jax():
    """The lane subsample under a pair budget (float64 uniforms, stable
    sort, the boundary lane trimmed): same lanes, same pairs."""
    jmt = make_jax_maintainer(max_pairs=64)
    assert jmt.cfg.pair_batch == 64
    tmt, jm, tm, _ = run_both_maintainers(jmt, n_batches=3, key=13)
    assert_maintainers_match(jmt, tmt, jm, tm)
    assert (tm.n_pairs <= 64).all() and (tm.n_pairs > 0).all()
