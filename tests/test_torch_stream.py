"""The slice as a whole: the port's `run_stream` against the JAX package's
on tests/test_stream.py's engine and mixed insert+delete stream, both merge
policies x both merge impls, from the same state (carried across with
`repro_torch.convert`) and the same key, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (assert_state_dicts_equal, jax_state_to_numpy,
                           make_jax_engine, make_stream, port_engine_like)
from repro_torch import convert
from repro_torch.core.update import pending_after_stream


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
@pytest.mark.parametrize("merge_impl", ["interleave", "lexsort"])
def test_run_stream_matches_reference(policy, merge_impl):
    eng = make_jax_engine(policy=policy, merge_impl=merge_impl, max_pending=2)
    teng = port_engine_like(eng)
    key = jax.random.PRNGKey(11)
    stream = make_stream(n_batches=5)
    want = np.asarray(eng.run_stream(key, *stream))
    got = teng.run_stream(np.asarray(key), *stream)
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng.n_pending == eng.n_pending and teng.epoch_counter == eng.epoch_counter
    assert teng.n_pending == pending_after_stream(0, 5, 2, policy)
    # every graph, store and pending field, slot_epoch and the counters
    assert_state_dicts_equal(jax_state_to_numpy(eng.state),
                             convert.state_to_numpy(teng.state))
    assert not teng.mav_overflowed and teng.total_affected == eng.total_affected
    np.testing.assert_array_equal(teng.walk_matrix().numpy(),
                                  np.asarray(eng.walk_matrix()).astype(np.int64))
    assert_state_dicts_equal(jax_state_to_numpy(eng.state),
                             convert.state_to_numpy(teng.state))


def test_per_batch_driver_and_overflow_flag_match_reference():
    """`update_batch` (with its forced merges) and a deliberately tiny MAV
    capacity, whose sticky overflow flag must match the reference's."""
    eng = make_jax_engine(max_pending=2)
    teng = port_engine_like(eng, mav_capacity=4)
    jtiny = make_jax_engine(max_pending=2)
    jtiny.mav_capacity = 4
    ins_s, ins_d, del_s, del_d = make_stream(n_batches=3, n_ins=20)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    for i in range(3):
        args = (ins_s[i], ins_d[i], del_s[i], del_d[i])
        want = int(jtiny.update_batch(keys[i], *args))
        assert int(teng.update_batch(np.asarray(keys[i]), *args)) == want
    assert teng.mav_overflowed and jtiny.mav_overflowed
    assert_state_dicts_equal(jax_state_to_numpy(jtiny.state),
                             convert.state_to_numpy(teng.state))


def test_convert_roundtrip_is_exact():
    eng = make_jax_engine()
    eng.run_stream(jax.random.PRNGKey(2), *make_stream(n_batches=2))
    d = jax_state_to_numpy(eng.state)
    back = convert.state_to_numpy(convert.state_from_numpy(d, device="cpu"))
    assert_state_dicts_equal(d, back)
    for k in convert.SCALARS:
        assert back[k] == d[k], k


def test_stream_step_and_affected_mask_match_reference():
    """`stream_step` on one mixed batch: the state of the reference's
    `stream_step`, and the port's own `stream_step_aux` state; the MAV's
    `affected_mask` on that batch, against the reference's."""
    import jax.numpy as jnp

    from repro.core import mav as jmav
    from repro.core.update import stream_step as j_stream_step
    from repro_torch.core import mav as tmav
    from repro_torch.core.update import stream_step, stream_step_aux

    eng = make_jax_engine(max_pending=2)
    ins_s, ins_d, del_s, del_d = (a[0] for a in make_stream(n_batches=1))
    key = jax.random.PRNGKey(21)
    jm = jmav.mav_dense(eng.store, *(jnp.asarray(a) for a in (ins_s, ins_d, del_s, del_d)))
    length = eng.store.length
    args = dict(cfg=eng.cfg, capacity=eng.rewalk_capacity,
                mav_capacity=eng.store.size, max_pending=eng.max_pending,
                merge_policy="on-demand", merge_impl="interleave")
    want = j_stream_step(eng.state, key, *(jnp.asarray(a) for a in
                                           (ins_s, ins_d, del_s, del_d)), **args)

    teng = port_engine_like(eng)
    tm = tmav.mav_dense(teng.store, ins_s, ins_d, del_s, del_d)
    np.testing.assert_array_equal(tmav.affected_mask(tm, length).numpy(),
                                  np.asarray(jmav.affected_mask(jm, length)))
    assert int(tmav.affected_mask(tm, length).sum()) > 0
    targs = dict(args, cfg=teng.cfg)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    tins = [torch.from_numpy(a.astype(np.int64)) for a in (ins_s, ins_d, del_s, del_d)]
    got = stream_step(teng.state, tkey, *tins, **targs)
    aux_state, _ = stream_step_aux(port_engine_like(eng).state, tkey, *tins,
                                   **targs)
    assert_state_dicts_equal(jax_state_to_numpy(want), convert.state_to_numpy(got))
    assert_state_dicts_equal(convert.state_to_numpy(aux_state),
                             convert.state_to_numpy(got))
