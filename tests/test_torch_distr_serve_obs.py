"""The port's sharded engine with metrics and under serving, against the
JAX package on the CPU: tests/test_obs.py::
test_sharded_metrics_bit_identity_and_replay and tests/test_serve.py::
test_pinned_serving_8shard_stream on 8 gloo ranks, the reference's side in
one subprocess with 8 host devices (the helpers of tests/test_torch_distr.py).

Metrics ON: every shard's state = the reference's shard and = the metrics
OFF run; the replicated counters uniform across shards; each shard's
handoff counters = the reference's shard's; the combined summary = the
reference's and = the numpy replay of the single-host run. Serving: a
pinned service over the unsharded window-A state answers as the
reference's single-host service, keeps its answers while its replica
streams window B, and the replica then equals the shards' window B."""
import json

import numpy as np
import pytest
import torch

import test_torch_distr as T
from repro_torch import convert
from repro_torch.distr import ranks
from repro_torch.obs.export import summary
from repro_torch.obs.metrics import PMIN_BUCKETS
from repro_torch.tree import tree_map

PPR_RTOL = 1e-6      # tests/test_serve.py:138
WINDOW_A, WINDOW_B = slice(0, 3), slice(3, None)

JAX_CODE = """
import json
from repro.obs.export import summary
from repro.serve.walk_queries import WalkQueryService

for policy in ("on-demand", "eager"):
    g, s = fresh()
    eng = WalkEngine(graph=g, store=s, cfg=cfg, merge_policy=policy,
                     rewalk_capacity=128, max_pending=4)
    aff, aux = eng.run_stream(key, *stream, return_masks=True)
    out[f"{policy}.single.affected"] = np.asarray(aff)
    out[f"{policy}.single.p_min"] = np.asarray(aux.p_min)
    out[f"{policy}.single.lane_valid"] = np.asarray(aux.lane_valid)
    stacked, aff, m = sharded_run_stream(
        shard_state(*fresh(), spec, 128, max_pending=4), key, *stream,
        cfg=cfg._replace(metrics=True), spec=spec, capacity=128,
        max_pending=4, merge_policy=policy)
    dump_state(f"{policy}.metrics.", stacked)
    out[f"{policy}.metrics.affected"] = np.asarray(aff)
    for f in ("handoff_sent", "handoff_cross", "handoff_max_load"):
        out[f"{policy}.metrics.{f}"] = np.asarray(getattr(m, f))
    out[f"{policy}.summary"] = np.asarray(json.dumps(summary(m)))

    # the serving replica of window A, single-host: run, merge, answers
    g, s = fresh()
    eng = WalkEngine(graph=g, store=s, cfg=cfg, merge_policy=policy,
                     rewalk_capacity=128, max_pending=4)
    eng.run_stream(key, *(a[:3] for a in stream))
    eng.merge()
    svc = WalkQueryService(engine=eng)
    wm = np.asarray(svc.walk_matrix())
    ws, ps = np.asarray([3, 17, 40]), np.asarray([0, 2, 5])
    nxt, found = svc.next_vertices(wm[ws, ps], ws, ps)
    for k, v in (("walk_matrix", wm),
                 ("walks_of", svc.walks_of([3, 11, 27], capacity=128)),
                 ("neighborhoods", svc.neighborhoods([1, 5, 9], hops=2)),
                 ("ppr", svc.ppr_rows([2, 9, 33])), ("next", nxt),
                 ("found", found)):
        out[f"{policy}.serve.{k}"] = np.asarray(v)
"""


def rank_job(rank, inp):
    """A rank: the stream with metrics under both policies, and the two
    serving windows (B continuing A's shard state)."""
    from repro_torch.tree import tree_map
    res = {}
    for policy in T.POLICIES:
        st, aff, m, counts = T.shard_stream(rank, inp, policy, metrics=True)
        off, _, _, _ = T.shard_stream(rank, inp, policy)
        res[policy] = dict(state=convert.state_to_numpy(st),
                           off=convert.state_to_numpy(off), affected=aff.numpy(),
                           metrics=tree_map(lambda t: t.numpy(), m),
                           counts=counts)
        st_a, aff_a, _, _ = T.shard_stream(rank, inp, policy, WINDOW_A)
        res[policy]["window_a"] = convert.state_to_numpy(st_a)
        st_b, aff_b, _, _ = T.shard_stream(rank, inp, policy, WINDOW_B,
                                           state=st_a)
        res[policy]["window_b"] = convert.state_to_numpy(st_b)
        res[policy]["affected_b"] = aff_b.numpy()
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distr_obs")
    inp = T.inputs()
    proc = T.start_jax(JAX_CODE, tmp, T.jax_arrays(inp))
    try:
        port = ranks.spawn(rank_job, T.S, inp, tmp)
    finally:
        jout = T.finish_jax(proc, tmp)
    return inp, port, jout


def _unshard(port, policy, part):
    from repro_torch.distr.sharded import unshard_state
    graph, store, ovf = unshard_state(
        [convert.state_from_numpy(r[policy][part], "cpu") for r in port],
        T.ECAP)
    assert not ovf
    return graph, store


def _stacked_metrics(port, policy):
    return tree_map(lambda *ls: torch.stack([torch.from_numpy(np.asarray(x))
                                             for x in ls]),
                    *[r[policy]["metrics"] for r in port])


@pytest.mark.parametrize("policy", T.POLICIES)
def test_sharded_metrics_bit_identity_and_replay(both, policy):
    from _torch_parity import assert_state_dicts_equal
    inp, port, jout = both
    want = T.jax_state(jout, f"{policy}.metrics.")
    got = convert.shard_states_to_numpy(
        [convert.state_from_numpy(r[policy]["state"], "cpu") for r in port])
    assert_state_dicts_equal(want, got)
    for r in port:       # metrics ON = OFF, shard by shard
        assert_state_dicts_equal(r[policy]["off"], r[policy]["state"])
        np.testing.assert_array_equal(r[policy]["affected"],
                                      jout[f"{policy}.single.affected"])

    # the unsharded ON run = the single-host metrics-OFF engine
    eng = T.single_host(inp, policy)
    eng.run_stream(inp["key"], *inp["stream"])
    eng.merge()
    g2, s2 = _unshard(port, policy, "state")
    assert torch.equal(g2.codes, eng.graph.codes)
    for f in ("owner", "code", "epoch", "slot_epoch"):
        assert torch.equal(getattr(s2, f), getattr(eng.store, f)), f

    # replicated counters uniform across the 8 shards; handoff per shard
    m = _stacked_metrics(port, policy)
    for leaf in (m.n_steps, m.affected_total, m.affected_max, m.pending_hwm,
                 m.merges_forced, m.merges_eager):
        assert int(leaf.max() - leaf.min()) == 0, policy
    assert bool((m.pmin_hist == m.pmin_hist[0]).all())
    for f in ("handoff_sent", "handoff_cross", "handoff_max_load"):
        np.testing.assert_array_equal(getattr(m, f).numpy(),
                                      jout[f"{policy}.metrics.{f}"], err_msg=f)

    # the combined summary = the reference's and the numpy replay
    s = summary(m)
    assert s == json.loads(str(jout[f"{policy}.summary"]))
    nb = len(inp["stream"][0])
    aff_np = jout[f"{policy}.single.affected"]
    p_min = jout[f"{policy}.single.p_min"]
    valid = jout[f"{policy}.single.lane_valid"]
    assert s["steps"] == nb
    assert s["affected"]["total"] == int(aff_np.sum())
    assert s["affected"]["max_per_step"] == int(aff_np.max())
    suffix = T.LENGTH - p_min
    bucket = np.clip((suffix * PMIN_BUCKETS) // T.LENGTH, 0, PMIN_BUCKETS - 1)
    hist = [int(((bucket == b) & valid).sum()) for b in range(PMIN_BUCKETS)]
    assert s["rewalk_suffix_hist"]["counts"] == hist
    if policy == "eager":
        assert s["merges"] == {"forced": 0, "eager": nb}
    else:
        from repro_torch.core.update import pending_after_stream
        fill = pending_after_stream(0, nb, T.MAX_PENDING, policy)
        assert s["merges"]["eager"] == 0
        assert s["merges"]["forced"] == (nb - fill) // T.MAX_PENDING
    # exact global handoff volume: each valid lane is routed once per
    # non-terminal re-walked position
    want_sent = int((np.maximum(T.LENGTH - 1 - p_min, 0) * valid).sum())
    assert s["handoff"]["sent_total"] == want_sent
    assert 0 <= s["handoff"]["cross_shard_total"] <= want_sent
    assert s["handoff"]["max_dest_load_per_step"] <= T.CAP
    assert all(v is None for v in s["overflow_first_epoch"].values())


@pytest.mark.parametrize("policy", T.POLICIES)
def test_pinned_serving_8shard_stream(both, policy):
    """Window A runs sharded and the serving replica is its unshard; a
    pinned service over it answers as the reference's, and keeps its
    answers while the replica applies window B (the shards ran B in their
    own processes); replica and shards then agree bit for bit."""
    from repro_torch.core.update import WalkEngine
    from repro_torch.serve import WalkQueryService
    from test_torch_serve import _answers, _assert_same, id_sets
    inp, port, jout = both
    g1, s1 = _unshard(port, policy, "window_a")
    # epoch=3 resumes the counter: the unsharded store's entries keep their
    # window-A epochs, and a restarted counter would lose every slot-epoch
    # liveness race to them
    eng = WalkEngine(graph=g1, store=s1, cfg=T.walk_config(),
                     merge_policy=policy, rewalk_capacity=T.CAP,
                     max_pending=T.MAX_PENDING, epoch=3)
    svc = WalkQueryService(engine=eng)
    snap = svc.pin()
    pre = _answers(svc, snap)
    ref = {k[len(f"{policy}.serve."):]: v for k, v in jout.items()
           if k.startswith(f"{policy}.serve.")}
    ref["walks_of"] = id_sets(ref["walks_of"])
    for k in ("walk_matrix", "neighborhoods", "next"):
        ref[k] = ref[k].astype(np.int64)
    _assert_same(pre, ref, ppr_rtol=PPR_RTOL)

    aff = eng.run_stream(inp["key"], *(a[WINDOW_B] for a in inp["stream"]))
    _assert_same(_answers(svc, snap), pre)          # pinned reads mid-stream
    for r in port:
        np.testing.assert_array_equal(aff.numpy(), r[policy]["affected_b"])

    eng.merge()
    g2, s2 = _unshard(port, policy, "window_b")
    assert torch.equal(g2.codes, eng.graph.codes)
    for f in ("owner", "code", "epoch", "slot_epoch"):
        assert torch.equal(getattr(s2, f), getattr(eng.store, f)), (policy, f)
    snap.release()
