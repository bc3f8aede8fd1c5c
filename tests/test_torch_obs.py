"""The port's observability (obs/) against the JAX package's on the CPU:
trace spans, the SLO collector, export (summary dicts equal, Prometheus
text byte-equal), the regression sentinel, and the stream metrics — the
counters of a metrics-ON stream equal the reference's on the same stream
and keys, and the engine stays bit-identical with metrics ON.

The reference's contract that metrics OFF lowers to byte-identical HLO
(tests/test_obs.py::test_metrics_off_hlo_identity and
::test_metrics_scope_in_compiled_executables) is restated for the port:
with metrics OFF `run_stream` calls exactly the kernel wrappers, in
order, that the plain step loop calls. The sharded metrics test is in
tests/test_torch_distr_serve_obs.py."""
import collections
import functools
import json
import os
import re
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_state_dicts_equal, port_engine_like
from repro.core import StreamingGraph, WalkConfig, generate_corpus
from repro.core.update import WalkEngine
from repro.core.walkers import WalkModel
from repro.data.streams import mixed_edge_stream, rmat_edges
from repro.obs import export as j_export
from repro.obs import metrics as j_metrics
from repro.obs import regress as j_regress
from repro.obs import slo as j_slo
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.core import update as t_update
from repro_torch.core.graph import StreamingGraph as TGraph
from repro_torch.kernels import ops
from repro_torch.obs import NEVER, PMIN_BUCKETS, StreamMetrics
from repro_torch.obs import export, regress, slo
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import combine_shards
from repro_torch.tree import tree_map
from repro_torch.obs.staleness import AUDIT_SALT, audit_invalid_count
from repro_torch.serve import WalkQueryService

LOG2_N = 6
N = 2 ** LOG2_N
CAP = 128
MAX_PENDING = 4
N_BATCHES = 5


def make_jax_engine(cfg, policy="on-demand", seed=0):
    """tests/test_obs.py's `make_graph_store` + `make_engine`."""
    src, dst = rmat_edges(jax.random.PRNGKey(seed), 200, LOG2_N)
    g = StreamingGraph.from_edges(src, dst, N, 4096)
    store = generate_corpus(jax.random.PRNGKey(seed + 1), g, cfg)
    return WalkEngine(graph=g, store=store, cfg=cfg, merge_policy=policy,
                      rewalk_capacity=CAP, max_pending=MAX_PENDING)


def make_stream(n_batches=N_BATCHES, seed=7):
    return tuple(np.asarray(a) for a in mixed_edge_stream(
        jax.random.PRNGKey(seed), n_batches, 10, 4, LOG2_N))


def key_np(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def jax_metrics_run(policy, order=1):
    """The reference's metrics-ON stream (tests/test_obs.py's sizes): its
    starting state (as the port's dict), final state, masks and summary."""
    if order == 1:
        cfg = WalkConfig(n_walks_per_vertex=2, length=8, metrics=True)
        stream = make_stream()
    else:
        model = WalkModel(order=2, p=0.5, q=2.0, sampler="factorized", dmax=4)
        cfg = WalkConfig(n_walks_per_vertex=2, length=8, model=model,
                         metrics=True)
        stream = make_stream(n_batches=1)
    eng = make_jax_engine(cfg, policy)
    start = port_engine_like(eng)
    aff, aux = eng.run_stream(jax.random.PRNGKey(3), *stream,
                              return_masks=True)
    from _torch_parity import jax_state_to_numpy
    return dict(start=start, stream=stream, affected=np.asarray(aff),
                aux=jax.tree.map(np.asarray, aux),
                state=jax_state_to_numpy(eng.state),
                summary=j_export.summary(eng.metrics),
                staleness=jax.tree.map(np.asarray, eng.metrics.staleness))


def port_twin(run, **cfg_kw):
    """A fresh port engine in the run's starting state."""
    e = run["start"]
    cfg = e.cfg._replace(**cfg_kw)
    st = convert.state_to_numpy(e.state)
    st = convert.state_from_numpy(st, "cpu")
    return t_update.WalkEngine(graph=st.graph, store=st.store, cfg=cfg,
                               merge_policy=e.merge_policy,
                               rewalk_capacity=e.rewalk_capacity,
                               max_pending=e.max_pending, pending=st.pending,
                               n_pending=st.n_pending, epoch=st.epoch)


# ------------------------------------------------- stream metrics, one device


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
def test_metrics_on_bit_identity_and_replay(policy):
    """Metrics ON vs OFF in the port: identical affected counts, masks and
    state; the ON counters equal the reference's ON counters (the whole
    summary) on the same stream and key."""
    run = jax_metrics_run(policy)
    off, on = port_twin(run, metrics=False), port_twin(run)
    assert off.metrics is None and on.metrics is not None
    key = key_np(3)
    aff_off, aux_off = off.run_stream(key, *run["stream"], return_masks=True)
    aff_on, aux_on = on.run_stream(key, *run["stream"], return_masks=True)
    assert torch.equal(aff_off, aff_on)
    for a, b in zip(aux_off, aux_on):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(aff_on.numpy(), run["affected"])
    st_off, st_on = (convert.state_to_numpy(e.state) for e in (off, on))
    assert_state_dicts_equal(st_off, st_on)
    assert_state_dicts_equal(st_on, run["state"])
    s = export.summary(on.metrics)
    assert s == run["summary"]
    assert s["steps"] == N_BATCHES
    assert s["affected"]["total"] == int(run["affected"].sum())
    assert s["order2"]["deg_fallback_lane_steps"] == 0
    assert all(v is None for v in s["overflow_first_epoch"].values())


def test_deg_fallback_counter_replay():
    """Order-2 factorized stream, dmax 4, one batch: deg_fallback_lanes
    equals the reference's and the numpy count of emitted non-terminal
    positions whose vertex has deg > dmax in the final corpus."""
    run = jax_metrics_run("on-demand", order=2)
    eng = port_twin(run)
    aff, aux = eng.run_stream(key_np(3), *run["stream"], return_masks=True)
    got = export.summary(eng.metrics)
    assert got == run["summary"]
    walks = eng.walk_matrix().numpy()
    deg = eng.graph.degrees().numpy()
    want = 0
    for w, pm, ok in zip(aux.walk_ids[0].numpy(), aux.p_min[0].numpy(),
                         aux.lane_valid[0].numpy()):
        if ok:
            want += int((deg[walks[w, int(pm):eng.cfg.length - 1]] > 4).sum())
    assert got["order2"]["deg_fallback_lane_steps"] == want > 0


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
def test_staleness_counters_match_numpy_replay(policy):
    """The freshness counters equal the reference's (lag histogram, sum,
    max, stale steps, audit counts), and a numpy replay of the slot-epoch
    stamps from the masks."""
    from repro_torch.obs.staleness import LAG_THRESHOLDS, STALE_LAG
    run = jax_metrics_run(policy)
    eng = port_twin(run)
    se0 = eng.store.slot_epoch.numpy().astype(np.int64)
    n_walks, length = eng.store.n_walks, eng.cfg.length
    _, aux = eng.run_stream(key_np(3), *run["stream"], return_masks=True)
    st = eng.metrics.staleness
    for name in ("lag_hist", "lag_sum", "lag_max", "walk_steps",
                 "stale_walk_steps", "audit_walks", "audit_transitions",
                 "audit_invalid"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      getattr(run["staleness"], name),
                                      err_msg=name)
    se = se0.reshape(n_walks, length).copy()
    hist = np.zeros(8, np.int64)
    stale = 0
    for step in range(N_BATCHES):
        for w, pm, ok in zip(aux.walk_ids[step].numpy(), aux.p_min[step].numpy(),
                             aux.lane_valid[step].numpy()):
            if ok:
                se[w, pm:] = step + 1
        lag = step + 1 - se.max(axis=1)
        np.add.at(hist, (lag[:, None] >= np.asarray(LAG_THRESHOLDS)).sum(1), 1)
        stale += int((lag >= STALE_LAG).sum())
    np.testing.assert_array_equal(st.lag_hist.numpy(), hist)
    assert int(st.stale_walk_steps) == stale
    assert int(st.audit_invalid) == 0
    assert int(st.audit_walks) == eng.cfg.audit_k * N_BATCHES


def test_divergence_auditor_detects_foreign_edits():
    """A graph swapped in behind the engine's back makes the auditor count
    invalid transitions: the port's count equals the reference's, and its
    fold_in + randint sample is the reference's walk ids."""
    from repro.obs.staleness import AUDIT_SALT as J_SALT
    assert AUDIT_SALT == J_SALT
    cfg = WalkConfig(n_walks_per_vertex=2, length=8, metrics=True, audit_k=16)
    jeng = make_jax_engine(cfg)
    teng = port_engine_like(jeng)
    s1, s2 = make_stream(n_batches=1), make_stream(n_batches=1, seed=11)
    src, dst = (np.asarray(a) for a in rmat_edges(jax.random.PRNGKey(0), 200, LOG2_N))
    jeng.run_stream(jax.random.PRNGKey(3), *s1)
    teng.run_stream(key_np(3), *s1)
    assert int(teng.metrics.staleness.audit_invalid) == 0
    jeng.state = jeng.state.replace(graph=StreamingGraph.from_edges(
        jnp.asarray(src[:40]), jnp.asarray(dst[:40]), N, 4096))
    teng.state = teng.state.replace(graph=TGraph.from_edges(
        src[:40], dst[:40], N, 4096, device="cpu"))
    jeng.run_stream(jax.random.PRNGKey(4), *s2)
    teng.run_stream(key_np(4), *s2)
    invalid = int(teng.metrics.staleness.audit_invalid)
    assert invalid > 0
    assert invalid == int(jeng.metrics.staleness.audit_invalid)
    step_key = jax.random.split(jax.random.PRNGKey(4), 1)[0]
    want = jax.random.randint(jax.random.fold_in(step_key, J_SALT), (16,), 0,
                              teng.store.n_walks)
    got = jr.randint(jr.fold_in(jr.as_key(np.asarray(step_key), "cpu"),
                                AUDIT_SALT), (16,), 0, teng.store.n_walks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the standalone check: the same count from the merged engine
    teng.merge()
    assert int(audit_invalid_count(
        jr.as_key(np.asarray(step_key), "cpu"), teng.graph, teng.store, None,
        16, 2)) == invalid


def test_audit_k_zero_compiles_auditor_out():
    """audit_k 0 keeps the lag counters but runs no audit, even against a
    corrupted graph."""
    cfg = WalkConfig(n_walks_per_vertex=2, length=8, metrics=True, audit_k=0)
    teng = port_engine_like(make_jax_engine(cfg))
    src, dst = (np.asarray(a) for a in rmat_edges(jax.random.PRNGKey(0), 200, LOG2_N))
    teng.state = teng.state.replace(graph=TGraph.from_edges(
        src[:40], dst[:40], N, 4096, device="cpu"))
    calls = []
    orig = t_update.Overlay.traverse
    t_update.Overlay.traverse = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        teng.run_stream(key_np(3), *make_stream(n_batches=1))
    finally:
        t_update.Overlay.traverse = orig
    st = teng.metrics.staleness
    assert calls == []
    assert int(st.audit_walks) == int(st.audit_transitions) == 0
    assert int(st.audit_invalid) == 0
    assert int(st.walk_steps) == teng.store.n_walks


def test_maintainer_metrics_bit_identity():
    """cfg.walk.metrics on the maintainer: per-step training metrics and
    the final state bit-identical with metrics ON; the engine counters
    equal the reference maintainer's and accumulate across streams."""
    from _torch_parity import port_maintainer_like
    from repro.downstream import EmbeddingMaintainer, MaintainerConfig
    wcfg = WalkConfig(n_walks_per_vertex=2, length=8)
    src, dst = rmat_edges(jax.random.PRNGKey(0), 200, LOG2_N)
    g = StreamingGraph.from_edges(src, dst, N, 4096)
    store = generate_corpus(jax.random.PRNGKey(1), g, wcfg)
    cfg = MaintainerConfig(walk=wcfg._replace(metrics=True), n_vertices=N,
                           dim=16, window=2, n_negative=3,
                           rewalk_capacity=CAP, max_pending=MAX_PENDING)
    jmt = EmbeddingMaintainer(graph=g, store=store, cfg=cfg,
                              key=jax.random.PRNGKey(5))
    on = port_maintainer_like(jmt)
    off = port_maintainer_like(jmt)
    off.cfg = off.cfg.replace(walk=off.cfg.walk._replace(metrics=False))
    off.metrics = None
    assert on.metrics is not None
    stream = make_stream()
    jmt.run_stream(jax.random.PRNGKey(6), *stream)
    m_on = on.run_stream(key_np(6), *stream)
    m_off = off.run_stream(key_np(6), *stream)
    for a, b in zip(m_on, m_off):
        assert torch.equal(a, b)
    assert_state_dicts_equal(convert.state_to_numpy(on.state.engine),
                             convert.state_to_numpy(off.state.engine))
    for name in ("in", "out"):
        assert torch.equal(on.params[name], off.params[name])
    assert export.summary(on.metrics) == j_export.summary(jmt.metrics)
    assert int(on.metrics.n_steps) == N_BATCHES
    assert int(on.metrics.affected_total) == int(on.state.engine.total_affected)
    on.run_stream(key_np(7), *make_stream(n_batches=2, seed=8))
    assert int(on.metrics.n_steps) == N_BATCHES + 2


def _wrapper_calls(monkeypatch):
    """Record the kernel wrapper behind every `ops._on_card` check, in
    order (each wrapper asks it once before its kernel or plain version)."""
    calls = []
    orig = ops._on_card

    def rec(*tensors):
        calls.append(sys._getframe(1).f_code.co_name)
        return orig(*tensors)

    monkeypatch.setattr(ops, "_on_card", rec)
    return calls


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
def test_metrics_off_launches_the_plain_loops_kernels(policy, monkeypatch):
    """The restated OFF contract: with metrics OFF, `run_stream` calls the
    same kernel wrappers in the same order as the plain loop of
    `stream_step_aux` steps (no metrics argument); with metrics ON it
    calls more (the auditor's replay), and the plain calls come first in
    every step."""
    run = jax_metrics_run(policy)
    calls = _wrapper_calls(monkeypatch)
    off = port_twin(run, metrics=False)
    off.run_stream(key_np(3), *run["stream"])
    seq_off = list(calls)
    calls.clear()
    plain = port_twin(run, metrics=False)
    keys = jr.split(jr.as_key(key_np(3), "cpu"), N_BATCHES)
    state = plain.state
    ins_s, ins_d, del_s, del_d = (torch.from_numpy(a.astype(np.int64))
                                  for a in run["stream"])
    for i in range(N_BATCHES):
        state, _ = t_update.stream_step_aux(
            state, keys[i], ins_s[i], ins_d[i], del_s[i], del_d[i], plain.cfg,
            CAP, plain._mav_capacity(), MAX_PENDING, policy, "interleave")
    seq_plain = list(calls)
    calls.clear()
    port_twin(run).run_stream(key_np(3), *run["stream"])
    seq_on = list(calls)
    assert seq_off == seq_plain and len(seq_off) > 0
    assert collections.Counter(seq_on) - collections.Counter(seq_off)
    assert not collections.Counter(seq_off) - collections.Counter(seq_on)


# ------------------------------------------------------- export + trace


def _fake(pkg):
    """tests/test_obs.py's `_fake_metrics`, in either package."""
    if pkg == "jax":
        i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
        m = j_metrics.StreamMetrics.empty()
        first = jnp.asarray([NEVER, 3, NEVER, NEVER], jnp.uint32)
    else:
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        m = StreamMetrics.empty("cpu")
        first = torch.tensor([NEVER, 3, NEVER, NEVER], dtype=torch.int64)
    return m.replace(
        n_steps=i32(4), affected_total=i32(100), affected_max=i32(40),
        pmin_hist=i32([0, 1, 2, 3, 4, 5, 6, 79]), pending_hwm=i32(3),
        merges_forced=i32(1), merges_eager=i32(0), handoff_sent=i32(64),
        handoff_cross=i32(16), handoff_max_load=i32(9),
        overflow_first_epoch=first)


def _weird_slo():
    weird = 'serve/we"ird\\kind\nq'
    hist = {"count": 3, "mean_us": 10.0, "p50_us": 8.0, "p95_us": 16.0,
            "p99_us": 16.0}
    return {"window_s": 2.0,
            "kinds": {weird: dict(hist, errors=1, validation_errors=0,
                                  qps=1.5, by={"live/percall": hist})},
            "targets": {weird: {"latency_us": 1000.0, "objective": 0.99}},
            "burn_rates": {weird: 0.25}}


def test_export_summary_schema_and_prometheus(tmp_path):
    serve = {"ppr_cache_hit": 7, "ppr_cache_miss": 2}
    s = export.summary(_fake("torch"), serve=serve)
    assert s == j_export.summary(_fake("jax"), serve=serve)
    assert s["schema"] == 2
    assert s["affected"] == {"total": 100, "max_per_step": 40,
                             "mean_per_step": 25.0}
    assert len(s["rewalk_suffix_hist"]["edges"]) == PMIN_BUCKETS + 1
    assert s["overflow_first_epoch"] == {"graph": None, "store_merge": 3,
                                         "mav_gather": None,
                                         "handoff_slab": None}
    text = export.to_prometheus(s)
    assert text == j_export.to_prometheus(_fake("jax"), serve=serve)
    assert "wharf_stream_steps_total 4" in text
    assert 'wharf_merges_total{cause="forced"} 1' in text
    assert 'source="graph"' not in text
    for args in ((), ({'odd key': 2},), ({"a": 1}, _weird_slo())):
        assert (export.to_prometheus(_fake("torch"), *args)
                == j_export.to_prometheus(_fake("jax"), *args))
    p = tmp_path / "counters.json"
    out = export.write_summary(str(p), _fake("torch"))
    assert json.loads(p.read_text()) == out
    j_export.write_summary(str(tmp_path / "j.json"), _fake("jax"))
    assert p.read_text() == (tmp_path / "j.json").read_text()


def test_export_combines_stacked_shards():
    """summary() of an [S, ...]-stacked tree reduces through combine_shards
    as the reference's: shard 0's replicated counters, summed handoff, the
    earliest overflow."""
    a, b = _fake("torch"), _fake("torch").replace(
        handoff_sent=torch.tensor(36, dtype=torch.int32),
        handoff_max_load=torch.tensor(11, dtype=torch.int32),
        overflow_first_epoch=torch.tensor([5, 9, NEVER, NEVER]))
    stacked = tree_map(lambda *ls: torch.stack(ls), a, b)
    s = export.summary(stacked)
    ja = _fake("jax")
    jb = ja.replace(handoff_sent=jnp.asarray(36, jnp.int32),
                    handoff_max_load=jnp.asarray(11, jnp.int32),
                    overflow_first_epoch=jnp.asarray([5, 9, NEVER, NEVER],
                                                     jnp.uint32))
    assert s == j_export.summary(jax.tree.map(lambda *ls: jnp.stack(ls), ja, jb))
    assert s["affected"]["total"] == 100 and s["handoff"]["sent_total"] == 100
    assert s["handoff"]["max_dest_load_per_step"] == 11
    assert s["overflow_first_epoch"]["graph"] == 5
    c = combine_shards(stacked)
    assert int(c.n_steps) == 4 and c.overflow_first_epoch.tolist()[1] == 3


def test_summary_v1_upgrades_to_v2():
    s2 = export.summary(_fake("torch"))
    v1 = {k: v for k, v in s2.items() if k != "staleness"}
    v1["schema"] = 1
    up = export.upgrade_summary(dict(v1))
    assert up == j_export.upgrade_summary(dict(v1))
    assert up["schema"] == 2 and up["staleness"]["walk_steps"] == 0
    assert export.upgrade_summary(dict(s2)) == s2
    with pytest.raises(ValueError):
        export.upgrade_summary({"schema": 99})


def test_prometheus_escaping_and_headers():
    assert export.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    assert export.metric_name("serve/walk matrix-reads") == \
        "serve_walk_matrix_reads"
    serve = {'odd key': 2, "ppr_cache_hit": 7}
    text = export.to_prometheus(_fake("torch"), serve=serve, slo=_weird_slo())
    assert text == j_export.to_prometheus(_fake("jax"), serve=serve,
                                          slo=_weird_slo())
    assert 'kind="serve/we\\"ird\\\\kind\\nq"' in text
    help_c, type_c, sampled = (collections.Counter(), collections.Counter(),
                               set())
    for line in text.splitlines():
        if line.startswith("# HELP "):
            help_c[line.split()[2]] += 1
        elif line.startswith("# TYPE "):
            type_c[line.split()[2]] += 1
        elif line and not line.startswith("#"):
            sampled.add(re.split(r"[{ ]", line, 1)[0])
    for name in sampled:
        fam = re.sub(r"_(bucket|count|sum)$", "", name)
        assert ({help_c.get(name, 0), type_c.get(name, 0)} == {1}
                or {help_c.get(fam, 0), type_c.get(fam, 0)} == {1}), name


def test_trace_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    obs_trace.install(path)
    try:
        with obs_trace.phase("serve/ppr_row", cat="serve", v=3):
            pass
        with obs_trace.phase(obs_trace.MERGE):
            pass
    finally:
        obs_trace.uninstall()
    assert obs_trace.active() is None
    spans = obs_trace.read_spans(path)
    assert [e["name"] for e in spans] == ["serve/ppr_row", "merge"]
    for e in spans:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0
    assert spans[0]["cat"] == "serve" and spans[0]["args"] == {"v": 3}
    assert spans[1]["cat"] == "engine"
    with obs_trace.phase("uninstalled"):
        pass
    assert len(obs_trace.read_spans(path)) == 2
    from repro.obs import trace as j_trace
    assert obs_trace.PHASES == j_trace.PHASES


def test_trace_phase_spans_in_the_torch_profiler():
    """A phase is a `record_function` scope: it names its span in a
    torch.profiler trace."""
    with torch.profiler.profile() as prof:
        with obs_trace.phase("serve/probe", cat="serve"):
            torch.ones(4).sum()
    assert "serve/probe" in {e.key for e in prof.key_averages()}


def test_trace_phase_flushes_on_exception():
    seen = []

    def watch(name, cat, dur, args, err):
        seen.append((name, err))

    obs_trace.add_observer(watch)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "spans.jsonl")
        obs_trace.install(path)
        try:
            with pytest.raises(RuntimeError, match="boom"):
                with obs_trace.phase("serve/explodes", cat="serve", v=1):
                    raise RuntimeError("boom")
            spans = obs_trace.read_spans(path)
        finally:
            obs_trace.uninstall()
            obs_trace.remove_observer(watch)
    assert [e["name"] for e in spans] == ["serve/explodes"]
    assert spans[0]["args"] == {"v": 1, "error": "RuntimeError: boom"}
    assert len(seen) == 1 and isinstance(seen[0][1], RuntimeError)


def test_serve_slo_collector():
    h = slo.LatencyHistogram()
    for d in (0.5, 3.0, 3.0, 100.0):
        h.observe(d)
    assert h.count == 4 and h.counts[0] == 1
    assert h.quantile_us(0.50) == 4.0 and h.quantile_us(0.99) == 128.0
    assert slo.LatencyHistogram().quantile_us(0.5) == 0.0
    tgt = {"serve/x": slo.SLOTarget(latency_us=15.0, objective=0.9)}
    jtgt = {"serve/x": j_slo.SLOTarget(latency_us=15.0, objective=0.9)}
    clock = lambda: 5.0  # noqa: E731  (a fixed window: summaries comparable)
    c, jc = slo.ServeSLO(tgt, clock=clock), j_slo.ServeSLO(jtgt, clock=clock)
    for col in (c, jc):
        col.observe("serve/x", 10.0)
        col.observe("serve/x", 20.0, view="pinned", mode="batched")
        col.validation_error("serve/y")
    assert c.burn_rates() == {"serve/x": 5.0}
    assert c.summary() == jc.summary()
    k = c.summary()["kinds"]["serve/x"]
    assert k["count"] == 2 and set(k["by"]) == {"live/percall", "pinned/batched"}
    col = slo.install(slo.ServeSLO())
    try:
        assert slo.active() is col
        with obs_trace.phase("serve/q", cat="serve", view="pinned", batch=8):
            pass
        with obs_trace.phase("serve/q", cat="serve"):
            pass
        with obs_trace.phase("engine/ignored"):
            pass
    finally:
        slo.uninstall()
    assert slo.active() is None
    ks = col.summary()["kinds"]
    assert set(ks) == {"serve/q"}
    assert set(ks["serve/q"]["by"]) == {"pinned/batched", "live/percall"}
    with obs_trace.phase("serve/q", cat="serve"):
        pass
    assert col.summary()["kinds"]["serve/q"]["count"] == 2


def _port_service():
    return WalkQueryService(engine=port_engine_like(make_jax_engine(
        WalkConfig(n_walks_per_vertex=2, length=8))))


def test_serve_validation_error_counter():
    svc = _port_service()
    col = slo.install(slo.ServeSLO())
    try:
        with pytest.raises(ValueError):
            svc.ppr_rows([N + 5])
        with pytest.raises(ValueError):
            svc.neighborhoods([0], hops=0)
        with pytest.raises(ValueError):
            svc.ppr_rows([0], restart_prob=1.5)
    finally:
        slo.uninstall()
    assert svc.obs_counters()["serve_validation_errors"] == 3
    v = col.summary()["kinds"]
    assert v["serve/ppr_row"]["validation_errors"] == 2
    assert v["serve/neighborhoods"]["validation_errors"] == 1
    svc.ppr_rows([0])
    assert svc.obs_counters()["serve_validation_errors"] == 3


def test_serve_counters():
    from repro.serve.walk_queries import WalkQueryService as JService
    svc = _port_service()
    jsvc = JService(engine=make_jax_engine(WalkConfig(n_walks_per_vertex=2,
                                                      length=8)))
    for s in (svc, jsvc):
        s.walk_matrix()
        s.walk_matrix()
    c = svc.obs_counters()
    assert c["ppr_cache_miss"] == 1 and c["ppr_cache_hit"] == 1
    assert c["overlay_rebuilds"] >= 1
    assert c == jsvc.obs_counters()
    s = export.summary(StreamMetrics.empty("cpu"), serve=c)
    assert export.to_prometheus(s) == j_export.to_prometheus(
        j_export.summary(j_metrics.StreamMetrics.empty(), serve=c))


# ------------------------------------------------- regression sentinel


def test_regress_compare_semantics(tmp_path):
    base = {"config": {"n": 64}, "t_us": 100.0, "qps": 50.0,
            "counters": {"c": 100}, "acc": 0.80, "gone": 1}
    cur = {"config": {"n": 64}, "t_us": 500.0, "qps": 10.0,
           "counters": {"c": 150}, "acc": 0.78, "fresh": 2}
    v = regress.compare(base, cur)
    assert v == j_regress.compare(base, cur)
    by = {c["path"]: c for c in v["cells"]}
    assert v["verdict"] == "fail" and by["counters.c"]["status"] == "fail"
    assert by["t_us"]["status"] == "info" and by["gone"]["status"] == "missing"
    assert by["fresh"]["status"] == "new" and "acc" not in by
    for a, b in (({"acc": 0.5}, {"acc": 0.9}), ({"acc": 0.9}, {"acc": 0.5}),
                 ({"quality_gap": 0.3}, {"quality_gap": 0.02}),
                 ({"config": {"n": 64}}, {"config": {"n": 128}}),
                 ({"pin": {"ok": True}}, {"pin": {"ok": False}})):
        assert regress.compare(a, b) == j_regress.compare(a, b)
    p = tmp_path / "thresholds.json"
    p.write_text('{"rules": [{"pattern": "counters.c", '
                 '"max_rel_delta": 0.1, "gate": false}]}')
    rules = regress.load_rules(str(p))
    assert regress.rules_to_json(rules) == j_regress.rules_to_json(
        j_regress.load_rules(str(p)))
    assert regress.compare(base, cur, rules)["verdict"] == "pass"
    vd = regress.Verdict(mode="smoke")
    vd.add("A", {"verdict": "pass", "counts": {}})
    vd.add("B", v)
    out = vd.to_json()
    assert out["verdict"] == "fail" and out["schema"] == 1
