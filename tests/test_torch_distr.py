"""The port's sharded walk engine (`repro_torch.distr`) against the JAX
package's on the CPU: 8 gloo ranks, one process a shard
(`repro_torch.distr.ranks.spawn`), against the reference's 8-device
shard_map engine in one subprocess with 8 forced host devices, as
tests/test_distr.py runs it (`start_jax`: it dumps its outputs as an npz),
the two started together. The inputs are tests/test_distr.py's: an R-MAT
graph of 64 vertices (200 edges), 2 walks of length 8 a vertex, the mixed
stream of 6 batches (16 inserts, 4 deletes), key 3, 8 shards of 1,024
edges and 512 triplets, the slab the whole lane capacity 128,
`max_pending` 4. tests/test_torch_distr_serve_obs.py imports the helpers
of this module.

Held bit for bit: the lane compaction, the frontier exchange on 4 ranks,
every field of every shard's state, the unsharded graph, store and
traverse against the single-host engine, the affected counts, and the
GSPMD engine's outputs (`distr/engine.py`, computed on one device's
state). A batch makes exactly 1 + `length` collectives."""
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

# no JAX at module level: the spawned ranks import this module for their
# job functions, and need only the port
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.core.corpus import compact_lanes_by_shard
from repro_torch.distr import ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]

N, ECAP, CAP, LENGTH, N_W, MAX_PENDING, S = 64, 4096, 128, 8, 2, 4, 8
SPEC = dict(n_shards=S, n_vertices=N, edge_capacity=1024, store_capacity=512,
            mav_capacity=512, slab=CAP)
POLICIES = ("on-demand", "eager")
# the collectives a rank may make, each counted while the engine runs
COLLECTIVES = ("all_reduce", "all_to_all_single", "all_to_all", "all_gather",
               "all_gather_into_tensor", "reduce_scatter", "broadcast",
               "reduce", "gather", "scatter", "barrier", "send", "recv")


def inputs() -> dict:
    """tests/test_distr.py's graph edges and stream (the JAX package's
    generators, as numpy) and keys."""
    import jax

    import repro.core  # noqa: F401  (x64)
    from repro.data.streams import mixed_edge_stream, rmat_edges
    src, dst = rmat_edges(jax.random.PRNGKey(0), 200, 6)
    stream = mixed_edge_stream(jax.random.PRNGKey(2), 6, 16, 4, 6)
    return {"src": np.asarray(src), "dst": np.asarray(dst),
            "stream": [np.asarray(a) for a in stream],
            "key": np.asarray(jax.random.PRNGKey(3)),
            "corpus_key": np.asarray(jax.random.PRNGKey(1))}


def walk_config(metrics: bool = False):
    from repro_torch.core import WalkConfig
    return WalkConfig(n_walks_per_vertex=N_W, length=LENGTH, megakernel="off",
                      metrics=metrics)


def port_start(inp: dict):
    """The port's single-device graph and corpus on the CPU."""
    from repro_torch import random as jr
    from repro_torch.core import StreamingGraph, generate_corpus
    graph = StreamingGraph.from_edges(inp["src"], inp["dst"], N, ECAP,
                                      device="cpu")
    return graph, generate_corpus(jr.as_key(inp["corpus_key"], "cpu"), graph,
                                  walk_config())


def port_spec():
    from repro_torch.distr.sharded import ShardSpec
    return ShardSpec(**SPEC)


class CollectiveCounter:
    """Counts every `torch.distributed` collective made while entered (the
    module's functions wrapped in place)."""

    def __enter__(self):
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self._saved = {name: getattr(dist, name) for name in COLLECTIVES}
        for name, fn in self._saved.items():
            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                return _fn(*a, **kw)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def shard_stream(rank: int, inp: dict, policy: str, batches=slice(None),
                 state=None, metrics: bool = False):
    """This rank's shard (of the port's start state, unless `state`)
    through `batches` of the stream -> (state, affected, metrics or None,
    collective counts)."""
    from repro_torch.distr.sharded import local_shard_state, sharded_run_stream
    spec = port_spec()
    if state is None:
        graph, store = port_start(inp)
        state = local_shard_state(graph, store, spec, rank, CAP, MAX_PENDING)
    with CollectiveCounter() as cc:
        out = sharded_run_stream(state, inp["key"],
                                 *(a[batches] for a in inp["stream"]),
                                 cfg=walk_config(metrics), spec=spec,
                                 capacity=CAP, max_pending=MAX_PENDING,
                                 merge_policy=policy)
    return out[0], out[1], (out[2] if metrics else None), cc.counts


def single_host(inp: dict, policy: str):
    """The port's single-device engine on the CPU through the stream."""
    from repro_torch.core.update import WalkEngine
    graph, store = port_start(inp)
    eng = WalkEngine(graph=graph, store=store, cfg=walk_config(),
                     merge_policy=policy, rewalk_capacity=CAP,
                     max_pending=MAX_PENDING)
    return eng


# ------------------------------------------------------------- JAX side


def start_jax(code: str, tmp_path, arrays: dict) -> subprocess.Popen:
    """Start JAX_SETUP + `code` in a subprocess with 8 host devices; it
    reads `arrays` as `z` (an npz) and writes the dict `out` to its npz."""
    np.savez(tmp_path / "inputs.npz", **arrays)
    head = (f"INPUTS = {str(tmp_path / 'inputs.npz')!r}\n"
            f"OUT = {str(tmp_path / 'jax.npz')!r}\n")
    body = textwrap.dedent(JAX_SETUP) + textwrap.dedent(code) + \
        "\nnp.savez(OUT, **out)\n"
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "PATH": "/usr/bin:/bin"}
    return subprocess.Popen([sys.executable, "-c", head + body],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))


def finish_jax(proc: subprocess.Popen, tmp_path) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    with np.load(tmp_path / "jax.npz") as z:
        return dict(z)


def jax_arrays(inp: dict, **more) -> dict:
    return dict(src=inp["src"], dst=inp["dst"], key=inp["key"],
                corpus_key=inp["corpus_key"],
                **{f"stream{i}": a for i, a in enumerate(inp["stream"])},
                **more)


JAX_SETUP = """
import jax, jax.numpy as jnp, numpy as np
from repro.core import StreamingGraph, generate_corpus
from repro.core.corpus import WalkConfig, walk_start_vertex
from repro.core.update import WalkEngine
from repro.distr.sharded import (ShardSpec, shard_state, sharded_run_stream,
                                 unshard_state)

z = dict(np.load(INPUTS))
stream = tuple(jnp.asarray(z[f"stream{i}"]) for i in range(4))
key = jnp.asarray(z["key"])
cfg = WalkConfig(n_walks_per_vertex=2, length=8, megakernel="off")
graph = StreamingGraph.from_edges(jnp.asarray(z["src"]),
                                  jnp.asarray(z["dst"]), 64, 4096)
store = generate_corpus(jnp.asarray(z["corpus_key"]), graph, cfg)
spec = ShardSpec(n_shards=8, n_vertices=64, edge_capacity=1024,
                 store_capacity=512, mav_capacity=512, slab=128)
STORE = ("owner", "code", "epoch", "offsets", "vmin", "vmax", "packed",
         "widths", "anchors_hi", "anchors_lo", "last_hi", "last_lo",
         "slot_epoch")
out = {}


def fresh():
    return jax.tree.map(jnp.array, graph), jax.tree.map(jnp.array, store)


def dump_state(prefix, st):
    # the flat dict of repro_torch.convert (leading shard axis if stacked)
    for f in ("codes", "offsets", "num_edges"):
        out[f"{prefix}graph.{f}"] = np.asarray(getattr(st.graph, f))
    for f in STORE:
        out[f"{prefix}store.{f}"] = np.asarray(getattr(st.store, f))
    for f in ("owner", "code", "epoch", "slot"):
        out[f"{prefix}pending.{f}"] = np.asarray(getattr(st.pending, f))
    for f in ("n_pending", "epoch", "last_affected", "total_affected",
              "overflow"):
        out[f"{prefix}{f}"] = np.asarray(getattr(st, f))


def dump_single(prefix, eng):
    out[f"{prefix}graph.codes"] = np.asarray(eng.graph.codes)
    for f in STORE:
        out[f"{prefix}store.{f}"] = np.asarray(getattr(eng.store, f))
    w = jnp.arange(eng.store.n_walks, dtype=jnp.uint32)
    out[f"{prefix}traverse"] = np.asarray(eng.store.traverse(
        w, walk_start_vertex(w, 2), 7))
"""


def jax_state(out: dict, prefix: str) -> dict:
    """A dumped state (`dump_state`) as the dict of `repro_torch.convert`,
    with the sizes filled in."""
    d = {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}
    d.update({"graph.n_vertices": N, "store.length": LENGTH,
              "store.n_walks": N * N_W, "store.n_vertices": N,
              "store.chunk_b": 128})
    return d


# ------------------------------------------------------------------ tests

EX_SLABS = (32, 6)     # the exchange's slab: roomy, and one that overflows

JAX_CODE = """
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.wharf_stream import WharfStreamConfig
from repro.distr.engine import (distributed_run_stream,
                                distributed_update_step, graph_to_dict,
                                store_to_dict, stream_shardings,
                                wharf_shardings)
from repro.distr.handoff import exchange_frontier

dump_state("start.", shard_state(*fresh(), spec, 128, max_pending=4))
for policy in ("on-demand", "eager"):
    g, s = fresh()
    eng = WalkEngine(graph=g, store=s, cfg=cfg, merge_policy=policy,
                     rewalk_capacity=128, max_pending=4)
    out[f"{policy}.single.affected"] = np.asarray(eng.run_stream(key, *stream))
    eng.merge()
    dump_single(f"{policy}.single.", eng)
    stacked, aff = sharded_run_stream(
        shard_state(*fresh(), spec, 128, max_pending=4), key, *stream,
        cfg=cfg, spec=spec, capacity=128, max_pending=4, merge_policy=policy)
    dump_state(f"{policy}.sharded.", stacked)
    out[f"{policy}.sharded.affected"] = np.asarray(aff)

# distr/engine.py under a 2x4 mesh, as tests/test_distr.py
wcfg = WharfStreamConfig(n_vertices=64, edge_capacity=4096,
                         n_walks_per_vertex=2, length=8, batch_edges=16,
                         rewalk_capacity=128, max_pending=4)
mesh = jax.make_mesh((2, 4), ("data", "model"))
g_sh, s_sh = wharf_shardings(mesh, wcfg)
st_sh = stream_shardings(mesh)
keys = jax.random.split(key, 6)
with mesh:
    step = jax.jit(lambda gd, sd, a, b, e, k: distributed_update_step(
        gd, sd, a, b, e, k, wcfg), in_shardings=(g_sh, s_sh, None, None, None,
                                                 None), out_shardings=s_sh)
    d = step(graph_to_dict(fresh()[0]), store_to_dict(fresh()[1]),
             jnp.asarray(z["upd_src"]), jnp.asarray(z["upd_dst"]),
             jnp.uint32(1), key)
    for k, v in d.items():
        out[f"update.{k}"] = np.asarray(v)
    for policy in ("on-demand", "eager"):
        f = jax.jit(lambda gd, sd, ks, a, b, c, e: distributed_run_stream(
            gd, sd, ks, a, b, wcfg, merge_policy=policy, max_pending=4,
            del_src=c, del_dst=e),
            in_shardings=(g_sh, s_sh, st_sh["keys"], st_sh["ins_src"],
                          st_sh["ins_dst"], st_sh["del_src"],
                          st_sh["del_dst"]), out_shardings=(g_sh, s_sh, None))
        gd, sd, aff = f(graph_to_dict(fresh()[0]), store_to_dict(fresh()[1]),
                        keys, *stream)
        for k, v in {**{"graph." + k: v for k, v in gd.items()},
                     **{"store." + k: v for k, v in sd.items()}}.items():
            out[f"{policy}.gspmd.{k}"] = np.asarray(v)
        out[f"{policy}.gspmd.affected"] = np.asarray(aff)
# the update step without merging, on one device
d = jax.jit(lambda gd, sd, a, b, e, k: distributed_update_step(
    gd, sd, a, b, e, k, wcfg, do_merge=False))(
    graph_to_dict(fresh()[0]), store_to_dict(fresh()[1]),
    jnp.asarray(z["upd_src"]), jnp.asarray(z["upd_dst"]), jnp.uint32(1), key)
for k, v in d.items():
    out[f"update_nomerge.{k}"] = np.asarray(v)

# exchange_frontier on 4 devices
mesh4 = Mesh(np.array(jax.devices()[:4]), ("shard",))
for slab in (32, 6):
    f = jax.jit(shard_map(lambda d, x: tuple(o[None] for o in exchange_frontier(
        d[0], x[0], 4, slab, "shard")), mesh=mesh4,
        in_specs=(P("shard"), P("shard")), out_specs=(P("shard"),) * 3,
        check_rep=False))
    cur, mine, ovf = f(jnp.asarray(z["ex_dest"]), jnp.asarray(z["ex_nxt"]))
    out[f"ex{slab}.cur"] = np.asarray(cur)
    out[f"ex{slab}.mine"] = np.asarray(mine)
    out[f"ex{slab}.overflow"] = np.asarray(ovf)
"""


def rank_job(rank, inp):
    """A rank: its shard of the start state, the stream under both
    policies, and (ranks 0-3) the frontier exchange on a 4-rank group."""
    import torch.distributed as dist

    from repro_torch.distr.handoff import exchange_frontier
    from repro_torch.distr.sharded import local_shard_state
    graph, store = port_start(inp)
    res = {"start": convert.state_to_numpy(local_shard_state(
        graph, store, port_spec(), rank, CAP, MAX_PENDING))}
    for policy in POLICIES:
        st, aff, _, counts = shard_stream(rank, inp, policy)
        res[policy] = dict(state=convert.state_to_numpy(st),
                           affected=aff.numpy(), counts=counts)
    group = dist.new_group([0, 1, 2, 3])
    if rank < 4:
        dest = torch.from_numpy(inp["ex_dest"][rank]).long()
        nxt = torch.from_numpy(inp["ex_nxt"][rank]).long()
        for slab in EX_SLABS:
            cur, mine, ovf = exchange_frontier(dest, nxt, 4, slab, group)
            res[f"ex{slab}"] = (cur.numpy(), mine.numpy(), bool(ovf))
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(inputs, the port's 8 ranks' results, the JAX subprocess's dump),
    the two run concurrently."""
    tmp = tmp_path_factory.mktemp("distr")
    inp = inputs()
    rng = np.random.default_rng(18)
    inp["ex_dest"] = rng.integers(0, 5, size=(4, 64)).astype(np.int32)
    inp["ex_nxt"] = rng.integers(0, 64, size=(4, 64)).astype(np.uint32)
    import jax

    from repro.data.streams import rmat_edges
    inp["upd_src"], inp["upd_dst"] = (np.asarray(a) for a in rmat_edges(
        jax.random.PRNGKey(2), 16, 6))
    proc = start_jax(JAX_CODE, tmp, jax_arrays(
        inp, ex_dest=inp["ex_dest"], ex_nxt=inp["ex_nxt"],
        upd_src=inp["upd_src"], upd_dst=inp["upd_dst"]))
    try:
        port = ranks.spawn(rank_job, S, inp, tmp)
    finally:
        jout = finish_jax(proc, tmp)
    return inp, port, jout


@pytest.mark.parametrize("case", ["buckets", "overflow", "random"])
def test_compact_lanes_by_shard(case):
    """tests/test_distr.py::test_compact_lanes_by_shard's cases, and a
    random one, against the JAX function."""
    import jax.numpy as jnp

    from repro.core.corpus import compact_lanes_by_shard as j_compact
    if case == "buckets":
        dest, n, slab = [2, 0, 4, 0, 2, 2, 4, 0, 1, 4, 4, 4], 4, 3
    elif case == "overflow":
        dest, n, slab = [0, 0, 0, 0, 1, 1], 2, 3
    else:
        dest, n, slab = np.random.default_rng(1).integers(0, 9, 200), 8, 20
    send, ovf = compact_lanes_by_shard(torch.tensor(dest), n, slab)
    j_send, j_ovf = j_compact(jnp.asarray(dest, jnp.int32), n, slab)
    np.testing.assert_array_equal(send.numpy(), np.asarray(j_send))
    assert bool(ovf) == bool(j_ovf)
    send = send.numpy()
    assert send.shape == (n, slab)
    if case == "buckets":
        assert list(send[0]) == [1, 3, 7]          # dest 0, ascending lanes
        assert list(send[1]) == [8, 12, 12]        # one lane + sentinel pad
        assert list(send[2]) == [0, 4, 5]
        assert list(send[3]) == [12, 12, 12]       # dest 3 is empty
        assert not bool(ovf)                       # dest 4 = inactive: dropped
    elif case == "overflow":
        assert bool(ovf) and list(send[0]) == [0, 1, 2]   # first `slab` kept


@pytest.mark.parametrize("slab", EX_SLABS)
def test_exchange_frontier_on_4_ranks_matches_jax(both, slab):
    _, port, jout = both
    ovf_any = False
    for r in range(4):
        cur, mine, ovf = port[r][f"ex{slab}"]
        np.testing.assert_array_equal(mine, jout[f"ex{slab}.mine"][r])
        np.testing.assert_array_equal(cur, jout[f"ex{slab}.cur"][r])
        assert ovf == bool(jout[f"ex{slab}.overflow"][r])
        ovf_any |= ovf
    assert ovf_any == (slab == 6)


def test_shard_state_matches_jax(both):
    """Every shard's start state: the port's `local_shard_state` on each
    rank and `shard_state` in one process = the reference's stacked
    `shard_state`."""
    from _torch_parity import assert_state_dicts_equal
    from repro_torch.distr.sharded import shard_state
    inp, port, jout = both
    want = jax_state(jout, "start.")
    got = convert.shard_states_to_numpy(
        [convert.state_from_numpy(r["start"], "cpu") for r in port])
    assert_state_dicts_equal(want, got)
    graph, store = port_start(inp)
    local = convert.shard_states_to_numpy(
        shard_state(graph, store, port_spec(), CAP, MAX_PENDING))
    assert_state_dicts_equal(want, local)
    for k in convert.SHARD_SCALARS:
        np.testing.assert_array_equal(local[k], want[k].astype(local[k].dtype))


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_engine_bit_equivalence(both, policy):
    """tests/test_distr.py::test_sharded_engine_bit_equivalence on 8 gloo
    ranks: each shard's state = the reference's shard field by field; the
    unsharded graph, store (every array) and traverse = the single-host
    engine; the affected counts equal; 1 + length collectives a batch."""
    from _torch_parity import assert_state_dicts_equal
    from repro_torch.distr.sharded import unshard_state
    _, port, jout = both
    want = jax_state(jout, f"{policy}.sharded.")
    got = convert.shard_states_to_numpy(
        [convert.state_from_numpy(r[policy]["state"], "cpu") for r in port])
    assert_state_dicts_equal(want, got)
    for k in convert.SHARD_SCALARS:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype))
    aff = jout[f"{policy}.single.affected"]
    np.testing.assert_array_equal(jout[f"{policy}.sharded.affected"], aff)
    n_batches = len(aff)
    for r in port:
        np.testing.assert_array_equal(r[policy]["affected"], aff)
        assert r[policy]["counts"] == dict(
            dict.fromkeys(COLLECTIVES, 0), all_reduce=n_batches,
            all_to_all_single=n_batches * LENGTH), r[policy]["counts"]

    g2, s2, ovf = unshard_state(convert.shard_states_from_numpy(got, "cpu"),
                                ECAP)
    assert not ovf
    prefix = f"{policy}.single."
    single = {k[len(prefix):]: v for k, v in jout.items()
              if k.startswith(prefix)}
    np.testing.assert_array_equal(convert._TO["u64"](g2.codes),
                                  single["graph.codes"])
    for k, kind in convert.FIELDS.items():
        if k.startswith("store."):
            np.testing.assert_array_equal(
                convert._TO[kind](getattr(s2, k[6:])), single[k], err_msg=k)
    w = torch.arange(s2.n_walks)
    trav = s2.traverse(w, w // N_W, LENGTH - 1)
    np.testing.assert_array_equal(trav.numpy(),
                                  single["traverse"].astype(np.int64))


def _dicts_port(gd, sd):
    return ({"graph." + k: v for k, v in gd.items()}
            | {"store." + k: v for k, v in sd.items()})


def _assert_dict_matches(port: dict, jout: dict, prefix: str):
    for k, v in port.items():
        if k == "graph.n_vertices":
            continue
        want = jout[prefix + k]
        np.testing.assert_array_equal(convert._TO[convert.FIELDS[k]](v), want,
                                      err_msg=k)


@pytest.mark.parametrize("do_merge", [True, False])
def test_distributed_walk_update_equivalence(both, do_merge):
    """tests/test_distr.py::test_distributed_walk_update_equivalence: the
    port's `distributed_update_step` = the reference's (under its 2x4
    mesh when merging), every store array; the merged store's codes =
    the single-host engine's after the same insert batch."""
    from repro_torch.configs.wharf_stream import WharfStreamConfig
    from repro_torch.core.update import WalkEngine
    from repro_torch.distr.engine import (distributed_update_step,
                                          graph_to_dict, store_to_dict)
    inp, _, jout = both
    wcfg = WharfStreamConfig(n_vertices=64, edge_capacity=4096,
                             n_walks_per_vertex=2, length=8, batch_edges=16,
                             rewalk_capacity=128, max_pending=4)
    graph, store = port_start(inp)
    key = jr.as_key(inp["key"], "cpu")
    d = distributed_update_step(graph_to_dict(graph), store_to_dict(store),
                                inp["upd_src"], inp["upd_dst"], 1, key, wcfg,
                                do_merge=do_merge)
    prefix = "update." if do_merge else "update_nomerge."
    _assert_dict_matches({"store." + k: v for k, v in d.items()},
                         {"store." + k[len(prefix):]: v for k, v in jout.items()
                          if k.startswith(prefix)}, "")
    if do_merge:
        eng = WalkEngine(graph=graph, store=store, cfg=wcfg.walk_config(),
                         merge_policy="eager", rewalk_capacity=128)
        eng.insert_edges(key, inp["upd_src"], inp["upd_dst"])
        assert torch.equal(torch.sort(d["code"]).values,
                           torch.sort(eng.store.code).values)


@pytest.mark.parametrize("policy", POLICIES)
def test_gspmd_mixed_stream_equivalence(both, policy):
    """tests/test_distr.py::test_gspmd_mixed_stream_equivalence: the port's
    `distributed_run_stream` on the mixed stream = the reference's GSPMD
    run (graph and store dicts, affected) = the single-host engine."""
    from repro_torch.configs.wharf_stream import WharfStreamConfig
    from repro_torch.distr.engine import (distributed_run_stream,
                                          graph_to_dict, store_to_dict)
    inp, _, jout = both
    wcfg = WharfStreamConfig(n_vertices=64, edge_capacity=4096,
                             n_walks_per_vertex=2, length=8, batch_edges=16,
                             rewalk_capacity=128, max_pending=4)
    graph, store = port_start(inp)
    keys = jr.split(jr.as_key(inp["key"], "cpu"), 6)
    gd, sd, aff = distributed_run_stream(
        graph_to_dict(graph), store_to_dict(store), keys, *inp["stream"][:2],
        wcfg, merge_policy=policy, max_pending=4, del_src=inp["stream"][2],
        del_dst=inp["stream"][3])
    np.testing.assert_array_equal(aff.numpy(), jout[f"{policy}.gspmd.affected"])
    np.testing.assert_array_equal(aff.numpy(), jout[f"{policy}.single.affected"])
    _assert_dict_matches(_dicts_port(gd, sd), jout, f"{policy}.gspmd.")
    for k in ("graph.codes", "store.owner", "store.code", "store.epoch",
              "store.slot_epoch"):
        np.testing.assert_array_equal(jout[f"{policy}.gspmd.{k}"],
                                      jout[f"{policy}.single.{k}"])


def test_order2_raises():
    """The sharded engine is order 1 only, as the reference."""
    from repro_torch.core.walkers import WalkModel, sample_next_sharded
    from repro_torch.distr.sharded import sharded_run_stream
    graph, _ = port_start(inputs())
    n2v = WalkModel(order=2, p=0.5, q=2.0)
    with pytest.raises(NotImplementedError):
        sample_next_sharded(jr.PRNGKey(0, "cpu"), graph,
                            torch.arange(4), n2v)
    with pytest.raises(NotImplementedError):
        sharded_run_stream(None, None, None, None,
                           cfg=walk_config()._replace(model=n2v),
                           spec=port_spec(), capacity=CAP)


def test_shard_states_numpy_round_trip(both):
    """`convert.shard_states_from_numpy` / `shard_states_to_numpy`: the
    reference's stacked state -> the port's S shard states -> back, the
    same arrays and per-shard scalars."""
    from _torch_parity import assert_state_dicts_equal
    _, _, jout = both
    d = jax_state(jout, "eager.sharded.")
    states = convert.shard_states_from_numpy(d, "cpu")
    assert len(states) == S
    assert [s.epoch for s in states] == [int(e) for e in d["epoch"]]
    back = convert.shard_states_to_numpy(states)
    assert_state_dicts_equal(d, back)
    for k in convert.SCALARS:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(d[k]).astype(
                                          np.asarray(back[k]).dtype))


def test_unshard_and_shard_raise_on_capacity():
    """A lost triplet (a capacity overflow's symptom) makes `unshard_state`
    raise; a shard whose rows exceed its capacity makes
    `local_shard_state` raise."""
    import dataclasses

    from repro_torch.distr.sharded import local_shard_state, shard_state, unshard_state
    graph, store = port_start(inputs())
    states = shard_state(graph, store, port_spec(), CAP, MAX_PENDING)
    g, s, ovf = unshard_state(states, ECAP)
    assert not ovf and torch.equal(s.code, store.code)
    lost = states[3].store.epoch.clone()
    lost[0] = -1
    states[3] = states[3].replace(store=states[3].store.replace(epoch=lost))
    with pytest.raises(RuntimeError, match="live triplets"):
        unshard_state(states, ECAP)
    tight = dataclasses.replace(port_spec(), store_capacity=8)
    with pytest.raises(ValueError, match="per-shard"):
        local_shard_state(graph, store, tight, 0, CAP, MAX_PENDING)


def test_shard_spec_matches_reference_config():
    """`WharfStreamConfig.shard_spec` = the reference's, with the balanced
    defaults and with every override."""
    import dataclasses

    from repro.configs.wharf_stream import WharfStreamConfig as JCfg
    from repro_torch.configs.wharf_stream import WharfStreamConfig
    for kw in ({}, dict(shard_edge_capacity=4096, shard_store_capacity=8192,
                        handoff_slab=64)):
        for n in (0, 4):
            want = dataclasses.asdict(JCfg(**kw).shard_spec(n))
            got = dataclasses.asdict(WharfStreamConfig(**kw).shard_spec(n))
            assert got == want, (kw, n)
