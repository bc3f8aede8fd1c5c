"""The sharded wharf cell on a mesh against the JAX package's own 8-device
run, on the CPU: `stream_10k_sharded` at the smoke config (64 vertices, 2
walks of 8 a vertex, 8 batches of 10,000 inserts and 2,000 deletes) on 8
lockstep ranks of the port (launch/lockstep.py, the plan built on a
(2, 4) mesh) and, in one subprocess with 8 forced host devices, the
reference's plan built on a (2, 4) mesh of Auto axes, as
tests/_torch_partition.py builds it (jax 0.9 makes the reference's own
mesh Explicit), jitted with its shardings, compiled and run: its
shard_map over the mesh flattened to one "shard" axis. The inputs are
drawn from a seed with numpy: the graph's edges, the corpus key, the
batches and their keys.

Held bit for bit: every field of every shard's state after the stream
(the port's rows against the reference's [S, ...]-stacked state), the
unsharded graph and store (the port's `steps.unshard_rows` against the
reference's `unshard_state`) and each rank's affected counts. And a
rank's collectives, counted by the port's work counter on rank 0, equal
the reference's compiled per-chip HLO (`repro.launch.hlo_analysis.
analyze`, the scan's trip count scaled) by kind, count and bytes: one
all-reduce of the n_walks u64 keys a batch and `length` all-to-alls of
S x slab x 8 bytes (the [S, slab, 2] u32 lane slabs)."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch._u64 import from_u32_numpy, to_u32_numpy, to_u64_numpy
from repro_torch.configs import get_arch
from repro_torch.core import StreamingGraph, generate_corpus
from repro_torch.launch import lockstep, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.tree import tree_map

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHAPE, RANKS, SEED, N_EDGES = "stream_10k_sharded", 8, 24, 320
U64_LEAVES = ("graph.codes", "store.code", "pending.code")
U32_LEAVES = ("store.owner", "store.epoch", "store.vmin", "store.vmax", "store.packed",
              "store.widths", "store.anchors_hi", "store.anchors_lo", "store.last_hi",
              "store.last_lo", "store.slot_epoch", "pending.owner", "pending.epoch", "epoch")

REF_CODE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    import repro.core  # noqa: F401  (x64)
    from repro.configs import get_arch
    from repro.core import StreamingGraph, generate_corpus
    from repro.distr.sharded import shard_state, unshard_state
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import build_cell
    z = dict(np.load(sys.argv[1]))
    cfg = get_arch("wharf-stream").make_config(True)
    graph = StreamingGraph.from_edges(jnp.asarray(z["src"]), jnp.asarray(z["dst"]),
                                      cfg.n_vertices, cfg.edge_capacity)
    store = generate_corpus(jnp.asarray(z["corpus_key"]), graph, cfg.walk_config())
    stacked = shard_state(graph, store, cfg.shard_spec(8), cfg.rewalk_capacity,
                          cfg.max_pending)
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    # no jax.set_mesh: its (2, 4) context mesh refuses the plan's shard_map
    # over the flat ("shard",) mesh
    plan = build_cell("wharf-stream", "stream_10k_sharded", mesh, smoke=True)
    fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                 out_shardings=plan.out_shardings, donate_argnums=plan.donate_argnums)
    tot = analyze(fn.lower(*plan.args).compile().as_text())
    out, affected = fn(stacked, jnp.asarray(z["keys"]), jnp.asarray(z["ins_src"]),
                       jnp.asarray(z["ins_dst"]), jnp.asarray(z["del_src"]),
                       jnp.asarray(z["del_dst"]))
    res = {"affected": np.asarray(affected)}
    for part in ("graph", "store", "pending"):
        obj = getattr(out, part)
        for f in obj._fields if hasattr(obj, "_fields") else vars(obj):
            v = getattr(obj, f)
            if hasattr(v, "shape"):
                res[f"{part}.{f}"] = np.asarray(v)
    for f in ("n_pending", "epoch", "last_affected", "total_affected", "overflow"):
        res[f] = np.asarray(getattr(out, f))
    g, s, ovf = unshard_state(out, cfg.edge_capacity)
    res["unsharded.graph.codes"] = np.asarray(g.codes)
    for f in ("owner", "code", "epoch", "offsets", "vmin", "vmax", "packed", "widths",
              "anchors_hi", "anchors_lo", "last_hi", "last_lo", "slot_epoch"):
        res[f"unsharded.store.{f}"] = np.asarray(getattr(s, f))
    np.savez(sys.argv[2], **res)
    print(json.dumps({"coll_counts": tot.coll_counts, "coll_bytes": tot.coll_bytes,
                      "overflow": bool(ovf)}))
""")


def inputs() -> dict:
    """The seeded inputs, as numpy in the reference's dtypes."""
    cfg = get_arch("wharf-stream").make_config(True)
    info = get_arch("wharf-stream").shapes[SHAPE]
    rng = np.random.default_rng(SEED)
    nb, be, de, n = info["n_batches"], info["batch_edges"], info["del_edges"], cfg.n_vertices

    def ids(*shape):
        return rng.integers(0, n, shape).astype(np.uint32)

    return {"src": ids(N_EDGES), "dst": ids(N_EDGES),
            "corpus_key": rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32),
            "keys": rng.integers(0, 2**32, (nb, 2), dtype=np.uint64).astype(np.uint32),
            "ins_src": ids(nb, be), "ins_dst": ids(nb, be),
            "del_src": ids(nb, de), "del_dst": ids(nb, de)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs and per-chip collectives (a subprocess,
    started before the port runs)."""
    d = tmp_path_factory.mktemp("wharf_mesh_ref")
    inp = inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT / "src"),
                                                      os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, "-c", REF_CODE, str(d / "inputs.npz"),
                             str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = port_run(inp)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "out.npz") as z:
        ref = dict(z)
    return port, ref, json.loads(out.strip().splitlines()[-1])


def port_run(inp: dict):
    """The port's mesh plan on 8 lockstep ranks from the same inputs ->
    (its stacked state after the stream, the Run)."""
    cfg = get_arch("wharf-stream").make_config(True)
    graph = StreamingGraph.from_edges(inp["src"], inp["dst"], cfg.n_vertices,
                                      cfg.edge_capacity, device=CPU)
    store = generate_corpus(jr.as_key(inp["corpus_key"], CPU), graph, cfg.walk_config())
    with tmesh.fake_mesh((2, 4), ("data", "model")) as mesh:
        plan = steps.build_cell("wharf-stream", SHAPE, mesh=mesh, smoke=True)
    stacked = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), plan.args[0])
    args = (stacked, jr.as_key(inp["keys"], CPU)) + tuple(
        from_u32_numpy(inp[k]) for k in ("ins_src", "ins_dst", "del_src", "del_dst"))
    run = lockstep.run(lambda r, _: plan.fn(*args), RANKS, device=CPU,
                       setup=lambda r: steps.shard_row(stacked, r, graph, store, cfg),
                       counted=0)
    return stacked, run


def leaf(stacked, name: str) -> torch.Tensor:
    part, _, field = name.partition(".")
    if not field:
        return stacked[part]
    obj = stacked[part]
    return obj[field] if isinstance(obj, dict) else getattr(obj, field)


def as_ref(name: str, t: torch.Tensor) -> np.ndarray:
    """A port leaf in the reference's representation."""
    if name in U64_LEAVES:
        return to_u64_numpy(t)
    if name in U32_LEAVES:
        return to_u32_numpy(t)
    return t.numpy()


def test_every_shard_equals_the_reference_shard_map(reference):
    (stacked, run), ref, _ = reference
    names = [k for k in ref if not k.startswith(("unsharded.", "affected"))]
    assert len(names) == 3 + 13 + 4 + 5
    for name in names:
        np.testing.assert_array_equal(as_ref(name, leaf(stacked, name)), ref[name],
                                      err_msg=name)
    for r, out in enumerate(run.outputs):
        np.testing.assert_array_equal(out[1].numpy(), ref["affected"][r:r + 1], err_msg=r)


def test_unsharded_state_equals_the_reference(reference):
    (stacked, _), ref, counts = reference
    graph, store, overflow = steps.unshard_rows(stacked, get_arch("wharf-stream")
                                                .make_config(True))
    assert overflow is counts["overflow"] is False
    np.testing.assert_array_equal(to_u64_numpy(graph["codes"]), ref["unsharded.graph.codes"])
    for k, v in store.items():
        want = ref[f"unsharded.store.{k}"]
        got = (to_u64_numpy(v) if k == "code" else
               v.numpy() if k == "offsets" else to_u32_numpy(v))
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_collectives_equal_the_reference_per_chip_hlo(reference):
    (_, run), _, counts = reference
    tot = run.totals
    got = {k: (tot.coll_counts[k], tot.coll_bytes[k]) for k in tot.coll_counts
           if tot.coll_counts[k]}
    want = {k: (counts["coll_counts"][k], counts["coll_bytes"][k])
            for k in counts["coll_counts"] if counts["coll_counts"][k]}
    assert got == want
    cfg = get_arch("wharf-stream").make_config(True)
    nb = get_arch("wharf-stream").shapes[SHAPE]["n_batches"]
    assert got == {"all-reduce": (nb, nb * cfg.n_vertices * cfg.n_walks_per_vertex * 8),
                   "all-to-all": (nb * cfg.length,
                                  nb * cfg.length * RANKS * cfg.shard_spec(RANKS).slab * 8)}
