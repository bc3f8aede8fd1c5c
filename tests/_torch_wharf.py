"""Shared helpers of the wharf cell-plan tests: the reference's plan and
the port's on the same seeded inputs, carried between the packages leaf
by leaf (numpy in the reference's dtypes; the port's biased int64 codes,
int32 u32 columns and int64 PRNG keys), and their outputs compared bit for
bit by leaf path."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import make_jax_engine
from repro_torch import random as jr
from repro_torch._u64 import from_u32_numpy, from_u64_numpy, to_u32_numpy, to_u64_numpy
from repro_torch.tree import leaf_paths, rebuild

SHAPES = ("stream_10k", "stream_100k", "stream_10k_interleave", "stream_10k_nomerge",
          "stream_10k_pipelined", "stream_10k_pipelined_eager", "stream_10k_mixed",
          "stream_10k_sharded", "stream_10k_n2v_rejection", "stream_10k_n2v_factorized",
          "stream_10k_n2v_megakernel", "serve_batched_q16", "serve_batched_q256")


def jax_mesh():
    import jax
    return jax.make_mesh((1, 1), ("data", "model"))


def _key_name(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def jax_paths(tree) -> dict:
    """{path: leaf} of a reference pytree, paths as the port's leaf_paths."""
    import jax
    return {"/".join(_key_name(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


PORT_DTYPE = {"uint64": "int64", "uint32": "int32"}


def port_leaf_dtypes(jtree, key_paths=()) -> dict:
    """{path: (shape, dtype)} of the reference's args in the port's
    representation: u64 -> int64, u32 -> int32, a PRNG key's uint32 words
    -> int64."""
    out = {}
    for k, leaf in jax_paths(jtree).items():
        dt = np.dtype(leaf.dtype).name
        out[k] = (tuple(leaf.shape), "int64" if k in key_paths else PORT_DTYPE.get(dt, dt))
    return out


def to_port(meta_tree, arrays, device="cpu"):
    """Numpy leaves (by the reference's paths) -> a tree shaped as the
    plan's meta arg: a leaf the plan holds as int64 from a uint32 array is
    a PRNG key, int64 from uint64 a biased code, int32 from uint32 a u32
    column."""
    leaves = {}
    for k, meta in leaf_paths(meta_tree).items():
        a = np.asarray(arrays[k])
        if a.dtype == np.uint64:
            t = from_u64_numpy(a, device)
        elif a.dtype == np.uint32 and meta.dtype == torch.int64:
            t = jr.as_key(a, device)
        elif a.dtype == np.uint32:
            t = from_u32_numpy(a, device)
        else:
            t = torch.from_numpy(a.copy()).to(device)
        t = t.reshape(a.shape)     # the bridges make a 0-d array 1-d
        assert t.dtype == meta.dtype and tuple(t.shape) == tuple(meta.shape), (k, t.dtype, meta)
        leaves[k] = t
    return rebuild(meta_tree, leaves)


def assert_outputs_equal(got, want, what: str) -> None:
    """Every leaf of the port's output = the reference's, bit for bit, by
    path; a port leaf is read back in the reference leaf's dtype."""
    want = {k: np.asarray(v) for k, v in jax_paths(want).items()}
    got = leaf_paths(got)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g = got[k]
        if w.dtype == np.uint64:
            g = to_u64_numpy(g)
        elif w.dtype == np.uint32:
            g = to_u32_numpy(g)
        else:
            g = g.detach().cpu().numpy().astype(w.dtype)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def jax_inputs(plan, seed: int = 0):
    """Seeded inputs of a reference smoke plan (numpy, the reference's
    dtypes, the args' tree structure): a 64-vertex R-MAT graph and its
    corpus (tests/test_stream.py's engine at the smoke config), uniform
    edge batches; the serve cell's pending blocks after two on-demand
    batches, queries half on stored walks."""
    import jax
    from repro.distr.engine import graph_to_dict, store_to_dict
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed + 11)
    eng = make_jax_engine(seed=seed, n_w=2, length=8, max_pending=8)
    n = eng.state.graph.n_vertices

    def ids(*shape):
        return rng.integers(0, n, shape).astype(np.uint32)

    a = plan.args
    if plan.step_name == "walk_serve_step":
        from repro.core.overlay import Overlay
        from repro.serve import batched as sb
        for i in range(2):
            eng.update_batch(jax.random.fold_in(key, i), ids(12), ids(12), ids(4), ids(4))
        st = eng.state
        qb = a[3].shape[0]
        w = rng.integers(0, st.store.n_walks, qb).astype(np.uint32)
        p = rng.integers(0, st.store.length - 1, qb).astype(np.uint32)
        wm = np.asarray(sb.walk_matrix_all(Overlay.build(st.store, st.pending), n_w=2))
        v = np.where(np.arange(qb) % 2 == 0, wm[w, p], ids(qb)).astype(np.uint32)
        emb = rng.standard_normal((n, a[2].shape[1])).astype(np.float32)
        return (st.store, st.pending, emb, v, w, p)
    st = eng.state
    if plan.step_name == "walk_update_step":
        be = a[2].shape[0]
        epoch = np.uint32(int(np.asarray(st.store.slot_epoch).max()) + 1)
        return (graph_to_dict(st.graph), store_to_dict(st.store), ids(be), ids(be),
                epoch, np.asarray(key))
    nb, be = a[-4].shape
    de = a[-2].shape[1]
    stream = (np.asarray(jax.random.split(key, nb)), ids(nb, be), ids(nb, be),
              ids(nb, de), ids(nb, de))
    if plan.step_name == "walk_stream_step":
        return (graph_to_dict(st.graph), store_to_dict(st.store)) + stream
    from repro.configs import get_arch
    from repro.distr.sharded import shard_state
    cfg = get_arch("wharf-stream").make_config(True)
    stacked = shard_state(st.graph, st.store, cfg.shard_spec(1), cfg.rewalk_capacity,
                          cfg.max_pending)
    return (stacked,) + stream


def port_args(plan, inputs, device="cpu"):
    """The reference's inputs as the port plan's args."""
    return tuple(to_port(meta, jax_paths(x), device) for meta, x in zip(plan.args, inputs))


@pytest.fixture
def registries():
    """Leave the process-wide backend registries of both packages as they
    were: a plan of an explicit-backend cell installs its backend."""
    from repro.core import packed_store as jps
    from repro.kernels import intersect as jint
    from repro.kernels import megakernel as jmk
    from repro_torch.core import packed_store
    from repro_torch.kernels import intersect, megakernel
    mods = (jps, jint, jmk, packed_store, intersect, megakernel)
    saved = [(m, k, getattr(m, k)) for m in mods
             for k in ("_default_backend", "_default_window") if hasattr(m, k)]
    yield
    for m, k, v in saved:
        setattr(m, k, v)


def _run_port(plan, args, tmp_path):
    import torch.distributed as dist
    if plan.step_name != "walk_stream_sharded_step":
        return plan.fn(*args)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        plan.fn(*args)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        return plan.fn(*args)
    finally:
        dist.destroy_process_group()


def check_smoke_run(shape: str, tmp_path) -> None:
    """The smoke plan's step on seeded inputs, the port's against the
    reference's jitted, every output leaf bit for bit (the sharded cell on
    a one-rank gloo group; it raises without one)."""
    import jax

    from repro.launch import steps as jsteps
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    want_plan = jsteps.build_cell("wharf-stream", shape, jax_mesh(), smoke=True)
    info = dict(get_arch("wharf-stream").shapes[shape])
    if info.get("megakernel") == "cuda":
        # the reference's "pallas" runs its interpret math off the TPU: the
        # port's "torch" (its "cuda" raises off the card)
        info["megakernel"] = "torch"
    plan = steps.build_cell("wharf-stream", shape, smoke=True, info=info)
    inputs = jax_inputs(want_plan)
    args = port_args(plan, inputs)
    want = jax.jit(want_plan.fn)(*inputs)
    with torch.no_grad():
        got = _run_port(plan, args, tmp_path)
    assert_outputs_equal(got, want, shape)
