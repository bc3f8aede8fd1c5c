"""The port's cell plans (repro_torch/launch/steps.py) against the JAX
package's `build_cell` on a 1 x 1 mesh, on the CPU.

Held: for every cell of the GNN, LM and recsys families, at the smoke and
the full configs, the step name, every argument leaf's path, shape and
dtype (the reference's uint32 PRNG key is the port's int64 key) and
`model_flops` exactly, every argument on the meta device, and the
qwen1.5-110b train_4k plan built in well under a second; a wharf cell
and a cell on a fake-backend mesh built. Then one `train_step` of `_gnn_full_plan` and
of `_gnn_sampled_plan` per arch against the jitted reference on the same
parameters, inputs and key, within GNN_TOL: loss, gradient norm, the new
parameters and moments. The sampled plan's three cells whose loss runs
the forward on the step's `params` (all but GraphSAGE) have a gradient
norm of exactly 0 in both packages, and the port runs that forward
without autograd. And the LM and DLRM plans' step functions on small
plans of real inputs against the reference's."""
import time

import jax
import numpy as np
import pytest
import torch

from _torch_gnn import GNN_ARCHS, GNN_TOL, graph
from _torch_lm import assert_trees_close, jax_tree_to_numpy
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_arch as jax_arch
from repro.launch import steps as jsteps
from repro.train.optim import adamw_init as jax_adamw_init
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.launch import steps
from repro_torch.train.optim import adamw_init
from repro_torch.tree import leaf_paths

CELLS = [c for c in jax_all_cells() if jax_arch(c[0]).family in ("gnn", "lm", "recsys")]
ZERO_GRAD = ("meshgraphnet", "equiformer-v2", "gat-cora")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _key_name(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def jax_leaves(tree) -> dict:
    """{path: (shape, dtype)} of the reference's abstract args, the key's
    uint32 words as the port's int64."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        dt = np.dtype(leaf.dtype).name
        out["/".join(_key_name(k) for k in path)] = (
            tuple(leaf.shape), "int64" if dt == "uint32" else dt)
    return out


def port_leaves(tree) -> dict:
    out = {}
    for k, v in leaf_paths(tree).items():
        assert v.is_meta, k
        out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def test_cells_cover_the_three_families():
    assert len(CELLS) == 40      # 5 LMs x 4, 4 GNNs x 4, dlrm-rm2 x 4
    assert {get_arch(a).family for a, _ in CELLS} == {"gnn", "lm", "recsys"}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_matches_jax(arch, shape, smoke):
    want = jsteps.build_cell(arch, shape, _mesh(), smoke=smoke)
    got = steps.build_cell(arch, shape, smoke=smoke)
    assert (got.arch, got.shape, got.step_name) == (want.arch, want.shape, want.step_name)
    assert port_leaves(got.args) == jax_leaves(want.args)
    assert got.model_flops == want.model_flops
    assert (got.donate_argnums, got.static_argnums) == (want.donate_argnums,
                                                        want.static_argnums)
    assert got.in_shardings is None and got.out_shardings is None


def test_full_width_plans_allocate_nothing_and_build_fast():
    steps.build_cell("gemma2-2b", "train_4k")        # the meta ops' first use
    t0 = time.perf_counter()
    plan = steps.build_cell("qwen1.5-110b", "train_4k")
    seconds = time.perf_counter() - t0
    assert seconds < 0.5, seconds
    n = sum(v.numel() for v in leaf_paths(plan.args[0]).values())
    assert n > 100e9 and all(v.is_meta for v in leaf_paths(plan.args).values())
    # abstract_tree: any tree of tensors as meta stand-ins of its shapes
    real = {"a": [torch.ones(3, 2)], "b": torch.zeros(4, dtype=torch.int32)}
    assert port_leaves(steps.abstract_tree(real)) == {
        "a/0": ((3, 2), "float32"), "b": ((4,), "int32")}
    assert steps._pad(1) == steps._pad(512) == 512 and steps._pad(513) == 1024


def test_wharf_cells_and_meshes_build():
    """The wharf family builds (tests/test_torch_wharf_plans.py holds each
    plan against the reference's), and so does a cell on a `DeviceMesh`
    (tests/test_torch_mesh.py holds the placements)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.kernels import megakernel
    plan = steps.build_cell("wharf-stream", "stream_10k_mixed", smoke=True)
    assert plan.step_name == "walk_stream_step" and plan.in_shardings is None
    assert megakernel.default_backend_request() is None   # "auto" installs nothing
    torch.distributed.init_process_group("fake", world_size=256, rank=0, store=FakeStore())
    try:
        mesh = make_production_mesh(device_type="cpu")
        plan = steps.build_cell("gat-cora", "molecule", mesh=mesh, smoke=True)
        assert set(leaf_paths(plan.in_shardings)) == set(leaf_paths(plan.args))
        assert plan.in_shardings[3].placements == (
            torch.distributed.tensor.Shard(0), torch.distributed.tensor.Replicate())
    finally:
        torch.distributed.destroy_process_group()


def _params_both(arch, jcfg, cfg, d_feat, seed=4):
    """The reference's parameters at the plan's cfg (outside jit), and the
    port's converted from them."""
    from repro.models import gnn as jg
    from _torch_gnn import JAX_INITS
    jcfg = jsteps._gnn_init(arch, jcfg, d_feat)[0]
    cfg = steps._gnn_init(arch, cfg, d_feat)[0]
    jp = getattr(jg, JAX_INITS[arch])(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.gnn_params_from_numpy(jax_tree_to_numpy(jp), arch, cfg, "cpu"), cfg


def _labels(arch, cfg, rows: int, rng):
    if arch in ("meshgraphnet", "equiformer-v2"):
        return rng.standard_normal((rows, cfg.d_out)).astype(np.float32)
    return rng.integers(0, cfg.n_classes, rows).astype(np.int32)


def _check_step(want, got, zero_grad: bool):
    """(params, opt, loss, gnorm) of both packages within GNN_TOL."""
    jparams, jopt, jloss, jgnorm = want
    params, opt, loss, gnorm = got
    np.testing.assert_allclose(float(loss), float(jloss), **GNN_TOL)
    if zero_grad:
        assert float(gnorm) == float(jgnorm) == 0.0
    else:
        assert float(jgnorm) > 0
        np.testing.assert_allclose(float(gnorm), float(jgnorm), **GNN_TOL)
    assert_trees_close(params, jax_tree_to_numpy(jparams), "params", **GNN_TOL)
    assert_trees_close(opt.m, jax_tree_to_numpy(jopt.m), "m", **GNN_TOL)
    assert_trees_close(opt.v, jax_tree_to_numpy(jopt.v), "v", **GNN_TOL)
    assert int(opt.step) == int(jopt.step) == 1


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_full_plan_train_step_matches_jax(arch):
    info = dict(kind="full", n_nodes=300, n_edges=400, d_feat=8)   # padded to 512
    jcfg, cfg = jax_arch(arch).make_config(True), get_arch(arch).make_config(True)
    want_plan = jsteps._gnn_full_plan(arch, jcfg, info, _mesh(), "t")
    plan = steps._gnn_full_plan(arch, cfg, info, None, "t")
    jp, tp, pcfg = _params_both(arch, jcfg, cfg, info["d_feat"])
    rng = np.random.default_rng(6)
    snd, rcv = graph(512, 512, seed=6)
    batch = {"senders": snd, "receivers": rcv}
    for k, v in plan.args[2].items():
        if k not in batch:
            batch[k] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    labels = _labels(arch, pcfg, 512, rng)
    want = jax.jit(want_plan.fn)(jp, jax_adamw_init(jp), batch, labels)
    got = plan.fn(tp, adamw_init(tp), {k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.from_numpy(labels))
    _check_step(want, got, zero_grad=False)


def _csr(n: int, e: int, rng):
    """A valid CSR: monotone offsets from 0 to e, vertices 0..9 of degree
    0, neighbors in [0, n)."""
    cuts = np.sort(rng.integers(0, e + 1, n - 11))
    offsets = np.concatenate([np.zeros(11, np.int64), cuts, [e]]).astype(np.int32)
    return offsets, rng.integers(0, n, e).astype(np.int32)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_sampled_plan_train_step_matches_jax(arch, monkeypatch):
    info = dict(kind="sampled", n_nodes=300, n_edges=2000, batch_nodes=16,
                fanout=(3, 2), d_feat=8)
    jcfg, cfg = jax_arch(arch).make_config(True), get_arch(arch).make_config(True)
    want_plan = jsteps._gnn_sampled_plan(arch, jcfg, info, _mesh(), "t")
    plan = steps._gnn_sampled_plan(arch, cfg, info, None, "t")
    jp, tp, pcfg = _params_both(arch, jcfg, cfg, info["d_feat"])
    rng = np.random.default_rng(8)
    n, e = 512, 2048
    feats = rng.standard_normal((n, info["d_feat"])).astype(np.float32)
    offsets, neighbors = _csr(n, e, rng)
    assert offsets.shape == tuple(plan.args[3].shape) and neighbors.shape == (e,)
    seeds = rng.integers(0, n, 16).astype(np.int32)
    seeds[:2] = [3, 7]                                  # degree 0
    labels = _labels(arch, pcfg, 16, rng)
    key = jax.random.PRNGKey(5)
    args = (feats, offsets, neighbors, seeds, labels)
    want = jax.jit(want_plan.fn)(jp, jax_adamw_init(jp), *args, key)
    grad_enabled = []
    forward = steps._gnn_forward

    def recorded(*a, **kw):
        grad_enabled.append(torch.is_grad_enabled())
        return forward(*a, **kw)

    monkeypatch.setattr(steps, "_gnn_forward", recorded)
    got = plan.fn(tp, adamw_init(tp), *(torch.from_numpy(a) for a in args),
                  jr.as_key(np.asarray(key), "cpu"))
    _check_step(want, got, zero_grad=arch in ZERO_GRAD)
    # the zero-gradient cells' forward builds no autograd graph
    assert grad_enabled == ([False] if arch in ZERO_GRAD else [])


LM_DLRM_STEPS = [("gemma2-2b", dict(kind="train", global_batch=2, seq_len=8)),
                 ("qwen2-moe-a2.7b", dict(kind="train", global_batch=2, seq_len=8)),
                 ("gemma2-2b", dict(kind="prefill", global_batch=2, seq_len=8)),
                 ("gemma2-2b", dict(kind="decode", global_batch=2, seq_len=16)),
                 ("dlrm-rm2", dict(kind="train", batch=8)),
                 ("dlrm-rm2", dict(kind="serve", batch=8)),
                 ("dlrm-rm2", dict(kind="retrieval", batch=1, n_candidates=1000))]


def _lm_dlrm_plans(arch, info):
    jcfg, cfg = jax_arch(arch).make_config(True), get_arch(arch).make_config(True)
    if arch == "dlrm-rm2":
        return (jsteps._dlrm_plan(arch, jcfg, info, _mesh(), "t"),
                steps._dlrm_plan(arch, cfg, info, None, "t"), jcfg, cfg)
    build = {"train": "_lm_train_plan", "prefill": "_lm_prefill_plan",
             "decode": "_lm_decode_plan"}[info["kind"]]
    return (getattr(jsteps, build)(arch, jcfg, info, _mesh()),
            getattr(steps, build)(arch, cfg, info, None), jcfg, cfg)


@pytest.mark.parametrize("arch,info", LM_DLRM_STEPS,
                         ids=[f"{a}-{i['kind']}" for a, i in LM_DLRM_STEPS])
def test_lm_and_dlrm_plan_steps_match_jax(arch, info):
    """The LM and DLRM plans' step functions on real inputs of small plans
    (f32 smoke configs) against the jitted reference's, within the LM
    tests' rtol 1e-4 / atol 1e-5: the train steps' gradient accumulation
    over one-sequence microbatches and AdamW, prefill's logits and cache,
    a decode step, DLRM's serve and retrieval scores."""
    from _torch_lm import F32_TOL
    from repro.models import dlrm as jdlrm
    from repro.models import transformer as jtfm
    want_plan, plan, jcfg, cfg = _lm_dlrm_plans(arch, info)
    if arch == "dlrm-rm2":
        jp = jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
        tp = convert.dlrm_params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    else:
        jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.lm_params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    rng = np.random.default_rng(9)
    args = []
    for a in plan.args[2 if want_plan.step_name == "train_step" else 1:]:
        for k, v in leaf_paths(a).items():
            assert v.dtype in (torch.float32, torch.int32), k
        if isinstance(a, dict):              # the decode cache
            args.append({k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                         for k, v in a.items()})
        elif a.dim() == 0:                    # the decode's cache_len
            args.append(np.int32(5))
        elif a.dtype == torch.int32:
            hi = cfg.table_rows if arch == "dlrm-rm2" else cfg.vocab_size
            args.append(np.asarray(rng.integers(0, hi, tuple(a.shape)), np.int32))
        else:
            args.append(rng.standard_normal(tuple(a.shape)).astype(np.float32))
    if want_plan.step_name == "train_step":
        if arch == "dlrm-rm2":
            args[-1] = (args[-1] > 0).astype(np.float32)      # labels in {0, 1}
        want = jax.jit(want_plan.fn)(jp, jax_adamw_init(jp), *args)
        got = plan.fn(tp, adamw_init(tp), *(torch.from_numpy(x) for x in args))
        np.testing.assert_allclose(float(got[2]), float(want[2]), **F32_TOL)
        np.testing.assert_allclose(float(got[3]), float(want[3]), **F32_TOL)
        assert_trees_close(got[0], jax_tree_to_numpy(want[0]), "params", **F32_TOL)
        return
    targs = [{k: torch.from_numpy(v.copy()) for k, v in x.items()} if isinstance(x, dict)
             else torch.as_tensor(x) for x in args]
    want = jax.jit(want_plan.fn)(jp, *args)
    with torch.no_grad():
        got = plan.fn(tp, *targs)
    assert_trees_close(got, jax_tree_to_numpy(want), want_plan.step_name, **F32_TOL)
