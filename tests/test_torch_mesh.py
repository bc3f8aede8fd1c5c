"""The port's production meshes (repro_torch/launch/mesh.py), sharding
rules (launch/sharding.py), `build_cell` on a mesh and the activation
constraints (models/act_sharding.py), on the CPU, with the meshes built
over a process group of the "fake" backend in this one process (256 or
512 ranks; no collective moves data).

Held: both production meshes have the reference's shapes and dim names;
the parameter placements of every LM arch at its full config, on both
meshes, are the reference's `lm_param_pspecs` translated one mesh dim at a
time (a mesh dim that a tensor dim's spec names shards that tensor dim,
every other mesh dim replicates), and so are the KV-cache placements of
`lm_cache_pspec` on the decode shapes and DLRM's and the GNNs' rules;
every cell of every family builds on both meshes with a sharding for
each argument leaf, the LM train plan's microbatches following the batch
dims; `constrain` is the identity without a mesh and on plain tensors,
and redistributes a DTensor under `set_mesh`."""
import inspect
from functools import partial

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_arch as jax_arch
from repro.launch import sharding as jshr
from repro.launch.mesh import batch_axes as jax_batch_axes
from repro_torch.configs import all_cells, get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shr
from repro_torch.launch import steps
from repro_torch.models import transformer as tfm
from repro_torch.models.act_sharding import constrain, resolved_placements
from repro_torch.tree import leaf_paths

LM_ARCHS = [a for a in ("gemma2-2b", "llama4-maverick-400b-a17b", "mistral-nemo-12b",
                        "qwen1.5-110b", "qwen2-moe-a2.7b")]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def mesh(request):
    """A production mesh over a fake-backend process group of its size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    multi = request.param
    dist.init_process_group("fake", world_size=512 if multi else 256, rank=0,
                            store=FakeStore())
    try:
        yield tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
    finally:
        dist.destroy_process_group()


def translate(spec, names) -> tuple:
    """A reference PartitionSpec -> DTensor placements, one a mesh dim."""
    out = []
    for m in names:
        dims = [d for d, e in enumerate(spec) if e == m or (isinstance(e, tuple) and m in e)]
        assert len(dims) <= 1, (spec, m)
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def placements_of(tree) -> dict:
    return {k: v.placements for k, v in leaf_paths(tree).items()}


def jax_mesh_like(mesh):
    return jax.sharding.AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def test_meshes_have_the_references_shapes(mesh):
    multi = "pod" in mesh.mesh_dim_names
    shape, names = MESHES[multi]
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == (shape, names)
    assert tmesh.production_shape(multi) == (shape, names)
    assert tmesh.mesh_size(mesh) == (512 if multi else 256)
    assert tmesh.batch_axes(mesh) == jax_batch_axes(jax_mesh_like(mesh))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_placements_are_the_references(arch, mesh):
    jcfg, cfg = jax_arch(arch).make_config(False), get_arch(arch).make_config(False)
    names = mesh.mesh_dim_names
    want = jshr.lm_param_pspecs(jcfg)
    want_layers = want.pop("layers")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        plan = steps.build_cell(arch, shape, mesh=mesh)
        got = placements_of(plan.in_shardings[0])
        for k, ps in want.items():
            assert got[k] == translate(ps, names), (shape, k)
        for k, ps in want_layers.items():
            assert got[f"layers/{k}"] == translate(ps, names), (shape, k)
        assert len(got) == len(want) + len(want_layers)
        info = get_arch(arch).shapes[shape]
        if info["kind"] == "decode":
            cache = translate(jshr.lm_cache_pspec(jcfg, info, jax_mesh_like(mesh)), names)
            assert plan.in_shardings[2]["k"].placements == cache
            assert plan.out_shardings[1]["v"].placements == cache
        if info["kind"] == "train":
            # the microbatches: one sequence a batch shard
            n_shards = 32 if "pod" in names else 16
            n_micro = inspect.getclosurevars(plan.fn).nonlocals["n_micro"]
            assert n_micro == info["global_batch"] // n_shards
            assert plan.in_shardings[1].m == plan.in_shardings[0]


def test_dlrm_and_gnn_rules_are_the_references(mesh):
    from repro.models import dlrm as jdlrm
    names = mesh.mesh_dim_names
    jcfg = jax_arch("dlrm-rm2").make_config(False)
    params = jax.eval_shape(partial(jdlrm.dlrm_init, cfg=jcfg), jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): ps
            for path, ps in jax.tree_util.tree_flatten_with_path(
                jshr.dlrm_param_pspecs(params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    got = placements_of(steps.build_cell("dlrm-rm2", "train_batch", mesh=mesh).in_shardings[0])
    assert got == {k: translate(ps, names) for k, ps in want.items()}
    assert got["tables"] == translate((None, "model", None), names)
    for arch in ("meshgraphnet", "equiformer-v2", "gat-cora", "graphsage-reddit"):
        plan = steps.build_cell(arch, "molecule", mesh=mesh)
        rep = (Replicate(),) * len(names)
        assert set(placements_of(plan.in_shardings[0]).values()) == {rep}
    # the spec rules themselves, as the reference's
    assert shr.opt_pspecs(shr.P("data")) == {"step": shr.P(), "m": shr.P("data"),
                                            "v": shr.P("data")}


def test_every_cell_builds_on_the_mesh(mesh):
    """All 53 cells: a sharding for every argument leaf, at the full configs."""
    from repro_torch.core import packed_store
    from repro_torch.kernels import intersect, megakernel
    saved = (packed_store._default_backend, intersect._default_backend,
             megakernel._default_backend)
    try:
        for arch, shape in all_cells():
            plan = steps.build_cell(arch, shape, mesh=mesh)
            assert set(leaf_paths(plan.in_shardings)) == set(leaf_paths(plan.args)), (arch, shape)
            assert all(isinstance(s, shr.NamedSharding)
                       for s in leaf_paths(plan.in_shardings).values())
    finally:
        (packed_store._default_backend, intersect._default_backend,
         megakernel._default_backend) = saved
    names = mesh.mesh_dim_names
    plan = steps.build_cell("wharf-stream", "stream_10k_sharded", mesh=mesh)
    s = tmesh.mesh_size(mesh)
    assert plan.args[0]["graph"]["codes"].shape[0] == s
    assert plan.in_shardings[0]["store"]["code"].placements == (Shard(0),) * len(names)
    plan = steps.build_cell("wharf-stream", "stream_10k_mixed", mesh=mesh)
    g, st = plan.in_shardings[:2]
    flat = tuple(Shard(0) if n in ("data", "model") else Replicate() for n in names)
    assert g["codes"].placements == st["packed"].placements == flat
    assert st["vmin"].placements == translate(("model",), names)
    assert g["offsets"].placements == (Replicate(),) * len(names)


def test_constrain(mesh):
    names = mesh.mesh_dim_names
    x = torch.ones(4, 6)
    d = DTensor.from_local(torch.ones(4, 6), mesh, (Replicate(),) * len(names))
    # no mesh: the identity, on plain tensors and DTensors
    assert constrain(x, "batch", "tp") is x and constrain(d, "batch", "tp") is d
    with tmesh.set_mesh(mesh):
        assert tmesh.current_mesh() is mesh
        assert constrain(x, "batch", "tp") is x
        assert constrain(d, None, None) is d
        y = constrain(d, "batch", "tp")
        assert isinstance(y, DTensor) and y.shape == d.shape
        assert y.placements == resolved_placements(mesh, "batch", "tp") == translate(
            (("pod", "data") if "pod" in names else "data", "model"), names)
    assert tmesh.current_mesh() is None
    # the transformer's calls pass plain tensors through under a mesh
    cfg = get_arch("gemma2-2b").make_config(True)
    from repro_torch import random as jr
    params = tfm.init_params(jr.PRNGKey(0, "cpu"), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    want = tfm.forward(params, tok, cfg)
    with tmesh.set_mesh(mesh):
        assert torch.equal(tfm.forward(params, tok, cfg), want)
