"""A cell's step run partitioned for real: ranks of a (data, model) mesh,
one process each, run `steps.partition` of the cell's plan on real
tensors, and each rank holds its shards of the outputs against the same
step run unsharded on one device.

    check([{"arch": "dlrm-rm2", "shape": "serve_p99"}], device=torch.device("cuda"),
          workdir=wd)

`check` builds each cell's plan on the mesh (over a "fake" process group
of its size in this process), draws its args once (the models' own inits,
data from `seed`), runs its step unsharded on plain tensors (the same
function, the same microbatches), counts its partition on meta
(`meta_collectives`), and starts the ranks (`distr/ranks.spawn`, gloo:
several ranks may share one card, where NCCL refuses two ranks on one
device). The ranks receive the args and the unsharded outputs as they are
(a card's tensors by CUDA IPC), cut their shards (`steps.partition`), run
the step once, timed, under the work counter (`op_analysis`: the
collectives each rank made, by kind and bytes), and compare their output
shards with the matching slices of the unsharded outputs. Nothing is
gathered to compare.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.tree import leaf_paths, tree_map

F32 = torch.float32
# forwards (logits, scores) and a step's parameters against the unsharded
# step: GNN_TOL, and tests/test_torch_lm_trainer.py's PARAM_TOL
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def cell_args(plan, arch: str, config, info: Optional[dict], seed: int, device) -> tuple:
    """Real args of an LM, DLRM or GNN plan on `device`: the parameters
    from the model's own init on key `seed`, AdamW's state from
    `adamw_init`, data drawn from a generator seeded `seed` (token and
    index ranges from the config; a decode step's cache normal and its
    length a third of it)."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm, gnn
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import adamw_init
    family = get_arch(arch).family
    gen = torch.Generator(device=device).manual_seed(seed)
    key = jr.PRNGKey(seed, device)

    def ints(t, high):
        return torch.randint(0, high, tuple(t.shape), generator=gen, device=device).to(t.dtype)

    def normal(t):
        return torch.randn(tuple(t.shape), generator=gen, device=device, dtype=F32).to(t.dtype)

    a = plan.args
    if family == "lm":
        params = tfm.init_params(key, config)
        if plan.step_name == "train_step":
            return params, adamw_init(params), ints(a[2], config.vocab_size)
        if plan.step_name == "prefill":
            return params, ints(a[1], config.vocab_size)
        cache = tree_map(normal, a[2])
        return params, ints(a[1], config.vocab_size), cache, a[2]["k"].shape[2] // 3
    if family == "recsys":
        params = dlrm.dlrm_init(key, config)
        if plan.step_name == "train_step":
            return (params, adamw_init(params), normal(a[2]), ints(a[3], config.table_rows),
                    ints(a[4], 2).to(F32))
        return params, normal(a[1]), ints(a[2], config.table_rows)
    if family == "gnn" and plan.step_name == "train_step" and isinstance(a[2], dict):
        from repro_torch.launch.steps import _gnn_init
        info = get_arch(arch).shapes[plan.shape] if info is None else info
        params = gnn.INITS[arch](key, _gnn_init(arch, config, info.get("d_feat", 16))[0])
        n_nodes = a[3].shape[0]          # the labels, one a node
        batch = {k: ints(v, n_nodes) if k in ("senders", "receivers") else normal(v)
                 for k, v in a[2].items()}
        labels = normal(a[3]) if a[3].is_floating_point() else ints(a[3], config.n_classes)
        return params, adamw_init(params), batch, labels
    raise ValueError(f"{arch} x {plan.shape}: no real args for this plan")


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def meta_collectives(plan, mesh) -> dict:
    """The collectives rank 0's partition of `plan` (built on `mesh`)
    makes, counted on meta: {kind: [count, bytes]}."""
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import partition
    tot = analyze(partition(plan, mesh))
    return {k: [tot.coll_counts[k], tot.coll_bytes[k]] for k in tot.coll_counts
            if tot.coll_counts[k]}


def _names(mesh_shape):
    return ("pod", "data", "model")[-len(mesh_shape):]


def _slices(out, full):
    """This rank's slice of the unsharded `full` that DTensor `out` holds."""
    from repro_torch.models.act_sharding import shard_range
    idx = []
    for d in range(out.dim()):
        s0, n = shard_range(out, d)
        idx.append(slice(s0, s0 + n))
    return full[tuple(idx)]


def _local(got, full):
    """(this rank's shard of `got`, the matching slice of the unsharded
    `full`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(got, DTensor):
        return got.to_local(), _slices(got, full)
    return got, full


def _compare(got, want, tol, held=None) -> dict:
    """Worst excess of |got - want| over atol + rtol |want| (<= 0 passes)
    over the elements `held` marks (all without it), the largest absolute
    difference over all, and the shard's largest |want| ("scale"; with
    `tol["scaled"]` the atol is a fraction of it: an f32 result's rounding
    follows the size of what it sums, not of each element)."""
    g, w = _local(got, want)
    if not g.is_floating_point():
        return {"excess": float((g != w).sum()), "max_abs_err": float((g != w).any())}
    d = (g.double() - w.double()).abs()
    scale = float(w.abs().max()) if w.numel() else 0.0
    atol = tol["atol"] * (scale if tol.get("scaled") else 1.0)
    over = d - atol - tol["rtol"] * w.double().abs()
    if held is not None:
        over = torch.where(held, over, -torch.inf)
    out = {"excess": float(over.max()) if over.numel() else 0.0,
           "max_abs_err": float(d.max()) if d.numel() else 0.0, "scale": scale}
    if g.dim() == 0:
        out.update(got=float(g), want=float(w))
    return out


def _adamw_compare(out: dict, want: dict, tol) -> dict:
    """A train step's outputs against the unsharded step's where AdamW's
    first step amplifies f32 rounding (`check`'s "adamw_eps"): the new
    first moments m (the clipped gradients times 1 - b1) within rtol and
    an atol of 1e-5 of each shard's largest |m|; the parameters within
    `tol` where the clipped gradient |m| / (1 - b1) is at least 10 AdamW
    eps (a step there is within 10% of +-lr whatever the rounding); the
    rest as `tol` says."""
    from repro_torch.train.optim import AdamWConfig
    c = AdamWConfig()
    res = {}
    for k, v in out.items():
        if k.startswith("1/m/"):
            res[k] = _compare(v, want[k], dict(rtol=tol["rtol"], atol=1e-5, scaled=True))
        elif k.startswith("0/") and "1/m/" + k[2:] in want:
            m = _local(v, want["1/m/" + k[2:]])[1]
            res[k] = _compare(v, want[k], tol, held=m.abs() / (1 - c.b1) >= 10 * c.eps)
        elif k in want:
            res[k] = _compare(v, want[k], tol)
    return res


def _run_cell(mesh, dev, cell: dict) -> dict:
    """One cell on this rank: its partitioned step run once under the work
    counter and timed (the counter's dispatch included), its output shards
    against the unsharded outputs, and the port's kernel launches."""
    from repro_torch.distr import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch.op_analysis import counted_run
    from repro_torch.launch.steps import build_cell, partition
    from repro_torch.models import transformer as tfm
    from repro_torch.models.act_sharding import whole
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    plan = build_cell(cell["arch"], cell["shape"], mesh=mesh, info=cell["info"],
                      config=cell["config"])
    sp = partition(plan, mesh, cell["args"])
    routes = []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    before, routed = dict(ops.launches), dict(collectives.routed)
    with collectives.gloo_routes(cuda_only=not cell["route_cpu"]):
        if cell["routes"] is not None:
            _record_routes(tfm, routes)
        sync()
        t0 = time.perf_counter()
        try:
            out, tot, _ = counted_run(sp, sp.args, scale_loops=False)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            if cell["routes"] is not None:
                tfm.moe_route = tfm.moe_route.__wrapped__
    leaves = leaf_paths(out)
    res = {"ms": ms,
           "compare": _adamw_compare(leaves, cell["want"], cell["tol"]) if cell["adamw_eps"]
           else {k: _compare(v, cell["want"][k], cell["tol"])
                 for k, v in leaves.items() if k in cell["want"]},
           "collectives": {k: [tot.coll_counts[k], tot.coll_bytes[k]]
                           for k in tot.coll_counts if tot.coll_counts[k]}}
    if cell["routes"] is not None:
        res["routes_equal"] = len(routes) == len(cell["routes"]) and all(
            all(torch.equal(whole(g), w) for g, w in zip(got, want))
            for got, want in zip(routes, cell["routes"]))
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    res["launches"] = {k: ops.launches[k] - before[k] for k in ops.KERNELS}
    res["routed"] = {k: collectives.routed[k] - routed[k] for k in routed}
    return res


def rank_job(rank: int, payload: dict) -> list:
    """One rank of `check` (module-level for `ranks.spawn`): each cell in
    turn on a (data, model) mesh over the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = payload["device"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False    # f32 products, as unsharded
    mesh = init_device_mesh(dev.type, payload["mesh_shape"],
                            mesh_dim_names=_names(payload["mesh_shape"]))
    out = []
    for cell in payload["cells"]:
        out.append(_run_cell(mesh, dev, cell))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _record_routes(tfm, into: list):
    """Wrap `transformer.moe_route` so that each call's (experts, slots,
    kept) land in `into`."""
    import functools
    inner = tfm.moe_route

    @functools.wraps(inner)
    def recorded(*a, **k):
        r = inner(*a, **k)
        into.append(r[1:4])
        return r
    tfm.moe_route = recorded


def check(cells, *, mesh_shape=(2, 2), seed: int = 0, device=None, workdir: str) -> list:
    """Each cell's step on `mesh_shape`'s ranks (gloo, all on `device`,
    one spawn for every cell) against the same step unsharded on `device`.
    A cell is a dict: "arch", "shape", and optionally "info" (the shape's
    entry), "config" (default: the full config), "tol" (default STEP_TOL
    for a train step, else FORWARD_TOL), "routes" (True: also hold the
    MoE routing of every layer equal to the unsharded step's, exactly),
    "skip" (output leaf path prefixes left uncompared, and not held by this
    process: "1/v" for a train step's second moments), "adamw_eps" (True:
    a train step at full width, compared as `_adamw_compare` says) and
    "route_cpu"
    (True: the CPU ranks' all-gathers and Shard -> Shard moves run through
    the card's gloo routes, `collectives.gloo_routes`). This process holds
    every cell's args and unsharded outputs while the ranks run (on one
    card, check fewer cells a call). -> per cell {"cell",
    "ranks": each rank's comparison, collectives, ms and peak GB; "meta":
    `meta_collectives`; "unsharded_ms"}."""
    import math

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.distr import ranks
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as tfm
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    jobs, results = [], []
    for c in cells:
        arch, shape, info = c["arch"], c["shape"], c.get("info")
        config = c.get("config") or get_arch(arch).make_config(False)
        rec = []
        # the plan built on the mesh (its microbatches follow the mesh's
        # batch dims: a MoE's capacity depends on them) run unsharded, on
        # plain tensors, and counted partitioned on meta
        with fake_mesh(mesh_shape, _names(mesh_shape)) as mesh:
            plan = build_cell(arch, shape, mesh=mesh, info=info, config=config)
            meta = meta_collectives(plan, mesh)
            args = cell_args(plan, arch, config, info, seed, device)
            if c.get("routes"):
                _record_routes(tfm, rec)
            try:
                sync()
                t0 = time.perf_counter()
                want = plan.fn(*tree_map(_clone, args))
                sync()
                unsharded_ms = (time.perf_counter() - t0) * 1e3
            finally:
                if c.get("routes"):
                    tfm.moe_route = tfm.moe_route.__wrapped__
        if device.type == "cuda":
            torch.cuda.empty_cache()     # the ranks share the card
        tol = c.get("tol") or (STEP_TOL if plan.step_name == "train_step" else FORWARD_TOL)
        jobs.append(dict(arch=arch, shape=shape, info=info, config=config, args=args, tol=tol,
                         route_cpu=bool(c.get("route_cpu")), adamw_eps=bool(c.get("adamw_eps")),
                         want={k: v.detach() for k, v in leaf_paths(want).items()
                               if not k.startswith(tuple(c.get("skip", ())))},
                         routes=[tuple(t.detach() for t in r) for r in rec]
                         if c.get("routes") else None))
        results.append({"cell": f"{arch}/{shape}", "meta": meta, "unsharded_ms": unsharded_ms})
    payload = dict(cells=jobs, device=device, mesh_shape=tuple(mesh_shape))
    per_rank = ranks.spawn(rank_job, math.prod(mesh_shape), payload, workdir, backend="gloo")
    for i, r in enumerate(results):
        r["ranks"] = [per_rank[k][i] for k in range(len(per_rank))]
    return results


def collectives_match(meta: dict, got: dict, rank: int) -> bool:
    """A rank's collectives against the meta count of rank 0's partition:
    the same kinds and counts, and rank 0's bytes equal (another rank's
    shard is no larger where a dim does not divide)."""
    return got.keys() == meta.keys() and all(
        got[k][0] == meta[k][0] and (got[k][1] == meta[k][1] if rank == 0
                                     else got[k][1] <= meta[k][1]) for k in meta)


def passed(result: dict) -> bool:
    """Of one cell of `check`: every rank's every output within tolerance,
    its collectives those counted on meta (`collectives_match`), and
    (where recorded) its routing exact."""
    return all(all(c["excess"] <= 0 for c in r["compare"].values())
               and collectives_match(result["meta"], r["collectives"], i)
               and r.get("routes_equal", True) for i, r in enumerate(result["ranks"]))
