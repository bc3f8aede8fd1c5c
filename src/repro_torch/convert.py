"""Carry engine state between the JAX package and the port, exactly.

`config_from` carries a reference `WalkConfig` (its walk model included)
over to the port's. `state_from_numpy` takes the fields of the reference's `StreamingGraph`,
`WalkStore`, `PendingBlocks` and `EngineState` as numpy arrays (in the
reference's dtypes: uint64 codes, uint32 columns) in a flat dict keyed
`"graph.codes"`, `"store.owner"`, ... (see FIELDS), and builds the port's
EngineState; `state_to_numpy` is its inverse. `maintainer_config_from`,
`params_from_numpy`/`params_to_numpy` and `maintainer_state_from_numpy`
do the same for the downstream maintainer (the SGNS tables and its
optimizer counters), `baseline_from_numpy`/`baseline_to_numpy` for the II
and Tree baselines (`core/baselines.py`), `wharf_config_from` for a
reference `WharfStreamConfig`, and `shard_states_from_numpy`/
`shard_states_to_numpy` for the sharded engine's states (`distr/`),
`lm_params_from_numpy`/`lm_params_to_numpy` for the transformer's
parameter tree, `dlrm_params_from_numpy`/`dlrm_params_to_numpy` for
DLRM's and `gnn_params_from_numpy`/`gnn_params_to_numpy` for the GNN
family's (nested lists of dicts: MGN's `blocks`, eqv2's `layers` and
their `so2` lists). No JAX is imported: the caller turns its arrays into numpy
first (bf16 leaves as their uint16 bits, or numpy's `bfloat16` from
ml_dtypes, which is viewed as such).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._u64 import from_u32_numpy, from_u64_numpy, to_u32_numpy, to_u64_numpy
from repro_torch.core.corpus import WalkConfig
from repro_torch.core.graph import StreamingGraph
from repro_torch.core.store import WalkStore
from repro_torch.core.update import EngineState, PendingBlocks
from repro_torch.core.walkers import WalkModel
from repro_torch.tree import leaf_paths, rebuild

# the reference's kernel backends (FINDNEXT, intersect) -> the port's
BACKEND_NAMES = {"auto": "auto", "pallas": "cuda", "interpret": "torch",
                 "pallas-interpret": "torch", "xla-ref": "ref"}

# the reference's megakernel backends -> the port's
MEGAKERNEL_NAMES = {"off": "off", **BACKEND_NAMES}

# the reference's SGNS backends -> the port's
SGNS_NAMES = {None: None, **BACKEND_NAMES}

# field -> its representation: "u64" codes, "u32" columns, "i32" columns
FIELDS = {
    "graph.codes": "u64", "graph.offsets": "i32", "graph.num_edges": "i32",
    "store.owner": "u32", "store.code": "u64", "store.epoch": "u32",
    "store.offsets": "i32", "store.vmin": "u32", "store.vmax": "u32",
    "store.packed": "u32", "store.widths": "u32", "store.anchors_hi": "u32",
    "store.anchors_lo": "u32", "store.last_hi": "u32", "store.last_lo": "u32",
    "store.slot_epoch": "u32",
    "pending.owner": "u32", "pending.code": "u64", "pending.epoch": "u32",
    "pending.slot": "i32",
    "last_affected": "i32", "total_affected": "i32",
}
# host integers and the bool flag
SCALARS = ("graph.n_vertices", "store.length", "store.n_walks",
           "store.n_vertices", "store.chunk_b", "n_pending", "epoch",
           "overflow")

_FROM = {"u64": from_u64_numpy, "u32": from_u32_numpy,
         "i32": lambda a, device: torch.from_numpy(
             np.array(a, dtype=np.int32)).to(device)}
_TO = {"u64": to_u64_numpy, "u32": to_u32_numpy,
       "i32": lambda t: t.detach().cpu().numpy().astype(np.int32)}


def config_from(cfg) -> WalkConfig:
    """A reference `WalkConfig` (any object with its fields) -> the port's:
    the walk model's order, p, q, trials, sampler and window width, the
    megakernel backend under its port name, and the metrics switch with
    the auditor's sample count."""
    m = cfg.model
    model = WalkModel(order=m.order, p=m.p, q=m.q, n_trials=m.n_trials,
                      sampler=m.sampler, dmax=m.dmax)
    return WalkConfig(n_walks_per_vertex=cfg.n_walks_per_vertex,
                      length=cfg.length, model=model, chunk_b=cfg.chunk_b,
                      megakernel=MEGAKERNEL_NAMES[cfg.megakernel],
                      metrics=cfg.metrics, audit_k=cfg.audit_k)


def _graph(t: dict, d: dict) -> StreamingGraph:
    return StreamingGraph(t["graph.codes"], t["graph.offsets"],
                          t["graph.num_edges"], int(d["graph.n_vertices"]))


def state_from_numpy(d: dict, device=None) -> EngineState:
    dev = resolve_device(device)
    t = {k: _FROM[kind](d[k], device=dev) for k, kind in FIELDS.items()}
    graph = _graph(t, d)
    cols = [t["store." + k] for k in (
        "owner", "code", "epoch", "offsets", "vmin", "vmax", "packed",
        "widths", "anchors_hi", "anchors_lo", "last_hi", "last_lo",
        "slot_epoch")]
    store = WalkStore(*cols, int(d["store.length"]), int(d["store.n_walks"]),
                      int(d["store.n_vertices"]), int(d["store.chunk_b"]))
    pending = PendingBlocks(t["pending.owner"], t["pending.code"],
                            t["pending.epoch"], t["pending.slot"])
    return EngineState(graph=graph, store=store, pending=pending,
                       n_pending=int(d["n_pending"]), epoch=int(d["epoch"]),
                       last_affected=t["last_affected"],
                       total_affected=t["total_affected"],
                       overflow=torch.tensor(bool(d["overflow"]), device=dev))


def state_to_numpy(state: EngineState) -> dict:
    src = {"graph": state.graph, "store": state.store,
           "pending": state.pending}
    out = {}
    for k, kind in FIELDS.items():
        obj, _, name = k.rpartition(".")
        val = getattr(src[obj], name) if obj else getattr(state, name)
        out[k] = _TO[kind](val)
    for k in SCALARS:
        obj, _, name = k.rpartition(".")
        val = getattr(src[obj], name) if obj else getattr(state, name)
        out[k] = bool(val) if k == "overflow" else int(val)
    return out


def maintainer_config_from(cfg):
    """A reference `MaintainerConfig` -> the port's, its walk config and
    SGNS backend under the port's names."""
    from repro_torch.downstream.maintainer import MaintainerConfig
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(MaintainerConfig)}
    kw["walk"] = config_from(cfg.walk)
    kw["sgns_backend"] = SGNS_NAMES[cfg.sgns_backend]
    return MaintainerConfig(**kw)


def params_from_numpy(d: dict, device=None) -> dict:
    """{"in", "out"} float32 numpy tables -> the port's SGNS params."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(d[k], dtype=np.float32)).to(dev)
            for k in ("in", "out")}


def params_to_numpy(params: dict) -> dict:
    return {k: params[k].detach().cpu().numpy() for k in ("in", "out")}


def maintainer_state_from_numpy(d: dict, device=None):
    """The flat engine dict of `state_from_numpy` plus "params.in",
    "params.out", "opt.step" and "opt.pairs" -> a MaintainerState."""
    from repro_torch.downstream.maintainer import MaintainerState
    dev = resolve_device(device)
    params = params_from_numpy({"in": d["params.in"], "out": d["params.out"]},
                               dev)
    opt = {"step": torch.tensor(int(d["opt.step"]), dtype=torch.int32,
                                device=dev),
           "pairs": torch.tensor(int(d["opt.pairs"]), dtype=torch.int64,
                                 device=dev)}
    return MaintainerState(engine=state_from_numpy(d, dev), params=params,
                           opt=opt)


# the baselines' columns: the II's walk matrix and index, the Tree's four
# triplet columns
II_FIELDS = {"walks": "u32", "index.vw": "u64", "index.offsets": "i32"}
TREE_FIELDS = {"owner": "u32", "walk": "u32", "pos": "u32", "nxt": "u32"}
GRAPH_FIELDS = {k: v for k, v in FIELDS.items() if k.startswith("graph.")}


def baseline_from_numpy(d: dict, cfg: WalkConfig, device=None,
                        rewalk_capacity: int = 1024):
    """The graph fields of `FIELDS` plus II_FIELDS (an `IIEngine`) or
    TREE_FIELDS (a `TreeEngine`) as numpy arrays -> the port's engine."""
    from repro_torch.core.baselines import IIEngine, InvertedIndex, TreeEngine
    dev = resolve_device(device)
    cols = II_FIELDS if "walks" in d else TREE_FIELDS
    t = {k: _FROM[kind](d[k], device=dev)
         for k, kind in {**GRAPH_FIELDS, **cols}.items()}
    graph = _graph(t, d)
    if "walks" in d:
        index = InvertedIndex(t["index.vw"], t["index.offsets"])
        return IIEngine(graph, t["walks"], index, cfg,
                        rewalk_capacity=rewalk_capacity)
    return TreeEngine(graph, *(t[k] for k in TREE_FIELDS), cfg,
                      rewalk_capacity=rewalk_capacity)


def baseline_to_numpy(eng) -> dict:
    """An `IIEngine` or `TreeEngine` -> the dict `baseline_from_numpy`
    reads, in the reference's dtypes."""
    cols = II_FIELDS if hasattr(eng, "walks") else TREE_FIELDS
    out = {"graph.n_vertices": eng.graph.n_vertices}
    for k, kind in {**GRAPH_FIELDS, **cols}.items():
        obj, _, name = k.rpartition(".")
        val = getattr(getattr(eng, obj) if obj else eng, name)
        out[k] = _TO[kind](val)
    return out


def wharf_config_from(cfg):
    """A reference `WharfStreamConfig` -> the port's, its FINDNEXT,
    intersect and megakernel backends under the port's names."""
    from repro_torch.configs.wharf_stream import WharfStreamConfig
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(WharfStreamConfig)}
    for k in ("find_next_backend", "intersect_backend"):
        kw[k] = BACKEND_NAMES[kw[k]]
    kw["megakernel"] = MEGAKERNEL_NAMES[kw["megakernel"]]
    return WharfStreamConfig(**kw)


# the fields of a sharded engine state that are per shard; the rest of
# SCALARS (the sizes) are one value for all shards
SHARD_SCALARS = ("n_pending", "epoch", "overflow")


def shard_states_from_numpy(d: dict, device=None) -> list:
    """The reference's [S, ...]-stacked sharded `EngineState` as the dict
    of `state_from_numpy` with a leading shard axis on every FIELDS entry
    and on SHARD_SCALARS -> the S shard states of `distr.sharded`, shard
    k at index k."""
    def shard(k):
        return {x: v[k] if x in FIELDS or x in SHARD_SCALARS else v
                for x, v in d.items()}
    return [state_from_numpy(shard(k), device)
            for k in range(len(d["graph.codes"]))]


def shard_states_to_numpy(states: list) -> dict:
    """The inverse of `shard_states_from_numpy`."""
    dicts = [state_to_numpy(s) for s in states]
    out = {k: np.stack([x[k] for x in dicts]) for k in (*FIELDS, *SHARD_SCALARS)}
    out.update({k: dicts[0][k] for k in SCALARS if k not in SHARD_SCALARS})
    return out


def _model_leaf(a, dtype: torch.dtype, shape, name: str, dev) -> torch.Tensor:
    """One numpy leaf -> a tensor of `dtype`, bit for bit: bf16 from its
    uint16 bits, float32 as is; the shape must be `shape`."""
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")
    if dtype == torch.bfloat16:
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        if a.dtype != np.uint16:
            raise TypeError(f"{name}: bf16 bits come as uint16, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    if a.dtype != np.float32 or dtype != torch.float32:
        raise TypeError(f"{name}: {a.dtype} for a {dtype} leaf")
    return torch.from_numpy(a.copy()).to(dev)


def _model_tree_to_numpy(tree) -> dict:
    """A parameter tree -> the same tree of numpy arrays (bf16 leaves as
    their uint16 bits)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return rebuild(tree, {k: leaf(v) for k, v in leaf_paths(tree).items()})


def lm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The reference transformer's parameter tree as numpy ({"embed",
    "final_ln", ["unembed"], "layers": {name: [L, ...]}}) -> the port's,
    each leaf in the shape and dtype `cfg` gives it
    (`transformer.param_specs`)."""
    from repro_torch.models.transformer import param_specs
    dev = resolve_device(device)
    specs = leaf_paths(param_specs(cfg))
    got = leaf_paths(tree)
    if set(got) != set(specs):
        raise ValueError(f"leaves {sorted(got)} != {sorted(specs)}")
    return rebuild(tree, {k: _model_leaf(got[k], m.dtype, m.shape, k, dev)
                          for k, m in specs.items()})


def lm_params_to_numpy(params: dict) -> dict:
    """The inverse of `lm_params_from_numpy`."""
    return _model_tree_to_numpy(params)


def dlrm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The reference DLRM's parameter tree as numpy ({"tables", "bot":
    [{"w", "b"}, ...], "top": [...]}) -> the port's, in `cfg.dtype`."""
    dev = resolve_device(device)
    return rebuild(tree, {k: _model_leaf(v, cfg.dtype, np.shape(v), k, dev)
                          for k, v in leaf_paths(tree).items()})


def dlrm_params_to_numpy(params: dict) -> dict:
    """The inverse of `dlrm_params_from_numpy`."""
    return _model_tree_to_numpy(params)


def gnn_params_from_numpy(tree, arch: str, cfg, device=None):
    """The reference GNN's parameter tree of `arch` as numpy (dicts and
    lists as the reference's init builds them) -> the port's, each leaf in
    the shape and dtype `cfg` gives it (`gnn.param_specs`)."""
    from repro_torch.models.gnn import param_specs
    dev = resolve_device(device)
    specs = leaf_paths(param_specs(arch, cfg))
    got = leaf_paths(tree)
    if set(got) != set(specs):
        raise ValueError(f"leaves {sorted(got)} != {sorted(specs)}")
    return rebuild(tree, {k: _model_leaf(got[k], m.dtype, m.shape, k, dev)
                          for k, m in specs.items()})


def gnn_params_to_numpy(params) -> dict:
    """The inverse of `gnn_params_from_numpy`."""
    return _model_tree_to_numpy(params)
