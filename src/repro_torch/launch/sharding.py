"""Sharding rules per model family (port of `repro/launch/sharding.py`).

Conventions, as the reference's: `FSDP` = "data" (parameter and optimizer
sharding, ZeRO-style), `TP` = "model" (tensor/expert/vocab/row parallel),
the batch over ("pod", "data") on the multi-pod mesh. Each rule returns a
tree of `P` specs shaped like the parameter tree, one entry a tensor dim
(a mesh dim name, a tuple of them, or None), as the reference's
PartitionSpecs; `named` turns a spec tree into `NamedSharding`s on a
`DeviceMesh`, each holding the DTensor placements of its spec, one a mesh
dim (`Shard(d)` where tensor dim d is split over that mesh dim, else
`Replicate()`), as `distr/engine.py::wharf_placements` does. Nothing here
applies a placement to a tensor.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.tree import leaf_paths, rebuild

FSDP = "data"
TP = "model"


class P:
    """A PartitionSpec: per tensor dim a mesh dim name, a tuple of mesh
    dim names (major to minor), or None. A leaf of the port's trees."""

    def __init__(self, *spec):
        self.spec = tuple(tuple(s) if isinstance(s, list) else s for s in spec)

    def __eq__(self, other):
        return isinstance(other, P) and self.spec == other.spec

    def __repr__(self):
        return f"P{self.spec}"


def placements(spec: P, mesh_dim_names) -> Tuple[Any, ...]:
    """The DTensor placements of `spec` on a mesh with these dim names,
    one a mesh dim. A tensor dim split over several mesh dims must name
    them in mesh order (DTensor shards them major to minor); a name the
    mesh lacks is skipped, as the reference's `batch_axes` never names
    one."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh_dim_names)
    for d, axes in enumerate(spec.spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        idx = [mesh_dim_names.index(a) for a in axes if a in mesh_dim_names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: tensor dim {d} names mesh dims out of "
                             f"mesh order {mesh_dim_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh dim {mesh_dim_names[i]} "
                                 f"shards two tensor dims")
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh: `placements` are its DTensor placements."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec
        self.placements = placements(spec, mesh.mesh_dim_names)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec}, {self.placements})"


def _map_specs(fn, tree):
    return rebuild(tree, {k: fn(v) for k, v in leaf_paths(tree).items()})


def named(mesh, pspec_tree):
    return _map_specs(lambda ps: NamedSharding(mesh, ps), pspec_tree)


def replicated(mesh, tree):
    return _map_specs(lambda _: NamedSharding(mesh, P()), tree)


# ------------------------------------------------------------------ LM rules


def lm_param_pspecs(cfg, tp_size: int = 16) -> Dict[str, Any]:
    """FSDP x TP rules. MoE: expert-parallel when n_experts % tp == 0, else
    tensor-parallel inside each expert (qwen2-moe's 60 experts vs tp=16)."""
    layer: Dict[str, Any] = {
        "wq": P(None, FSDP, TP),
        "wk": P(None, FSDP, TP),
        "wv": P(None, FSDP, TP),
        "wo": P(None, TP, FSDP),
        "ln1": P(None, None),
        "ln2": P(None, None),
    }
    if cfg.qkv_bias:
        layer.update({"bq": P(None, TP), "bk": P(None, TP), "bv": P(None, TP)})
    if cfg.moe:
        if cfg.moe.e_padded % tp_size == 0:
            layer.update({
                "router": P(None, FSDP, None),
                "we_gate": P(None, TP, FSDP, None),
                "we_up": P(None, TP, FSDP, None),
                "we_down": P(None, TP, None, FSDP),
            })
        else:
            layer.update({
                "router": P(None, FSDP, None),
                "we_gate": P(None, None, FSDP, TP),
                "we_up": P(None, None, FSDP, TP),
                "we_down": P(None, None, TP, FSDP),
            })
        if cfg.moe.n_shared:
            layer.update({
                "ws_gate": P(None, FSDP, TP),
                "ws_up": P(None, FSDP, TP),
                "ws_down": P(None, TP, FSDP),
            })
    else:
        layer.update({
            "w_gate": P(None, FSDP, TP),
            "w_up": P(None, FSDP, TP),
            "w_down": P(None, TP, FSDP),
        })
    out = {"embed": P(TP, FSDP), "final_ln": P(None), "layers": layer}
    if not cfg.tie_embeddings:
        out["unembed"] = P(FSDP, TP)
    return out


def lm_cache_pspec(cfg, shape_info, mesh) -> P:
    """KV cache [L, B, T, NKV, D] rules per decode shape."""
    names = mesh.mesh_dim_names
    batch = ("pod", "data") if "pod" in names else ("data",)
    if shape_info["global_batch"] == 1:
        # long-context single stream: shard the cache length everywhere useful
        seq_axes = tuple(a for a in ("pod", "data", "model") if a in names)
        return P(None, None, seq_axes, None, None)
    if cfg.n_kv_heads % 16 == 0:
        return P(None, batch, None, TP, None)
    return P(None, batch, TP, None, None)  # shard cache length over model


def opt_pspecs(param_pspecs):
    """Adam m/v shard exactly like their params; step is replicated."""
    return {"step": P(), "m": param_pspecs, "v": param_pspecs}


# ------------------------------------------------------------------ GNN/recsys


def gnn_param_pspecs(params_shape) -> Any:
    """GNN params are small: replicate (activations carry the scale)."""
    return _map_specs(lambda _: P(), params_shape)


def dlrm_param_pspecs(params_shape) -> Dict[str, Any]:
    """Row-shard the embedding tables over TP; MLPs replicate."""
    pspecs = _map_specs(lambda _: P(), params_shape)
    pspecs["tables"] = P(None, TP, None)
    return pspecs
