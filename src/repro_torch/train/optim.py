"""AdamW as a plain transform of trees of tensors; port of
`repro/train/optim.py`.

Adam moments are kept in f32 whatever the parameters' dtype (mixed-
precision training), and the bias corrections b^step are taken in f32,
as the reference takes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaf_paths, rebuild, tree_leaves, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 []
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero f32 moments beside each parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32. Leaves that are
    DTensors (a partitioned step's gradients, placed as their parameters)
    are summed on their shards (`_sharded_sum_of_squares`)."""
    from torch.distributed.tensor import DTensor
    leaves = tree_leaves(tree)
    if any(isinstance(x, DTensor) for x in leaves):
        return torch.sqrt(_sharded_sum_of_squares(leaves))
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in leaves))


def _sharded_sum_of_squares(leaves) -> torch.Tensor:
    """The sum of squares of DTensor leaves without gathering one: each
    rank sums the squares of its shards, a leaf replicated over a mesh dim
    counted on that dim's first rank only, then one all-reduce over every
    rank of the mesh (a plain tensor, the same on every rank)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Shard
    mesh = next(x.device_mesh for x in leaves if hasattr(x, "device_mesh"))
    if mesh.size() != dist.get_world_size():
        raise ValueError("the gradients' mesh must span every rank")
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=F32, device=leaves[0].to_local().device)
    for x in leaves:
        if any(isinstance(p, Partial) for p in x.placements):
            raise ValueError(f"unreduced gradient: {x.placements}")
        if any(c and not isinstance(p, Shard) for c, p in zip(coord, x.placements)):
            continue
        total = total + torch.sum(torch.square(x.to_local().to(F32)))
    return funcol.wait_tensor(funcol.all_reduce(total, "sum", dist.group.WORLD))


def _adamw_math(grads, state: AdamWState, cfg: AdamWConfig):
    """-> (gnorm, the next step count, the update of one leaf (g, m, v, p)
    -> (p, m, v)), global-norm clipping included."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    sf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=sf.device), sf)

    def upd(g, m, v, p):
        g = g.to(F32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - cfg.lr * delta).to(p.dtype), m, v

    return gnorm, step, upd


def placed_as(grads, params):
    """Each DTensor gradient redistributed to its parameter's placements
    (the partial sums of a sharded step reduced, reduce-scattered onto the
    FSDP shards); plain gradients unchanged."""
    from torch.distributed.tensor import DTensor

    def place(g, p):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return tree_map(place, grads, params)


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping -> (params, state, gnorm).
    On DTensors each leaf's update runs on its shards."""
    grads = placed_as(grads, params)
    gnorm, step, upd = _adamw_math(grads, state, cfg)
    g, m, v, p = (leaf_paths(t) for t in (grads, state.m, state.v, params))
    out = {k: upd(g[k], m[k], v[k], p[k]) for k in g}
    new_p, new_m, new_v = (rebuild(grads, {k: o[i] for k, o in out.items()})
                           for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm


def adamw_update_(grads, state: AdamWState, params, cfg: AdamWConfig):
    """`adamw_update` writing the new parameters and moments into the
    tensors of `params` and `state` in place, one leaf at a time -> (params,
    state, gnorm), the same values bit for bit. It holds one leaf's
    temporaries where `adamw_update` holds a second copy of the parameters
    and moments beside the first (26 GB at gemma2-2b's full width)."""
    grads = placed_as(grads, params)
    gnorm, step, upd = _adamw_math(grads, state, cfg)
    g, m, v, p = (leaf_paths(t) for t in (grads, state.m, state.v, params))
    for k in g:
        for dst, src in zip((p[k], m[k], v[k]), upd(g[k], m[k], v[k], p[k])):
            dst.copy_(src)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
