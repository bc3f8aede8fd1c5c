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
    """sqrt of the sum of squares over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


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


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping -> (params, state, gnorm)."""
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
    gnorm, step, upd = _adamw_math(grads, state, cfg)
    g, m, v, p = (leaf_paths(t) for t in (grads, state.m, state.v, params))
    for k in g:
        for dst, src in zip((p[k], m[k], v[k]), upd(g[k], m[k], v[k], p[k])):
            dst.copy_(src)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
