"""Random-walk models (paper §3.2); port of `repro/core/walkers.py`.

This slice ports order 1 (DeepWalk: uniform over the current neighbors).
Order 2 (node2vec's rejection and factorized samplers, the latter on the
intersect kernel) is ported in a later slice and raises here.
"""
from __future__ import annotations

from typing import NamedTuple


class WalkModel(NamedTuple):
    """order=1 -> DeepWalk; order=2 -> node2vec(p, q) (later slice)."""

    order: int = 1
    p: float = 1.0
    q: float = 1.0
    n_trials: int = 8
    sampler: str = "rejection"
    dmax: int = 128


DEEPWALK = WalkModel(order=1)


def check_order(model: WalkModel) -> None:
    if model.order != 1:
        raise NotImplementedError(
            "repro_torch ports order-1 (DeepWalk) walks only; order-2 "
            "(node2vec) sampling comes with the intersect-kernel slice")


def deepwalk_step(key, graph, v):
    """v: int64 [B] current vertices -> int64 [B] next vertices."""
    return graph.sample_neighbor(key, v)


def sample_next(key, graph, v, prev, model: WalkModel):
    """SAMPLENEXT (paper Alg. 2 line 8), vectorized over walkers."""
    check_order(model)
    return deepwalk_step(key, graph, v)
