"""Random-walk models (paper §3.2); port of `repro/core/walkers.py`.

DeepWalk (order 1) steps to a uniform neighbor of the current vertex v.
node2vec(p, q) (order 2) weighs each neighbor x of v by

    alpha(prev, x) = 1/p  if x == prev
                     1    if x is a neighbor of prev
                     1/q  otherwise

with two samplers, chosen by `WalkModel.sampler`:

  * "rejection": propose a uniform neighbor, accept with probability
    alpha / alpha_max; a fixed number of trials, first acceptance wins,
    the last proposal otherwise (approximate, as in the reference).
  * "factorized": exact. The three groups are sampled by aggregate mass,
    then a member uniformly (kernels/intersect.py, kernel 5 on the card,
    which reads the CSR segments of v and prev itself). Windows are `dmax`
    wide: lanes where deg(v) or deg(prev) exceed dmax take the rejection
    sampler with per-lane keys fold_in(key, lane), so a lane's draws
    depend on (key, lane) alone and the overflowed lanes are compacted
    (`rejection_fallback`).

The reference runs its trials in a `lax.scan`; every trial's draws come
from keys fixed before the first trial, so the port draws all trials at
once and takes the first acceptance: the same selections.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.kernels import intersect

F64 = torch.float64


class WalkModel(NamedTuple):
    """order=1 -> DeepWalk; order=2 -> node2vec(p, q).

    sampler: order-2 backend, "rejection" or "factorized"; dmax: the
    factorized window width (lanes with a larger degree fall back to
    rejection)."""

    order: int = 1
    p: float = 1.0
    q: float = 1.0
    n_trials: int = 8
    sampler: str = "rejection"
    dmax: int = 128


DEEPWALK = WalkModel(order=1)


def check_model(model: WalkModel) -> None:
    if model.order not in (1, 2):
        raise ValueError(f"walk order {model.order}: 1 (DeepWalk) or 2 "
                         "(node2vec)")
    if model.order == 2 and model.sampler not in ("rejection", "factorized"):
        raise ValueError(f"unknown order-2 sampler {model.sampler!r}; "
                         f"expected 'rejection' or 'factorized'")


def deepwalk_step(key, graph, v):
    """v: int64 [B] current vertices -> int64 [B] next vertices."""
    return graph.sample_neighbor(key, v)


def _alpha_max(p: float, q: float) -> float:
    return max(max(1.0 / p, 1.0), 1.0 / q)


def _accept_first(graph, x, u, prev, p: float, q: float, dim: int):
    """The rejection trials' outcome: proposals x and f64 uniforms u, trials
    along `dim`. A trial accepts when u * alpha_max <= alpha(prev, x) (f64,
    as the reference under x64); the first acceptance wins, else the last
    proposal."""
    alpha = torch.where(
        x == prev, torch.tensor(1.0 / p, dtype=F64, device=x.device),
        torch.where(graph.has_edge(prev, x),
                    torch.tensor(1.0, dtype=F64, device=x.device),
                    torch.tensor(1.0 / q, dtype=F64, device=x.device)))
    accept = u * _alpha_max(p, q) <= alpha
    n = x.shape[dim]
    first = torch.argmax(accept.to(torch.int8), dim=dim, keepdim=True)
    pick = torch.where(accept.any(dim=dim, keepdim=True), first, n - 1)
    return torch.gather(x, dim, pick).squeeze(dim)


def _node2vec_step(key, graph, v, prev, p, q, n_trials: int):
    """K-trial rejection over the whole batch: trial t draws from
    split(split(key, K)[t]) at the batch's shape."""
    if n_trials == 0:
        return v
    ks = jr.split(jr.split(key, n_trials), 2)         # [K, 2, 2]
    x = graph.sample_neighbor(ks[:, 0], v)             # [K, B]
    u = jr.uniform(ks[:, 1], v.shape, F64)
    return _accept_first(graph, x, u, prev[None], p, q, dim=0)


def _node2vec_step_perlane(key, graph, v, prev, p, q, n_trials: int,
                           lane_ids):
    """Rejection with every draw keyed by fold_in(key, lane_id): a lane's
    selection is the same in any batch it is evaluated in."""
    if n_trials == 0:
        return v
    lane_keys = jr.fold_in(key, lane_ids)                  # [L, 2]
    ks = jr.split(jr.split(lane_keys, n_trials), 2)        # [L, K, 2, 2]
    x = graph.sample_neighbor_per_key(ks[:, :, 0], v[:, None])   # [L, K]
    u = jr.uniform(ks[:, :, 1], (), F64)
    return _accept_first(graph, x, u, prev[:, None], p, q, dim=1)


def rejection_fallback(key, graph, v, prev, overflow, nxt, p, q,
                       n_trials: int):
    """Replace `nxt` on the overflowed lanes with per-lane rejection
    samples. The reference compacts them into a side batch under
    `lax.cond` tiers that are bit-identical to a whole-batch re-run; the
    port compacts exactly the overflowed lanes (same draws, keyed by lane)."""
    lanes = torch.nonzero(overflow).reshape(-1)
    if lanes.numel() == 0:
        return nxt
    out = nxt.clone()
    out[lanes] = _node2vec_step_perlane(key, graph, v[lanes], prev[lanes], p,
                                        q, n_trials, lanes)
    return out


def _neighbor_window(graph, v, dmax: int):
    """Sentinel-padded neighbor windows: (int64 [B, dmax], deg int64 [B]),
    the first min(deg, dmax) CSR neighbors of each vertex (sorted)."""
    return intersect.neighbor_window(graph.codes, graph.offsets, v, dmax)


def _node2vec_factorized_step(key, graph, v, prev, p, q, n_trials: int,
                              dmax: int, backend=None):
    """The exact order-2 step. The two uniforms per lane come from one half
    of split(key), the rejection fallback takes the other, so the selection
    is the same on every backend and whether or not a lane overflowed. On
    the card the kernel reads the CSR segments of v and prev; elsewhere
    their windows are built (`intersect.factorized_next_csr`)."""
    k_u, k_fb = jr.split(key)
    u = jr.uniform(k_u, (v.shape[0], 2), torch.float32)
    nxt, found, overflow = intersect.factorized_next_csr(
        graph.codes, graph.offsets, v, prev, u, dmax, p, q, backend=backend)
    nxt = torch.where(found, nxt, v)   # isolated vertices stay in place
    return rejection_fallback(k_fb, graph, v, prev, overflow, nxt, p, q,
                              n_trials)


def sample_next_sharded(key, graph, v, model: WalkModel):
    """SAMPLENEXT over the FULL lane vector against a vertex-range-local
    graph: the per-shard half of the sharded rewalk (distr/sharded.py).

    A lane's draw of `deepwalk_step` depends only on (key, lane index),
    not on the other lanes' degrees, so every shard calls this with the
    same key and the same [capacity] lanes as the single-device rewalk;
    the lanes whose current vertex the shard owns come out as the
    single-device draw, the others are masked by the caller. Folding the
    shard into the key would change the stream. Order 2 needs N(prev),
    which another shard may own: it raises, as in the reference."""
    if model.order != 1:
        raise NotImplementedError(
            "sharded SAMPLENEXT is order-1 (DeepWalk) only: order-2 biases "
            "need N(prev), which may be owned by another shard")
    return deepwalk_step(key, graph, v)


def sample_next(key, graph, v, prev, model: WalkModel):
    """SAMPLENEXT (paper Alg. 2 line 8), vectorized over walkers."""
    if model.order == 1:
        return deepwalk_step(key, graph, v)
    check_model(model)
    if model.sampler == "factorized":
        return _node2vec_factorized_step(
            key, graph, v, prev, model.p, model.q, model.n_trials, model.dmax,
            intersect.default_backend_request())
    return _node2vec_step(key, graph, v, prev, model.p, model.q,
                          model.n_trials)
