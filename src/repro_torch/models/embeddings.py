"""Skip-gram with negative sampling (SGNS) over Wharf-maintained walks;
port of `repro/models/embeddings.py`.

The paper's downstream consumer (§7.6): pairs are drawn from walk windows
and trained on log σ(u·v+) + Σ log σ(-u·v-); after a batch update only the
affected walks' windows are trained again (`vskip`). The fused step goes
through the kernels/sgns.py registry: the CUDA kernel on the card, the
same math in torch on the CPU. Vertex ids and pair indices are int64.

`train_epoch` (it needs `jax.random.permutation`) and `logistic_eval` (a
probe) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import random as jr

F32 = torch.float32
I64 = torch.int64


@dataclass(frozen=True)
class SGNSConfig:
    n_vertices: int
    dim: int = 128
    window: int = 5
    n_negative: int = 5
    lr: float = 0.05
    dtype: Any = F32


def sgns_init(key, cfg: SGNSConfig):
    """A normal input table scaled by 1/sqrt(dim) and a zero output table,
    on the key's device."""
    k1, _ = jr.split(key)
    return {
        "in": (jr.normal(k1, (cfg.n_vertices, cfg.dim))
               * (1.0 / cfg.dim ** 0.5)).to(cfg.dtype),
        "out": torch.zeros((cfg.n_vertices, cfg.dim), dtype=cfg.dtype,
                           device=key.device),
    }


def window_pairs(walks, window: int):
    """All (center, context) pairs within ±window from a [W, L] walk matrix."""
    centers, contexts = [], []
    for off in range(1, window + 1):
        centers.append(walks[:, :-off].reshape(-1))
        contexts.append(walks[:, off:].reshape(-1))
        centers.append(walks[:, off:].reshape(-1))
        contexts.append(walks[:, :-off].reshape(-1))
    return torch.cat(centers), torch.cat(contexts)


def n_window_pairs(length: int, window: int) -> int:
    """Ordered in-window pairs per walk: 2 * Σ_{off=1..window} (l - off)."""
    return 2 * sum(length - off for off in range(1, min(window, length - 1) + 1))


def window_pair_index(length: int, window: int, device=None):
    """Per-walk pair positions (c_pos, x_pos) int64 [P_walk]: row j of a
    [W, L] walk matrix yields pair j*P_walk+k as (walks[j, c_pos[k]],
    walks[j, x_pos[k]]), in the reference's order."""
    c, x = [], []
    for off in range(1, min(window, length - 1) + 1):
        for i in range(length - off):
            c += [i, i + off]
            x += [i + off, i]
    return (torch.tensor(c, dtype=I64, device=device),
            torch.tensor(x, dtype=I64, device=device))


def affected_pairs(walks, lane_valid, p_min, window: int,
                   skip_stale_prefix: bool = True):
    """Skip-gram pairs of affected walks, masked for incremental training.

    walks int64 [W, L] (overlay reads of the affected walks), lane_valid
    bool [W], p_min int [W] (first re-sampled position). Returns (centers,
    contexts int64 [W*P_walk], mask bool): a pair is trained iff its lane
    is valid and (unless `skip_stale_prefix=False`) its window touches the
    re-walked suffix [p_min, L)."""
    length = walks.shape[1]
    c_pos, x_pos = window_pair_index(length, window, walks.device)
    centers = walks[:, c_pos]
    contexts = walks[:, x_pos]
    mask = lane_valid[:, None].expand(centers.shape)
    if skip_stale_prefix:
        mask = mask & (torch.maximum(c_pos, x_pos)[None, :] >= p_min[:, None])
    return centers.reshape(-1), contexts.reshape(-1), mask.reshape(-1)


def sgns_loss(params, centers, contexts, negatives):
    """centers/contexts [B], negatives [B, K] -> the loss SUMMED over pairs
    (word2vec applies per-pair updates)."""
    u = params["in"][centers]
    vp = params["out"][contexts]
    vn = params["out"][negatives]
    pos = (u * vp).sum(-1)
    neg = (u[:, None, :] * vn).sum(-1)
    logsig = torch.nn.functional.logsigmoid
    return -(logsig(pos).sum() + logsig(-neg).sum())


def masked_sgns_step(params, centers, contexts, negatives, mask, lr,
                     backend=None):
    """One fused SGNS step over a masked pair batch.

    The per-pair gradients come from the kernels/sgns.py registry and are
    scatter-added into new tables (`index_add`; the given tables are not
    written): grad-of-sum-loss over the live pairs. Masked-out pairs add
    zeros. On the card the scatter-add uses atomics, so the f32 sums of
    rows that several pairs hit are taken in an order that changes from
    run to run. Returns (params, loss_sum, n_pairs) over the live pairs."""
    from repro_torch.kernels.sgns import sgns_apply
    u = params["in"][centers]                       # [B, D]
    vp = params["out"][contexts]                    # [B, D]
    vn = params["out"][negatives]                   # [B, K, D]
    loss, du, dvp, dvn = sgns_apply(u, vp, vn, backend)
    del u, vp, vn       # free each operand before the next temporary: GBs at 2^20 pairs
    m = mask.to(params["in"].dtype)
    step = -torch.as_tensor(lr, dtype=params["in"].dtype, device=m.device)
    new_in = params["in"].index_add(0, centers, step * du * m[:, None])
    del du
    new_out = params["out"].index_add(0, contexts, step * dvp * m[:, None])
    del dvp
    new_out.index_add_(0, negatives.reshape(-1),
                       (step * dvn * m[:, None, None]).reshape(-1, dvn.shape[-1]))
    return ({"in": new_in, "out": new_out}, (loss * m).sum(), mask.sum())


def sgns_step(params, centers, contexts, negatives, lr):
    """One plain SGD step on the summed loss through autograd -> (params,
    mean loss per pair)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = sgns_loss(leaves, centers, contexts, negatives)
        grads = torch.autograd.grad(loss, [leaves["in"], leaves["out"]])
    new = {k: params[k] - lr * g.to(params[k].dtype)
           for k, g in zip(("in", "out"), grads)}
    return new, loss.detach() / centers.shape[0]
