"""Personalized PageRank from maintained walks (paper §7.6, Bahmani et al.
[2]); port of `repro/core/ppr.py`.

PPR(u, v) is estimated as the visit frequency of v over the
restart-truncated walks that start at u.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def ppr_scores(walk_matrix: torch.Tensor, n_vertices: int,
               restart_prob: float = 0.2) -> torch.Tensor:
    """f32 [n, n] PPR rows of every start vertex from a [n_walks, l] walk
    matrix (walk w starts at walk_matrix[w, 0]); row u is normalized to sum
    to 1 (0 rows stay 0).

    The reference scatter-adds every (start, visited) weight in one call.
    Here the weights are added one position at a time, an accumulating
    `index_put_` per p: within one call every add into a cell adds the same
    w_p, so in whatever order the card's threads add them the sum has the
    same bits, the CPU's bits too. The row sums are each device's own
    reduction: the table is deterministic on a device (two builds from one
    matrix are bit-identical), and the card's and the CPU's agree within a
    few f32 ulps, as the reference's order of adds does.
    """
    n_walks, length = walk_matrix.shape
    dev = walk_matrix.device
    # geometric survival weights (1 - alpha)^p: the f32 power of the f32
    # base, as the reference takes it, made on the host so that every
    # device adds the same values
    base = np.float32(1.0 - restart_prob)
    w_pos = torch.from_numpy(np.power(base, np.arange(length, dtype=np.float32),
                                      dtype=np.float32)).to(dev)
    rows = walk_matrix[:, 0].to(torch.int64)
    scores = torch.zeros((n_vertices, n_vertices), dtype=F32, device=dev)
    for p in range(length):
        scores.index_put_((rows, walk_matrix[:, p].to(torch.int64)),
                          w_pos[p].expand(n_walks), accumulate=True)
    denom = torch.clamp(scores.sum(dim=1, keepdim=True), min=1e-9)
    return scores / denom


def smape(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9,
          min_score: float = 0.0) -> torch.Tensor:
    """Symmetric mean absolute percentage error (paper Fig. 1b / 13b) over
    the entries with b >= min_score (at small walk counts the near-zero
    tail is sampling noise for any estimator)."""
    num = (a - b).abs()
    den = (a.abs() + b.abs()) / 2.0 + eps
    mask = ((a.abs() + b.abs()) > eps) & (b >= min_score)
    total = torch.where(mask, num / den, torch.zeros_like(num)).sum()
    return 100.0 * total / torch.clamp(mask.sum(), min=1)
