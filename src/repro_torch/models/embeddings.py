"""Skip-gram with negative sampling (SGNS) over Wharf-maintained walks;
port of `repro/models/embeddings.py`.

The paper's downstream consumer (§7.6): pairs are drawn from walk windows
and trained on log σ(u·v+) + Σ log σ(-u·v-); after a batch update only the
affected walks' windows are trained again (`vskip`). The fused step goes
through the kernels/sgns.py registry: the CUDA kernel on the card, the
same math in torch on the CPU. Vertex ids and pair indices are int64.

`train_epoch` (a full retrain through autograd, as the reference) and
`logistic_eval` (the vertex-classification probe of §7.6) launch no
kernel.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch._device import resolve_device

F32 = torch.float32
I64 = torch.int64

NEG_SLAB = 64   # batches whose negatives `train_epoch` draws in one call


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


def train_epoch(key, params, walks, cfg: SGNSConfig, batch: int = 8192,
                walk_mask=None):
    """One pass over the window pairs of `walks` [W, L] in a random order,
    `batch` pairs a `sgns_step` (a tail shorter than `batch` is dropped)
    -> (params, mean of the batches' losses).

    With `walk_mask` (incremental mode) the kept walks are those of the
    mask, padded to W rows with copies of walk 0, as the reference's
    `jnp.nonzero(walk_mask, size=W, fill_value=0)` does: walk 0's pairs
    are trained once for every walk the mask leaves out.

    The batches' keys are split off one after another, as the reference
    splits them, on the host (two words each); their negatives are drawn
    for NEG_SLAB batches in one call, each batch's from its own key."""
    if walk_mask is not None:
        keep = torch.nonzero(walk_mask).reshape(-1)
        pad = torch.zeros((walks.shape[0] - keep.shape[0],), dtype=I64,
                          device=keep.device)
        walks = walks[torch.cat([keep, pad])]
    centers, contexts = window_pairs(walks, cfg.window)
    n = centers.shape[0]
    key, kp = jr.split(key)
    perm = jr.permutation(kp, n)
    centers, contexts = centers[perm].to(I64), contexts[perm].to(I64)
    starts = range(0, n - batch + 1, batch)
    host_key, neg_keys = key.cpu(), []
    for _ in starts:
        host_key, kn = jr.split(host_key)
        neg_keys.append(kn)
    losses = []
    for s0 in range(0, len(neg_keys), NEG_SLAB):
        ks = torch.stack(neg_keys[s0:s0 + NEG_SLAB]).to(key.device)
        negs = jr.randint(ks, (batch, cfg.n_negative), 0, cfg.n_vertices)
        for j, i in enumerate(starts[s0:s0 + NEG_SLAB]):
            params, loss = sgns_step(params, centers[i:i + batch],
                                     contexts[i:i + batch], negs[j], cfg.lr)
            losses.append(loss)
    mean_loss = (torch.stack(losses).mean() if losses
                 else torch.zeros((), dtype=F32, device=key.device))
    return params, mean_loss


@contextlib.contextmanager
def _no_tf32():
    """f32 products on the card without TF32, as the reference's f32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def logistic_probe(x, y, tr, steps: int = 300, lr: float = 0.5):
    """Full-batch gradient descent on the softmax cross-entropy of a linear
    probe over rows `tr` of `x` (f32 [n, d]) with labels `y` -> weights f32
    [d, n_classes]. The gradient in closed form, x^T (softmax - onehot) /
    |tr|, in f32 (TF32 off), as the reference's f32 `jax.grad`."""
    n_cls = int(y.max()) + 1
    xt = x[tr]
    onehot = torch.nn.functional.one_hot(y[tr], n_cls).to(F32)
    w = torch.zeros((x.shape[1], n_cls), dtype=F32, device=x.device)
    with _no_tf32():
        for _ in range(steps):
            p = torch.softmax(xt @ w, dim=-1)
            w = w - lr * (xt.T @ ((p - onehot) / xt.shape[0]))
    return w


def logistic_eval(embeddings, labels, train_frac=0.7, seed=0, steps=300,
                  lr=0.5, device=None):
    """Multinomial logistic probe on embeddings (vertex classification)
    -> test accuracy as a Python float. The split is numpy's
    `default_rng(seed).permutation`, as the reference's; rows are
    normalised to unit length (norms floored at 1e-6). It runs on the
    embeddings' device when they are a tensor and `device` is None, else
    on `device` (the card unless the caller asks for the CPU)."""
    if isinstance(embeddings, torch.Tensor) and device is None:
        dev = embeddings.device
    else:
        dev = resolve_device(device)
    n = embeddings.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(n * train_frac)
    tr = torch.from_numpy(perm[:cut]).to(dev)
    te = torch.from_numpy(perm[cut:]).to(dev)
    x = torch.as_tensor(embeddings).to(device=dev, dtype=F32)
    x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-6)
    y = torch.as_tensor(labels).to(device=dev, dtype=I64)
    w = logistic_probe(x, y, tr, steps, lr)
    with _no_tf32():
        pred = torch.argmax(x[te] @ w, dim=1)
    # the reference's f32 mean: XLA divides by the constant count as a
    # product with its f32 reciprocal
    hits = (pred == y[te]).to(F32).sum()
    return float(hits * torch.tensor(1.0 / te.shape[0], dtype=F32, device=dev))
