"""int8 block-quantised gradients with error feedback, for the cross-pod
mean; port of `repro/train/compression.py`.

Gradients are quantised to int8 (a per-block f32 scale, 4x fewer bytes
than f32) before the reduction over the slower links; the quantisation
residual is fed back into the next step's gradient (error feedback keeps
SGD convergence: Seide et al. 2014, Karimireddy et al. 2019).
`cross_pod_mean_int8` runs over a `torch.distributed` group, one rank a
pod, as `distr/collectives.py` runs the sharded engine's collectives.

XLA divides by a constant as a product with its f32 reciprocal, so the
scales here are max * f32(1/127), as the reference computes them; and
its compiled cross-pod body contracts the residual g - q * scale into an
FMA (`random.fma32`), where its eager `compress_tree` rounds twice.
`torch.round` and `jnp.round` both round half to even.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.random import fma32
from repro_torch.tree import leaf_paths, rebuild, tree_map

F32 = torch.float32
BLOCK = 256


def _inv127(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(1.0 / 127.0, dtype=F32, device=like.device)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened, zero-padded to a multiple of BLOCK -> f32 [-1, BLOCK]."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=x.dtype,
                                            device=x.device)])
    return flat.reshape(-1, BLOCK).to(F32)


def _codes(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)


def quantize_int8(x):
    """f32 [..] -> (int8 codes [-1, BLOCK], f32 per-block scales [-1, 1])."""
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1, keepdim=True) * _inv127(x) + 1e-12
    return _codes(blocks, scale), scale


def dequantize_int8(q, scale, shape):
    blocks = q.to(F32) * scale
    return blocks.reshape(-1)[:_numel(shape)].reshape(shape)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def compress_tree(grads, error_feedback):
    """Quantise grads (+ the carried error) -> (tree of (q, scale), new
    error)."""
    g, e = leaf_paths(grads), leaf_paths(error_feedback)
    qs, errs = {}, {}
    for k in g:
        g32 = g[k].to(F32) + e[k]
        q, s = quantize_int8(g32)
        qs[k] = (q, s)
        errs[k] = g32 - dequantize_int8(q, s, g[k].shape)  # next step's feedback
    return rebuild(grads, qs), rebuild(grads, errs)


def decompress_tree(q_tree, grads_template):
    qp = leaf_paths(q_tree)     # a (codes, scales) pair at each leaf path
    out = {}
    for k, g in leaf_paths(grads_template).items():
        q, s = (qp[f"{k}/{i}" if k else str(i)] for i in (0, 1))
        out[k] = dequantize_int8(q, s, g.shape).to(g.dtype)
    return rebuild(grads_template, out)


def zeros_error_feedback(grads_template):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device),
                    grads_template)


def cross_pod_mean_int8(grads, error_feedback, group=None):
    """Mean of int8-quantised grads over the ranks of `group` (each rank a
    pod) -> (mean tree, this rank's error feedback).

    Every rank quantises against a SHARED per-block scale (the MAX
    all_reduce of the local block maxima, a small f32 collective), so the
    SUM all_reduce of the int32 codes is exact on the quantisation grid;
    the error feedback carries this rank's own quantisation residual."""
    n = float(dist.get_world_size(group))
    g, e = leaf_paths(grads), leaf_paths(error_feedback)
    outs, errs = {}, {}
    for k in g:
        shape = g[k].shape
        g32 = g[k].to(F32) + e[k]
        blocks = _blocks(g32)
        scale = blocks.abs().amax(dim=1, keepdim=True)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        scale = scale * _inv127(scale) + 1e-12
        q = _codes(blocks, scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.to(F32) * scale / n
        outs[k] = mean.reshape(-1)[:_numel(shape)].reshape(shape).to(g[k].dtype)
        # g32 - q * scale: the reference's jitted body contracts the
        # product and the difference into one FMA
        err = fma32(-q.to(F32), scale, blocks)
        errs[k] = err.reshape(-1)[:_numel(shape)].reshape(shape)
    return rebuild(grads, outs), rebuild(grads, errs)
