"""Cell plans: (step function, abstract inputs, shardings, analytic FLOPs)
for every (architecture x input shape) cell, the step the shape's `kind`
dictates (train / prefill / decode / serve / retrieval / walk-update);
port of `repro/launch/steps.py`.

A plan's `args` stand in for the reference's `jax.ShapeDtypeStruct`s:
tensors on the `meta` device with the reference's shapes, so that no plan
allocates, however wide its model. Parameter shapes come from each model's
init on a meta key (`repro_torch.random` draws nothing there) or from
`transformer.param_specs`. Dtypes are the port's: a PRNG key is int64 [2]
(`repro_torch.random`; the reference's is uint32 [2]), and the wharf
plans' u64 codes are biased int64 and their u32 columns int32
(`repro_torch/_u64.py`).

Without a mesh (`mesh=None`, one card) `in_shardings` and `out_shardings`
are None and `_lm_train_plan`'s batch lies on one shard, so it accumulates
one sequence a microbatch. With a `DeviceMesh` (`launch/mesh.py`) they are
the reference's sharding trees as `sharding.NamedSharding`s (DTensor
placements, one a mesh dim), and the microbatch count follows the mesh's
batch dims. `partition(plan, mesh)` applies them: the args become DTensors
and the step runs as one rank's partition (the models' DTensor paths).

As in the reference, the minibatch plan (`_gnn_sampled_plan`) trains no
weight but GraphSAGE's: its loss of the other archs runs the forward on
the step's `params`, not on the differentiated `p`, so their gradient is
zero and AdamW moves the weights by weight decay alone. The port runs that
forward without autograd and returns zero gradients.

The wharf family's plans (`_wharf_plan`) keep three reference behaviours:
smoke plans keep the shape's `batch_edges`, not the smoke config's; the
walk-update plans default `merge_impl` to "lexsort"; and a plan of a
config with an explicit backend installs it process-wide
(`WharfStreamConfig.install_backends`), so `stream_10k_n2v_megakernel`
turns the fused step on ("cuda") for the whole process.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import batch_axes, mesh_size
from repro_torch.launch.op_analysis import uniform_loop
from repro_torch.launch.sharding import NamedSharding, P
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.act_sharding import (constrain, cut, from_local, is_dtensor, on_mesh,
                                             reshard, row_lookup, whole)
from repro_torch.train.optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                                    placed_as)
from repro_torch.tree import leaf_paths, rebuild, tree_map

F32 = torch.float32
I32 = torch.int32
KEY = torch.int64           # the port's PRNG key words (repro_torch.random)
U32 = torch.int32           # a u32 column's bits (repro_torch/_u64.py)
U64 = torch.int64           # a u64 code, biased


def S(shape, dtype) -> torch.Tensor:
    """An abstract input: a meta tensor of `shape` and `dtype`."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass
class CellPlan:
    arch: str
    shape: str
    step_name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Optional[Tuple[Any, ...]]
    out_shardings: Any
    model_flops: float          # analytic "useful" FLOPs (6·N_active·D etc.)
    donate_argnums: Tuple[int, ...] = ()
    static_argnums: Tuple[int, ...] = ()


def abstract_tree(tree):
    return tree_map(lambda x: S(x.shape, x.dtype), tree)


def _pad(n: int, mult: int = 512) -> int:
    """Round up to a shard multiple (the reference pads graph and candidate
    dims to its mesh sizes; masks carry validity)."""
    return -(-n // mult) * mult


def value_and_grad(fn, params):
    """(loss, gradient tree) of fn(params) through autograd. A leaf the
    loss does not reach gets a zero gradient (`jax.grad`'s), and so does
    every leaf of a loss that reaches none."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in leaf_paths(params).items()}
    loss = fn(rebuild(params, leaves))
    grads = [None] * len(leaves)
    if loss.requires_grad:
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), grads)]
    return loss.detach(), rebuild(params, dict(zip(leaves, grads)))


# ---------------------------------------------------------------------- LM


def _n_batch_shards(mesh) -> int:
    """The batch's shard count: the product of the mesh's batch dims (1
    without a mesh: the batch lies on one shard)."""
    n = 1
    if mesh is not None:
        for a in batch_axes(mesh):
            n *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return n


def _rep(mesh):
    return NamedSharding(mesh, P())


def _opt_shardings(mesh, p_shard):
    """AdamW's state: the step replicated, the moments as their params."""
    return AdamWState(step=_rep(mesh), m=p_shard, v=p_shard)


def _lm_train_plan(arch, cfg, info, mesh) -> CellPlan:
    opt_cfg = AdamWConfig()
    gb = info["global_batch"]
    # microbatching: 1 sequence per chip per microbatch (grad accumulation)
    n_micro = max(1, gb // _n_batch_shards(mesh))
    mb = gb // n_micro

    def train_step(params, opt_state, tokens):
        # microbatch i holds rows i, i + n_micro, ...: on a mesh each batch
        # shard's rows stay on it, one a microbatch (mb carries the batch
        # dims), and without one (mb = 1) these are rows i, as contiguous
        micro_tokens = tokens.reshape(mb, n_micro, tokens.shape[-1]).transpose(0, 1)
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
        lsum = on_mesh(torch.zeros((), dtype=F32, device=tokens.device), tokens)
        # every microbatch runs the same ops: a loop a counter may scale
        for batch in uniform_loop(micro_tokens):
            batch = constrain(batch, "batch", None)
            loss, grads = value_and_grad(lambda p: tfm.lm_loss(p, batch, cfg), params)
            # on a mesh each microbatch's gradients are reduced onto the
            # parameters' placements, so every iteration runs the same ops
            grads = placed_as(grads, params)
            gsum = tree_map(lambda a, g: a + g.to(F32), gsum, grads)
            lsum = lsum + loss
        div = torch.tensor(float(n_micro), dtype=F32, device=tokens.device)
        grads = tree_map(lambda g: g / div, gsum)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, lsum / div, gnorm

    params = tfm.param_specs(cfg)
    opt = adamw_init(params)
    tokens = S((info["global_batch"], info["seq_len"] + 1), I32)
    tokens_count = info["global_batch"] * info["seq_len"]
    flops = 6.0 * cfg.active_param_count() * tokens_count + _attn_flops(
        cfg, info["global_batch"], info["seq_len"], train=True)
    in_sh = out_sh = None
    if mesh is not None:
        ba = batch_axes(mesh)
        p_shard = shr.named(mesh, _expand(shr.lm_param_pspecs(cfg), params))
        o_shard = _opt_shardings(mesh, p_shard)
        in_sh = (p_shard, o_shard, NamedSharding(mesh, P(ba, None)))
        out_sh = (p_shard, o_shard, _rep(mesh), _rep(mesh))
    return CellPlan(arch, "train", "train_step", train_step,
                    (params, opt, tokens), in_sh, out_sh, flops, donate_argnums=(0, 1))


def _lm_prefill_plan(arch, cfg, info, mesh) -> CellPlan:
    b, s_len = info["global_batch"], info["seq_len"]

    def prefill(params, tokens):
        return tfm.prefill(params, tokens, cfg)

    flops = 2.0 * cfg.active_param_count() * b * s_len + _attn_flops(
        cfg, b, s_len, train=False)
    params = tfm.param_specs(cfg)
    in_sh = out_sh = None
    if mesh is not None:
        ba = batch_axes(mesh)
        p_shard = shr.named(mesh, _expand(shr.lm_param_pspecs(cfg), params))
        cache_sh = NamedSharding(mesh, shr.lm_cache_pspec(cfg, info, mesh))
        in_sh = (p_shard, NamedSharding(mesh, P(ba, None)))
        out_sh = (NamedSharding(mesh, P(ba, None)), {"k": cache_sh, "v": cache_sh})
    return CellPlan(arch, "prefill", "prefill", prefill,
                    (params, S((b, s_len), I32)), in_sh, out_sh, flops)


def _lm_decode_plan(arch, cfg, info, mesh) -> CellPlan:
    b, ctx = info["global_batch"], info["seq_len"]

    def serve_step(params, token, cache, cache_len):
        return tfm.decode_step(params, token, cache, cache_len, cfg)

    cache_shape = (cfg.n_layers, b, ctx, cfg.n_kv_heads, cfg.hd)
    cache = {"k": S(cache_shape, cfg.dtype), "v": S(cache_shape, cfg.dtype)}
    # decode: 2 FLOPs/param/token + attention reads 2*ctx*nh*hd*2 per layer
    attn = 4.0 * cfg.n_layers * b * ctx * cfg.n_heads * cfg.hd
    flops = 2.0 * cfg.active_param_count() * b + attn
    params = tfm.param_specs(cfg)
    in_sh = out_sh = None
    if mesh is not None:
        ba = batch_axes(mesh)
        p_shard = shr.named(mesh, _expand(shr.lm_param_pspecs(cfg), params))
        cache_ps = NamedSharding(mesh, shr.lm_cache_pspec(cfg, info, mesh))
        cache_sh = {"k": cache_ps, "v": cache_ps}
        tok_sh = NamedSharding(mesh, P(ba, None) if b > 1 else P())
        logits_sh = NamedSharding(mesh, P(ba, None, None) if b > 1 else P())
        in_sh = (p_shard, tok_sh, cache_sh, _rep(mesh))
        out_sh = (logits_sh, cache_sh)
    return CellPlan(arch, "decode", "serve_step", serve_step,
                    (params, S((b, 1), I32), cache, S((), I32)),
                    in_sh, out_sh, flops, donate_argnums=(2,))


def _attn_flops(cfg, b, s, train: bool):
    mult = 3 if train else 1  # fwd + 2x bwd
    per_layer = 4.0 * b * s * s * cfg.n_heads * cfg.hd / 2  # causal half
    window = cfg.sliding_window
    if window and cfg.layer_pattern == "local_global":
        local = 4.0 * b * s * min(window, s) * cfg.n_heads * cfg.hd
        n_loc = cfg.n_layers // 2
        return mult * (n_loc * local + (cfg.n_layers - n_loc) * per_layer)
    return mult * cfg.n_layers * per_layer


def _expand(pspec_dict, params):
    """Layer pspecs are shared across the stacked-layer dict entries."""
    out = dict(pspec_dict)
    out["layers"] = {k: pspec_dict["layers"][k] for k in params["layers"]}
    return out


# --------------------------------------------------------------------- GNN


def _gnn_forward(arch, params, batch, cfg):
    if arch == "meshgraphnet":
        return gnn_mod.mgn_forward(params, batch["node_feat"], batch["edge_feat"],
                                   batch["senders"], batch["receivers"], cfg)
    if arch == "equiformer-v2":
        return gnn_mod.eqv2_forward(params, batch["species"], batch["positions"],
                                    batch["senders"], batch["receivers"], cfg)
    if arch == "gat-cora":
        return gnn_mod.gat_forward(params, batch["node_feat"], batch["senders"],
                                   batch["receivers"], cfg)
    if arch == "graphsage-reddit":
        return gnn_mod.sage_forward_full(params, batch["node_feat"], batch["senders"],
                                         batch["receivers"], cfg)
    raise KeyError(arch)


def _gnn_init(arch, cfg, d_feat):
    """(cfg with the shape's input widths, the parameter tree's shapes):
    MGN's edge features are 4 wide, its node features and GAT's and
    GraphSAGE's inputs `d_feat`."""
    if arch == "meshgraphnet":
        cfg = dataclasses.replace(cfg, d_node_in=d_feat, d_edge_in=4)
    elif arch in ("gat-cora", "graphsage-reddit"):
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    elif arch != "equiformer-v2":
        raise KeyError(arch)
    return cfg, gnn_mod.param_specs(arch, cfg)


def _gnn_batch_specs(arch, n, e, d_feat):
    batch = {"senders": S((e,), I32), "receivers": S((e,), I32)}
    if arch == "equiformer-v2":
        batch["species"] = S((n, 1), F32)
        batch["positions"] = S((n, 3), F32)
    else:
        batch["node_feat"] = S((n, d_feat), F32)
    if arch == "meshgraphnet":
        batch["edge_feat"] = S((e, 4), F32)
    return batch


def _gnn_batch_shardings(arch, mesh):
    ba = batch_axes(mesh)
    b = {"senders": NamedSharding(mesh, P(ba)), "receivers": NamedSharding(mesh, P(ba))}
    if arch == "equiformer-v2":
        b["species"] = NamedSharding(mesh, P(ba, None))
        b["positions"] = NamedSharding(mesh, P(ba, None))
    else:
        b["node_feat"] = NamedSharding(mesh, P(ba, None))
    if arch == "meshgraphnet":
        b["edge_feat"] = NamedSharding(mesh, P(ba, None))
    return b


def _regression(arch) -> bool:
    return arch in ("meshgraphnet", "equiformer-v2")


def _labels_loss(arch, out, labels):
    """MSE for the regression archs, else the mean NLL of the labels."""
    if _regression(arch):
        return torch.mean((out - labels) ** 2)
    logp = torch.log_softmax(out, dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


def _gnn_loss(arch, params, batch, labels, cfg):
    return _labels_loss(arch, _gnn_forward(arch, params, batch, cfg), labels)


def _gnn_full_plan(arch, cfg, info, mesh, shape_name) -> CellPlan:
    n, e, d_feat = info["n_nodes"], info["n_edges"], info.get("d_feat", 16)
    if info["kind"] == "batched":
        n = info["n_nodes"] * info["batch"]
        e = info["n_edges"] * info["batch"]
    n, e = _pad(n), _pad(e)
    cfg, params = _gnn_init(arch, cfg, d_feat)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig()
    batch = _gnn_batch_specs(arch, n, e, d_feat)
    labels = S((n, cfg.d_out), F32) if _regression(arch) else S((n,), I32)

    def train_step(params, opt_state, batch, labels):
        loss, grads = value_and_grad(
            lambda p: _gnn_loss(arch, p, batch, labels, cfg), params)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss, gnorm

    flops = _gnn_flops(arch, cfg, n, e) * 3.0
    in_sh = out_sh = None
    if mesh is not None:
        ba = batch_axes(mesh)
        p_shard = shr.named(mesh, shr.gnn_param_pspecs(params))
        o_shard = _opt_shardings(mesh, p_shard)
        lbl = NamedSharding(mesh, P(ba, None) if labels.dim() == 2 else P(ba))
        in_sh = (p_shard, o_shard, _gnn_batch_shardings(arch, mesh), lbl)
        out_sh = (p_shard, o_shard, _rep(mesh), _rep(mesh))
    return CellPlan(arch, shape_name, "train_step", train_step,
                    (params, opt, batch, labels), in_sh, out_sh, flops,
                    donate_argnums=(0, 1))


def _gnn_sampled_plan(arch, cfg, info, mesh, shape_name) -> CellPlan:
    """minibatch_lg: two-hop fanout sampling inside the step (the CSR
    machinery of models/sampling.py on a plain offsets/neighbors pair),
    then the model on the sampled star subgraph."""
    n, e = _pad(info["n_nodes"]), _pad(info["n_edges"])
    bsz = info["batch_nodes"]
    f1, f2 = info["fanout"]
    d_feat = info["d_feat"]
    cfg, params = _gnn_init(arch, cfg, d_feat)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig()
    e_cap = e  # directed edge capacity

    def sample(key, offsets, neighbors_at, seeds, fan):
        b = seeds.shape[0]
        seeds = seeds.long()
        start = offsets[seeds].long()
        deg = offsets[seeds + 1].long() - start
        r = jr.randint(key, (b, fan), 0, torch.clamp(deg, min=1)[:, None])
        nbrs = neighbors_at(torch.clamp(start[:, None] + r, 0, e_cap - 1))
        mask = (deg[:, None] > 0).expand(b, fan)
        return torch.where(mask, nbrs, seeds[:, None].to(nbrs.dtype)), mask

    def train_step(params, opt_state, feats, offsets, neighbors, seeds, labels, key):
        # on a mesh (DTensor args) the sampling runs on every rank's whole
        # copy of the key, offsets and seeds; the neighbor array and the
        # feature table stay row-sharded (masked lookups, `row_lookup`),
        # and the sampled ids are cut over the batch again for the model
        if is_dtensor(feats):
            key, offsets, seeds = whole(key), whole(offsets), whole(seeds)

            def neighbors_at(i):
                return whole(row_lookup(neighbors, on_mesh(i, neighbors)))

            def batch(t):
                return reshard(on_mesh(t, feats), "batch", *[None] * (t.dim() - 1))

            def rows(i):
                return row_lookup(feats, batch(i))
        else:
            def neighbors_at(i):
                return neighbors[i]

            def batch(t):
                return t

            def rows(i):
                return feats[i]
        k1, k2 = jr.split(key)
        h1, m1 = sample(k1, offsets, neighbors_at, seeds, f1)           # [B, f1]
        h2, m2 = sample(k2, offsets, neighbors_at, h1.reshape(-1), f2)
        h2 = h2.reshape(bsz, f1, f2)
        dev = seeds.device

        def loss_fn(p):
            if arch == "graphsage-reddit":
                nbr = {"h1": rows(h1.long()), "h2": rows(h2.long())}
                msk = {"h1": batch(m1.to(F32)), "h2": batch(m2.reshape(bsz, f1, f2).to(F32))}
                out = gnn_mod.sage_forward_sampled(p, rows(seeds.long()), nbr, msk, cfg)
                return _labels_loss(arch, out, labels)
            # star subgraph: local ids 0..B-1 seeds, then h1, then h2
            nodes = torch.cat([seeds, h1.reshape(-1), h2.reshape(-1)]).long()
            loc_seed = torch.arange(bsz, dtype=I32, device=dev)
            loc_h1 = bsz + torch.arange(bsz * f1, dtype=I32, device=dev)
            loc_h2 = bsz + bsz * f1 + torch.arange(bsz * f1 * f2, dtype=I32, device=dev)
            senders = torch.cat([loc_h1, loc_h2])
            receivers = torch.cat([torch.repeat_interleave(loc_seed, f1),
                                   torch.repeat_interleave(loc_h1, f2)])
            batch_d = {"senders": batch(senders.long()), "receivers": batch(receivers.long())}
            x = rows(nodes)
            if arch == "equiformer-v2":
                batch_d["species"], batch_d["positions"] = x[:, :1], x[:, 1:4]
            else:
                batch_d["node_feat"] = x
            if arch == "meshgraphnet":
                batch_d["edge_feat"] = batch(torch.ones((senders.shape[0], 4), dtype=F32,
                                                        device=dev))
            # the reference's forward reads the step's `params`, not `p`
            # (module doc): no gradient reaches p, so no graph is built
            with torch.no_grad():
                out = _gnn_forward(arch, params, batch_d, cfg)[:bsz]
            return _labels_loss(arch, out, labels)

        loss, grads = value_and_grad(loss_fn, params)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss, gnorm

    feats = S((n, d_feat), F32)
    offsets = S((n + 1,), I32)
    neighbors = S((e,), I32)
    seeds = S((bsz,), I32)
    labels = S((bsz, cfg.d_out), F32) if _regression(arch) else S((bsz,), I32)
    key = S((2,), KEY)
    sub_n = bsz * (1 + f1 + f1 * f2)
    sub_e = bsz * (f1 + f1 * f2)
    flops = _gnn_flops(arch, cfg, sub_n, sub_e) * 3.0
    in_sh = out_sh = None
    if mesh is not None:
        ba = batch_axes(mesh)
        p_shard = shr.named(mesh, shr.gnn_param_pspecs(params))
        o_shard = _opt_shardings(mesh, p_shard)
        lbl = P(ba, None) if _regression(arch) else P(ba)
        in_sh = (p_shard, o_shard,
                 NamedSharding(mesh, P(shr.TP, None)),   # feature table row-sharded
                 _rep(mesh),                             # offsets replicated
                 NamedSharding(mesh, P(shr.TP)),         # neighbor array row-sharded
                 NamedSharding(mesh, P(ba)), NamedSharding(mesh, lbl), _rep(mesh))
        out_sh = (p_shard, o_shard, _rep(mesh), _rep(mesh))
    return CellPlan(arch, shape_name, "train_step", train_step,
                    (params, opt, feats, offsets, neighbors, seeds, labels, key),
                    in_sh, out_sh, flops, donate_argnums=(0, 1))


def _gnn_flops(arch, cfg, n, e):
    if arch == "meshgraphnet":
        h = cfg.d_hidden
        return cfg.n_layers * (2 * e * (3 * h) * h + 2 * e * h * h
                               + 2 * n * (2 * h) * h + 2 * n * h * h)
    if arch == "equiformer-v2":
        c = cfg.d_hidden
        blocks = gnn_mod.m_block_indices(cfg.l_max, cfg.m_max)
        so2 = sum(2 * e * (len(b) * c) ** 2 for b in blocks)
        return cfg.n_layers * (so2 + 2 * n * c * 2 * c * 2)
    if arch == "gat-cora":
        d0, h, heads = cfg.d_in, cfg.d_hidden, cfg.n_heads
        return (2 * n * d0 * heads * h + 2 * e * heads * h
                + 2 * n * heads * h * cfg.n_classes)
    if arch == "graphsage-reddit":
        d0, h = cfg.d_in, cfg.d_hidden
        return (2 * (n + e) * d0 * h + 2 * n * h * cfg.n_classes) * 2
    raise KeyError(arch)


# ------------------------------------------------------------------- recsys


def _dlrm_plan(arch, cfg, info, mesh, shape_name) -> CellPlan:
    kind = info["kind"]
    params = dlrm_mod.dlrm_init(jr.PRNGKey(0, "meta"), cfg)
    p_shard = ba = None
    if mesh is not None:
        ba = batch_axes(mesh)
        p_shard = shr.named(mesh, shr.dlrm_param_pspecs(params))

    if kind == "retrieval":
        n_cand = _pad(info["n_candidates"])

        def retrieval(params, dense, sparse_idx, cand_emb):
            return dlrm_mod.retrieval_score(params, dense, sparse_idx, cand_emb, cfg)

        args = (params, S((1, cfg.n_dense), F32),
                S((1, cfg.n_sparse, cfg.multi_hot), I32),
                S((n_cand, cfg.embed_dim), F32))
        sh = (None, None)
        if mesh is not None:
            cand = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)
            sh = ((p_shard, _rep(mesh), _rep(mesh), NamedSharding(mesh, P(cand, None))),
                  NamedSharding(mesh, P(None, cand)))
        return CellPlan(arch, shape_name, "retrieval_score", retrieval, args,
                        *sh, 2.0 * n_cand * cfg.embed_dim)

    b = info["batch"]
    dense = S((b, cfg.n_dense), F32)
    sparse = S((b, cfg.n_sparse, cfg.multi_hot), I32)
    sizes = list(cfg.bot_mlp)
    mlp_flops = sum(2 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
    tsz = [cfg.d_interact] + list(cfg.top_mlp)[1:]
    mlp_flops += sum(2 * a * bb for a, bb in zip(tsz[:-1], tsz[1:]))
    f = cfg.n_sparse + 1
    per_sample = mlp_flops + 2 * f * f * cfg.embed_dim

    if kind == "serve":
        def serve(params, dense, sparse_idx):
            return dlrm_mod.dlrm_forward(params, dense, sparse_idx, cfg)

        sh = (None, None)
        if mesh is not None:
            sh = ((p_shard, NamedSharding(mesh, P(ba, None)),
                   NamedSharding(mesh, P(ba, None, None))),
                  NamedSharding(mesh, P(ba)))
        return CellPlan(arch, shape_name, "serve_step", serve,
                        (params, dense, sparse), *sh, per_sample * b)

    opt_cfg = AdamWConfig()

    def train_step(params, opt_state, dense, sparse_idx, labels):
        loss, grads = value_and_grad(
            lambda p: dlrm_mod.dlrm_loss(p, dense, sparse_idx, labels, cfg), params)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss, gnorm

    sh = (None, None)
    if mesh is not None:
        o_shard = _opt_shardings(mesh, p_shard)
        sh = ((p_shard, o_shard, NamedSharding(mesh, P(ba, None)),
               NamedSharding(mesh, P(ba, None, None)), NamedSharding(mesh, P(ba))),
              (p_shard, o_shard, _rep(mesh), _rep(mesh)))
    return CellPlan(arch, shape_name, "train_step", train_step,
                    (params, adamw_init(params), dense, sparse, S((b,), F32)),
                    *sh, per_sample * b * 3.0, donate_argnums=(0, 1))


# ------------------------------------------------------------------- wharf


def _graph_args(edge_capacity: int, n_vertices: int, lead=()):
    return {"codes": S((*lead, edge_capacity), U64),
            "offsets": S((*lead, n_vertices + 1), I32),
            "num_edges": S(lead, I32)}


def _store_args(cfg, t: int, n_chunks: int, lead=()):
    from repro_torch.kernels.delta import WORDS
    return {
        "owner": S((*lead, t), U32), "code": S((*lead, t), U64),
        "epoch": S((*lead, t), U32), "offsets": S((*lead, cfg.n_vertices + 1), I32),
        "vmin": S((*lead, cfg.n_vertices), U32), "vmax": S((*lead, cfg.n_vertices), U32),
        "packed": S((*lead, n_chunks, WORDS), U32), "widths": S((*lead, n_chunks), U32),
        "anchors_hi": S((*lead, n_chunks), U32), "anchors_lo": S((*lead, n_chunks), U32),
        "last_hi": S((*lead, n_chunks), U32), "last_lo": S((*lead, n_chunks), U32),
        "slot_epoch": S((*lead, cfg.n_vertices * cfg.n_walks_per_vertex * cfg.length), U32),
    }


def _pending_args(cfg, lead=()):
    from repro_torch.core.update import PendingBlocks
    shape = (*lead, cfg.max_pending, cfg.rewalk_capacity * cfg.length)
    return PendingBlocks(owner=S(shape, U32), code=S(shape, U64), epoch=S(shape, U32),
                         slot=S(shape, I32))


def _wharf_shardings(mesh):
    """(graph, store) specs of the reference's `wharf_shardings`: the
    triplet and edge arrays (and the packed chunks, which follow them)
    split dim 0 over ("data", "model"), a vertex-range partition in
    vertex-major order; vmin/vmax over "model"; the CSR offsets and the
    edge count replicated."""
    from repro_torch.distr.engine import STORE_KEYS
    flat = tuple(a for a in ("data", "model") if a in mesh.mesh_dim_names)
    g = {"codes": P(flat), "offsets": P(), "num_edges": P()}
    s = {k: P(flat) for k in STORE_KEYS}
    s.update(offsets=P(), vmin=P(("model",)), vmax=P(("model",)), packed=P(flat, None))
    return shr.named(mesh, g), shr.named(mesh, s)


def _row_state(stacked, row: int, cfg):
    """Row `row` of an [S, ...]-stacked engine state dict -> that shard's
    `EngineState` (views of the stacked tensors: in-place updates of the
    pending blocks land in the row)."""
    from repro_torch._u64 import u32_value
    from repro_torch.core.graph import StreamingGraph
    from repro_torch.core.store import WalkStore
    from repro_torch.core.update import EngineState, PendingBlocks
    from repro_torch.distr.engine import STORE_KEYS
    g, st, pd = stacked["graph"], stacked["store"], stacked["pending"]
    return EngineState(
        graph=StreamingGraph(g["codes"][row], g["offsets"][row], g["num_edges"][row],
                             cfg.n_vertices),
        store=WalkStore(**{k: st[k][row] for k in STORE_KEYS}, length=cfg.length,
                        n_walks=cfg.n_vertices * cfg.n_walks_per_vertex,
                        n_vertices=cfg.n_vertices, chunk_b=cfg.chunk_b),
        pending=PendingBlocks(*(getattr(pd, k)[row] for k in PendingBlocks._fields)),
        n_pending=int(stacked["n_pending"][row]),
        epoch=int(u32_value(stacked["epoch"][row])),
        last_affected=stacked["last_affected"][row],
        total_affected=stacked["total_affected"][row],
        overflow=stacked["overflow"][row])


def _write_row(stacked, row: int, state) -> None:
    """Write `state` into row `row` of the stacked dict, in place."""
    from repro_torch._u64 import u32_bits
    from repro_torch.distr.engine import STORE_KEYS, graph_to_dict
    pairs = [(stacked["graph"][k], v) for k, v in graph_to_dict(state.graph).items()]
    pairs += [(stacked["store"][k], getattr(state.store, k)) for k in STORE_KEYS]
    pairs += [(getattr(stacked["pending"], k), getattr(state.pending, k))
              for k in state.pending._fields]
    pairs += [(stacked[k], getattr(state, k))
              for k in ("last_affected", "total_affected", "overflow")]
    for dst, src in pairs:
        if dst[row].data_ptr() != src.data_ptr():
            dst[row].copy_(src)
    stacked["n_pending"][row] = state.n_pending
    stacked["epoch"][row] = u32_bits(torch.tensor(state.epoch))


def _wharf_plan(arch, cfg, info, mesh, shape_name) -> CellPlan:
    """The paper's walk-update step (the reference's `_wharf_plan`).

    kind="walk_update": one batch per call (eager or no-merge forms),
    `distr.engine.distributed_update_step`.
    kind="walk_stream": a whole [n_batches, batch] stream per call through
    `distributed_run_stream`, with the policy's merges; `del_edges` adds a
    stacked deletion stream.
    kind="walk_stream_sharded": the explicitly partitioned engine
    (`distr/sharded.py`) over the mesh's S ranks seen as one flat shard
    axis (S = 1 without a mesh). The state args are [S, ...]-stacked as
    the reference's; the step runs the calling rank's row (rank = shard)
    and needs `torch.distributed` at S ranks.
    kind="walk_serve": the batched multi-query read step: the overlay over
    base + pending, FINDNEXT, walks-of, the walk matrix and its
    neighborhoods, and the embedding top-k, over a replicated view."""
    from repro_torch.distr.engine import distributed_run_stream, distributed_update_step
    from repro_torch.kernels.delta import CHUNK

    if "order" in info or "sampler" in info or "megakernel" in info:
        # per-shape walk-model overrides (the order-2 sampler cells and the
        # fused-step cell) on a copy of the frozen config
        cfg = dataclasses.replace(cfg, order=info.get("order", cfg.order),
                                  sampler=info.get("sampler", cfg.sampler),
                                  megakernel=info.get("megakernel", cfg.megakernel))
    # an explicit backend is installed process-wide, as the reference's
    # `select_backend` call here does; "auto" fields leave the registries
    cfg.install_backends()
    wcfg = cfg.walk_config()
    t = cfg.n_vertices * cfg.n_walks_per_vertex * cfg.length
    n_chunks = -(-t // CHUNK)  # packed grid is CHUNK-wide (kernel layout)
    batch_e = info["batch_edges"]
    graph = _graph_args(cfg.edge_capacity, cfg.n_vertices)
    store = _store_args(cfg, t, n_chunks)
    merge_impl = info.get("merge_impl", "lexsort")  # paper-faithful default
    # useful work: |I| ~ capacity * l/2 resamples + merge sort of T + |I|
    flops_batch = (cfg.rewalk_capacity * cfg.length * 20.0
                   + (t + cfg.rewalk_capacity * cfg.length) * math.log2(max(t, 2)) * 2)
    g_sh = s_sh = None
    if mesh is not None:
        g_sh, s_sh = _wharf_shardings(mesh)

    if info["kind"] == "walk_stream_sharded":
        import torch.distributed as dist

        from repro_torch.core.graph import as_ids
        from repro_torch.distr.sharded import consolidate, shard_group, sharded_stream_step

        n_batches = info.get("n_batches", cfg.stream_batches)
        merge_policy = info.get("merge_policy", "on-demand")
        del_e = info.get("del_edges", 0)
        # one flat shard axis over every mesh rank: the vertex-range
        # partition does not distinguish pod/data/model
        sn = mesh_size(mesh) if mesh is not None else 1
        spec = cfg.shard_spec(sn)

        def sharded_stream(stacked, keys, ins_src, ins_dst, del_src, del_dst):
            group = shard_group(sn)
            rank = dist.get_rank(group)
            state = _row_state(stacked, rank, cfg)
            dev = state.store.device
            ins_src, ins_dst = as_ids(ins_src, dev), as_ids(ins_dst, dev)
            del_src, del_dst = as_ids(del_src, dev), as_ids(del_dst, dev)
            affected = []
            for i in range(n_batches):
                state = sharded_stream_step(
                    state, keys[i], ins_src[i], ins_dst[i], del_src[i], del_dst[i], wcfg,
                    cfg.rewalk_capacity, spec, rank, cfg.max_pending, merge_policy, group)
                affected.append(state.last_affected)
            # end-of-stream consolidate: the returned store is self-contained
            _write_row(stacked, rank, consolidate(state))
            return stacked, torch.stack(affected)[None]

        lead = (sn,)
        nc_s = -(-spec.store_capacity // CHUNK)
        state = {
            "graph": _graph_args(spec.edge_capacity, cfg.n_vertices, lead),
            "store": _store_args(cfg, spec.store_capacity, nc_s, lead),
            "pending": _pending_args(cfg, lead),
            "n_pending": S(lead, I32), "epoch": S(lead, U32),
            "last_affected": S(lead, I32), "total_affected": S(lead, I32),
            "overflow": S(lead, torch.bool)}
        args = (state, S((n_batches, 2), KEY),
                S((n_batches, batch_e), U32), S((n_batches, batch_e), U32),
                S((n_batches, del_e), U32), S((n_batches, del_e), U32))
        in_sh = out_sh = None
        if mesh is not None:
            # dim 0 over every mesh dim in order: the flat shard axis
            flat = P(tuple(mesh.mesh_dim_names))
            part = shr.named(mesh, tree_map(lambda _: flat, state))
            in_sh = (part,) + (_rep(mesh),) * 5
            out_sh = (part, NamedSharding(mesh, flat))
        return CellPlan(arch, shape_name, "walk_stream_sharded_step", sharded_stream,
                        args, in_sh, out_sh, flops_batch * n_batches, donate_argnums=(0,))

    if info["kind"] == "walk_serve":
        from repro_torch.core.overlay import Overlay
        from repro_torch.distr.engine import dict_to_store
        from repro_torch.serve import batched as sb

        qb = info.get("q_batch", cfg.serve_batch)
        hops = info.get("hops", 2)
        wcap = info.get("walks_capacity", cfg.serve_walks_capacity)
        n_w = cfg.n_walks_per_vertex

        def serve_step(store_s, pending_s, emb, v, w, p):
            ov = Overlay.build(dict_to_store(store_s, cfg), pending_s)
            nxt, found = ov.find_next(v, w, p)
            wof = sb.walks_of_batch(ov, v, capacity=wcap)
            wm = sb.walk_matrix_all(ov, n_w=n_w)
            nb = sb.neighborhoods_from_matrix(wm, v, n_w=n_w, hops=hops)
            ids, sc = sb.embedding_topk(emb, v, k=cfg.serve_topk)
            return nxt, found, wof, nb, ids, sc

        args = (store, _pending_args(cfg), S((cfg.n_vertices, cfg.serve_emb_dim), F32),
                S((qb,), U32), S((qb,), U32), S((qb,), U32))
        # traversal dominates compute; the top-k matmul dominates per-query
        serve_flops = (cfg.n_vertices * n_w * cfg.length * 100.0
                       + qb * cfg.n_vertices * cfg.serve_emb_dim * 2.0)
        in_sh = out_sh = None
        if mesh is not None:
            in_sh, out_sh = shr.replicated(mesh, args), _rep(mesh)
        return CellPlan(arch, shape_name, "walk_serve_step", serve_step, args,
                        in_sh, out_sh, serve_flops, donate_argnums=())

    if info["kind"] == "walk_stream":
        n_batches = info.get("n_batches", cfg.stream_batches)
        merge_policy = info.get("merge_policy", "on-demand")
        del_e = info.get("del_edges", 0)

        def stream(graph_d, store_d, keys, ins_src, ins_dst, del_src, del_dst):
            return distributed_run_stream(
                graph_d, store_d, keys, ins_src, ins_dst, cfg, merge_impl=merge_impl,
                merge_policy=merge_policy, max_pending=cfg.max_pending,
                del_src=del_src, del_dst=del_dst)

        args = (graph, store, S((n_batches, 2), KEY),
                S((n_batches, batch_e), U32), S((n_batches, batch_e), U32),
                S((n_batches, del_e), U32), S((n_batches, del_e), U32))
        in_sh = out_sh = None
        if mesh is not None:
            in_sh = (g_sh, s_sh) + (_rep(mesh),) * 5
            out_sh = (g_sh, s_sh, _rep(mesh))
        return CellPlan(arch, shape_name, "walk_stream_step", stream, args,
                        in_sh, out_sh, flops_batch * n_batches, donate_argnums=(1,))

    do_merge = info.get("do_merge", True)

    def step(graph_d, store_d, ins_src, ins_dst, new_epoch, key):
        return distributed_update_step(graph_d, store_d, ins_src, ins_dst, new_epoch, key,
                                       cfg, merge_impl=merge_impl, do_merge=do_merge)

    args = (graph, store, S((batch_e,), U32), S((batch_e,), U32), S((), U32), S((2,), KEY))
    in_sh = out_sh = None
    if mesh is not None:
        in_sh, out_sh = (g_sh, s_sh) + (_rep(mesh),) * 4, s_sh
    return CellPlan(arch, shape_name, "walk_update_step", step, args, in_sh,
                    out_sh, flops_batch, donate_argnums=(1,))


# ------------------------------------------------------------ partitioned


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of `shape` under `placements`
    (`act_sharding.cut` on each dim)."""
    from torch.distributed.tensor import Shard
    return tuple(cut(n, mesh, [i for i, p in enumerate(placements)
                               if isinstance(p, Shard) and p.dim == d])[1]
                 for d, n in enumerate(shape))


def _to_dtensor(x, sh, mesh):
    """`x`, the whole tensor (the same on every rank), as a DTensor of
    this rank's shard, cut here without a collective."""
    if not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import Shard
    if x.is_meta:
        local = torch.empty(local_shape(x.shape, sh.placements, mesh), dtype=x.dtype,
                            device="meta")
    else:
        idx = []
        for d, n in enumerate(x.shape):
            s0, size = cut(n, mesh, [i for i, p in enumerate(sh.placements)
                                     if isinstance(p, Shard) and p.dim == d])
            idx.append(slice(s0, s0 + size))
        local = x[tuple(idx)].contiguous()
    return from_local(local, mesh, sh.placements, x.shape)


def _placed(x, sh, mesh):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(sh.placements):
        return x.redistribute(mesh, sh.placements)
    return x


def partition(plan: CellPlan, mesh, args=None) -> CellPlan:
    """The plan as one rank of `mesh` runs it: its args DTensors placed by
    `plan.in_shardings` (on meta each leaf is built from its local shard's
    shape, so no global tensor is allocated; real tensors, the same on
    every rank, are cut on each rank), its step run under
    `set_mesh` with the outputs redistributed to `plan.out_shardings`.
    `args` default to the plan's meta args, the decode step's cache length
    a host int. The plan must have been built on `mesh`."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.op_analysis import meta_args
    if plan.in_shardings is None:
        raise ValueError(f"{plan.arch} x {plan.shape}: built without a mesh")
    args = meta_args(plan) if args is None else tuple(args)
    dargs = tuple(tree_map(lambda x, sh: _to_dtensor(x, sh, mesh), a, sh)
                  for a, sh in zip(args, plan.in_shardings))
    fn = plan.fn

    def step(*a):
        with set_mesh(mesh):
            out = fn(*a)
            return tree_map(lambda x, sh: _placed(x, sh, mesh), out, plan.out_shardings)

    return dataclasses.replace(plan, fn=step, args=dargs)


# ------------------------------------------------------------------ public


def build_cell(arch_name: str, shape_name: str, mesh=None,
               smoke: bool = False, info: Optional[dict] = None,
               config=None) -> CellPlan:
    """The plan of one (arch, shape) cell: on one card with `mesh` None,
    else with the mesh's shardings (a `DeviceMesh`, `launch/mesh.py`);
    `info`, where given, stands for the shape's entry and `config` for the
    arch's config (a cell cut to fit the card)."""
    spec = get_arch(arch_name)
    info = spec.shapes[shape_name] if info is None else info
    cfg = spec.make_config(smoke) if config is None else config
    if spec.family == "lm":
        kind = info["kind"]
        if kind == "train":
            return _lm_train_plan(arch_name, cfg, info, mesh)
        if kind == "prefill":
            return _lm_prefill_plan(arch_name, cfg, info, mesh)
        return _lm_decode_plan(arch_name, cfg, info, mesh)
    if spec.family == "gnn":
        if info["kind"] == "sampled":
            return _gnn_sampled_plan(arch_name, cfg, info, mesh, shape_name)
        return _gnn_full_plan(arch_name, cfg, info, mesh, shape_name)
    if spec.family == "recsys":
        return _dlrm_plan(arch_name, cfg, info, mesh, shape_name)
    if spec.family == "wharf":
        return _wharf_plan(arch_name, cfg, info, mesh, shape_name)
    raise KeyError(spec.family)
