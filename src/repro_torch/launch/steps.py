"""Cell plans: (step function, abstract inputs, analytic FLOPs) for every
(architecture x input shape) cell, the step the shape's `kind` dictates
(train / prefill / decode / serve / retrieval); port of
`repro/launch/steps.py` on one card.

A plan's `args` stand in for the reference's `jax.ShapeDtypeStruct`s:
tensors on the `meta` device with the reference's shapes and dtypes, so
that no plan allocates, however wide its model. Parameter shapes come from
each model's init on a meta key (`repro_torch.random` draws nothing
there) or from `transformer.param_specs`. A PRNG key is the port's int64
[2] (`repro_torch.random`), where the reference's is uint32 [2].

Without a mesh there is nothing to shard: `in_shardings` and
`out_shardings` are None and `_lm_train_plan`'s batch lies on one shard,
so it accumulates one sequence a microbatch. The walk-update plans of
family `wharf` (the reference's `_wharf_plan`) need the sharded engine's
cell forms and a device mesh, which are not ported (ROADMAP.md, queue 1
item 2): `build_cell` raises for them.

As in the reference, the minibatch plan (`_gnn_sampled_plan`) trains no
weight but GraphSAGE's: its loss of the other archs runs the forward on
the step's `params`, not on the differentiated `p`, so their gradient is
zero and AdamW moves the weights by weight decay alone. The port runs that
forward without autograd and returns zero gradients.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tfm
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaf_paths, rebuild, tree_map

F32 = torch.float32
I32 = torch.int32
KEY = torch.int64           # the port's PRNG key words (repro_torch.random)
UNPORTED = "ROADMAP.md, queue 1 item 2"


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


def _lm_train_plan(arch, cfg, info, mesh) -> CellPlan:
    opt_cfg = AdamWConfig()
    gb = info["global_batch"]
    n_batch_shards = 1          # no mesh: the batch lies on one shard
    # microbatching: 1 sequence per chip per microbatch (grad accumulation)
    n_micro = max(1, gb // n_batch_shards)
    mb = gb // n_micro

    def train_step(params, opt_state, tokens):
        micro_tokens = tokens.reshape(n_micro, mb, tokens.shape[-1])
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
        lsum = 0.0
        for batch in micro_tokens:
            loss, grads = value_and_grad(lambda p: tfm.lm_loss(p, batch, cfg), params)
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
    return CellPlan(arch, "train", "train_step", train_step,
                    (params, opt, tokens), None, None, flops, donate_argnums=(0, 1))


def _lm_prefill_plan(arch, cfg, info, mesh) -> CellPlan:
    b, s_len = info["global_batch"], info["seq_len"]

    def prefill(params, tokens):
        return tfm.prefill(params, tokens, cfg)

    flops = 2.0 * cfg.active_param_count() * b * s_len + _attn_flops(
        cfg, b, s_len, train=False)
    return CellPlan(arch, "prefill", "prefill", prefill,
                    (tfm.param_specs(cfg), S((b, s_len), I32)), None, None, flops)


def _lm_decode_plan(arch, cfg, info, mesh) -> CellPlan:
    b, ctx = info["global_batch"], info["seq_len"]

    def serve_step(params, token, cache, cache_len):
        return tfm.decode_step(params, token, cache, cache_len, cfg)

    cache_shape = (cfg.n_layers, b, ctx, cfg.n_kv_heads, cfg.hd)
    cache = {"k": S(cache_shape, cfg.dtype), "v": S(cache_shape, cfg.dtype)}
    # decode: 2 FLOPs/param/token + attention reads 2*ctx*nh*hd*2 per layer
    attn = 4.0 * cfg.n_layers * b * ctx * cfg.n_heads * cfg.hd
    flops = 2.0 * cfg.active_param_count() * b + attn
    return CellPlan(arch, "decode", "serve_step", serve_step,
                    (tfm.param_specs(cfg), S((b, 1), I32), cache, S((), I32)),
                    None, None, flops, donate_argnums=(2,))


def _attn_flops(cfg, b, s, train: bool):
    mult = 3 if train else 1  # fwd + 2x bwd
    per_layer = 4.0 * b * s * s * cfg.n_heads * cfg.hd / 2  # causal half
    window = cfg.sliding_window
    if window and cfg.layer_pattern == "local_global":
        local = 4.0 * b * s * min(window, s) * cfg.n_heads * cfg.hd
        n_loc = cfg.n_layers // 2
        return mult * (n_loc * local + (cfg.n_layers - n_loc) * per_layer)
    return mult * cfg.n_layers * per_layer


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
    return CellPlan(arch, shape_name, "train_step", train_step,
                    (params, opt, batch, labels), None, None, flops,
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

    def sample(key, offsets, neighbors, seeds, fan):
        b = seeds.shape[0]
        seeds = seeds.long()
        start = offsets[seeds].long()
        deg = offsets[seeds + 1].long() - start
        r = jr.randint(key, (b, fan), 0, torch.clamp(deg, min=1)[:, None])
        nbrs = neighbors[torch.clamp(start[:, None] + r, 0, e_cap - 1)]
        mask = (deg[:, None] > 0).expand(b, fan)
        return torch.where(mask, nbrs, seeds[:, None].to(nbrs.dtype)), mask

    def train_step(params, opt_state, feats, offsets, neighbors, seeds, labels, key):
        k1, k2 = jr.split(key)
        h1, m1 = sample(k1, offsets, neighbors, seeds, f1)           # [B, f1]
        h2, m2 = sample(k2, offsets, neighbors, h1.reshape(-1), f2)
        h2 = h2.reshape(bsz, f1, f2)
        dev = feats.device

        def loss_fn(p):
            if arch == "graphsage-reddit":
                nbr = {"h1": feats[h1.long()], "h2": feats[h2.long()]}
                msk = {"h1": m1.to(F32), "h2": m2.reshape(bsz, f1, f2).to(F32)}
                out = gnn_mod.sage_forward_sampled(p, feats[seeds.long()], nbr, msk, cfg)
                return _labels_loss(arch, out, labels)
            # star subgraph: local ids 0..B-1 seeds, then h1, then h2
            nodes = torch.cat([seeds, h1.reshape(-1), h2.reshape(-1)]).long()
            loc_seed = torch.arange(bsz, dtype=I32, device=dev)
            loc_h1 = bsz + torch.arange(bsz * f1, dtype=I32, device=dev)
            loc_h2 = bsz + bsz * f1 + torch.arange(bsz * f1 * f2, dtype=I32, device=dev)
            senders = torch.cat([loc_h1, loc_h2])
            receivers = torch.cat([torch.repeat_interleave(loc_seed, f1),
                                   torch.repeat_interleave(loc_h1, f2)])
            batch = {"senders": senders.long(), "receivers": receivers.long()}
            x = feats[nodes]
            if arch == "equiformer-v2":
                batch["species"], batch["positions"] = x[:, :1], x[:, 1:4]
            else:
                batch["node_feat"] = x
            if arch == "meshgraphnet":
                batch["edge_feat"] = torch.ones((senders.shape[0], 4), dtype=F32, device=dev)
            # the reference's forward reads the step's `params`, not `p`
            # (module doc): no gradient reaches p, so no graph is built
            with torch.no_grad():
                out = _gnn_forward(arch, params, batch, cfg)[:bsz]
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
    return CellPlan(arch, shape_name, "train_step", train_step,
                    (params, opt, feats, offsets, neighbors, seeds, labels, key),
                    None, None, flops, donate_argnums=(0, 1))


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

    if kind == "retrieval":
        n_cand = _pad(info["n_candidates"])

        def retrieval(params, dense, sparse_idx, cand_emb):
            return dlrm_mod.retrieval_score(params, dense, sparse_idx, cand_emb, cfg)

        args = (params, S((1, cfg.n_dense), F32),
                S((1, cfg.n_sparse, cfg.multi_hot), I32),
                S((n_cand, cfg.embed_dim), F32))
        return CellPlan(arch, shape_name, "retrieval_score", retrieval, args,
                        None, None, 2.0 * n_cand * cfg.embed_dim)

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

        return CellPlan(arch, shape_name, "serve_step", serve,
                        (params, dense, sparse), None, None, per_sample * b)

    opt_cfg = AdamWConfig()

    def train_step(params, opt_state, dense, sparse_idx, labels):
        loss, grads = value_and_grad(
            lambda p: dlrm_mod.dlrm_loss(p, dense, sparse_idx, labels, cfg), params)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss, gnorm

    return CellPlan(arch, shape_name, "train_step", train_step,
                    (params, adamw_init(params), dense, sparse, S((b,), F32)),
                    None, None, per_sample * b * 3.0, donate_argnums=(0, 1))


# ------------------------------------------------------------------ public


def build_cell(arch_name: str, shape_name: str, mesh=None,
               smoke: bool = False, info: Optional[dict] = None) -> CellPlan:
    """The plan of one (arch, shape) cell on one card (`mesh` None); `info`,
    where given, stands for the shape's entry (a cell cut to fit the card)."""
    if mesh is not None:
        raise NotImplementedError(f"build_cell on a device mesh: {UNPORTED}")
    spec = get_arch(arch_name)
    info = spec.shapes[shape_name] if info is None else info
    cfg = spec.make_config(smoke)
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
        raise NotImplementedError(
            f"the walk-update plans of family wharf (the reference's _wharf_plan "
            f"on distr/engine.py's shard_map forms): {UNPORTED}")
    raise KeyError(spec.family)
