"""GNN architectures: MeshGraphNet, EquiformerV2 (eSCN), GAT, GraphSAGE;
port of `repro/models/gnn.py`.

Message passing is a gather by edge index and a scatter-add back into the
nodes, as the reference's `jax.ops.segment_sum`/`segment_max`: here
`index_add` (the same sums in the same order on the CPU) and
`scatter_reduce("amax", include_self=False)`. Graph batches are (senders,
receivers, node_feat, edge_feat) of fixed shapes; the GraphSAGE neighbor
sampler is models/sampling.py.

Every update of a node tensor is out of place (`index_add`/`index_copy`
returning a new tensor), as the reference's `x.at[...].add/set`: autograd
never sees an in-place write to a tensor it saved.

EquiformerV2 (DESIGN.md §2): node features are irreps [N, (L+1)^2, C]. The
SO(2) block-diagonal convolution of eSCN is a dense channel mix per |m|;
the Wigner rotation into and out of the edge frame is the reference's
stub, an RBF-conditioned per-(l, m) gate, which keeps the shapes and the
compute but not SO(3) equivariance.

Reproduced from the reference on purpose: GAT's `a_src` and `a_dst` are
drawn from one key (they are equal), as are GraphSAGE's `w_self` and
`w_nbr`; eqv2 adds 1e-9 to each component of `rel` before the norm; the
RBF centres are `jnp.linspace`'s values (`rbf_centres`) in float64, as the
reference's package runs with x64 on (`repro.configs` and `repro.core`
enable it), so its RBF is taken in f64 and cast to f32 at the gate.

Scales are divided by device tensors (`_f32`), never by Python scalars: a
CUDA tensor over a Python scalar is multiplied by the scalar's reciprocal,
an ulp off the reference's quotient.

On a mesh (DTensor nodes and edges cut over the batch dims, the
parameters whole) each edge gather reads the node table made whole on
every rank (`rows`, `act_sharding.gather_rows`), and the segment sums
add each rank's edges into partial sums that are reduce-scattered onto
the node shards; the segment max is all-reduced by max. eqv2's index ops
over the irreps run on each rank's rows (`act_sharding.on_rows`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch

from repro_torch import random as jr
from repro_torch.models.act_sharding import gather_rows, is_dtensor, on_mesh, on_rows, reshard

F32 = torch.float32


def _f32(v: float, device) -> torch.Tensor:
    """A Python scalar as an f32 tensor on the device (JAX's weak type)."""
    return torch.tensor(v, dtype=F32, device=device)


class _SegmentSum(torch.autograd.Function):
    """index_add into zeros whose backward is the gather of the output's
    gradient, as the transpose of the reference's scatter-add. Autograd's
    own `index_add` keeps the whole source for its backward: an [E, 128]
    f32 message tensor of ogb_products is 31.7 GB."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments: int):
        ctx.save_for_backward(segment_ids)
        out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        return out.index_add_(0, segment_ids, data)

    @staticmethod
    def backward(ctx, grad):
        (segment_ids,) = ctx.saved_tensors
        return grad.index_select(0, segment_ids), None, None


def segment_sum(data, segment_ids, num_segments: int):
    """`jax.ops.segment_sum`: rows of `data` added into `num_segments`
    rows of zeros at `segment_ids`, in row order on the CPU. On DTensors
    (`_sharded_segment`) each rank adds its rows, and the result is their
    sums, reduce-scattered onto segment shards."""
    if is_dtensor(data):
        return _sharded_segment(_SegmentSum.apply, "sum", data, segment_ids, num_segments)
    return _SegmentSum.apply(data, segment_ids, num_segments)


def _segment_max(data, segment_ids, num_segments: int):
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_max(data, segment_ids, num_segments: int):
    """`jax.ops.segment_max`: the max of each segment's rows, -inf where a
    segment is empty. On DTensors each rank takes the max of its rows, and
    the result is reduced by max over the ranks that cut the rows."""
    if is_dtensor(data):
        return _sharded_segment(_segment_max, "max", data, segment_ids, num_segments)
    return _segment_max(data, segment_ids, num_segments)


def rows(x, ids):
    """`x[ids]`: on DTensors `act_sharding.gather_rows` (x gathered whole,
    each rank indexing with its own ids)."""
    if is_dtensor(x):
        return gather_rows(x, ids)
    return x[ids]


def _sharded_segment(fn, op: str, data, segment_ids, num_segments: int):
    """A segment reduction `fn` of DTensor rows: the ids placed as the
    rows, each rank reduces its own rows into all `num_segments`, and the
    result is a partial sum (`op` "sum") over the mesh dims that cut the
    rows, reduce-scattered so that the segments are cut as the rows were
    (`op` "sum"), or whole after an all-reduce by max ("max"); a mesh dim
    that cuts a trailing dim of `data` cuts the same dim of the result."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models.act_sharding import from_local, to_local
    mesh = data.device_mesh
    data = data.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p
                                    for p in data.placements])
    ids = segment_ids
    if not is_dtensor(ids):
        ids = on_mesh(ids, data)
    place = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in data.placements]
    ids = ids.redistribute(mesh, place)
    out = fn(to_local(data), ids.to_local(), num_segments)
    part = [Partial(op) if isinstance(p, Shard) and p.dim == 0 else p for p in data.placements]
    out = from_local(out, mesh, part, (num_segments,) + tuple(data.shape[1:]))
    # sums are reduce-scattered onto segment shards as the rows were cut
    done = Shard(0) if op == "sum" else Replicate()
    return out.redistribute(mesh, [done if isinstance(p, Partial) else p for p in part])


def segment_softmax(logits, segment_ids, num_segments: int):
    """Softmax of `logits` ([E] or [E, H], each column apart) over the
    edges of each segment, with the reference's 1e-9 floor on the sum."""
    m = segment_max(logits, segment_ids, num_segments)
    z = torch.exp(logits - rows(m, segment_ids))
    s = segment_sum(z, segment_ids, num_segments)
    return z / torch.clamp(rows(s, segment_ids), min=1e-9)


def _mlp_params(key, sizes, dtype=F32):
    ks = jr.split(key, len(sizes) - 1)
    return [{"w": (jr.normal(k, (a, b)) / _f32(a ** 0.5, key.device)).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=key.device)}
            for k, (a, b) in zip(ks, zip(sizes[:-1], sizes[1:]))]


def param_specs(arch: str, cfg):
    """The parameter tree of `arch` at `cfg` as meta tensors (shapes and
    dtypes, nothing drawn): its init on a meta key."""
    return INITS[arch](jr.PRNGKey(0, "meta"), cfg)


def _mlp(x, layers, act=torch.relu, final_act=False):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _l2_normalize(x):
    """x / max(||x||, 1e-6) over the last axis (`jnp.linalg.norm`)."""
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-6)


# ------------------------------------------------------------ MeshGraphNet


@dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 12
    d_edge_in: int = 7
    d_out: int = 3
    dtype: Any = F32


def mgn_init(key, cfg: MGNConfig):
    """The reference's `mgn_init` bit for bit, on the key's device."""
    ks = jr.split(key, 4 + cfg.n_layers * 2)
    h, m = cfg.d_hidden, cfg.mlp_layers
    hidden = [h] * m
    return {
        "enc_node": _mlp_params(ks[0], [cfg.d_node_in] + hidden + [h], cfg.dtype),
        "enc_edge": _mlp_params(ks[1], [cfg.d_edge_in] + hidden + [h], cfg.dtype),
        "dec": _mlp_params(ks[2], [h] + hidden + [cfg.d_out], cfg.dtype),
        "blocks": [
            {"edge": _mlp_params(ks[4 + 2 * i], [3 * h] + hidden + [h], cfg.dtype),
             "node": _mlp_params(ks[5 + 2 * i], [2 * h] + hidden + [h], cfg.dtype)}
            for i in range(cfg.n_layers)
        ],
    }


def mgn_forward(params, node_feat, edge_feat, senders, receivers,
                cfg: MGNConfig):
    n = node_feat.shape[0]
    x = _mlp(node_feat.to(cfg.dtype), params["enc_node"])
    e = _mlp(edge_feat.to(cfg.dtype), params["enc_edge"])
    for blk in params["blocks"]:
        msg_in = torch.cat([e, rows(x, senders), rows(x, receivers)], dim=-1)
        e = e + _mlp(msg_in, blk["edge"])
        agg = segment_sum(e, receivers, n)
        x = x + _mlp(torch.cat([x, agg], dim=-1), blk["node"])
    return _mlp(x, params["dec"])


# ------------------------------------------------------- EquiformerV2/eSCN


@dataclass(frozen=True)
class EqV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    d_out: int = 1
    dtype: Any = F32

    @property
    def n_irreps(self) -> int:
        return (self.l_max + 1) ** 2


def m_block_indices(l_max: int, m_max: int) -> List[List[int]]:
    """For each |m| <= m_max the (l, m) component indices (real SH
    layout), sorted; the reference's `_m_blocks` as lists."""
    blocks = []
    for m in range(m_max + 1):
        idx = []
        for l in range(m, l_max + 1):
            base = l * l + l  # (l, 0) position
            idx.append(base + m)
            if m > 0:
                idx.append(base - m)
        blocks.append(sorted(idx))
    return blocks


def _m_blocks(l_max: int, m_max: int, device=None) -> List[torch.Tensor]:
    return [torch.tensor(b, dtype=torch.int64, device=device)
            for b in m_block_indices(l_max, m_max)]


def rbf_centres(n_rbf: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0., 5., n_rbf)` bit for bit in float64, the reference's
    dtype as its package runs (x64 on): XLA turns its iota / (n - 1) * 5
    into iota * (5 * (1 / (n - 1))), each constant rounded, and keeps the
    endpoint 5.0 exact (torch.linspace rounds otherwise)."""
    if n_rbf == 1:
        return torch.zeros((1,), dtype=torch.float64, device=device)
    scale = 5.0 * (1.0 / (n_rbf - 1))
    out = torch.arange(n_rbf, dtype=torch.float64, device=device) * torch.tensor(
        scale, dtype=torch.float64, device=device)
    out[-1] = 5.0
    return out


def eqv2_init(key, cfg: EqV2Config):
    """The reference's `eqv2_init` bit for bit, on the key's device."""
    c = cfg.d_hidden
    dev = key.device
    ks = jr.split(key, 6 + cfg.n_layers)
    sizes = [len(b) for b in m_block_indices(cfg.l_max, cfg.m_max)]
    layers = []
    for i in range(cfg.n_layers):
        lk = jr.split(ks[6 + i], 4 + len(sizes))
        so2 = [(jr.normal(lk[4 + m], (s * c, s * c)) / _f32((s * c) ** 0.5, dev)
                ).to(cfg.dtype) for m, s in enumerate(sizes)]
        layers.append({
            "so2": so2,
            "rbf_gate": _mlp_params(lk[0], [cfg.n_rbf, c, cfg.n_irreps], cfg.dtype),
            "attn_q": (jr.normal(lk[1], (c, cfg.n_heads)) / _f32(c ** 0.5, dev)
                       ).to(cfg.dtype),
            "attn_k": (jr.normal(lk[2], (c, cfg.n_heads)) / _f32(c ** 0.5, dev)
                       ).to(cfg.dtype),
            "ffn": _mlp_params(lk[3], [c, 2 * c, c], cfg.dtype),
        })
    return {
        "embed": _mlp_params(ks[0], [1, c], cfg.dtype),   # scalar (l=0) embed
        "layers": layers,
        "head": _mlp_params(ks[1], [c, c, cfg.d_out], cfg.dtype),
    }


def eqv2_forward(params, species, positions, senders, receivers,
                 cfg: EqV2Config):
    """species [N, 1] float, positions [N, 3] -> [N, d_out].

    Edge tensors hold the SO(2)-active components only (|m| <= m_max: 29
    of 49 at l_max 6, m_max 2), m-major, so each |m| block is a slice.
    The receivers' scalar channel is gathered as `x[:, 0][receivers]` and the
    FFN reads a copy of `x[:, 0]`: the reference's values, without an
    [E, (L+1)^2, C] gather or a saved view that keeps a whole [N, (L+1)^2,
    C] layer alive for the backward."""
    n = species.shape[0]
    c = cfg.d_hidden
    dev = species.device
    blocks = _m_blocks(cfg.l_max, cfg.m_max, dev)
    idx_active = torch.cat(blocks)
    ranges, start = [], 0
    for b in blocks:
        ranges.append((start, start + len(b)))
        start += len(b)
    scalar = torch.zeros((1,), dtype=torch.int64, device=dev)
    x = reshard(on_mesh(torch.zeros((n, cfg.n_irreps, c), dtype=cfg.dtype, device=dev),
                        species), "batch", None, None)
    x = on_rows(lambda x, e: x.index_copy(1, scalar, e), x,
                _mlp(species.to(cfg.dtype), params["embed"])[:, None])
    rel = rows(positions, receivers) - rows(positions, senders)
    rel = rel + _f32(1e-9, dev)
    dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
    # the reference's centres are f64 (x64): the RBF is taken in f64 and
    # cast to the model's dtype where the gate reads it
    rbf = torch.exp(-((dist.double() - on_mesh(rbf_centres(cfg.n_rbf, device=dev), dist)[None])
                      ** 2))
    rbf = rbf.to(cfg.dtype)
    heads_root = _f32(cfg.n_heads ** 0.5, dev)
    for layer in params["layers"]:
        # node-side restriction first (N << E), then the edge gather
        src = rows(on_rows(lambda x: x[:, idx_active, :], x), senders)  # [E, A, C]
        # edge-frame gate (rotation stand-in, RBF conditioned; module doc)
        gate = _mlp(rbf, layer["rbf_gate"])                    # [E, I]
        src = src * on_rows(lambda g: g[:, idx_active, None], gate)
        # SO(2) per-|m| block-diagonal channel mix (the eSCN O(L^3) kernel)
        e = src.shape[0]
        out = torch.cat([(src[:, lo:hi, :].reshape(e, -1) @ w).reshape(e, hi - lo, c)
                         for (lo, hi), w in zip(ranges, layer["so2"])], dim=1)
        # graph attention over edges (the scalar channel drives the score)
        qh = rows(x[:, 0, :], receivers) @ layer["attn_q"]     # [E, H]
        kh = out[:, 0, :] @ layer["attn_k"]
        logits = (qh * kh).sum(-1) / heads_root
        alpha = segment_softmax(logits.to(F32), receivers, n).to(cfg.dtype)
        agg = segment_sum(out * alpha[:, None, None], receivers, n)  # [N, A, C]
        x = on_rows(lambda x, a: x.index_add(1, idx_active, a), x, agg)
        # scalar-channel FFN
        x = on_rows(lambda x, f: x.index_add(1, scalar, f), x,
                    _mlp(x[:, 0, :].clone(), layer["ffn"])[:, None])
    return _mlp(x[:, 0, :], params["head"])


# --------------------------------------------------------------------- GAT


@dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    dtype: Any = F32


def gat_init(key, cfg: GATConfig):
    """The reference's `gat_init` bit for bit: `a_src` and `a_dst` of a
    layer come from the same key, so they are equal."""
    ks = jr.split(key, 2 * cfg.n_layers)
    dev = key.device
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = cfg.n_classes if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        layers.append({
            "w": (jr.normal(ks[2 * i], (d_in, heads * h)) / _f32(d_in ** 0.5, dev)
                  ).to(cfg.dtype),
            "a_src": (jr.normal(ks[2 * i + 1], (heads, h)) * _f32(0.1, dev)
                      ).to(cfg.dtype),
            "a_dst": (jr.normal(ks[2 * i + 1], (heads, h)) * _f32(0.1, dev)
                      ).to(cfg.dtype),
        })
        d_in = heads * h
    return {"layers": layers}


def gat_forward(params, node_feat, senders, receivers, cfg: GATConfig):
    n = node_feat.shape[0]
    x = node_feat.to(cfg.dtype)
    for i, l in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        heads = 1 if last else cfg.n_heads
        h = l["w"].shape[1] // heads
        z = (x @ l["w"]).reshape(n, heads, h)
        e_src = (z * l["a_src"][None]).sum(-1)   # [N, H]
        e_dst = (z * l["a_dst"][None]).sum(-1)
        logits = torch.nn.functional.leaky_relu(rows(e_src, senders) + rows(e_dst, receivers),
                                                0.2)
        alpha = segment_softmax(logits.to(F32), receivers, n)   # per head
        msg = rows(z, senders) * alpha[..., None].to(cfg.dtype)
        x = segment_sum(msg, receivers, n).reshape(n, heads * h)
        if not last:
            x = torch.nn.functional.elu(x)
    return x


# --------------------------------------------------------------- GraphSAGE


@dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    sample_sizes: tuple = (25, 10)
    dtype: Any = F32


def sage_init(key, cfg: SAGEConfig):
    """The reference's `sage_init` bit for bit: `w_self` and `w_nbr` of a
    layer come from the same key, so they are equal."""
    ks = jr.split(key, cfg.n_layers)
    dev = key.device
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        root = _f32(d_in ** 0.5, dev)
        layers.append({
            "w_self": (jr.normal(ks[i], (d_in, d_out)) / root).to(cfg.dtype),
            "w_nbr": (jr.normal(ks[i], (d_in, d_out)) / root).to(cfg.dtype),
        })
        d_in = d_out
    return {"layers": layers}


def sage_forward_full(params, node_feat, senders, receivers, cfg: SAGEConfig):
    """Full-graph mean-aggregator forward."""
    n = node_feat.shape[0]
    x = node_feat.to(cfg.dtype)
    ones = torch.ones_like(senders, dtype=cfg.dtype)
    deg = torch.clamp(segment_sum(ones, receivers, n), min=1.0)
    for i, l in enumerate(params["layers"]):
        agg = segment_sum(rows(x, senders), receivers, n) / deg[:, None]
        x = x @ l["w_self"] + agg @ l["w_nbr"]
        if i < len(params["layers"]) - 1:
            x = _l2_normalize(torch.relu(x))
    return x


def _masked_mean(x, mask, dim: int):
    return (x * mask[..., None]).sum(dim) / torch.clamp(mask.sum(dim)[..., None], min=1.0)


def sage_forward_sampled(params, feats, nbr_feats, nbr_mask, cfg: SAGEConfig):
    """Minibatch forward on sampled two-hop neighborhoods.

    feats [B, d] seed features; nbr_feats {"h1": [B, F1, d], "h2": [B, F1,
    F2, d]}; nbr_mask {"h1": [B, F1], "h2": [B, F1, F2]} (models/sampling.py).
    """
    x_seed, x_h1, x_h2 = feats, nbr_feats["h1"], nbr_feats["h2"]
    m1, m2 = nbr_mask["h1"], nbr_mask["h2"]
    l1, l2 = params["layers"][0], params["layers"][1]
    # layer 1 on hop-1 nodes: aggregate hop 2
    agg2 = _masked_mean(x_h2, m2, 2)
    h1 = _l2_normalize(torch.relu(x_h1 @ l1["w_self"] + agg2 @ l1["w_nbr"]))
    # layer 1 on seeds: aggregate hop-1 raw features
    agg1 = _masked_mean(x_h1, m1, 1)
    h0 = _l2_normalize(torch.relu(x_seed @ l1["w_self"] + agg1 @ l1["w_nbr"]))
    # layer 2 on seeds: aggregate layer-1 hop-1 embeddings
    aggh = _masked_mean(h1, m1, 1)
    return h0 @ l2["w_self"] + aggh @ l2["w_nbr"]


INITS = {"meshgraphnet": mgn_init, "equiformer-v2": eqv2_init,
         "gat-cora": gat_init, "graphsage-reddit": sage_init}
