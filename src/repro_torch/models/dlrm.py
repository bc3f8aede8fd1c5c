"""DLRM-RM2: sparse embedding tables, dot interaction and MLPs; port of
`repro/models/dlrm.py`.

EmbeddingBag is a gather and a sum over the bag, as the reference's
`jnp.take` + sum (no `nn.EmbeddingBag`). The reference maps
`embedding_bag` over the fields with `vmap`; the port gathers every
field's bag in one indexing (`_bags`), the same sums. `retrieval_score`
scores one query against [N, D] candidate embeddings as one product.
The tables, 26 x 1,000,000 x 64 f32 at full width, are drawn as one
`normal` in slabs of the flat index (`random.scaled_normal`), bit for
bit the reference's draw. On a mesh (DTensor tables, rows cut over
"model") the bags are a masked lookup of each rank's rows and one
all-reduce of the partial bags (`_sharded_bags`), as the reference's
partition does; the tables are never gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch import random as jr
from repro_torch.models.act_sharding import from_local, is_dtensor, reshard, to_local

F32 = torch.float32


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    table_rows: int = 1_000_000           # rows per sparse table
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    multi_hot: int = 1                     # lookups per field (bag size)
    dtype: Any = F32

    @property
    def d_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2 + self.embed_dim


def _root(a: int, device) -> torch.Tensor:
    """sqrt(a) as a tensor on the device: a division by it is a true
    division there too (a CUDA tensor over a Python scalar is multiplied by
    the scalar's reciprocal, an ulp off the reference's quotient)."""
    return torch.tensor(a ** 0.5, dtype=F32, device=device)


def _mlp_params(key, sizes, dtype):
    ks = jr.split(key, len(sizes) - 1)
    return [{"w": (jr.normal(k, (a, b)) / _root(a, key.device)).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=key.device)}
            for k, (a, b) in zip(ks, zip(sizes[:-1], sizes[1:]))]


def _mlp(x, layers, final_act=False):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def dlrm_init(key, cfg: DLRMConfig):
    """The reference's `dlrm_init` bit for bit, on the key's device."""
    k1, k2, k3 = jr.split(key, 3)
    top_in = cfg.d_interact
    return {
        "tables": jr.scaled_normal(
            k1, (cfg.n_sparse, cfg.table_rows, cfg.embed_dim), 0.01, cfg.dtype),
        "bot": _mlp_params(k2, list(cfg.bot_mlp), cfg.dtype),
        "top": _mlp_params(k3, [top_in] + list(cfg.top_mlp)[1:], cfg.dtype),
    }


def embedding_bag(table, indices, offsets_mask=None):
    """Sum-bag lookup: indices [B, H] -> [B, D] (gather, then a sum over
    the bag; `offsets_mask` [B, H] weights each lookup)."""
    emb = table[indices]                             # [B, H, D]
    if offsets_mask is not None:
        emb = emb * offsets_mask[..., None]
    return emb.sum(dim=1)


def _bags(tables, sparse_idx):
    """One bag per sparse field: tables [F, R, D], sparse_idx [B, F, H] ->
    [B, F, D], `embedding_bag(tables[f], sparse_idx[:, f])` for every f."""
    if is_dtensor(tables):
        return _sharded_bags(tables, sparse_idx)
    fields = torch.arange(tables.shape[0], device=tables.device)[None, :, None]
    return tables[fields, sparse_idx].sum(dim=2)


def _sharded_bags(tables, sparse_idx):
    """`_bags` of DTensor tables whose rows are sharded (the rule's
    `P(None, TP, None)`): each rank looks up the indices that fall in its
    rows, zeros elsewhere, and the partial bags are summed over the rows'
    mesh dims (one all-reduce, the reference's). The tables are never
    gathered; the indices keep their batch placements."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.models.act_sharding import from_local, shard_range, spanning, to_local
    mesh = tables.device_mesh
    rows = spanning(tables, 1)
    place = [Replicate()] * mesh.ndim
    for i in rows:
        place[i] = tables.placements[i]
    tables = tables.redistribute(mesh, place)
    idx_place = [Replicate() if i in rows else p for i, p in enumerate(sparse_idx.placements)]
    sparse_idx = sparse_idx.redistribute(mesh, idx_place)
    r0, n_rows = shard_range(tables, 1)
    local, idx = to_local(tables, sparse_idx), sparse_idx.to_local().long()
    mine = (idx >= r0) & (idx < r0 + n_rows)
    fields = torch.arange(local.shape[0], device=local.device)[None, :, None]
    emb = local[fields, torch.where(mine, idx - r0, 0)] * mine[..., None].to(local.dtype)
    part = [Partial() if i in rows else p for i, p in enumerate(idx_place)]
    bags = from_local(emb.sum(dim=2), mesh, part,
                      (sparse_idx.shape[0], tables.shape[0], tables.shape[2]))
    return bags.redistribute(mesh, idx_place)


def _interact(x, bags):
    """The dot interaction: the bottom MLP's output and the bags' pairwise
    products above the diagonal, in `triu_indices` order (row-major, as
    `jnp.triu_indices`) -> [B, D + F(F-1)/2]."""
    feats = torch.cat([x[:, None, :], bags], dim=1)  # [B, F, D]
    f = feats.shape[1]
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)
    iu, ju = torch.triu_indices(f, f, offset=1, device=x.device)
    if is_dtensor(inter):
        # each rank picks its rows' pairs (DTensor's index_put, the pick's
        # backward, takes no index list with a whole dim in torch 2.11)
        inter = reshard(inter, "batch", None, None)
        pairs = from_local(to_local(inter)[:, iu, ju], inter.device_mesh, inter.placements,
                           (inter.shape[0], iu.numel()))
    else:
        pairs = inter[:, iu, ju]
    return torch.cat([x, pairs], dim=1)


def dlrm_forward(params, dense, sparse_idx, cfg: DLRMConfig):
    """dense [B, n_dense]; sparse_idx [B, n_sparse, multi_hot] -> logits [B]."""
    x = _mlp(dense.to(cfg.dtype), params["bot"], final_act=True)  # [B, D]
    top_in = _interact(x, _bags(params["tables"], sparse_idx))
    return _mlp(top_in, params["top"])[:, 0]


def dlrm_loss(params, dense, sparse_idx, labels, cfg: DLRMConfig):
    """The mean logistic loss, written out as the reference's formula."""
    logits = dlrm_forward(params, dense, sparse_idx, cfg)
    return torch.mean(
        torch.maximum(logits, torch.zeros((), dtype=logits.dtype, device=logits.device))
        - logits * labels + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_score(params, dense, sparse_idx, cand_emb, cfg: DLRMConfig):
    """Score queries against [N_cand, D] candidate embeddings (one product)."""
    x = _mlp(dense.to(cfg.dtype), params["bot"], final_act=True)  # [B, D]
    q = x + _bags(params["tables"], sparse_idx).mean(dim=1)        # query tower
    return q @ cand_emb.T                            # [B, N_cand]
