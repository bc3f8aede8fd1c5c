"""Decoder-only transformer LM of the five LM architectures; port of
`repro/models/transformer.py`.

Features (selected per config): GQA, explicit head_dim, QKV bias (qwen),
alternating local/global sliding-window attention and logit softcapping
(gemma2), RoPE, RMSNorm, SwiGLU/GeGLU, MoE with shared and routed experts
and top-k routing (qwen2-moe, llama4), tied embeddings. Parameters keep
the reference's tree: the `layers` leaves are stacked `[L, ...]`, so a JAX
leaf maps one to one to a port leaf (`convert.lm_params_from_numpy`). The
reference's `lax.scan` over layers (or over (local, global) pairs) is a
loop over the same groups, each under `torch.utils.checkpoint` when
`cfg.remat` and gradients are on.

`act_sharding.constrain` is called where the reference calls it: on q, k,
the attention output, the logits and the expert-parallel MoE buffer. It is
the identity on plain tensors and without an ambient mesh
(`launch.mesh.set_mesh`); on DTensors under a mesh it redistributes to the
logical names' placements.

On DTensors (a plan run by `launch.steps.partition`) the step is one
rank's share, as the reference's SPMD partition is: FSDP weights are
gathered over the mesh dims that cut the batch (`gather_fsdp`), the
residual stream is cut over the batch only, the column-parallel products
are cut over "tp" and the row-parallel ones reduced back; the query heads
stay cut over "tp" where the KV heads divide it, else the queries are cut
along the sequence. Written out on each rank's shards: the vocab-sharded
embedding (a masked lookup, `row_lookup`) and loss (`_vocab_sharded_nll`),
causal attention (`_sharded_attention`), decode attention over a cache
whose length is cut (`_sharded_decode_attention`: local scores, the
softmax's max and sum and the weighted values all-reduced), and the MoE
dispatch, which runs on every rank's whole copy of the tokens (`ffn_moe`).

Numerics follow the reference's casts: RMSNorm's f32 statistics cast back
to the input's dtype, attention scores cast to f32 before the softcap,
probabilities cast to v's dtype, the unembedding in the activations' dtype
before f32. A Python scalar that meets a bf16 tensor is rounded to bf16
first, as JAX's weak types do (`_weak`): the attention scale at head_dim
128 is 11.3125, not 11.3137. `jax.nn.gelu` is the tanh approximation.

MoE uses capacity-based scatter dispatch (GShard-style) as the reference:
top-k over the router's softmax (ties to the lower expert index, as
`lax.top_k`), each (token, k) row's slot in its expert's buffer by a
cumsum in row order, rows beyond `cap` dropped into a trash row.

No kernel of the port is launched here: attention, the MoE dispatch and
the losses are plain torch, as the reference's are plain `jnp`.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random as jr
from repro_torch.models.act_sharding import (all_reduce, constrain, extent, from_local,
                                             gather_fsdp, is_dtensor, on_mesh, on_whole,
                                             reshard, row_lookup, shard_range, spanning,
                                             to_local)

F32 = torch.float32


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int             # per-expert FFN hidden size
    n_shared: int = 0         # always-on shared experts
    d_shared: int = 0         # shared-expert hidden size (total)
    capacity_factor: float = 1.25
    # expert-weight storage padded to a shard multiple (qwen2-moe's 60 ->
    # 64); the padded experts have no router column and are never chosen
    pad_experts_to: Optional[int] = None

    @property
    def e_padded(self) -> int:
        return self.pad_experts_to or self.n_experts


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # window for local layers
    layer_pattern: str = "global"          # "global" | "local_global"
    gated_act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline accounting)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe:
            m = self.moe
            ffn = (m.n_experts * 3 * d * m.d_expert + d * m.n_experts
                   + (3 * d * m.d_shared if m.n_shared else 0))
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: routed top-k + shared)."""
        if not self.moe:
            return self.param_count()
        d, hd = self.d_model, self.hd
        m = self.moe
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ffn = (m.top_k * 3 * d * m.d_expert + d * m.n_experts
               + (3 * d * m.d_shared if m.n_shared else 0))
        per_layer = attn + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


# ------------------------------------------------------------------ params


def layer_param_specs(cfg: LMConfig) -> Dict[str, tuple]:
    """One layer's leaves: name -> (how, shape, dtype), `how` the index of
    the layer key that draws it (scaled by 1/sqrt(shape[0]), so the experts'
    by 1/sqrt(e_padded)), or "ones" / "zeros"."""
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    s = {"wq": (0, (d, nh * hd), dt), "wk": (1, (d, nkv * hd), dt),
         "wv": (2, (d, nkv * hd), dt), "wo": (3, (nh * hd, d), dt),
         "ln1": ("ones", (d,), F32), "ln2": ("ones", (d,), F32)}
    if cfg.qkv_bias:
        s.update(bq=("zeros", (nh * hd,), dt), bk=("zeros", (nkv * hd,), dt),
                 bv=("zeros", (nkv * hd,), dt))
    if cfg.moe:
        m = cfg.moe
        ep = m.e_padded
        s.update(router=(4, (d, m.n_experts), F32),
                 we_gate=(5, (ep, d, m.d_expert), dt),
                 we_up=(6, (ep, d, m.d_expert), dt),
                 we_down=(7, (ep, m.d_expert, d), dt))
        if m.n_shared:
            s.update(ws_gate=(8, (d, m.d_shared), dt),
                     ws_up=(9, (d, m.d_shared), dt),
                     ws_down=(10, (m.d_shared, d), dt))
    else:
        s.update(w_gate=(4, (d, cfg.d_ff), dt), w_up=(5, (d, cfg.d_ff), dt),
                 w_down=(6, (cfg.d_ff, d), dt))
    return s


def param_specs(cfg: LMConfig) -> Dict[str, Any]:
    """The parameter tree as meta tensors (shapes and dtypes, no data):
    {"embed", "final_ln", ["unembed"], "layers": {name: [L, ...]}}."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    d, v = cfg.d_model, cfg.vocab_size
    out = {"embed": meta((v, d), cfg.dtype), "final_ln": meta((d,), F32),
           "layers": {k: meta((cfg.n_layers,) + shape, dt)
                      for k, (_, shape, dt) in layer_param_specs(cfg).items()}}
    if not cfg.tie_embeddings:
        out["unembed"] = meta((d, v), cfg.dtype)
    return out


def _dense(key, shape, dtype, scale=None, out=None):
    scale = scale or (1.0 / (shape[0] ** 0.5))
    return jr.scaled_normal(key, shape, scale, dtype, out=out)


def _init_leaf(keys, how, shape, dtype, out=None):
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=keys.device)
    if how == "ones":
        return out.fill_(1)
    if how == "zeros":
        return out.zero_()
    return _dense(keys[how], shape, dtype, out=out)


def init_layer_params(key, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """One layer's parameters from one key [2] (12 subkeys)."""
    ks = jr.split(key, 12)
    return {k: _init_leaf(ks, how, shape, dt)
            for k, (how, shape, dt) in layer_param_specs(cfg).items()}


def init_params(key, cfg: LMConfig) -> Dict[str, Any]:
    """The reference's `init_params` bit for bit, on the key's device. The
    stacked layer leaves are filled layer by layer in place (no second copy
    of the [L, ...] weights), each weight drawn in slabs."""
    k_emb, k_out, k_layers = jr.split(key, 3)
    layer_keys = jr.split(k_layers, cfg.n_layers)
    specs = layer_param_specs(cfg)
    layers = {k: torch.empty((cfg.n_layers,) + shape, dtype=dt, device=key.device)
              for k, (_, shape, dt) in specs.items()}
    for i in range(cfg.n_layers):
        ks = jr.split(layer_keys[i], 12)
        for k, (how, shape, dt) in specs.items():
            _init_leaf(ks, how, shape, dt, out=layers[k][i])
    params = {
        "embed": _dense(k_emb, (cfg.vocab_size, cfg.d_model), cfg.dtype, 0.02),
        "final_ln": torch.ones((cfg.d_model,), dtype=F32, device=key.device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _dense(k_out, (cfg.d_model, cfg.vocab_size), cfg.dtype)
    return params


# ------------------------------------------------------------------- layers


def _weak(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type meets `like`: rounded to its
    dtype first (to bf16 for a bf16 tensor, where torch would keep the
    scalar in f32)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def rmsnorm(x, w, eps):
    x32 = x.to(F32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * w).to(x.dtype)


def rope(x, positions, theta):
    """x: [B, S, H, D]; positions: [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (on_mesh(torch.arange(0, half, dtype=F32, device=x.device), x)
                             / half))
    ang = positions[..., None].to(F32) * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def attention(q, k, v, mask, softcap=None):
    """q: [B,S,NH,D], k/v: [B,T,NKV,D] -> [B,S,NH,D] with GQA groups."""
    b, s, nh, d = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    q = q.reshape(b, s, nkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / _weak(d ** 0.5, q)
    scores = _softcap(scores.to(F32), softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, nh, d)


def _causal_mask(s, t, offset, window, device=None):
    """[s, t] mask; offset = absolute position of query 0 minus key 0."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _act(name: str):
    return F.silu if name == "silu" else _gelu


def _w(p, name, x):
    """Weight `name` of `p` for a product with `x` (`gather_fsdp`)."""
    return gather_fsdp(p[name], x)


def ffn_dense(x, p, act):
    a = _act(act)
    h = a(x @ _w(p, "w_gate", x)) * (x @ _w(p, "w_up", x))
    return reshard(h @ _w(p, "w_down", h), "batch", *[None] * (h.dim() - 1))


def _top_k(logits, m: MoEConfig):
    """The top-k experts of the router's softmax (ties to the lower index)
    and their renormalised weights."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :m.top_k], top_e[:, :m.top_k]
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_e


def moe_route(xt, router, m: MoEConfig):
    """The routing of `ffn_moe` for tokens xt [t, d] -> (top_p [t, k] f32,
    top_e [t, k], pos [t, k], keep [t, k], cap): the top-k experts of the
    router's softmax (ties to the lower index), their renormalised
    weights, each (token, k) row's slot in its expert's buffer (rows in
    row-major order), and whether the slot lies below the capacity."""
    t = xt.shape[0]
    logits = xt.to(F32) @ router
    if is_dtensor(logits):
        # each rank ranks its own tokens' experts (torch 2.11's DTensor
        # sort has no backward)
        logits = reshard(logits, "batch", None)
        top_p, top_e = _top_k(to_local(logits), m)
        top_p, top_e = (from_local(v, logits.device_mesh, logits.placements, (t, m.top_k))
                        for v in (top_p, top_e))
    else:
        top_p, top_e = _top_k(logits, m)
    cap = max(1, int(t * m.top_k * m.capacity_factor / m.n_experts))
    onehot = F.one_hot(top_e, m.e_padded)                    # [t, k, Ep]
    pos_in_e = (torch.cumsum(onehot.reshape(t * m.top_k, m.e_padded), dim=0)
                - 1).reshape(t, m.top_k, m.e_padded)
    pos = torch.sum(pos_in_e * onehot, dim=-1)              # [t, k]
    return top_p, top_e, pos, pos < cap, cap


def _dispatch(xt, top_e, pos, keep, m: MoEConfig, cap: int):
    """The expert buffer [Ep, cap, d]: each kept (token, k) row added at
    its slot, the rows beyond the capacity into a trash row cut off."""
    e_idx = top_e.reshape(-1)
    c_idx = torch.where(keep, pos, cap).reshape(-1)          # cap row = trash
    buf = torch.zeros((m.e_padded, cap + 1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    return buf.index_put((e_idx, c_idx), xt.repeat_interleave(m.top_k, dim=0),
                         accumulate=True)[:, :cap]


def _combine(out_buf, top_e, pos, keep, top_p, m: MoEConfig, cap: int):
    """Each token's experts' outputs weighted by their routing weights
    (a dropped row reads the zero trash row) -> [t, d]."""
    e_idx = top_e.reshape(-1)
    c_idx = torch.where(keep, pos, cap).reshape(-1)
    ep, _, d = out_buf.shape
    out_buf = torch.cat([out_buf, out_buf.new_zeros((ep, 1, d))], dim=1)
    gathered = out_buf[e_idx, c_idx].reshape(top_e.shape[0], m.top_k, d)
    return torch.sum(gathered * top_p[..., None].to(gathered.dtype), dim=1)


def ffn_moe(x, p, cfg: LMConfig):
    """Capacity-based top-k MoE (GShard-style scatter dispatch). Under a
    mesh the routing reads the batch-sharded tokens, and the dispatch and
    combine run on every rank's whole copy of the tokens and routes (the
    capacity slots depend on every token before them: `on_whole`); the
    expert buffer is then cut over the experts (expert-parallel) or each
    expert's columns (the rule's tensor-parallel case)."""
    m = cfg.moe
    a = _act(cfg.gated_act)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_e, pos, keep, cap = moe_route(xt, _w(p, "router", xt), m)
    buf = on_whole(lambda *v: _dispatch(*v, m, cap), xt.to(cfg.dtype), top_e, pos, keep)
    if m.e_padded % 16 == 0:  # expert-parallel layout (matches the param rules)
        buf = constrain(buf, "expert", None, None)
    h = a(torch.einsum("ecd,edf->ecf", buf, p["we_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["we_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["we_down"])  # [E, cap, d]
    yt = on_whole(lambda *v: _combine(*v, m, cap), out_buf, top_e, pos, keep, top_p)
    if m.n_shared:
        sh = (a(xt @ _w(p, "ws_gate", xt)) * (xt @ _w(p, "ws_up", xt)))
        yt = yt + reshard(sh @ _w(p, "ws_down", sh), "batch", None)
    return reshard(yt.reshape(b, s, d), "batch", None, None)


def _sharded_attention(q, k, v, window, softcap):
    """Causal attention of DTensors on each rank's shards: q [B, S, NH, D]
    cut over the batch and over the heads or the sequence; k and v [B, T,
    NKV, D] placed to match (the same batch and heads, the key sequence
    whole), the mask built for this rank's query positions. -> placed as q."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    kv_place = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in q.placements]
    k, v = (t.redistribute(mesh, kv_place) for t in (k, v))
    s0, sn = shard_range(q, 1)
    ql, kl, vl = to_local(q, k), to_local(k, q), to_local(v, q)
    mask = _causal_mask(sn, kl.shape[1], s0, window, ql.device)[None]
    return from_local(attention(ql, kl, vl, mask, softcap), mesh, q.placements, tuple(q.shape))


def _sharded_decode_attention(q, k, v, kv, cache_len, window, softcap):
    """Decode attention over DTensor caches [B, T, NKV, D] on this rank's
    shard of them: the new k and v written where this rank holds position
    `cache_len`, scores against the local keys only, then the softmax's
    max and sum and the weighted values all-reduced over the mesh dims
    that cut the cache length. Each rank keeps its share of the work; the
    caches are never gathered. -> [B, 1, NH, D] placed as the caches, the
    length dim whole."""
    from torch.distributed.tensor import Replicate
    kc, vc = kv
    mesh = kc.device_mesh
    tdims = spanning(kc, 1)
    place = [Replicate() if i in tdims else p for i, p in enumerate(kc.placements)]
    shape = tuple(q.shape)
    q, k, v = (t.redistribute(mesh, place).to_local() for t in (q, k, v))
    kl, vl = kc.to_local(), vc.to_local()
    t0, tn = shard_range(kc, 1)
    pos = int(cache_len.to_local() if is_dtensor(cache_len) else cache_len)
    if t0 <= pos < t0 + tn:
        kl[:, pos - t0] = k[:, 0].to(kl.dtype)
        vl[:, pos - t0] = v[:, 0].to(vl.dtype)
    b, s, nh, d = q.shape
    nkv = kl.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kl) / _weak(d ** 0.5, q)
    scores = _softcap(scores.to(F32), softcap)
    kj = t0 + torch.arange(tn, device=kl.device)
    m = kj <= pos
    if window is not None:
        m &= kj > pos - window
    scores = torch.where(m, scores, -1e30)
    p = torch.exp(scores - all_reduce(scores.amax(-1, keepdim=True), "max", mesh, tdims))
    probs = (p / all_reduce(p.sum(-1, keepdim=True), "sum", mesh, tdims)).to(vl.dtype)
    out = all_reduce(torch.einsum("bkgst,btkd->bskgd", probs, vl), "sum", mesh, tdims)
    return from_local(out.reshape(b, s, nh, d), mesh, place, shape)


def layer_fwd(x, p, cfg: LMConfig, positions, kv=None, is_local=False,
              cache_len=None):
    """One transformer block. If kv is given (k_cache, v_cache [B,T,NKV,D]),
    runs in decode mode: writes the current k/v at position cache_len into
    the caches in place and attends over them."""
    b, s, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = h @ _w(p, "wq", h)
    k = h @ _w(p, "wk", h)
    v = h @ _w(p, "wv", h)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # under a mesh the head columns stay cut over "tp" where the KV heads
    # divide it (the reference's constraints); else the queries are cut
    # along the sequence (whole in decode) and k and v are whole
    q_spec = ("batch", None, "tp", None)
    if nkv % extent("tp"):
        q_spec = ("batch", "seq" if kv is None else None, None, None)
        q = reshard(q, *q_spec[:2], None)
        k, v = (reshard(t, "batch", None, None) for t in (k, v))
    q = rope(q.reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, nkv, hd)
    window = cfg.sliding_window if is_local else None
    if kv is None:
        q = constrain(q, *q_spec)
        k = constrain(k, "batch", None, None, None)
        if is_dtensor(q):
            out = _sharded_attention(q, k, v, window, cfg.attn_softcap)
        else:
            mask = _causal_mask(s, s, 0, window, x.device)[None]
            out = attention(q, k, v, mask, cfg.attn_softcap)
        out = constrain(out, *q_spec)
        new_kv = (k, v)
    elif is_dtensor(kv[0]):
        out = _sharded_decode_attention(q, k, v, kv, cache_len, window, cfg.attn_softcap)
        new_kv = kv
    else:
        kc, vc = kv
        t = kc.shape[1]
        kc[:, cache_len] = k[:, 0].to(kc.dtype)
        vc[:, cache_len] = v[:, 0].to(vc.dtype)
        kj = torch.arange(t, device=x.device)[None, :]
        m = kj <= cache_len
        if window is not None:
            m &= kj > cache_len - window
        mask = torch.broadcast_to(m, (b, t))[:, None, :]     # [B, S=1, T]
        out = attention(q, kc, vc, mask, cfg.attn_softcap)
        new_kv = (kc, vc)
    # the row-parallel output projection: heads cut over "tp", the partial
    # sums reduced back onto the residual stream's placements
    out = reshard(out.reshape(b, s, nh * hd), "batch", None, "tp")
    x = x + reshard((out @ _w(p, "wo", out)).to(x.dtype), "batch", None, None)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe:
        y = ffn_moe(h, p, cfg)
    else:
        y = ffn_dense(h, p, cfg.gated_act)
    return x + y.to(x.dtype), new_kv


# ------------------------------------------------------------ full forward


def _paired(cfg: LMConfig) -> bool:
    """local/global alternation runs (local, global) LAYER PAIRS as one
    scan body (one checkpoint a pair under remat)."""
    return (cfg.sliding_window is not None
            and cfg.layer_pattern == "local_global"
            and cfg.n_layers % 2 == 0)


def _pair_params(layers, n_layers: int):
    return {k: v.reshape(n_layers // 2, 2, *v.shape[1:]) for k, v in layers.items()}


def _groups(params, cfg: LMConfig):
    """The scan bodies' parameters in order: per body a list of (layer
    dict, is_local) — a (local, global) pair when paired, else one
    layer. Views of the stacked leaves (`unbind`, whose gradient is one
    stack)."""
    layers = params["layers"]
    if _paired(cfg):
        pairs = _pair_params(layers, cfg.n_layers)
        names = list(pairs)
        out = []
        for vals in zip(*(pairs[k].unbind(0) for k in names)):
            pair = dict(zip(names, vals))
            out.append([({k: q[0] for k, q in pair.items()}, True),
                        ({k: q[1] for k, q in pair.items()}, False)])
        return out
    names = list(layers)
    return [[(dict(zip(names, vals)), False)]
            for vals in zip(*(layers[k].unbind(0) for k in names))]


def _embed(params, tokens, cfg: LMConfig):
    if is_dtensor(params["embed"]):
        # the vocab-sharded table: a masked lookup of each rank's rows
        x = reshard(row_lookup(params["embed"], tokens).to(cfg.dtype), "batch", None, None)
    else:
        x = params["embed"][tokens].to(cfg.dtype)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)  # gemma-style scale
    return x


def _unembed(params, x, cfg: LMConfig):
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ gather_fsdp(unembed, x).to(x.dtype)).to(F32)
    # vocab-sharded logits: [B, S, V] from forward, [B, V] from prefill
    logits = constrain(logits, "batch", *[None] * (logits.dim() - 2), "tp")
    return _softcap(logits, cfg.final_softcap)


def _body(x, group, cfg, positions):
    for p, is_local in group:
        x, _ = layer_fwd(x, p, cfg, positions, is_local=is_local)
    return x


def forward(params, tokens, cfg: LMConfig):
    """tokens [B, S] -> logits [B, S, V] f32 (training / prefill, causal)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = on_mesh(torch.arange(s, device=x.device)[None].expand(b, s), x)
    remat = cfg.remat and torch.is_grad_enabled()
    for group in _groups(params, cfg):
        body = functools.partial(_body, group=group, cfg=cfg, positions=positions)
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(params, x, cfg)


@torch.no_grad()
def prefill(params, tokens, cfg: LMConfig):
    """Causal forward over a full prompt -> (last-token logits [B, V] f32,
    KV cache {"k", "v"} [L, B, S, NKV, D]). Only the final position's
    logits are computed against the vocabulary."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = on_mesh(torch.arange(s, device=x.device)[None].expand(b, s), x)
    ks, vs = [], []
    for group in _groups(params, cfg):
        for p, is_local in group:
            x, (k, v) = layer_fwd(x, p, cfg, positions, is_local=is_local)
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x[:, -1], params["final_ln"], cfg.norm_eps)  # [B, D]
    return _unembed(params, x, cfg), {"k": torch.stack(ks), "v": torch.stack(vs)}


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


@torch.no_grad()
def decode_step(params, token, cache, cache_len, cfg: LMConfig):
    """One decode step: token [B, 1]; cache [L,B,T,NKV,D] -> (logits
    [B, 1, V] f32, cache). The new position's k and v are written into
    `cache` in place (the reference returns an updated copy); `cache_len`
    is an int or a 0-d tensor."""
    b = token.shape[0]
    x = _embed(params, token, cfg)
    positions = on_mesh(torch.full((b, 1), 0, dtype=torch.int64, device=x.device), x) + cache_len
    li = 0
    for group in _groups(params, cfg):
        for p, is_local in group:
            x, _ = layer_fwd(x, p, cfg, positions, kv=(cache["k"][li], cache["v"][li]),
                             is_local=is_local, cache_len=cache_len)
            li += 1
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(params, x, cfg), cache


# ----------------------------------------------------------------- training


def _vocab_sharded_nll(logits, targets):
    """-log softmax(logits)[target] of DTensor logits whose vocab dim is
    sharded, without gathering them: each rank takes its vocab slice's max
    (all-reduced by max), its sum of exps and the targets its slice holds;
    the sums are partial over the vocab's mesh dims. The gradient reaches
    the logits on their own placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    vocab = spanning(logits, -1)
    place = [p if isinstance(p, Shard) and p.dim < targets.dim() else Replicate()
             for p in logits.placements]
    part = [Partial() if i in vocab else p for i, p in enumerate(place)]
    shape = tuple(logits.shape[:-1])
    ll = to_local(logits)
    z = ll - all_reduce(ll.detach().amax(-1, keepdim=True), "max", mesh, vocab)
    sumexp = from_local(torch.exp(z).sum(-1), mesh, part, shape)
    targets = targets.redistribute(mesh, place).to_local()
    v0, n_v = shard_range(logits, -1)
    mine = (targets >= v0) & (targets < v0 + n_v)
    pick = torch.gather(z, -1, torch.where(mine, targets - v0, 0)[..., None])[..., 0]
    pick = from_local(pick * mine.to(z.dtype), mesh, part, shape)
    # both sums reduced before they meet (torch 2.11's DTensor sends a
    # whole operand's gradient wrongly through a partial-sum difference)
    return torch.log(sumexp.redistribute(mesh, place)) - pick.redistribute(mesh, place)


def lm_loss(params, tokens, cfg: LMConfig):
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()
    if is_dtensor(logits):
        return _vocab_sharded_nll(logits, targets).mean()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()
