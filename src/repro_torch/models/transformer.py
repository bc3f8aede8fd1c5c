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
from repro_torch.models.act_sharding import constrain

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
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
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


def ffn_dense(x, p, act):
    a = _act(act)
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def moe_route(xt, router, m: MoEConfig):
    """The routing of `ffn_moe` for tokens xt [t, d] -> (top_p [t, k] f32,
    top_e [t, k], pos [t, k], keep [t, k], cap): the top-k experts of the
    router's softmax (ties to the lower index), their renormalised
    weights, each (token, k) row's slot in its expert's buffer (rows in
    row-major order), and whether the slot lies below the capacity."""
    t = xt.shape[0]
    probs = torch.softmax(xt.to(F32) @ router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :m.top_k], top_e[:, :m.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(t * m.top_k * m.capacity_factor / m.n_experts))
    onehot = F.one_hot(top_e, m.e_padded)                    # [t, k, Ep]
    pos_in_e = (torch.cumsum(onehot.reshape(t * m.top_k, m.e_padded), dim=0)
                - 1).reshape(t, m.top_k, m.e_padded)
    pos = torch.sum(pos_in_e * onehot, dim=-1)              # [t, k]
    return top_p, top_e, pos, pos < cap, cap


def ffn_moe(x, p, cfg: LMConfig):
    """Capacity-based top-k MoE (GShard-style scatter dispatch)."""
    m = cfg.moe
    a = _act(cfg.gated_act)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_e, pos, keep, cap = moe_route(xt, p["router"], m)
    ep = m.e_padded
    e_idx = top_e.reshape(-1)
    c_idx = torch.where(keep, pos, cap).reshape(-1)          # cap row = trash
    buf = torch.zeros((ep, cap + 1, d), dtype=cfg.dtype, device=x.device)
    buf = buf.index_put((e_idx, c_idx), xt.repeat_interleave(m.top_k, dim=0),
                        accumulate=True)[:, :cap]
    if ep % 16 == 0:  # expert-parallel layout (matches the param rules)
        buf = constrain(buf, "expert", None, None)
    h = a(torch.einsum("ecd,edf->ecf", buf, p["we_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["we_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["we_down"])  # [E, cap, d]
    out_buf = torch.cat([out_buf, out_buf.new_zeros((ep, 1, d))], dim=1)
    gathered = out_buf[e_idx, c_idx].reshape(t, m.top_k, d)
    yt = torch.sum(gathered * top_p[..., None].to(gathered.dtype), dim=1)
    if m.n_shared:
        yt = yt + (a(xt @ p["ws_gate"]) * (xt @ p["ws_up"])) @ p["ws_down"]
    return yt.reshape(b, s, d)


def layer_fwd(x, p, cfg: LMConfig, positions, kv=None, is_local=False,
              cache_len=None):
    """One transformer block. If kv is given (k_cache, v_cache [B,T,NKV,D]),
    runs in decode mode: writes the current k/v at position cache_len into
    the caches in place and attends over them."""
    b, s, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, nkv, hd)
    window = cfg.sliding_window if is_local else None
    if kv is None:
        q = constrain(q, "batch", None, "tp", None)
        k = constrain(k, "batch", None, None, None)
        mask = _causal_mask(s, s, 0, window, x.device)[None]
        out = attention(q, k, v, mask, cfg.attn_softcap)
        out = constrain(out, "batch", None, "tp", None)
        new_kv = (k, v)
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
    x = x + (out.reshape(b, s, nh * hd) @ p["wo"]).to(x.dtype)
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
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)  # gemma-style scale
    return x


def _unembed(params, x, cfg: LMConfig):
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ unembed.to(x.dtype)).to(F32)
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
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
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
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
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
    positions = torch.full((b, 1), 0, dtype=torch.int64, device=x.device) + cache_len
    li = 0
    for group in _groups(params, cfg):
        for p, is_local in group:
            x, _ = layer_fwd(x, p, cfg, positions, kv=(cache["k"][li], cache["v"][li]),
                             is_local=is_local, cache_len=cache_len)
            li += 1
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(params, x, cfg), cache


# ----------------------------------------------------------------- training


def lm_loss(params, tokens, cfg: LMConfig):
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()
