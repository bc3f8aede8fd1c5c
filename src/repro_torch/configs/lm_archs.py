"""The five LM architectures with their published hyperparameters; port
of `repro/configs/lm_archs.py`.

Sources (as the reference records them):
  mistral-nemo-12b          [hf:mistralai/Mistral-Nemo-Base-2407]
  qwen1.5-110b              [hf:Qwen/Qwen1.5-*]
  gemma2-2b                 [arXiv:2408.00118]
  qwen2-moe-a2.7b           [hf:Qwen/Qwen1.5-MoE-A2.7B]
  llama4-maverick-400b-a17b [hf:meta-llama (unverified)] — text backbone
                            only; the early-fusion multimodal frontend is
                            a stub (the inputs are token ids).

Every arch is registered, the two that no single card holds
(qwen1.5-110b, llama4-maverick) included: a config costs nothing.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import LMConfig, MoEConfig


def _smoke(cfg: LMConfig) -> LMConfig:
    kw = dict(n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
              head_dim=16, d_ff=128, vocab_size=199, dtype=torch.float32,
              remat=False)
    if cfg.moe:
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_expert=32,
                              n_shared=min(cfg.moe.n_shared, 1),
                              d_shared=64 if cfg.moe.n_shared else 0)
    if cfg.sliding_window:
        kw["sliding_window"] = 4
    return cfg.replace(**kw)


MISTRAL_NEMO_12B = LMConfig(
    name="mistral-nemo-12b", n_layers=40, d_model=5120, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1_000_000.0, norm_eps=1e-5)

QWEN15_110B = LMConfig(
    name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, head_dim=128, d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6)

GEMMA2_2B = LMConfig(
    name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    head_dim=256, d_ff=9216, vocab_size=256000, gated_act="gelu",
    attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
    layer_pattern="local_global", tie_embeddings=True, norm_eps=1e-6)

QWEN2_MOE_A27B = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=151936,
    qkv_bias=True, norm_eps=1e-6,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632, pad_experts_to=64))

LLAMA4_MAVERICK = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
    rope_theta=500_000.0, norm_eps=1e-5,
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192,
                  n_shared=1, d_shared=8192))

_ALL = (MISTRAL_NEMO_12B, QWEN15_110B, GEMMA2_2B, QWEN2_MOE_A27B,
        LLAMA4_MAVERICK)

for _cfg in _ALL:
    register(ArchSpec(
        name=_cfg.name, family="lm",
        make_config=(lambda c: (lambda smoke=False: _smoke(c) if smoke else c))(_cfg),
        shapes=LM_SHAPES,
        notes=("full attention; long_500k lowered as decode (linear per-step "
               "cost vs KV cache) — see DESIGN.md"),
    ))
