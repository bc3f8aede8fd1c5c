"""Arch registry (port of `repro/configs/base.py`): every architecture is a
selectable config with a FULL (paper-exact) and SMOKE (reduced) variant plus
its own input-shape set. The shape sets of the LM, GNN and recsys archs are
kept for the archs that register them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

LM_SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES: Dict[str, dict] = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(kind="sampled", n_nodes=232965, n_edges=114615892,
                         batch_nodes=1024, fanout=(15, 10), d_feat=602),
    "ogb_products": dict(kind="full", n_nodes=2449029, n_edges=61859140,
                         d_feat=100),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16),
}

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                      # lm | gnn | recsys | wharf
    make_config: Callable[..., Any]  # make_config(smoke: bool) -> model config
    shapes: Dict[str, dict]
    notes: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """All (arch, shape) cells of the registered archs."""
    import repro_torch.configs  # noqa: F401
    return tuple((a, s) for a in sorted(_REGISTRY)
                 for s in _REGISTRY[a].shapes)
