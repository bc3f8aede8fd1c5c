"""Shared helpers of the GNN parity tests: numpy-seeded graphs and inputs
for the four archs, and each arch's forward in the JAX package and in the
port on the same arrays."""
from __future__ import annotations

import numpy as np
import torch

import _torch_parity  # noqa: F401  (x64 as the other parity tests, one torch thread)
from repro_torch.models import gnn

GNN_ARCHS = ["meshgraphnet", "equiformer-v2", "gat-cora", "graphsage-reddit"]
JAX_INITS = {"meshgraphnet": "mgn_init", "equiformer-v2": "eqv2_init",
             "gat-cora": "gat_init", "graphsage-reddit": "sage_init"}
# f32 forward, loss and gradients against JAX: the matmuls' sums run in
# another order (XLA's Eigen against torch's GEMM: no f32 product of the
# two libraries is bit for bit, measured ~3e-7 relative), and XLA's exp
# and expm1 (segment softmax, RBF, elu) differ from torch's in the last
# bit; the segment max's gradient rule differs on ties, where the max
# cancels out of the softmax (~1e-7 relative). Measured <= 8e-7 relative.
GNN_TOL = dict(rtol=1e-5, atol=1e-6)


def graph(n: int = 40, e: int = 160, seed: int = 0):
    """(senders, receivers) int32 [e] with duplicate edges (rows 10-19
    repeat rows 0-9), self-loops (rows 20-24) and vertices of in-degree
    0 (the receivers avoid the last 4 ids)."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n - 4, e).astype(np.int32)
    snd[10:20], rcv[10:20] = snd[:10], rcv[:10]
    snd[20:25] = rcv[20:25]
    return snd, rcv


def features(arch: str, cfg, n: int, e: int, seed: int = 1) -> dict:
    """The arch's node (and edge) inputs as numpy f32."""
    rng = np.random.default_rng(seed)
    if arch == "meshgraphnet":
        return {"node_feat": rng.standard_normal((n, cfg.d_node_in)).astype(np.float32),
                "edge_feat": rng.standard_normal((e, cfg.d_edge_in)).astype(np.float32)}
    if arch == "equiformer-v2":
        return {"species": rng.standard_normal((n, 1)).astype(np.float32),
                "positions": rng.standard_normal((n, 3)).astype(np.float32)}
    return {"node_feat": rng.standard_normal((n, cfg.d_in)).astype(np.float32)}


def jax_forward(arch: str, params, feats: dict, snd, rcv, cfg):
    from repro.models import gnn as jg
    if arch == "meshgraphnet":
        return jg.mgn_forward(params, feats["node_feat"], feats["edge_feat"], snd, rcv, cfg)
    if arch == "equiformer-v2":
        return jg.eqv2_forward(params, feats["species"], feats["positions"], snd, rcv, cfg)
    if arch == "gat-cora":
        return jg.gat_forward(params, feats["node_feat"], snd, rcv, cfg)
    return jg.sage_forward_full(params, feats["node_feat"], snd, rcv, cfg)


def port_forward(arch: str, params, feats: dict, snd, rcv, cfg, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in feats.items()}
    s, r = (torch.from_numpy(a).to(device) for a in (snd, rcv))
    if arch == "meshgraphnet":
        return gnn.mgn_forward(params, t["node_feat"], t["edge_feat"], s, r, cfg)
    if arch == "equiformer-v2":
        return gnn.eqv2_forward(params, t["species"], t["positions"], s, r, cfg)
    if arch == "gat-cora":
        return gnn.gat_forward(params, t["node_feat"], s, r, cfg)
    return gnn.sage_forward_full(params, t["node_feat"], s, r, cfg)
