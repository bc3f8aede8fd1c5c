"""The four GNN architectures with their published configs; port of
`repro/configs/gnn_archs.py`."""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gnn import EqV2Config, GATConfig, MGNConfig, SAGEConfig


def _mgn(smoke: bool = False) -> MGNConfig:
    if smoke:
        return MGNConfig(n_layers=2, d_hidden=16, mlp_layers=2,
                         d_node_in=4, d_edge_in=3)
    return MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2)


def _eqv2(smoke: bool = False) -> EqV2Config:
    if smoke:
        return EqV2Config(n_layers=2, d_hidden=8, l_max=2, m_max=1,
                          n_heads=2, n_rbf=8)
    return EqV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8)


def _gat(smoke: bool = False) -> GATConfig:
    if smoke:
        return GATConfig(n_layers=2, d_hidden=4, n_heads=2, d_in=32,
                         n_classes=7)
    return GATConfig(n_layers=2, d_hidden=8, n_heads=8)


def _sage(smoke: bool = False) -> SAGEConfig:
    if smoke:
        return SAGEConfig(n_layers=2, d_hidden=8, d_in=16, n_classes=5,
                          sample_sizes=(3, 2))
    return SAGEConfig(n_layers=2, d_hidden=128, sample_sizes=(25, 10))


register(ArchSpec(name="meshgraphnet", family="gnn", make_config=_mgn,
                  shapes=GNN_SHAPES,
                  notes="aggregator=sum; arXiv:2010.03409"))
register(ArchSpec(name="equiformer-v2", family="gnn", make_config=_eqv2,
                  shapes=GNN_SHAPES,
                  notes="eSCN SO(2) conv, l_max=6 m_max=2; arXiv:2306.12059; "
                        "Wigner rotation stubbed (DESIGN.md §2)"))
register(ArchSpec(name="gat-cora", family="gnn", make_config=_gat,
                  shapes=GNN_SHAPES, notes="arXiv:1710.10903"))
register(ArchSpec(name="graphsage-reddit", family="gnn", make_config=_sage,
                  shapes=GNN_SHAPES,
                  notes="mean aggregator, fanout 25-10; arXiv:1706.02216; "
                        "minibatch sampler = Wharf CSR machinery"))
