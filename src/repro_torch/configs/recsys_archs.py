"""dlrm-rm2 (arXiv:1906.00091) with its published sizes; port of
`repro/configs/recsys_archs.py`."""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.dlrm import DLRMConfig


def _dlrm(smoke: bool = False) -> DLRMConfig:
    if smoke:
        return DLRMConfig(n_dense=13, n_sparse=4, embed_dim=8,
                          table_rows=100, bot_mlp=(13, 16, 8),
                          top_mlp=(16, 16, 1))
    return DLRMConfig(n_dense=13, n_sparse=26, embed_dim=64,
                      table_rows=1_000_000,
                      bot_mlp=(13, 512, 256, 64),
                      top_mlp=(512, 512, 256, 1))


register(ArchSpec(
    name="dlrm-rm2", family="recsys", make_config=_dlrm,
    shapes=RECSYS_SHAPES,
    notes="interaction=dot; embedding tables row-sharded over `model`; "
          "EmbeddingBag = take + segment_sum; retrieval_cand = batched dot "
          "over 1M candidates (Wharf-walk candidate generation optional)"))
