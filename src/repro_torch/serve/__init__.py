"""Serving frontend: batched queries over live walk corpora; port of
`repro/serve/`.

  * serve/walk_queries.py — `WalkQueryService`, the batched multi-query
    engine (FINDNEXT point lookups, walks-of, neighborhoods, PPR rows,
    embedding neighbors) with frontend input validation.
  * serve/batched.py — the bucketed query functions the service calls.
  * serve/cache.py — `EpochCache`, the epoch-keyed LRU of every derived
    read product (overlay, walk matrix, PPR tables, normalized
    embeddings).
  * serve/snapshots.py — `PinnedSnapshot`: epoch-stamped views that serve
    bit-identical answers across later stream windows (copy-on-pin of the
    pending rows, refcounted release).
"""
from repro_torch.serve.cache import EpochCache  # noqa: F401
from repro_torch.serve.snapshots import PinnedSnapshot, pin_snapshot  # noqa: F401
from repro_torch.serve.walk_queries import WalkQueryService  # noqa: F401
