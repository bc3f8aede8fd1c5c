"""Epoch-keyed serving caches; port of `repro/serve/cache.py` (pure Python,
the port's own copy).

The engine's host epoch mirror is the one invalidation signal every read
cache needs: an update bumps it, a merge does not (a merge consolidates
storage without changing corpus contents, DESIGN.md §5). `EpochCache` is
that pattern extracted once and reused for every derived read product —
the overlay snapshot, the traversed walk matrix, full PPR score tables,
and the L2-normalized embedding view (serve/walk_queries.py) — instead of
each query kind hand-rolling its own `_cache/_epoch` field pair.

Keys are tuples whose FIRST element is the epoch counter the value was
derived at (extra elements carry value parameters, e.g. the PPR restart
probability); pinned snapshots at older epochs keep their entries live, so
a bounded LRU holds the last few epochs instead of exactly one. Hit/miss
counters feed `WalkQueryService.obs_counters()` and from there the
obs/export.py `summary(serve=...)` / Prometheus surfaces. Nothing here
syncs the device: keys are host scalars, values are device arrays.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Tuple


class EpochCache:
    """Bounded LRU over `(epoch, *params)` tuple keys with hit/miss counters.

    `max_entries` bounds device memory held by cached values: the serving
    steady state needs the current epoch plus any pinned ones, so a small
    constant (default 4) suffices — older epochs evict in LRU order.
    """

    def __init__(self, name: str, max_entries: int = 4):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.name = name
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple, compute: Callable[[], Any]):
        """The cached value for `key`, computing (and inserting) on miss.

        Hits return the SAME object every time — identity-stable values are
        what lets consumers (and tests) assert `x is y` across merges."""
        if key in self._entries:
            self.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        value = compute()
        self._entries[key] = value
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return value

    def peek(self, key: Tuple):
        """The cached value or None — no counters, no LRU touch."""
        return self._entries.get(key)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def counters(self, hit_key: str = None, miss_key: str = None) -> dict:
        """`{<name>_cache_hit: .., <name>_cache_miss: ..}` for obs export
        (override the key names where a legacy schema pins them)."""
        return {hit_key or f"{self.name}_cache_hit": self.hits,
                miss_key or f"{self.name}_cache_miss": self.misses}
