"""Walk-query serving frontend: batched reads over a WalkEngine; port of
`repro/serve/walk_queries.py`.

The paper's consumers (GRL trainers, PPR scorers, recommenders) read the
maintained corpus while updates keep arriving. A snapshot is an `Overlay`
over the base store plus the pending version blocks, resolved per corpus
slot by slot-epoch precedence: no query forces a merge, and reads between
merges return exactly the post-merge answer.

  * every query kind is one batched function (serve/batched.py), its
    batch padded to a power-of-two bucket;
  * derived read products (overlay, walk matrix, PPR tables, normalized
    embeddings) live in epoch-keyed caches (serve/cache.py): an update
    invalidates, a merge does not;
  * `pin()` returns a `PinnedSnapshot` (serve/snapshots.py) that keeps
    serving bit-identical answers while the engine streams on.

Query kinds:
  * next_vertices(v, w, p)  — batched FINDNEXT point lookups
  * walks_of(vertices)      — all walks visiting the given vertices
  * neighborhoods(seeds)    — walk-based neighborhoods, gathered from the
                              cached walk matrix
  * ppr_rows(vs)            — personalized-PageRank rows, gathered from an
                              (epoch, restart_prob)-cached table
  * embedding_neighbors(v)  — cosine nearest neighbors in the maintained
                              embedding table (downstream/maintainer.py)

The service runs on its engine's device. Out-of-range ids and an over-wide
top-k raise `ValueError` here, before any gather could clamp them; the
check reads the ids' min and max (for ids on the card, one small copy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import packed_store
from repro_torch.core.overlay import Overlay
from repro_torch.core.store import WalkStore
from repro_torch.obs import slo, trace
from repro_torch.serve import batched
from repro_torch.serve.cache import EpochCache
from repro_torch.serve.snapshots import PinnedSnapshot, pin_snapshot

I64 = torch.int64


def _as_ids(ids, device) -> torch.Tensor:
    """Query ids (a list, numpy, or a tensor on any device) -> int64 1-D on
    `device`."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=I64).reshape(-1)
    return torch.from_numpy(np.asarray(ids, dtype=np.int64).reshape(-1)
                            ).to(device)


def _check_ids(ids: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """Validate query ids against [0, n) with a clear error (a gather would
    fail or clamp instead). Reads only the min and max."""
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= n:
            raise ValueError(
                f"{what} id out of range: got [{lo}, {hi}] with valid "
                f"range [0, {n})")
    return ids


def _view_label(snapshot) -> str:
    """SLO span label: which view served the query."""
    return "live" if snapshot is None else "pinned"


class WalkQueryService:
    """Batched multi-query engine over one `WalkEngine` (or an
    `EmbeddingMaintainer.engine_view()`).

    Every query accepts an optional `snapshot=` — a `PinnedSnapshot` from
    `pin()` — to serve a pinned epoch while the engine keeps writing; the
    default is the engine's live (mergeless) overlay. Results of one epoch
    are identity-stable (the cache contract). `cache_epochs` bounds how
    many epochs of derived products are kept for pinned readers."""

    def __init__(self, engine=None, backend: Optional[str] = None,
                 cache_epochs: int = 4):
        self.engine = engine
        self.backend = backend  # FINDNEXT backend (None = by device)
        self._overlay_cache = EpochCache("overlay", cache_epochs)
        self._wm_cache = EpochCache("walk_matrix", cache_epochs)
        self._ppr_cache = EpochCache("ppr_table", cache_epochs)
        self._emb_cache = EpochCache("emb_norm", max_entries=2)
        self._emb_normed = None
        self._pins_total = 0
        self._validation_errors = 0

    @property
    def device(self) -> torch.device:
        return self.engine.store.device

    # ------------------------------------------------------------ telemetry

    def _invalid(self, kind: str, err: ValueError) -> ValueError:
        """Count a host-side input rejection (the `serve_validation_errors`
        counter and the installed SLO collector's per-kind tally) and hand
        the error back for the caller to raise."""
        self._validation_errors += 1
        collector = slo.active()
        if collector is not None:
            collector.validation_error(f"serve/{kind}")
        return err

    def _checked_ids(self, ids, n: int, what: str, kind: str):
        ids = _as_ids(ids, self.device)
        try:
            return _check_ids(ids, n, what)
        except ValueError as e:
            raise self._invalid(kind, e)

    def obs_counters(self) -> dict:
        """Serving-layer counters for `obs.export.summary(m, serve=...)`,
        under the reference's names: `ppr_cache_hit`/`ppr_cache_miss` are
        the walk-matrix cache's outcomes, the other caches report under
        their own names, `pins_total`/`pins_active` count pins."""
        c = self._wm_cache.counters("ppr_cache_hit", "ppr_cache_miss")
        c["overlay_rebuilds"] = self._overlay_cache.misses
        c.update(self._ppr_cache.counters())
        c.update(self._emb_cache.counters())
        c["pins_total"] = self._pins_total
        c["pins_active"] = getattr(self.engine, "pins_active", 0)
        c["serve_validation_errors"] = self._validation_errors
        return c

    # ------------------------------------------------------------ snapshots

    def snapshot(self) -> Overlay:
        """Consistent read snapshot, mergeless and O(|pending|) to build,
        cached on `(epoch_counter, n_pending)`: an update bumps the epoch, a
        merge drains the pending count, and two states agreeing on both
        hold the same corpus. Valid until the engine's next update; use
        `pin()` for a snapshot that must outlive further updates."""
        eng = self.engine
        key = (eng.epoch_counter, eng.n_pending)

        def build():
            with trace.phase("serve/snapshot", cat="serve"):
                return eng.overlay()

        return self._overlay_cache.get(key, build)

    def pin(self) -> PinnedSnapshot:
        """Pin the current epoch for durable reads: the pending rows are
        copied now (`with svc.pin() as snap: ...` releases it)."""
        eng = self.engine
        ov = self.snapshot()
        with trace.phase("serve/pin", cat="serve", epoch=eng.epoch_counter):
            snap = pin_snapshot(eng, ov, eng.epoch_counter, eng.n_pending)
        self._pins_total += 1
        return snap

    def materialize(self) -> WalkStore:
        """Merged, self-contained store snapshot (forces the merge)."""
        self.engine.merge()
        return self.engine.store

    def _view(self, snapshot: Optional[PinnedSnapshot]):
        """(overlay, epoch) for a query: the pinned view or the live one."""
        if snapshot is not None:
            snapshot.check_live()
            return snapshot.overlay, snapshot.epoch
        return self.snapshot(), self.engine.epoch_counter

    # -------------------------------------------------------- query kinds

    def next_vertices(self, v, w, p,
                      snapshot: Optional[PinnedSnapshot] = None):
        """Batched FINDNEXT: (v_next int64 [B], found bool [B])."""
        ov, _ = self._view(snapshot)
        dev = self.device
        v, w, p = (_as_ids(x, dev) for x in (v, w, p))
        with trace.phase("serve/next_vertices", cat="serve",
                         view=_view_label(snapshot), batch=v.numel()):
            v, n = batched.pad_ids(v)
            w, _ = batched.pad_ids(w)
            p, _ = batched.pad_ids(p)
            nxt, found = batched.find_next_batch(
                ov, v, w, p,
                backend=packed_store.resolve_backend(self.backend, dev))
        return nxt[:n], found[:n]

    def walks_of(self, vertices, capacity: int,
                 snapshot: Optional[PinnedSnapshot] = None):
        """Walk ids visiting each vertex: int64 [B, 2*capacity], -1 padded
        (base segment + live pending entries; as a set, each row equals the
        post-merge segment's walks)."""
        ov, _ = self._view(snapshot)
        ids = self._checked_ids(vertices, ov.base.n_vertices,
                                "walks_of vertex", "walks_of")
        with trace.phase("serve/walks_of", cat="serve",
                         view=_view_label(snapshot), batch=ids.numel()):
            ids, n = batched.pad_ids(ids)
            out = batched.walks_of_batch(ov, ids, capacity=capacity)
        return out[:n]

    def neighborhoods(self, seeds, hops: int = 2,
                      snapshot: Optional[PinnedSnapshot] = None):
        """[B, n_w, hops+1] walk-based neighborhoods of the seed vertices,
        gathered from the epoch-cached walk matrix."""
        eng = self.engine
        length = eng.store.length
        if not 0 < hops < length:
            raise self._invalid("neighborhoods", ValueError(
                f"hops must be in [1, {length - 1}] for "
                f"length-{length} walks, got {hops}"))
        ids = self._checked_ids(seeds, eng.store.n_vertices,
                                "neighborhood seed", "neighborhoods")
        wm = self.walk_matrix(snapshot=snapshot)
        with trace.phase("serve/neighborhoods", cat="serve",
                         view=_view_label(snapshot), batch=ids.numel()):
            ids, n = batched.pad_ids(ids)
            nb = batched.neighborhoods_from_matrix(
                wm, ids, n_w=eng.cfg.n_walks_per_vertex, hops=hops)
        return nb[:n]

    def walk_matrix(self, snapshot: Optional[PinnedSnapshot] = None):
        """Full [n_walks, l] corpus via overlay traversal — mergeless, and
        cached on the epoch (invalidated by updates, stable across merges;
        pinned epochs keep their own entries)."""
        ov, epoch = self._view(snapshot)

        def build():
            with trace.phase("serve/walk_matrix", cat="serve", epoch=epoch,
                             view=_view_label(snapshot)):
                return batched.walk_matrix_all(
                    ov, n_w=self.engine.cfg.n_walks_per_vertex,
                    backend=packed_store.resolve_backend(self.backend,
                                                         self.device))

        return self._wm_cache.get((epoch,), build)

    def ppr_rows(self, vertices, restart_prob: float = 0.2,
                 snapshot: Optional[PinnedSnapshot] = None):
        """PPR score rows f32 [B, n] for the query vertices: the full table
        is built once per (epoch, restart_prob) and cached; a warm query is
        a row gather."""
        if not 0.0 < restart_prob < 1.0:
            raise self._invalid("ppr_row", ValueError(
                f"restart_prob must be in (0, 1), got {restart_prob}"))
        n = self.engine.store.n_vertices
        ids = self._checked_ids(vertices, n, "ppr vertex", "ppr_row")
        _, epoch = self._view(snapshot)

        def build():
            wm = self.walk_matrix(snapshot=snapshot)
            with trace.phase("serve/ppr_table", cat="serve", epoch=epoch):
                return batched.ppr_table(wm, n_vertices=n,
                                         restart_prob=restart_prob)

        table = self._ppr_cache.get((epoch, restart_prob), build)
        with trace.phase("serve/ppr_row", cat="serve",
                         view=_view_label(snapshot), batch=ids.numel()):
            ids, b = batched.pad_ids(ids)
            rows = batched.gather_rows(table, ids)
        return rows[:b]

    def ppr_row(self, v: int, restart_prob: float = 0.2,
                snapshot: Optional[PinnedSnapshot] = None):
        """PPR scores of vertex v over all vertices (`ppr_rows` of one)."""
        return self.ppr_rows([v], restart_prob, snapshot=snapshot)[0]

    # ------------------------------------------------- embedding serving

    def set_embedding_table(self, table) -> None:
        """Install or refresh the maintained embedding table ([n, d], e.g.
        `EmbeddingMaintainer.embeddings`, moved to the service's device).
        Rows are L2-normalized once per distinct table (the emb-norm cache,
        keyed on the object and its shape; the entry holds the table so the
        key stays valid)."""
        key = (id(table), tuple(table.shape))

        def build():
            t = torch.as_tensor(table).to(self.device)
            return table, batched.normalize_rows(t)

        _, self._emb_normed = self._emb_cache.get(key, build)

    def embedding_neighbors(self, vertices, k: int = 10):
        """Cosine top-k neighbors of each query vertex in the installed
        table: (ids int64 [B, k], scores f32 [B, k]), the vertex itself
        excluded, the lower id first among equal scores. Requires
        `set_embedding_table` first."""
        if self._emb_normed is None:
            raise self._invalid("embedding_neighbors", ValueError(
                "no embedding table installed — call "
                "set_embedding_table(maintainer.embeddings)"))
        n = self._emb_normed.shape[0]
        if not 0 < k < n:
            raise self._invalid("embedding_neighbors", ValueError(
                f"k must be in [1, {n - 1}] for an {n}-row table with the "
                f"query vertex excluded, got k={k}"))
        ids = self._checked_ids(vertices, n, "embedding vertex",
                                "embedding_neighbors")
        with trace.phase("serve/embedding_neighbors", cat="serve",
                         batch=ids.numel()):
            ids, b = batched.pad_ids(ids)
            out_ids, out_scores = batched.embedding_topk(
                self._emb_normed, ids, k=k)
        return out_ids[:b], out_scores[:b]
