"""The paper's own workload as a config: the streaming walk-update step
(port of `repro/configs/wharf_stream.py`).

Backend fields take the port's names: "cuda" (the reference's "pallas"),
"torch" (its "interpret" and "pallas-interpret"), "ref" (its "xla-ref"),
and "auto"; `repro_torch.convert.wharf_config_from` carries a reference
config across. The shard fields are kept for the port's `distr/`, which
will read them through `shard_spec`.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchSpec, register
from repro_torch.core.corpus import WalkConfig
from repro_torch.core.walkers import WalkModel


@dataclass(frozen=True)
class WharfStreamConfig:
    name: str = "wharf-stream"
    n_vertices: int = 1 << 20          # er-20-scale graph (paper §7.3)
    edge_capacity: int = 1 << 27       # ~134M directed edges (avg degree 100)
    n_walks_per_vertex: int = 10       # paper defaults
    length: int = 80
    batch_edges: int = 10_000          # paper's default update batch
    rewalk_capacity: int = 1 << 20     # affected-walk bound per batch
    chunk_b: int = 128
    order: int = 1
    # order-2 SAMPLENEXT: "rejection" is the K-trial approximate sampler;
    # "factorized" the exact group sampler (kernels/intersect.py) with
    # `sampler_dmax`-wide rows (per-lane rejection fallback above dmax)
    sampler: str = "rejection"
    sampler_dmax: int = 128
    # batches a `run_stream` consumes, and the pending-block depth before
    # the forced merge
    stream_batches: int = 8
    max_pending: int = 8
    # FINDNEXT backend registry (core/packed_store.py): "auto" keeps the
    # per-device pick, the CUDA kernel on the card and its plain version on
    # the CPU
    find_next_backend: str = "auto"
    find_next_window: int = 8          # K candidate chunks per query
    # intersect (factorized-sampler) backend registry: the same rules
    intersect_backend: str = "auto"
    # the vertex-range partition of the sharded engine: shard count and
    # per-shard capacities; 0 = derive balanced defaults
    n_shards: int = 8
    shard_edge_capacity: int = 0
    shard_store_capacity: int = 0
    handoff_slab: int = 0
    # fused rewalk step: "auto" consults the kernels/megakernel registry,
    # whose process default is OFF; "cuda" / "torch" / "ref" enable it,
    # "off" pins the unfused path regardless of the registry
    megakernel: str = "auto"
    # stream telemetry (repro_torch/obs): OFF runs none of its code
    metrics: bool = False
    # serving frontend (repro_torch/serve): query-batch bucket, walks-of
    # per-vertex capacity, embedding dim and top-k, epochs of derived read
    # products the serving caches keep
    serve_batch: int = 16
    serve_walks_capacity: int = 1024
    serve_emb_dim: int = 64
    serve_topk: int = 10
    serve_cache_epochs: int = 4

    def walk_config(self) -> WalkConfig:
        return WalkConfig(n_walks_per_vertex=self.n_walks_per_vertex,
                          length=self.length,
                          model=WalkModel(order=self.order,
                                          sampler=self.sampler,
                                          dmax=self.sampler_dmax),
                          chunk_b=self.chunk_b,
                          megakernel=self.megakernel,
                          metrics=self.metrics)

    def select_backend(self, device=None) -> str:
        """Install this config's FINDNEXT, intersect and megakernel
        backends as the process defaults; returns the FINDNEXT backend a
        request of None now resolves to on `device` (the card unless the
        caller asks for the CPU). "auto" fields leave the corresponding
        registry untouched."""
        from repro_torch.core import packed_store
        from repro_torch.kernels import intersect, megakernel
        if self.find_next_backend != "auto":
            # the candidate window rides the explicit FINDNEXT choice: an
            # intersect-only explicit config must not reset another
            # component's installed window
            packed_store.set_default_backend(self.find_next_backend)
            packed_store.set_default_window(self.find_next_window)
        if self.intersect_backend != "auto":
            intersect.set_default_backend(self.intersect_backend)
        if self.megakernel != "auto":
            megakernel.set_default_backend(self.megakernel)
        return packed_store.get_default_backend(device)


def _wharf(smoke: bool = False) -> WharfStreamConfig:
    if smoke:
        return WharfStreamConfig(n_vertices=64, edge_capacity=4096,
                                 n_walks_per_vertex=2, length=8,
                                 batch_edges=16, rewalk_capacity=128,
                                 serve_batch=8, serve_walks_capacity=128,
                                 serve_emb_dim=16)
    return WharfStreamConfig()


WHARF_SHAPES = {
    # paper-faithful baseline: eager lexsort merge every batch
    "stream_10k": dict(kind="walk_update", batch_edges=10_000,
                       merge_impl="lexsort", do_merge=True),
    "stream_100k": dict(kind="walk_update", batch_edges=100_000,
                        merge_impl="lexsort", do_merge=True),
    "stream_10k_interleave": dict(kind="walk_update", batch_edges=10_000,
                                  merge_impl="interleave", do_merge=True),
    "stream_10k_nomerge": dict(kind="walk_update", batch_edges=10_000,
                               merge_impl="interleave", do_merge=False),
    # a whole [n_batches, batch] stream per run_stream call, on-demand
    # merges: the streaming-throughput production shape
    "stream_10k_pipelined": dict(kind="walk_stream", batch_edges=10_000,
                                 n_batches=8, merge_impl="interleave",
                                 merge_policy="on-demand"),
    "stream_10k_pipelined_eager": dict(kind="walk_stream",
                                       batch_edges=10_000, n_batches=8,
                                       merge_impl="interleave",
                                       merge_policy="eager"),
    # mixed insert+delete stream through the same run_stream loop
    "stream_10k_mixed": dict(kind="walk_stream", batch_edges=10_000,
                             del_edges=2_000, n_batches=8,
                             merge_impl="interleave",
                             merge_policy="on-demand"),
    # the explicitly partitioned engine
    "stream_10k_sharded": dict(kind="walk_stream_sharded",
                               batch_edges=10_000, del_edges=2_000,
                               n_batches=8, merge_policy="on-demand"),
    # order-2 cells: the K-trial rejection sampler vs the exact factorized
    # sampler; `order`/`sampler` override the config fields per shape
    "stream_10k_n2v_rejection": dict(kind="walk_stream", batch_edges=10_000,
                                     n_batches=8, merge_impl="interleave",
                                     merge_policy="on-demand", order=2,
                                     sampler="rejection"),
    "stream_10k_n2v_factorized": dict(kind="walk_stream", batch_edges=10_000,
                                      n_batches=8, merge_impl="interleave",
                                      merge_policy="on-demand", order=2,
                                      sampler="factorized"),
    # the fused rewalk step on the same factorized cell
    "stream_10k_n2v_megakernel": dict(kind="walk_stream", batch_edges=10_000,
                                      n_batches=8, merge_impl="interleave",
                                      merge_policy="on-demand", order=2,
                                      sampler="factorized",
                                      megakernel="cuda"),
    # serving frontend: the batched multi-query read step, two buckets
    "serve_batched_q16": dict(kind="walk_serve", batch_edges=0, q_batch=16),
    "serve_batched_q256": dict(kind="walk_serve", batch_edges=0,
                               q_batch=256),
}

register(ArchSpec(name="wharf-stream", family="wharf", make_config=_wharf,
                  shapes=WHARF_SHAPES,
                  notes="paper's streaming random-walk maintenance step"))
