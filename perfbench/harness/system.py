"""The system under test: the PyTorch/CUDA port's streaming walk engine,
built from a configuration file and driven through its public entry.

Everything else of the port stays out of the harness: the engine gets the
generated graph, the corpus key and the batches, and hands back what it
produced (its graph, its walks read through its own read path, its merged
store's rows, the affected walks it reports).
"""
from __future__ import annotations

import torch


def walk_config(cfg: dict):
    """The port's WalkConfig of a configuration file."""
    from repro_torch.core.corpus import WalkConfig
    from repro_torch.core.walkers import WalkModel
    m = cfg["model"]
    model = WalkModel(order=m["order"], p=m.get("p", 1.0), q=m.get("q", 1.0),
                      n_trials=m.get("n_trials", 8),
                      sampler=m.get("sampler", "rejection"),
                      dmax=m.get("dmax", 128))
    return WalkConfig(n_walks_per_vertex=cfg["n_walks_per_vertex"],
                      length=cfg["length"], model=model,
                      chunk_b=cfg["chunk_b"],
                      megakernel=cfg.get("megakernel", "auto"))


def n_walks(cfg: dict) -> int:
    return cfg["n_vertices"] * cfg["n_walks_per_vertex"]


def rewalk_capacity(cfg: dict) -> int:
    cap = cfg["rewalk_capacity"]
    return n_walks(cfg) if cap == "n_walks" else int(cap)


def build_kernels(device: torch.device) -> None:
    """Build (or find built) the port's kernel library: set-up's work."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.lib()


class WalkSystem:
    """A WalkEngine over the generated graph and a fresh corpus."""

    def __init__(self, cfg: dict, src, dst, corpus_key, device,
                 capacity: int = None, model_override: dict = None):
        from repro_torch.core.corpus import generate_corpus
        from repro_torch.core.graph import StreamingGraph
        from repro_torch.core.update import WalkEngine
        self.cfg = cfg
        wcfg = walk_config(cfg if model_override is None
                           else {**cfg, "model": {**cfg["model"], **model_override}})
        graph = StreamingGraph.from_edges(src, dst, cfg["n_vertices"],
                                          cfg["edge_capacity"], device=device)
        store = generate_corpus(corpus_key, graph, wcfg)
        self.engine = WalkEngine(
            graph, store, wcfg, merge_policy=cfg["merge_policy"],
            rewalk_capacity=capacity or rewalk_capacity(cfg),
            max_pending=cfg["max_pending"], merge_impl=cfg["merge_impl"])

    def step(self, key, ins_src, ins_dst, del_src, del_dst):
        """One batch through the entry; -> the affected count (device)."""
        return self.engine.run_stream(key, ins_src, ins_dst, del_src,
                                      del_dst)[0]

    def step_with_masks(self, key, ins_src, ins_dst, del_src, del_dst):
        """One batch through the same entry, asking for its affected walks:
        -> (count, walk ids, first affected positions) of the walks it
        re-walked."""
        affected, aux = self.engine.run_stream(key, ins_src, ins_dst, del_src,
                                               del_dst, return_masks=True)
        valid = aux.lane_valid[0]
        return int(affected[0]), aux.walk_ids[0][valid], aux.p_min[0][valid]

    def merge(self) -> None:
        self.engine.merge()

    @property
    def n_pending(self) -> int:
        return self.engine.n_pending

    def overflow_flag(self) -> torch.Tensor:
        """The engine's sticky MAV overflow flag (a device bool)."""
        return self.engine.state.overflow

    def packed_bytes(self) -> int:
        return self.engine.store.nbytes_packed()

    def walks(self) -> torch.Tensor:
        """Every walk read back through the engine's overlay (base store and
        pending blocks), int32 [n_walks, l]."""
        cfg = self.cfg
        w = torch.arange(n_walks(cfg), device=self.engine.store.device)
        start = w // cfg["n_walks_per_vertex"]
        return self.engine.overlay().traverse(w, start, cfg["length"] - 1).to(
            torch.int32)

    def merged_walks(self) -> torch.Tensor:
        """The engine's merge, then every walk read from the merged store."""
        return self.engine.walk_matrix().to(torch.int32)

    def store_rows(self) -> dict:
        s = self.engine.store
        return dict(owner=s.owner, code=s.code, epoch=s.epoch,
                    slot_epoch=s.slot_epoch)

    def graph(self) -> dict:
        g = self.engine.graph
        live = int(g.num_edges)
        return dict(graph_codes=g.codes[:live].clone(),
                    graph_offsets=g.offsets.clone())
