"""Quickstart on the PyTorch/CUDA port: maintain random walks on a streaming
graph (the paper's core loop), section for section as examples/quickstart.py,
with the same sizes, seeds, keys and order of draws.

  python examples/quickstart_torch.py                 # on the card
  python examples/quickstart_torch.py --device cpu    # the plain versions

Every line but section 5's (the resolved FINDNEXT backend) prints what
examples/quickstart.py prints.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import torch  # noqa: E402

from repro_torch import random as jr  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus  # noqa: E402
from repro_torch.core import packed_store  # noqa: E402
from repro_torch.core.update import WalkEngine  # noqa: E402
from repro_torch.data.streams import edge_batch_stream, rmat_edges  # noqa: E402
from repro_torch.downstream import EmbeddingMaintainer, MaintainerConfig  # noqa: E402
from repro_torch.obs import export  # noqa: E402
from repro_torch.serve import WalkQueryService  # noqa: E402

N_VERTICES = 1 << 10      # 1024-vertex RMAT graph
LOG2_N = 10


class Lines(list):
    """The lines a driver printed, and (`values`) the raw numbers behind the
    ones ranked by f32 scores, for a caller that checks a run."""

    def __init__(self):
        super().__init__()
        self.values = {}

    def say(self, line: str) -> None:
        print(line, flush=True)
        self.append(line)


def main(argv=None) -> Lines:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    out = Lines()

    # 1. build the initial streaming graph + walk corpus (n_w walks per vertex)
    key = jr.PRNGKey(0, dev)
    src, dst = rmat_edges(key, 4_000, LOG2_N)
    graph = StreamingGraph.from_edges(src, dst, N_VERTICES, edge_capacity=65536,
                                      device=dev)
    cfg = WalkConfig(n_walks_per_vertex=4, length=16)
    store = generate_corpus(jr.PRNGKey(1, dev), graph, cfg)
    out.say(f"graph: {int(graph.num_edges)} directed edges; "
            f"corpus: {store.n_walks} walks x {store.length} "
            f"({store.size} encoded triplets, "
            f"{store.nbytes_packed() / 1e6:.1f} MB packed)")

    # 2. stream edge updates; Wharf re-walks only the affected walks
    engine = WalkEngine(graph=graph, store=store, cfg=cfg, rewalk_capacity=4096)
    for step in range(5):
        k1, k2 = jr.split(jr.fold_in(key, step))
        ins_src, ins_dst = rmat_edges(k1, 200, LOG2_N)
        n_affected = engine.insert_edges(k2, ins_src, ins_dst)
        out.say(f"batch {step}: +200 edges -> {int(n_affected)} affected walks "
                f"({engine.n_pending} pending version blocks)")

    # 3. or consume a whole stacked stream in one call (the reference's one
    # jitted scan is a host loop over the same step here)
    stream_src, stream_dst = edge_batch_stream(jr.fold_in(key, 99), 8, 200, LOG2_N)
    affected = engine.run_stream(jr.fold_in(key, 100), stream_src, stream_dst)
    out.say(f"run_stream: 8 batches in one scan -> per-batch affected "
            f"{[int(a) for a in affected]}")

    # 4. read the corpus (triggers the on-demand merge) and traverse a walk
    walks = engine.walk_matrix()
    out.say(f"walk 7: {walks[7].cpu().numpy()}")

    # 5. FINDNEXT: the paper's indexed point lookup, served from the
    # compressed chunks (the CUDA kernel on the card, its plain twin here)
    out.say(f"find_next backend: {packed_store.get_default_backend(dev)}")
    v = walks[7][3:4]
    w = torch.tensor([7], dtype=torch.int64, device=dev)
    p = torch.tensor([3], dtype=torch.int64, device=dev)
    nxt, found = engine.store.find_next(v, w, p)
    out.say(f"find_next(v={int(v[0])}, w=7, p=3) -> {int(nxt[0])} "
            f"(found={bool(found[0])}, matches walk: {int(walks[7][4])})")

    # 6. serve a batched query mix from a pinned snapshot while the stream
    # keeps writing: the same answers come back bit-identical across later
    # run_stream windows, the live view moves on
    service = WalkQueryService(engine=engine)
    probes = [7, 21, 99]
    with service.pin() as snap:
        pinned_before = service.ppr_rows(probes, snapshot=snap)
        stream_src, stream_dst = edge_batch_stream(jr.fold_in(key, 300), 4, 200,
                                                   LOG2_N)
        engine.run_stream(jr.fold_in(key, 301), stream_src, stream_dst)
        pinned_after = service.ppr_rows(probes, snapshot=snap)
        stable = bool(torch.equal(pinned_before, pinned_after))
        nb = service.neighborhoods(probes, hops=2, snapshot=snap)
    out.say(f"pinned query batch over 4 stream windows: bit-identical={stable}; "
            f"neighborhoods {tuple(nb.shape)}; live epoch {engine.epoch_counter} "
            f"vs pinned {snap.epoch}")

    # 7. the downstream loop: stream more edges while maintaining SGNS
    # embeddings, each step retraining only the affected walks' windows, and
    # watch a nearest-neighbor query move. lr 0.0005: nearly every walk is
    # affected per batch here, and the sum-loss step diverges at 0.01.
    # metrics=True turns on the stream counters and the walk-freshness
    # auditor; the engine's outputs stay bit-identical
    mcfg = MaintainerConfig(walk=cfg._replace(metrics=True),
                            n_vertices=N_VERTICES, dim=32, window=3,
                            rewalk_capacity=4096, lr=0.0005)
    # handoff of a mid-stream store: merge first (unmerged pending rewrites
    # live outside the base store) and resume the epoch counter
    engine.merge()
    maintainer = EmbeddingMaintainer(graph=engine.graph, store=engine.store,
                                     cfg=mcfg, key=jr.PRNGKey(5, dev),
                                     epoch=engine.epoch_counter)
    service = WalkQueryService(engine=maintainer.engine_view())
    probe = int(walks[7][0])
    service.set_embedding_table(maintainer.embeddings)
    before_ids, _ = service.embedding_neighbors(probe, k=5)
    out.values["before"] = _neighbor_values(service, probe, before_ids)

    stream_src, stream_dst = edge_batch_stream(jr.fold_in(key, 200), 8, 200, LOG2_N)
    metrics = maintainer.run_stream(jr.fold_in(key, 201), stream_src, stream_dst)
    out.say(f"maintained embeddings over 8 batches: "
            f"{int(metrics.n_pairs.sum())} pairs trained on "
            f"{int(metrics.n_affected.sum())} affected walks "
            f"(loss/pair {float(metrics.loss_sum.sum() / metrics.n_pairs.sum()):.3f})")
    service.set_embedding_table(maintainer.embeddings)
    after_ids, _ = service.embedding_neighbors(probe, k=5)
    out.values["after"] = _neighbor_values(service, probe, after_ids)
    out.say(f"nearest neighbors of v={probe}: "
            f"before {[int(i) for i in before_ids[0]]} -> "
            f"after {[int(i) for i in after_ids[0]]}")

    # 8. how fresh are the walks the embeddings just trained on? per-walk lag
    # = stream batches since the walk was last rewritten; the divergence
    # auditor replays sampled walks against the live graph (invalid
    # transitions must be 0 on a maintained engine)
    stale = export.summary(maintainer.metrics)["staleness"]
    out.say(f"freshness after the stream: lag mean {stale['lag_mean']:.2f} "
            f"batches (max {stale['lag_max']}), "
            f"stale fraction {stale['stale_fraction']:.4f}; "
            f"auditor: {stale['audit']['invalid']}/{stale['audit']['transitions']} "
            f"invalid transitions (divergence {stale['audit']['divergence_rate']})")
    return out


def _neighbor_values(service, probe: int, ids) -> dict:
    """The printed neighbor ids and the cosine score of every vertex against
    the probe in the installed table (the probe itself excluded)."""
    all_ids, scores = service.embedding_neighbors(
        probe, k=service.engine.store.n_vertices - 1)
    row = torch.full((service.engine.store.n_vertices,), float("-inf"))
    row[all_ids[0].cpu()] = scores[0].cpu()
    return dict(ids=[int(i) for i in ids[0]], scores=row.numpy())


if __name__ == "__main__":
    main()
