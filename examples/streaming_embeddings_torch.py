"""End-to-end driver on the PyTorch/CUDA port: streaming DeepWalk embeddings,
as examples/streaming_embeddings.py, with the same sizes, seeds and keys.

Trains skip-gram embeddings over a Wharf-maintained walk corpus while the
graph streams, refreshing incrementally after each batch (paper §7.6 /
Fig. 13a), with fault-tolerant checkpointing.

  python examples/streaming_embeddings_torch.py                 # on the card
  python examples/streaming_embeddings_torch.py --device cpu    # plain versions
  python examples/streaming_embeddings_torch.py --ckpt-dir DIR
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch import random as jr  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus  # noqa: E402
from repro_torch.core.update import WalkEngine  # noqa: E402
from repro_torch.data.streams import cora_like  # noqa: E402
from repro_torch.models.embeddings import (SGNSConfig, logistic_eval,  # noqa: E402
                                           sgns_init, train_epoch)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

N = 256
SNAPSHOTS = 4
BATCH_EDGES = 40


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "streaming_embeddings_torch_ckpt"),
        help="checkpoint directory (its steps from earlier runs are kept)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    key = jr.PRNGKey(0, dev)
    (src, dst), labels, _ = cora_like(key, n_vertices=N, n_edges=N * 4)
    n0 = src.shape[0] - SNAPSHOTS * BATCH_EDGES
    graph = StreamingGraph.from_edges(src[:n0], dst[:n0], N, edge_capacity=16384,
                                      device=dev)
    wcfg = WalkConfig(n_walks_per_vertex=10, length=10)
    store = generate_corpus(jr.PRNGKey(1, dev), graph, wcfg)
    engine = WalkEngine(graph=graph, store=store, cfg=wcfg, rewalk_capacity=N * 10)

    scfg = SGNSConfig(n_vertices=N, dim=32, window=3, n_negative=4)
    params = sgns_init(jr.PRNGKey(2, dev), scfg)
    ckpt = CheckpointManager(args.ckpt_dir)

    # initial training on the initial corpus
    walks = engine.walk_matrix()
    k = jr.PRNGKey(3, dev)
    for _ in range(6):
        k, kk = jr.split(k)
        params, loss = train_epoch(kk, params, walks, scfg, batch=4096)
    acc = logistic_eval(params["in"], labels)
    say(f"snapshot -1: loss={float(loss):.3f} acc={acc:.3f}")

    for snap in range(SNAPSHOTS):
        lo = n0 + snap * BATCH_EDGES
        hi = lo + BATCH_EDGES
        n_aff = engine.insert_edges(jr.fold_in(key, snap), src[lo:hi], dst[lo:hi])
        walks = engine.walk_matrix()
        # vskip-style incremental refresh: 2 passes over the updated corpus
        for _ in range(2):
            k, kk = jr.split(k)
            params, loss = train_epoch(kk, params, walks, scfg, batch=4096)
        acc = logistic_eval(params["in"], labels)
        ckpt.save(snap, {"embeddings": params}, blocking=True)
        say(f"snapshot {snap}: {int(n_aff)} walks updated, loss={float(loss):.3f} "
            f"acc={acc:.3f} (ckpt step {ckpt.latest_step()})")
    say(f"done; embeddings checkpointed to {args.ckpt_dir}")
    return lines


if __name__ == "__main__":
    main()
