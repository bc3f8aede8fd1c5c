"""Serving example on the PyTorch/CUDA port: Personalized-PageRank answering
over streaming walks (paper §7.6 / Bahmani et al.), as
examples/ppr_serving.py, with the same sizes, seeds and keys. Queries are
served from the maintained corpus while edge batches stream in; no
from-scratch recompute.

  python examples/ppr_serving_torch.py                 # on the card
  python examples/ppr_serving_torch.py --device cpu    # the plain versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np  # noqa: E402

from repro_torch import random as jr  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus  # noqa: E402
from repro_torch.core.ppr import ppr_scores, smape  # noqa: E402
from repro_torch.core.update import WalkEngine  # noqa: E402
from repro_torch.data.streams import rmat_edges  # noqa: E402

N, LOG2_N = 512, 9


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

    key = jr.PRNGKey(0, dev)
    src, dst = rmat_edges(key, 3000, LOG2_N)
    graph = StreamingGraph.from_edges(src, dst, N, edge_capacity=32768, device=dev)
    cfg = WalkConfig(n_walks_per_vertex=10, length=10)
    store = generate_corpus(jr.PRNGKey(1, dev), graph, cfg)
    engine = WalkEngine(graph=graph, store=store, cfg=cfg, rewalk_capacity=N * 10)

    out.values["ppr7"] = []
    for batch in range(3):
        k1, k2 = jr.split(jr.fold_in(key, batch))
        ins = rmat_edges(k1, 150, LOG2_N)
        n_aff = engine.insert_edges(k2, *ins)
        walks = engine.walk_matrix()
        scores = ppr_scores(walks, N, restart_prob=0.2)
        fresh = generate_corpus(jr.fold_in(key, 100 + batch), engine.graph, cfg)
        ideal_eng = WalkEngine(graph=engine.graph, store=fresh, cfg=cfg)
        ideal = ppr_scores(ideal_eng.walk_matrix(), N, restart_prob=0.2)
        err = float(smape(scores, ideal, min_score=0.02))
        # serve: top-5 personalized neighbors for query vertex 7
        row = scores[7].cpu().numpy()
        top = np.argsort(-row)[:5]
        out.values["ppr7"].append(row)
        out.say(f"batch {batch}: {int(n_aff)} walks refreshed | "
                f"SMAPE vs from-scratch {err:.1f}% | ppr(7) top-5 = {top.tolist()}")
    return out


if __name__ == "__main__":
    main()
