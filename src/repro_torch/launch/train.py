"""Training/streaming launcher; port of `repro/launch/train.py`.

  python -m repro_torch.launch.train --arch gemma2-2b --smoke --steps 20 \\
      [--batch 4 --seq 64] [--device cpu]
  python -m repro_torch.launch.train --arch wharf-stream --smoke --steps 10
  python -m repro_torch.launch.train --arch wharf-stream --smoke \\
      --mode downstream --steps 10 [--device cpu]

LM archs run next-token training on synthetic token streams (`lm_trainer`:
the transformer's loss and AdamW, the tokens drawn from the step's key);
wharf-stream runs the paper's streaming walk-update loop (R-MAT edge
batches); `--mode downstream` co-schedules the incremental SGNS embedding
maintenance with the same stream (downstream/maintainer.py): each TrainLoop
step is one edge batch -> walk update -> affected-only embedding retrain,
and the checkpoint carries (EngineState, SGNS tables, opt) as one tree, so
streaming and training resume together. Every trainer goes through
the fault-tolerant TrainLoop (checkpoint/restart, straggler monitor). They
run on the card unless `--device cpu` asks for the plain versions.

As in the reference, `--mode stream` checkpoints only the store's codes
and restores no engine: a resumed stream run continues from a freshly
built engine. Only `--mode downstream` resumes the streaming state.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from repro_torch import random as jr
from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update_
from repro_torch.train.runtime import TrainLoop
from repro_torch.tree import leaf_paths, rebuild

def lm_trainer(arch: str, smoke: bool, batch: int, seq: int, device=None):
    """Next-token training of an LM arch -> (state, step_fn, batch_fn).
    The carry is {"params", "opt"} (AdamW at lr 1e-3, updated in place:
    `adamw_update_`, the reference's values without a second copy of the
    parameters and moments); a step's tokens are `randint(key, (batch,
    seq + 1), 0, vocab, int32)` of its key, and its metrics the loss and
    the gradients' global norm."""
    from repro_torch.models import transformer as tfm
    dev = resolve_device(device)
    cfg = get_arch(arch).make_config(smoke)
    params = tfm.init_params(jr.PRNGKey(0, dev), cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = {"params": params, "opt": adamw_init(params)}

    def step_fn(state, tokens, key):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in leaf_paths(state["params"]).items()}
        loss = tfm.lm_loss(rebuild(state["params"], leaves), tokens, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = rebuild(state["params"], dict(zip(leaves, grads)))
        del leaves
        with torch.no_grad():
            params, opt, gnorm = adamw_update_(grads, state["opt"],
                                               state["params"], opt_cfg)
        return {"params": params, "opt": opt}, {"loss": float(loss.detach()),
                                                "gnorm": float(gnorm)}

    def batch_fn(step, key):
        return jr.randint(key, (batch, seq + 1), 0, cfg.vocab_size,
                          dtype=torch.int32)

    return state, step_fn, batch_fn


def _start(cfg, batch_edges: int, dev):
    """The launcher's graph (R-MAT, 4 * batch_edges edges) and corpus."""
    from repro_torch.core import StreamingGraph, generate_corpus
    from repro_torch.data.streams import rmat_edges
    log2n = int(math.log2(cfg.n_vertices))
    src, dst = rmat_edges(jr.PRNGKey(1, dev), batch_edges * 4, log2n)
    graph = StreamingGraph.from_edges(src, dst, cfg.n_vertices,
                                      cfg.edge_capacity, device=dev)
    store = generate_corpus(jr.PRNGKey(2, dev), graph, cfg.walk_config())
    return graph, store, log2n


def wharf_trainer(arch: str, smoke: bool, batch_edges: int, device=None):
    """The plain streaming trainer -> (state, step_fn, batch_fn). Its carry
    is the store's codes only; the engine lives in the closure."""
    from repro_torch.core.update import WalkEngine
    from repro_torch.data.streams import rmat_edges
    dev = resolve_device(device)
    cfg = get_arch(arch).make_config(smoke)
    graph, store, log2n = _start(cfg, batch_edges, dev)
    engine = WalkEngine(graph=graph, store=store, cfg=cfg.walk_config(),
                        rewalk_capacity=cfg.rewalk_capacity)
    state = {"store_code": store.code}  # checkpointable view

    def step_fn(state, batch, key):
        isrc, idst = batch
        n_aff = engine.update_batch(key, isrc, idst, None, None)
        return {"store_code": engine.store.code}, {"affected_walks": int(n_aff)}

    def batch_fn(step, key):
        return rmat_edges(key, batch_edges, log2n)

    return state, step_fn, batch_fn


def downstream_trainer(arch: str, smoke: bool, batch_edges: int, dim: int,
                       max_pairs: int = 1 << 16, device=None):
    """The co-scheduled streaming trainer: walk updates + SGNS maintenance.

    Returns (state, step_fn, batch_fn, on_restore): the TrainLoop carry IS
    the maintainer's (EngineState, tables, opt) tree, so one checkpoint
    holds streaming and training state; `on_restore` hands a restored
    carry (its host counters included) back to the maintainer before the
    loop continues."""
    from repro_torch.data.streams import rmat_edges
    from repro_torch.downstream import EmbeddingMaintainer, MaintainerConfig
    dev = resolve_device(device)
    cfg = get_arch(arch).make_config(smoke)
    graph, store, log2n = _start(cfg, batch_edges, dev)
    # max_pairs bounds the pair batch: at full scale (rewalk_capacity
    # 2^20, length 80) the affected-pair set is ~5e8 pairs a step
    mcfg = MaintainerConfig(walk=cfg.walk_config(), n_vertices=cfg.n_vertices,
                            dim=dim, rewalk_capacity=cfg.rewalk_capacity,
                            max_pending=cfg.max_pending, max_pairs=max_pairs)
    mt = EmbeddingMaintainer(graph=graph, store=store, cfg=mcfg,
                             key=jr.PRNGKey(3, dev))

    def step_fn(state, batch, key):
        mt.load_state(state)  # the loop's carry is authoritative
        isrc, idst = batch
        k_u, k_t = jr.split(key)
        m = mt.step(k_u, k_t, isrc, idst)
        return mt.state, {"loss": float(m.loss_sum),
                          "pairs": int(m.n_pairs),
                          "affected_walks": int(m.n_affected)}

    def batch_fn(step, key):
        return rmat_edges(jr.fold_in(key, 1), batch_edges, log2n)

    def on_restore(state, step):
        mt.load_state(state)
        return mt.state

    return mt.state, step_fn, batch_fn, on_restore


def main(argv=None):
    # no abbreviations: `--batch` must not stand for `--batch-edges`
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4, help="sequences a step (lm)")
    ap.add_argument("--seq", type=int, default=64, help="tokens a sequence (lm)")
    ap.add_argument("--batch-edges", type=int, default=64)
    ap.add_argument("--mode", default="stream",
                    choices=("stream", "downstream"),
                    help="wharf family: plain walk maintenance, or "
                         "co-scheduled embedding maintenance")
    ap.add_argument("--dim", type=int, default=64,
                    help="embedding dim (--mode downstream)")
    ap.add_argument("--max-pairs", type=int, default=1 << 16,
                    help="per-step trained-pair budget (--mode downstream)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    family = get_arch(args.arch).family
    on_restore = None
    if family == "lm":
        state, step_fn, batch_fn = lm_trainer(
            args.arch, args.smoke, args.batch, args.seq, device=args.device)
    elif family == "wharf" and args.mode == "downstream":
        state, step_fn, batch_fn, on_restore = downstream_trainer(
            args.arch, args.smoke, args.batch_edges, args.dim,
            args.max_pairs, device=args.device)
    elif family == "wharf":
        state, step_fn, batch_fn = wharf_trainer(
            args.arch, args.smoke, args.batch_edges, device=args.device)
    else:
        raise SystemExit(f"use examples/ drivers for family {family}")

    loop = TrainLoop(step_fn=step_fn, batch_fn=batch_fn,
                     ckpt=CheckpointManager(args.ckpt_dir),
                     ckpt_every=args.ckpt_every, on_restore=on_restore,
                     device=args.device)
    state, start = loop.resume(state)
    print(f"starting at step {start}")

    def on_metrics(step, dt, metrics):
        print(f"step {step}: {dt * 1e3:.1f}ms {metrics}")

    loop.run(state, start, args.steps, on_metrics)
    if loop.straggler.events:
        print("straggler events:", loop.straggler.events)


if __name__ == "__main__":
    main()
