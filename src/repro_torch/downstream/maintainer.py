"""Streaming embedding maintenance co-scheduled with walk updates; port of
`repro/downstream/maintainer.py`.

The paper keeps walks fresh for the sake of the downstream task (§7.6:
DeepWalk/node2vec embeddings -> vertex classification). One step is

    edge batch --stream_step_aux--> fresh walks + affected set (UpdateAux)
                                         |
                 overlay reads of the affected walks' windows only
                                         |
             masked skip-gram pairs (vskip stale-prefix filter)
                                         |
          fused SGNS step (kernels/sgns.py registry) -> new tables

The engine half advances through the same `stream_step_aux` as
`WalkEngine.run_stream`, so a maintainer leaves an engine state that is
bit-identical to a plain engine's on the same update keys. The reference
runs a stream in one `lax.scan`; here it is a host loop, as in
`core/update.run_stream`, and the engine's pending tensors are written in
place where the reference donates the carry.

Not ported yet: `cfg.walk.metrics` (obs/) raises NotImplementedError, and
restoring a `MaintainerState` from a checkpoint waits for train/.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch import random as jr
from repro_torch.core.corpus import WalkConfig, check_config, walk_start_vertex
from repro_torch.core.graph import StreamingGraph, as_ids
from repro_torch.core.overlay import Overlay
from repro_torch.core.store import WalkStore
from repro_torch.core.update import EngineState, WalkEngine, stream_step_aux
from repro_torch.kernels.sgns import ROWS
from repro_torch.models.embeddings import (affected_pairs, masked_sgns_step,
                                           n_window_pairs)

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

TRAIN_SALT = 0x5465   # fold_in(key, TRAIN_SALT): the default training key


@dataclass(frozen=True)
class MaintainerConfig:
    """The co-scheduling configuration. The walk/engine half mirrors
    WalkEngine's options, the SGNS half `models.embeddings.SGNSConfig`.
    `lr_decay_steps > 0` decays the learning rate linearly with the step
    count, floored at `lr_min_frac * lr`. `sgns_backend` takes the port's
    names ("cuda", "torch", "ref"; None/"auto": by device)."""

    walk: WalkConfig
    n_vertices: int
    dim: int = 64
    window: int = 3
    n_negative: int = 4
    lr: float = 0.01
    lr_min_frac: float = 0.1
    lr_decay_steps: int = 0
    skip_stale_prefix: bool = True
    max_pairs: int = 0            # 0 = train every live pair
    rewalk_capacity: int = 1024
    max_pending: int = 8
    mav_capacity: int = 0         # 0 = resolved to store.size at init
    merge_policy: str = "on-demand"
    merge_impl: str = "interleave"
    sgns_backend: Optional[str] = None

    @property
    def pairs_per_walk(self) -> int:
        return n_window_pairs(self.walk.length, self.window)

    @property
    def pair_batch(self) -> int:
        """Pair-batch size: capacity * pairs-per-walk, capped by
        `max_pairs`, rounded up to the reference's 8-row tile (the
        negatives' shape, and so every draw, depends on it)."""
        p = self.rewalk_capacity * self.pairs_per_walk
        if self.max_pairs:
            p = min(p, self.max_pairs)
        return -(-p // ROWS) * ROWS

    def replace(self, **kw) -> "MaintainerConfig":
        return dataclasses.replace(self, **kw)


class MaintainerState(NamedTuple):
    """The co-scheduled pipeline state."""

    engine: EngineState
    params: dict    # {"in": f32 [n, d], "out": f32 [n, d]} SGNS tables
    opt: dict       # {"step": int32 [], "pairs": int64 []}


class StepMetrics(NamedTuple):
    loss_sum: torch.Tensor    # f32 [] summed SGNS loss over trained pairs
    n_pairs: torch.Tensor     # int32 [] pairs trained this step
    n_affected: torch.Tensor  # int32 [] affected walks this step (|MAV|)


def init_params(key, n_vertices: int, dim: int):
    """word2vec init on the key's device: a small normal input table, a
    zero output table."""
    return {
        "in": jr.normal(key, (n_vertices, dim)) * (1.0 / dim ** 0.5),
        "out": torch.zeros((n_vertices, dim), dtype=F32, device=key.device),
    }


def init_maintainer(key, graph: StreamingGraph, store: WalkStore,
                    cfg: MaintainerConfig, epoch: int = 0) -> MaintainerState:
    dev = store.device
    engine = EngineState.create(graph, store, cfg.max_pending,
                                cfg.rewalk_capacity * cfg.walk.length,
                                epoch=epoch)
    return MaintainerState(
        engine=engine,
        params=init_params(jr.as_key(key, dev), cfg.n_vertices, cfg.dim),
        opt={"step": torch.zeros((), dtype=I32, device=dev),
             "pairs": torch.zeros((), dtype=I64, device=dev)})


def _lr_schedule(cfg: MaintainerConfig, step):
    if not cfg.lr_decay_steps:
        return torch.tensor(cfg.lr, dtype=F32, device=step.device)
    frac = 1.0 - step.to(F32) / cfg.lr_decay_steps
    return cfg.lr * torch.clamp(frac, min=cfg.lr_min_frac)


def maintain_step(state: MaintainerState, key_update, key_train, ins_src,
                  ins_dst, del_src, del_dst, cfg: MaintainerConfig,
                  mav_capacity: int):
    """One co-scheduled step: `stream_step_aux`, then SGNS on the affected
    walks' pairs. Returns (MaintainerState, StepMetrics).

    Under a `max_pairs` budget the reference reads every affected lane
    through the overlay and then keeps the `n_lanes` it drew; this reads
    only those lanes, which gives the same rows (at full width, 1,362
    lanes instead of 2.6M)."""
    wcfg = cfg.walk
    engine, aux = stream_step_aux(
        state.engine, key_update, ins_src, ins_dst, del_src, del_dst, wcfg,
        cfg.rewalk_capacity, mav_capacity, cfg.max_pending, cfg.merge_policy,
        cfg.merge_impl)
    dev = engine.store.device

    with record_function("maintainer.pairs"):
        k_sub, k_neg = jr.split(key_train)
        b = cfg.pair_batch
        walk_ids, lane_valid, p_min = aux
        ppw = cfg.pairs_per_walk
        if b < cfg.rewalk_capacity * ppw:
            # the max_pairs budget: valid lanes first, in uniform random
            # order (float64 uniforms, as the reference draws under x64;
            # a stable sort, as jnp.argsort)
            n_lanes = -(-b // ppw)
            r = jr.uniform(k_sub, (cfg.rewalk_capacity,), torch.float64)
            order = torch.argsort(torch.where(lane_valid, r, 2.0),
                                  stable=True)[:n_lanes]
            walk_ids, lane_valid, p_min = (walk_ids[order], lane_valid[order],
                                           p_min[order])
        # mergeless read of the walks' post-update windows
        ov = Overlay.build(engine.store, engine.pending.filled(engine.n_pending))
        start = walk_start_vertex(walk_ids, wcfg.n_walks_per_vertex)
        walks = ov.traverse(walk_ids, start, wcfg.length - 1)
        centers, contexts, mask = affected_pairs(
            walks, lane_valid, p_min, cfg.window,
            skip_stale_prefix=cfg.skip_stale_prefix)
        n_all = centers.shape[0]
        if b < n_all:       # trim the boundary lane's tail to the budget
            centers, contexts, mask = centers[:b], contexts[:b], mask[:b]
        elif b > n_all:     # pad to the 8-row tile
            pad = b - n_all
            zeros = torch.zeros((pad,), dtype=I64, device=dev)
            centers = torch.cat([centers, zeros])
            contexts = torch.cat([contexts, zeros])
            mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool,
                                                device=dev)])
        negatives = jr.randint(k_neg, (b, cfg.n_negative), 0, cfg.n_vertices,
                               dtype=I32).to(I64)

    with record_function("maintainer.sgns"):
        lr_t = _lr_schedule(cfg, state.opt["step"])
        params, loss_sum, n_pairs = masked_sgns_step(
            state.params, centers, contexts, negatives, mask, lr_t,
            backend=cfg.sgns_backend)
    opt = {"step": state.opt["step"] + 1,
           "pairs": state.opt["pairs"] + n_pairs.to(I64)}
    metrics = StepMetrics(loss_sum=loss_sum, n_pairs=n_pairs.to(I32),
                          n_affected=engine.last_affected)
    return MaintainerState(engine=engine, params=params, opt=opt), metrics


class EmbeddingMaintainer:
    """A WalkEngine whose stream steps also train SGNS.

    It mirrors `WalkEngine`'s entry points (per-batch `step`, whole-stream
    `run_stream`). Update keys are split as WalkEngine splits them
    (`split(key, n_batches)`), so the engine state matches a plain engine's
    on the same keys bit for bit; training draws come from their own keys
    (`fold_in(key, 0x5465)` split per batch, unless `train_key` is given)."""

    def __init__(self, graph: StreamingGraph = None, store: WalkStore = None,
                 cfg: MaintainerConfig = None, key=None, epoch: int = 0):
        check_config(cfg.walk)
        if cfg.mav_capacity == 0:
            cfg = cfg.replace(mav_capacity=store.size)
        self.cfg = cfg
        key = jr.PRNGKey(0, store.device) if key is None else key
        # `epoch` resumes the update counter of a store built mid-stream
        self.state = init_maintainer(key, graph, store, cfg, epoch=epoch)

    # ----------------------------------------------------- state projections

    @property
    def device(self) -> torch.device:
        return self.state.engine.store.device

    @property
    def params(self) -> dict:
        return self.state.params

    @property
    def embeddings(self) -> torch.Tensor:
        """The maintained embedding table (the SGNS input vectors)."""
        return self.state.params["in"]

    @property
    def engine_state(self) -> EngineState:
        return self.state.engine

    @property
    def epoch_counter(self) -> int:
        return self.state.engine.epoch

    @property
    def pairs_trained(self) -> int:
        return int(self.state.opt["pairs"])

    @property
    def mav_overflowed(self) -> bool:
        return bool(self.state.engine.overflow)

    def engine_view(self) -> WalkEngine:
        """A WalkEngine sharing this maintainer's engine state (its pending
        tensors included). Steps through the view and further maintainer
        steps must not interleave."""
        c, st = self.cfg, self.state.engine
        eng = WalkEngine(graph=st.graph, store=st.store, cfg=c.walk,
                         merge_policy=c.merge_policy, merge_impl=c.merge_impl,
                         rewalk_capacity=c.rewalk_capacity,
                         max_pending=c.max_pending, mav_capacity=c.mav_capacity,
                         pending=st.pending, n_pending=st.n_pending,
                         epoch=st.epoch)
        eng.state = st
        return eng

    def load_state(self, state: MaintainerState) -> None:
        """Install a MaintainerState (its engine carries the merge
        schedule's host counters)."""
        self.state = state

    # ------------------------------------------------------------------ API

    def step(self, key_update, key_train, ins_src, ins_dst, del_src=None,
             del_dst=None) -> StepMetrics:
        """One co-scheduled update+train batch."""
        dev = self.device
        ins_src, ins_dst, del_src, del_dst = (
            torch.zeros((0,), dtype=I64, device=dev) if a is None
            else as_ids(a, dev) for a in (ins_src, ins_dst, del_src, del_dst))
        self.state, metrics = maintain_step(
            self.state, jr.as_key(key_update, dev), jr.as_key(key_train, dev),
            ins_src, ins_dst, del_src, del_dst, self.cfg,
            self.cfg.mav_capacity)
        return metrics

    def run_stream(self, key, ins_src, ins_dst, del_src=None, del_dst=None,
                   train_key=None) -> StepMetrics:
        """Consume a whole [n_batches, batch] edge stream, maintaining the
        embeddings as it goes -> per-batch StepMetrics stacked [n_batches].
        `key` drives the walk updates as `WalkEngine.run_stream` would;
        `train_key` (default `fold_in(key, 0x5465)`) drives the pair
        subsample and the negatives."""
        dev = self.device
        key = jr.as_key(key, dev)
        ins_src, ins_dst = as_ids(ins_src, dev), as_ids(ins_dst, dev)
        n_batches = ins_src.shape[0]
        if del_src is None:
            del_src = del_dst = torch.zeros((n_batches, 0), dtype=I64,
                                            device=dev)
        else:
            del_src, del_dst = as_ids(del_src, dev), as_ids(del_dst, dev)
        update_keys = jr.split(key, n_batches)
        train_key = (jr.fold_in(key, TRAIN_SALT) if train_key is None
                     else jr.as_key(train_key, dev))
        train_keys = jr.split(train_key, n_batches)
        out = []
        for i in range(n_batches):
            self.state, m = maintain_step(
                self.state, update_keys[i], train_keys[i], ins_src[i],
                ins_dst[i], del_src[i], del_dst[i], self.cfg,
                self.cfg.mav_capacity)
            out.append(m)
        return StepMetrics(*map(torch.stack, zip(*out)))
