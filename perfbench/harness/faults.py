"""Faults planted in the system under test, underneath an unchanged harness,
to show that the check reads `correct` false for each. The CPU tests plant
them at a tiny size and `perfbench/calibrate.py --faults` at a cell's own
size on the card. No benchmark run plants one.

* `state_unchanged`: a batch returns with nothing done (graph, walks and
  store as they were, no walk reported affected).
* `half_batch`: half of each batch's inserts and deletes left out.
* `next_vertex_altered`: one next vertex of each sampler call altered where
  the sampler produces it.
* `walks_not_rewalked`: the graph and the MAV are updated, but each affected
  walk's new block holds its old vertices from p_min on (the walks are not
  re-walked).
* `off_by_one`: DeepWalk's step drawn among all neighbours but the last
  (an index range one short).
* `first_neighbor`: DeepWalk's step always to the first neighbour.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("state_unchanged", "half_batch", "next_vertex_altered",
         "walks_not_rewalked", "off_by_one", "first_neighbor")


def _state_unchanged(orig):
    def run_stream(self, key, ins_src, *rest, return_masks=False, **kw):
        from repro_torch.core.update import UpdateAux
        n, dev = len(ins_src), self.store.device
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        if not return_masks:
            return zeros
        cap = self.rewalk_capacity
        return zeros, UpdateAux(
            torch.zeros((n, cap), dtype=torch.int64, device=dev),
            torch.zeros((n, cap), dtype=torch.bool, device=dev),
            torch.zeros((n, cap), dtype=torch.int64, device=dev))
    return run_stream


def _half_batch(orig):
    def run_stream(self, key, ins_src, ins_dst, del_src=None, del_dst=None,
                   **kw):
        h = ins_src.shape[1] // 2
        hd = del_src.shape[1] // 2 if del_src is not None else 0
        return orig(self, key, ins_src[:, :h], ins_dst[:, :h],
                    None if del_src is None else del_src[:, :hd],
                    None if del_dst is None else del_dst[:, :hd], **kw)
    return run_stream


def _next_vertex_altered(orig):
    def sample_next(key, graph, v, prev, model):
        nxt = orig(key, graph, v, prev, model).clone()
        nxt[0] = (nxt[0] + 1) % graph.n_vertices
        return nxt
    return sample_next


def _walks_not_rewalked(orig):
    def rewalk(key, graph, store, pending, mav, new_epoch, cfg, capacity):
        from repro_torch.core.overlay import Overlay
        from repro_torch.core.store import PAD_EPOCH
        from repro_torch.kernels import ops
        block, slot_epoch, n_aff, aux = orig(key, graph, store, pending, mav,
                                             new_epoch, cfg, capacity)
        length = store.length
        view = store if pending is None else Overlay.build(store, pending)
        start = aux.walk_ids // cfg.n_walks_per_vertex
        old = view.traverse(aux.walk_ids, start, length - 1)   # [cap, l]
        nxt = torch.cat([old[:, 1:], old[:, -1:]], dim=1)     # last: itself
        slots = (aux.walk_ids[:, None] * length
                 + torch.arange(length, device=old.device)[None])
        emits = block.epoch != PAD_EPOCH
        owner = torch.where(emits, old.reshape(-1).to(block.owner.dtype),
                            block.owner)
        code = torch.where(emits, ops.szudzik_pair(slots.reshape(-1),
                                                   nxt.reshape(-1)),
                           block.code)
        return (block._replace(owner=owner, code=code), slot_epoch, n_aff,
                aux)
    return rewalk


def _deepwalk_step(pick):
    def sample_neighbor(self, key, v):
        from repro_torch import random as jr
        start = self.offsets[v]
        deg = self.offsets[v + 1] - start
        r = pick(jr, key, v, deg)
        idx = (start + r).clamp(max=self.codes.shape[0] - 1)
        return torch.where(deg > 0, self.codes[idx] & 0xFFFFFFFF, v)
    return sample_neighbor


def _off_by_one(orig):
    return _deepwalk_step(lambda jr, key, v, deg: jr.randint(
        key, v.shape, 0, torch.clamp(deg - 1, min=1)))


def _first_neighbor(orig):
    return _deepwalk_step(lambda jr, key, v, deg: torch.zeros_like(deg))


def _target(name):
    from repro_torch.core import update
    from repro_torch.core.graph import StreamingGraph
    return {"state_unchanged": (update.WalkEngine, "run_stream",
                                _state_unchanged),
            "half_batch": (update.WalkEngine, "run_stream", _half_batch),
            "next_vertex_altered": (update, "sample_next",
                                    _next_vertex_altered),
            "walks_not_rewalked": (update, "_rewalk", _walks_not_rewalked),
            "off_by_one": (StreamingGraph, "sample_neighbor", _off_by_one),
            "first_neighbor": (StreamingGraph, "sample_neighbor",
                               _first_neighbor)}[name]


@contextlib.contextmanager
def planted(name: str):
    """The system with fault `name` planted, restored on exit."""
    owner, attr, wrap = _target(name)
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)
