"""The step loop with checkpoint/restart and straggler detection; port of
`repro/train/runtime.py`.

  * crash / preemption -> a restarted process calls `resume()`, which
    restores the latest committed checkpoint (a partial save is invisible)
    and continues from step N+1
  * restore onto another device: `resume(shardings=...)` (train/checkpoint.py)
  * stragglers -> a per-step wall-time EWMA; a step slower than `factor`
    x the EWMA is logged and kept out of the mean
  * determinism -> the key of step s is fold_in(PRNGKey(seed), s), so a
    recovery replays the same batches

A step's time is taken after `torch.cuda.synchronize` on the device of
the state's first tensor leaf (none on the CPU), as the reference blocks
on its first leaf before it stops the clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import random as jr
from repro_torch._device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_leaves


@dataclass
class StragglerMonitor:
    factor: float = 2.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    events: List[Dict[str, Any]] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ewma is not None and dt > self.factor * self.ewma:
            is_straggler = True
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
        # stragglers don't poison the mean
        if self.ewma is None:
            self.ewma = dt
        elif not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def _sync(state) -> None:
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


@dataclass
class TrainLoop:
    step_fn: Callable          # (state, batch, key) -> (state, metrics)
    batch_fn: Callable         # (step, key) -> batch
    ckpt: CheckpointManager
    ckpt_every: int = 50
    straggler: StragglerMonitor = field(default_factory=StragglerMonitor)
    seed: int = 0
    # restore hook: (state, step) -> state. The downstream trainer hands
    # the restored (EngineState, tables, opt) carry back to its
    # EmbeddingMaintainer with it (launch/train.py)
    on_restore: Optional[Callable] = None
    # the device the step keys are made on: the card unless told otherwise
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def resume(self, init_state, shardings=None):
        """Restore the latest committed checkpoint, or start fresh ->
        (state, first step to run)."""
        step = self.ckpt.latest_step()
        if step is None:
            return init_state, 0
        state, step = self.ckpt.restore(init_state, shardings=shardings)
        if self.on_restore is not None:
            state = self.on_restore(state, step)
        return state, step + 1

    def run(self, state, start_step: int, num_steps: int,
            on_metrics: Optional[Callable] = None):
        base = jr.PRNGKey(self.seed, self.device)
        for step in range(start_step, start_step + num_steps):
            key = jr.fold_in(base, step)  # deterministic replay
            batch = self.batch_fn(step, key)
            t0 = time.time()
            state, metrics = self.step_fn(state, batch, key)
            _sync(state)
            dt = time.time() - t0
            if self.straggler.observe(step, dt):
                metrics = dict(metrics, straggler=True)
            if on_metrics:
                on_metrics(step, dt, metrics)
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(start_step + num_steps - 1, state, blocking=True)
        return state
