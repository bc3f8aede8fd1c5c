"""Pinned read snapshots: epoch-stamped views that survive later stream
windows; port of `repro/serve/snapshots.py`.

The engine rewrites its pending version blocks in place: a step writes its
block into the pending tensors, a merge clears them (core/update.py). An
overlay handed to a reader therefore goes stale at the writer's next step,
as the reference's does when `run_stream` donates its buffers. A pin makes
a snapshot durable:

  * **copy-on-pin** — the pin owns fresh copies of the pending rows and of
    the slot -> row table (`Overlay.copy_pending`). Nothing else a pinned
    overlay reads is ever written in place: each update clones
    `slot_epoch`, and a merge builds a new store (every in-place write in
    core/ lands in a tensor the same call allocated, except the pending
    blocks), so the base store is shared, not copied;
  * **refcounted release** — the pin registers with the engine
    (`WalkEngine.pin_buffers`; the reference stops donating while a pin
    is out, the port never donates), and `release()` drops it.

The pin costs one copy of the filled pending blocks (20 bytes a row) and
the table (4 bytes a corpus slot) up front. Release promptly; `with
service.pin() as snap:` scopes it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.overlay import Overlay
from repro_torch.obs import trace


@dataclass
class PinnedSnapshot:
    """A consistent, epoch-stamped read view pinned against later updates.

    `overlay` shares the base store and owns copied pending rows;
    `epoch`/`n_pending` stamp the engine state it was built from — `epoch`
    keys every derived-read cache (walk matrix, PPR tables), so two pins
    of the same epoch share cached products."""

    overlay: Overlay
    epoch: int
    n_pending: int
    _engine: object = field(repr=False, default=None)
    _released: bool = field(default=False, repr=False)

    @property
    def released(self) -> bool:
        return self._released

    @property
    def nbytes(self) -> int:
        """Bytes the pin copied (the pending rows and the slot table)."""
        ov = self.overlay
        return sum(t.numel() * t.element_size() for t in (
            ov.owner, ov.code, ov.epoch, ov.slot, ov.row_of_slot))

    def release(self) -> None:
        """Drop the pin (idempotent); the snapshot must not be read again."""
        if not self._released:
            self._released = True
            if self._engine is not None:
                with trace.phase("serve/unpin", cat="serve",
                                 epoch=self.epoch):
                    self._engine.unpin_buffers()

    def check_live(self) -> None:
        if self._released:
            raise ValueError(
                "pinned snapshot was released — its buffers may have been "
                "rewritten by a later stream; pin() a fresh one")

    def __enter__(self) -> "PinnedSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def pin_snapshot(engine, overlay: Overlay, epoch: int,
                 n_pending: int) -> PinnedSnapshot:
    """Build a pin from the service's current overlay: copy the pending
    rows, take the engine refcount (released via `PinnedSnapshot`)."""
    engine.pin_buffers()
    return PinnedSnapshot(overlay=overlay.copy_pending(), epoch=epoch,
                          n_pending=n_pending, _engine=engine)
