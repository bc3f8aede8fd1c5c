"""Lockstep ranks: the S ranks of a sharded step as threads of this
process, taking turns on one device, with one of them counted.

The wharf cells on the 16 x 16 and 2 x 16 x 16 meshes run 256 or 512
ranks of the explicit engine (`distr/sharded.py`, one vertex range a
rank). Processes cannot be those ranks (a CUDA context each, or a gloo
process each, does not fit one card or one host); threads can. `run`
starts one thread a rank, binds each to a `LockstepGroup` (the two
collectives of `distr/collectives.py` on shared buffers) and runs them in
turns: one rank at a time, in rank order, each until its next collective,
which completes when the last rank has posted to it. The turns keep the
ranks from contending for the interpreter lock (on an H100 under torch
2.11, eight threads launching small ops at once ran 12,957 a second, one
thread 59,830 and eight in turns 121,181: `tools/lockstep_probe.py`), make
the order of every launch the same in every run, and let the ranks share
the device's one stream.

A collective's work is done once, on the last rank's turn: a MIN
all-reduce is one `amin` over the stacked inputs, an all-to-all one stack
of the sends, of which each rank takes its column. The counted rank's
work counter (`launch/op_analysis.py`) is suspended inside each
collective, which it records once by kind and output bytes, so the count
holds no op of the group's own copies, whichever rank makes them; its
kernel calls and launches are its own thread's (`kernels/_observe.py`,
`kernels/ops.thread_launches`).

A rank that raises fails the run: the others stop at their next turn and
`run` raises the first error. A run in which no rank takes a turn for
`timeout` seconds fails with TimeoutError. There is no other route: the
ranks are these threads, on the device the caller names.

torch's own threaded process group (`torch.testing._internal.distributed.
multi_threaded_pg`) also runs ranks as threads, but its rank 0 makes an
all-to-all as S^2 slice copies (3.3 s a call at S = 256 on an H100 under
torch 2.11, 80 calls a batch), its threads run at once, its waits have no
timeout, and under torch 2.11 its teardown fails ("'ThreadLocalWorld'
object has no attribute 'comms'"; `tools/lockstep_probe.py`).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import torch

from repro_torch.distr import collectives
from repro_torch.kernels import ops

TIMEOUT = 600.0  # seconds without a turn taken before a run fails


class _Stopped(Exception):
    """Raised in a rank whose run another rank failed."""


class LockstepGroup(collectives.InProcessGroup):
    """S thread ranks that take turns in rank order, switching at their
    collectives (module doc)."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a group of {size} ranks")
        self._size = size
        self._lock = threading.Lock()
        # one condition a rank, and the caller's: a turn wakes its rank alone
        self._conds = [threading.Condition(self._lock) for _ in range(size)]
        self._cond = threading.Condition(self._lock)
        self._turn = 0
        self._done = [False] * size
        self._posted = {}       # rank -> (collective, tensor) of the one in progress
        self._result = None     # the last completed collective's shared result
        self._ranks = threading.local()
        self.error: Optional[BaseException] = None
        self.last_turn = time.monotonic()

    # -- the rank's side

    def rank(self) -> int:
        return self._ranks.rank

    def size(self) -> int:
        return self._size

    def start(self, rank: int) -> None:
        """Bind this thread to `rank` and wait for its first turn."""
        self._ranks.rank = rank
        with self._lock:
            self._wait_turn(rank)

    def finish(self) -> None:
        """This rank returned: it takes no more turns."""
        rank = self.rank()
        with self._lock:
            if self._posted:
                self._fail(RuntimeError(
                    f"rank {rank} returned while ranks {sorted(self._posted)} wait at "
                    f"a collective"))
                return
            self._done[rank] = True
            self._pass(rank)

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            self._fail(exc)

    def all_reduce_min(self, t: torch.Tensor) -> None:
        t.copy_(self._collective("all_reduce_min", t, lambda ts: torch.stack(ts).amin(0)))

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        stacked = self._collective("all_to_all", send, torch.stack)
        s = self._size
        block = send.shape[0] // s
        if block * s != send.shape[0]:
            raise ValueError(f"all_to_all of {tuple(send.shape)} over {s} ranks")
        # column r of the [src, dst] blocks, in source order
        cols = stacked.view(s, s, block, *send.shape[1:])[:, self.rank()]
        return cols.reshape(send.shape)

    def _collective(self, name: str, t: torch.Tensor, combine: Callable):
        """Post `t` to the collective in progress; on the last rank's post
        combine all of them. Returns the combined result, on this rank's
        next turn."""
        rank = self.rank()
        with self._lock:
            if self.error is not None:
                raise _Stopped()
            if any(self._done):
                self._fail(RuntimeError(f"rank {rank} posts {name} after rank "
                                        f"{self._done.index(True)} returned"))
                raise _Stopped()
            self._posted[rank] = (name, t)
            if len(self._posted) == self._size:
                names = {n for n, _ in self._posted.values()}
                if len(names) != 1:
                    self._fail(RuntimeError(f"the ranks post different collectives: "
                                            f"{sorted(names)}"))
                    raise _Stopped()
                self._result = combine([self._posted[r][1] for r in range(self._size)])
                self._posted = {}
            self._pass(rank)
            self._wait_turn(rank)
            return self._result

    # -- the turns (the lock held)

    def _pass(self, rank: int) -> None:
        self.last_turn = time.monotonic()
        for k in range(1, self._size + 1):
            nxt = (rank + k) % self._size
            if not self._done[nxt]:
                self._turn = nxt
                self._conds[nxt].notify()
                return
        self._cond.notify()      # every rank returned

    def _wait_turn(self, rank: int) -> None:
        while self._turn != rank and self.error is None:
            self._conds[rank].wait()
        if self.error is not None:
            raise _Stopped()

    def _fail(self, exc: BaseException) -> None:
        if self.error is None:
            self.error = exc
        for cond in self._conds:
            cond.notify()
        self._cond.notify()

    # -- the caller's side

    def wait_all(self, timeout: float) -> None:
        """Until every rank returned, or raise the first error; no turn
        taken for `timeout` seconds fails the run."""
        with self._lock:
            while not all(self._done) and self.error is None:
                idle = time.monotonic() - self.last_turn
                if idle > timeout:
                    self._fail(TimeoutError(
                        f"no rank of {self._size} took a turn in {timeout:.0f} s (rank "
                        f"{self._turn} holds it)"))
                    break
                self._cond.wait(min(1.0, timeout - idle + 0.01))
            if self.error is not None:
                raise self.error


@dataclass
class Run:
    """What `run` returns: each rank's outputs, its kernel launches in its
    step and in its setup, the counted rank's totals and rows
    (`op_analysis.counted_call`), and the run's host seconds."""
    outputs: List[Any]
    launches: List[dict]
    setup_launches: List[dict]
    totals: Any = None
    rows: list = field(default_factory=list)
    seconds: float = 0.0


def run(step: Callable, size: int, *, device, setup: Optional[Callable] = None,
        counted: Optional[int] = 0, timeout: float = TIMEOUT,
        top: Optional[int] = None) -> Run:
    """Run `step(rank, setup(rank))` (`step(rank, None)` without `setup`)
    on `size` lockstep ranks on `device`, under `torch.no_grad`; rank
    `counted` (None: no rank) runs its step under the work counter, its
    setup uncounted. Returns the `Run`; raises the first rank's error (its
    note names the rank) or TimeoutError (module doc)."""
    from repro_torch.launch.op_analysis import counted_call
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if counted is not None and not 0 <= counted < size:
        raise ValueError(f"rank {counted} of {size}")
    group = LockstepGroup(size)
    res = Run(outputs=[None] * size, launches=[None] * size, setup_launches=[None] * size)

    def since(before: dict) -> dict:
        return {k: v - before[k] for k, v in ops.thread_launches().items()}

    def rank_main(rank: int) -> None:
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            with collectives.bind(group), torch.no_grad():
                group.start(rank)
                before = dict(ops.thread_launches())
                ctx = setup(rank) if setup is not None else None
                res.setup_launches[rank] = since(before)
                before = dict(ops.thread_launches())
                if rank == counted:
                    out, res.totals, res.rows = counted_call(step, rank, ctx, top=top)
                else:
                    out = step(rank, ctx)
                res.outputs[rank] = out
                res.launches[rank] = since(before)
                group.finish()
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001  (the run's boundary: fail every rank)
            e.add_note(f"in rank {rank} of {size} lockstep ranks")
            group.fail(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=rank_main, args=(r,), name=f"lockstep-rank-{r}",
                                daemon=True) for r in range(size)]
    for t in threads:
        t.start()
    try:
        group.wait_all(timeout)
    finally:
        if group.error is None:
            for t in threads:
                t.join()
        else:
            # the ranks stop at their next turn; one stuck outside the
            # group's waits is left behind, a daemon
            deadline = time.monotonic() + min(5.0, timeout)
            for t in threads:
                t.join(max(0.0, deadline - time.monotonic()))
    res.seconds = time.perf_counter() - t0
    return res
