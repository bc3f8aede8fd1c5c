"""Spawn the ranks of a sharded run: one process a shard, rank = shard
index, each in a `torch.distributed` process group of its own backend
(`spawn`). The processes start with the `spawn` method, meet at a file
rendezvous, and hand their results back pickled, through files."""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

# a collective that waits longer fails (a rank that died leaves the others
# waiting; gloo's own default is 30 minutes)
TIMEOUT = datetime.timedelta(seconds=600)


def _entry(rank: int, n_ranks: int, backend: str, workdir: str,
           threads: int, fn, payload) -> None:
    import faulthandler
    faulthandler.enable()      # a rank that crashes prints where
    torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "rendezvous"),
        world_size=n_ranks, rank=rank, timeout=TIMEOUT)
    try:
        res = fn(rank, payload)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn(fn, n_ranks: int, payload, workdir, backend: str = "gloo",
          threads: int = 1) -> list:
    """Run `fn(rank, payload)` in `n_ranks` spawned processes, each a rank
    of one `backend` process group with `threads` intra-op threads, and
    return their results in rank order. `fn` and `payload` must pickle
    (a module-level function; numpy arrays and plain values). The
    rendezvous and result files go to a fresh directory under `workdir`.
    A rank that raises ends the others, and the exception reaches the
    caller."""
    import torch.multiprocessing as mp
    run_dir = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    mp.spawn(_entry, args=(n_ranks, backend, run_dir, threads, fn, payload),
             nprocs=n_ranks, join=True)
    out = []
    for r in range(n_ranks):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
