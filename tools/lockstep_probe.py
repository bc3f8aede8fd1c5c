"""Why the wharf cells' lockstep ranks (src/repro_torch/launch/lockstep.py)
are an in-process group of the port's own: checks torch's threaded process
group (`torch.testing._internal.distributed.multi_threaded_pg`) on a
device, and times threads launching torch ops at once against in turns.

    python tools/lockstep_probe.py                 # on the card
    python tools/lockstep_probe.py --device cpu

Prints one JSON line a check: the threaded group's MIN all-reduce and
all-to-all on 4 ranks (results, and the errors of each rank by where they
were raised: set-up, collective or teardown), a rank that raises (whether
the others stop), the seconds of its all-to-all at S ranks (rank 0 makes it
as S^2 slice copies), and torch ops a second of one thread, of 8 threads
at once and of 8 threads taking turns.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import torch
import torch.distributed as dist


def threaded_group(n: int, fn, device, timeout: float = 120.0) -> dict:
    """`fn(rank, n)` on n threads of torch's threaded group -> results and
    each rank's error by phase."""
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg
    store = dist.HashStore()
    mtpg._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    res, errs = [None] * n, []

    def rank_main(r):
        phase = "set-up"
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group("threaded", rank=r, world_size=n, store=store)
            phase = "collective"
            res[r] = fn(r, n)
            phase = "teardown"
            dist.destroy_process_group()
        except BaseException as e:  # noqa: BLE001  (recorded by phase; the group is told)
            errs.append((r, phase, repr(e)[:100]))
            mtpg.ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    out = dict(s=time.perf_counter() - t0, alive=sum(t.is_alive() for t in threads),
               errors_by_phase={p: sum(1 for _, q, _ in errs if q == p)
                                for p in ("set-up", "collective", "teardown")},
               first_errors=sorted(errs)[:2], results=res)
    mtpg.ProcessLocalGroup.reset()
    mtpg._uninstall_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(False)
    return out


def ops_per_s(device, n_threads: int, turns: bool, n_ops: int = 4000) -> float:
    """Torch ops a second of `n_threads` threads each launching `n_ops`
    small int64 ops, at once or one thread at a time."""
    lock = threading.Lock()

    def work():
        x = torch.arange(16384, dtype=torch.int64, device=device)
        for _ in range(n_ops // 2):
            x = x + 1
            x = x ^ 3
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run():
        if turns:
            with lock:
                work()
        else:
            work()

    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return n_threads * n_ops / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=256, help="ranks of the all-to-all timing")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps(dict(torch=torch.__version__, device=str(device),
                          card=torch.cuda.get_device_name(device)
                          if device.type == "cuda" else None)), flush=True)

    def collectives(r, n):
        x = torch.tensor([10 * r + 3, 100 - r, r], dtype=torch.int64, device=device)
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        send = torch.arange(2 * n, dtype=torch.int32, device=device) + 1000 * r
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return x.tolist(), recv.tolist()

    out = threaded_group(4, collectives, device)
    want = [([3, 97, 0], [2 * r + 1000 * q + j for q in range(4) for j in range(2)])
            for r in range(4)]
    out["results_right"] = out.pop("results") == want
    print(json.dumps(dict(check="threaded group: MIN all-reduce and all-to-all, 4 ranks",
                          **out)), flush=True)

    def failing(r, n):
        x = torch.zeros(3, dtype=torch.int64, device=device)
        if r == 2:
            raise ValueError("rank 2 fails")
        dist.all_reduce(x, op=dist.ReduceOp.MIN)

    out = threaded_group(4, failing, device, timeout=30)
    out.pop("results")
    print(json.dumps(dict(check="threaded group: rank 2 raises", **out)), flush=True)

    calls = 5

    def all_to_all(r, n):
        send = torch.zeros(n * 64 * 2, dtype=torch.int32, device=device)
        for _ in range(calls):
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = threaded_group(args.ranks, all_to_all, device)
    out.pop("results")
    print(json.dumps(dict(check=f"threaded group: {calls} all-to-alls of {args.ranks} ranks",
                          s_per_call=out["s"] / calls, **out)), flush=True)

    rates = {"1 thread": ops_per_s(device, 1, False),
             "8 threads at once": ops_per_s(device, 8, False),
             "8 threads in turns": ops_per_s(device, 8, True)}
    print(json.dumps(dict(check="torch ops a second", **rates)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
