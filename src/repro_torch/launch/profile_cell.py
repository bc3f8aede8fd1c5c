"""Per-cell profile: the static op table of a cell (`op_analysis.breakdown`:
the heaviest ops by counted bytes, loops scaled), then one run of the
cell's step under `torch.profiler` and its top device operations by device
time, the port's seven kernels named (port of
`repro/launch/profile_cell.py`, whose profile is the compiled HLO's table
alone).

    python -m repro_torch.launch.profile_cell --arch wharf-stream \\
        --shape stream_10k_pipelined --wharf-log2-n 14
    python -m repro_torch.launch.profile_cell --arch gemma2-2b --shape train_4k \\
        --static-only        # meta: the static table, on any machine
    python -m repro_torch.launch.profile_cell --arch gemma2-2b --shape decode_32k \\
        --multi              # one rank's table on the 2 x 16 x 16 mesh
    python -m repro_torch.launch.profile_cell --arch wharf-stream --shape stream_10k \\
        --mesh single --wharf-log2-n 12 --wharf-rewalk-capacity 1024 --device cpu

A wharf cell runs on real inputs (`dryrun.wharf_inputs`) on `--device`,
the card unless the caller asks for the CPU; on the CPU the step runs the
kernels' plain versions, and the device table is the CPU's. The other
families' plans are meta-only at their full widths: they print the static
table (`--static-only` is implied). As the reference's, `--mesh single`
and `--multi` (`--mesh multi`) partition such a plan on the 16 x 16 or
2 x 16 x 16 mesh (`dryrun.fake_mesh`, `steps.partition`): the table then
lists one rank's ops at their shard shapes and its collectives; `--mesh
1`, the default, counts one card's step of the whole cell. An order-1
wharf cell on a mesh runs its 256 or 512 ranks as lockstep threads on
`--device` (cut it with `--wharf-log2-n`) and lists rank 0's table, with
no device trace; the order-2 wharf cells count on one card. For the
runtime phases of a live engine see `repro_torch/obs/trace.py`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.op_analysis import counted_run
from repro_torch.tree import tree_map

# the port's record_function scopes (their device spans hold kernels)
SCOPES = ("wharf.", "maintainer.")
# a substring of each kernel's device symbol -> the kernel (kernels/ops.py)
KERNEL_SYMBOLS = (("unpair_kernel", "szudzik_unpair"), ("pair_kernel", "szudzik_pair"),
                  ("decode_kernel", "delta_decode"), ("search_kernel", "find_next_packed"),
                  ("WindowSrc", "intersect_next"), ("CsrSrc", "intersect_csr"),
                  ("fused_step_kernel", "fused_rewalk_step"), ("sgns_kernel", "sgns_step"))


def kernel_of(symbol: str):
    """The port kernel a device symbol belongs to, or None."""
    for sub, name in KERNEL_SYMBOLS:
        if sub in symbol:
            return name
    return None


def device_table(run, top: int = 25) -> dict:
    """`run()` under torch.profiler: wall ms, the device's busy ms and idle
    share, the top-N device ops by device time, each with the port kernel
    it is (None for PyTorch's own), and each port kernel's total device
    ms and calls. Times are the device's records (ctypes launches belong
    to no host operator)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    # the device's records alone on the card: host events would double
    # the trace a step of ~10^5 launches makes
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    by_name = {}
    for e in prof.events():
        if e.device_type != want or (not cuda and e.cpu_parent is not None):
            continue
        if cuda and (getattr(e, "is_user_annotation", False) or e.name.startswith(SCOPES)):
            continue    # a record_function scope's device span, not a kernel
        ms = (e.time_range.end - e.time_range.start) / 1e3
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += ms
        row[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    kernels = {}
    for n, (ms, c) in by_name.items():
        k = kernel_of(n)
        if k:
            acc = kernels.setdefault(k, {"ms": 0.0, "calls": 0})
            acc["ms"] += ms
            acc["calls"] += c
    return {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "wall_ms": wall_ms, "busy_ms": busy if cuda else None,
            "idle_share": 1 - busy / wall_ms if cuda and wall_ms else None,
            "top": [{"name": n[:120], "kernel": kernel_of(n), "ms": ms, "calls": c}
                    for n, (ms, c) in rows],
            "kernels": kernels}


def profile_cell(arch: str, shape: str, *, config=None, info=None, device=None,
                 seed: int = 0, top: int = 25, static_only: bool = False,
                 smoke: bool = False, mesh=None) -> dict:
    """The static table and, for a wharf cell, the profiled run; `info`
    stands for the shape's entry (a cell cut in batches). With `mesh` (a
    `DeviceMesh`) the table is one rank's of the plan partitioned on it:
    an LM, GNN or recsys plan's on meta, an order-1 wharf cell's rank 0 of
    its ranks run as lockstep threads on real inputs on `device`
    (`launch/lockstep.py`; no device trace)."""
    from repro_torch._device import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import wharf_inputs
    from repro_torch.launch.steps import build_cell
    wharf = get_arch(arch).family == "wharf"
    if mesh is not None and wharf:
        # the S ranks of the explicit partition as lockstep threads, rank 0
        # counted: its table alone, no device trace of S ranks
        from repro_torch.launch import lockstep
        from repro_torch.launch.dryrun import (ORDER2_NOTE, mesh_name, partitionable,
                                               wharf_mesh_inputs)
        if not partitionable(shape):
            raise ValueError(f"{shape}: {ORDER2_NOTE}")
        cfg = config or get_arch(arch).make_config(smoke)
        plan = build_cell(arch, shape, mesh=mesh, smoke=smoke, config=config, info=info)
        dev = resolve_device(device)
        args, setup, _ = wharf_mesh_inputs(plan, cfg, seed, dev)
        run = lockstep.run(lambda r, _: plan.fn(*args), mesh.size(), device=dev, setup=setup,
                           counted=0, top=None)
        return {"arch": arch, "shape": shape, "step": plan.step_name,
                "mesh": mesh_name(mesh), "totals": run.totals, "static": run.rows[:top],
                "op_calls": sum(r[5] for r in run.rows)}
    if mesh is not None:
        from repro_torch.launch.dryrun import mesh_name
        from repro_torch.launch.steps import partition
        plan = partition(build_cell(arch, shape, mesh=mesh, smoke=smoke, config=config,
                                    info=info), mesh)
        _, tot, rows = counted_run(plan, top=top)
        return {"arch": arch, "shape": shape, "step": plan.step_name,
                "mesh": mesh_name(mesh), "totals": tot, "static": rows}
    plan = build_cell(arch, shape, smoke=smoke, config=config, info=info)
    out = {"arch": arch, "shape": shape, "step": plan.step_name}
    if not wharf:
        _, tot, rows = counted_run(plan, top=top)
        out.update(totals=tot, static=rows)
        return out
    cfg = config or get_arch(arch).make_config(smoke)
    dev = resolve_device(device)
    args = wharf_inputs(plan, cfg, seed, dev)
    with torch.no_grad():
        # the step donates its state: the count runs on copies
        _, tot, rows = counted_run(plan, tree_map(torch.clone, args), top=top)
        out.update(totals=tot, static=rows)
        if not static_only:
            out["device_ops"] = device_table(lambda: plan.fn(*args), top)
    return out


def print_profile(prof: dict) -> None:
    tot = prof["totals"]
    where = f" on the {prof['mesh']} mesh, one rank" if "mesh" in prof else ""
    print(f"{prof['arch']} x {prof['shape']} ({prof['step']}){where}")
    print(f"totals: flops={tot.flops:.4g} mem={tot.mem_bytes:.4g}B "
          f"coll={tot.coll_total:.4g}B kernels={ {k: v for k, v in tot.kernel_calls.items() if v} }")
    if "op_calls" in prof:
        print(f"ops counted: {prof['op_calls']:.0f} calls (views and bare allocations aside)")
    if "mesh" in prof:
        print("collectives: " + ", ".join(
            f"{k} {tot.coll_counts[k]:.0f} x {tot.coll_bytes[k]:.4g}B"
            for k in tot.coll_bytes if tot.coll_counts[k]))
    print(f"{'bytes':>12s} {'flops':>12s} {'calls':>8s} op                 name  shape")
    for b, fl, opc, name, shape, m in prof["static"]:
        print(f"{b:12.4g} {fl:12.4g} {m:8.0f} {opc:18s} {name[:42]:42s} {shape}")
    dt = prof.get("device_ops")
    if dt:
        print(f"device {dt['device']}: wall {dt['wall_ms']:.1f} ms, busy {dt['busy_ms']} ms, "
              f"idle share {dt['idle_share']}")
        for r in dt["top"]:
            print(f"{r['ms']:12.3f} ms {r['calls']:6d}  {r['kernel'] or '-':18s} {r['name']}")
        for k, r in dt["kernels"].items():
            print(f"kernel {k}: {r['ms']:.3f} ms over {r['calls']} calls")


def main(argv=None):
    from repro_torch.launch.dryrun import wharf_config
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--smoke", action="store_true", help="the smoke config")
    ap.add_argument("--wharf-log2-n", type=int, default=20,
                    help="the wharf config's vertices, 2^N (20: uncut)")
    ap.add_argument("--wharf-rewalk-capacity", type=int, default=0,
                    help="the wharf config's rewalk capacity (0: dryrun.wharf_config's)")
    ap.add_argument("--wharf-max-pending", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--mesh", choices=("1", "single", "multi"), default="1",
                    help="16x16 (single), 2x16x16 (multi) or 1: one card's step")
    ap.add_argument("--multi", action="store_true", help="the 2x16x16 mesh (--mesh multi)")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import fake_mesh
    wharf = get_arch(args.arch).family == "wharf"
    config = (wharf_config(args.wharf_log2_n, args.wharf_max_pending,
                           args.wharf_rewalk_capacity) if wharf and not args.smoke else None)
    mesh = "multi" if args.multi else args.mesh
    kw = dict(config=config, device=args.device, seed=args.seed, top=args.top,
              smoke=args.smoke, static_only=args.static_only)
    if mesh == "1":
        print_profile(profile_cell(args.arch, args.shape, **kw))
    else:
        with fake_mesh(mesh == "multi") as m:
            print_profile(profile_cell(args.arch, args.shape, mesh=m, **kw))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
