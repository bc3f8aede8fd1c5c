"""Dry-run: count every (architecture x input shape) cell's work and set
it against the card's roofline (port of `repro/launch/dryrun.py`).

    python -m repro_torch.launch.dryrun                       # LM, GNN, recsys, both meshes
    python -m repro_torch.launch.dryrun --mesh single --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --cell dlrm-rm2/serve_p99 --cell gemma2-2b/decode_32k
    python -m repro_torch.launch.dryrun --mesh 1              # one card's step
    python -m repro_torch.launch.dryrun --mesh 1 --include-wharf --wharf-log2-n 14
    python -m repro_torch.launch.dryrun --mesh 1 --device cpu --include-wharf --wharf-log2-n 10

The LM, GNN and recsys cells build at their full configs on the meta
device and are counted there (`op_analysis`: nothing is allocated, the
microbatch loop is counted once and scaled). As the reference's, the
default counts each cell partitioned on the 16 x 16 mesh (`--mesh single`)
and the 2 x 16 x 16 one (`multi`; `both`): the plan built on the mesh,
its args DTensors placed by the plan's shardings (`steps.partition`), the
counts those of one rank (rank 0, whose shard is the largest where a dim
does not divide), over a process group of the "fake" backend of 256 or 512
ranks made in this process. `--mesh 1` counts one card's step of the
whole cell. The wharf cells' ops have data-dependent shapes, so they run
one card's step on real inputs drawn from `--seed` on `--device` (the
card unless the caller asks for the CPU), at the full config cut to
2^`--wharf-log2-n` vertices, whatever `--mesh` says. Results accumulate
in `--out`, one record a cell and mesh: keyed `arch|shape|single` or
`|multi` on a mesh, `arch|shape|full` (or `|smoke`) on one card.

A record: the counted FLOPs (by dtype) and bytes a rank, collective bytes
and counts by kind a rank, the seven kernels' calls and bytes (and, on the
card, the launches `kernels/ops.py` counted in the run), `model_flops` and
its ratio to the count times the ranks (`model_flops / (flops * n_cards)`),
the roofline terms a card against the H100 constants of `launch/mesh.py`
(compute: FLOPs of bf16/f16 products at the bf16 peak, the rest at the f32
peak; memory: bytes at the HBM rate; collective: bytes at the NVLink rate,
though 256 cards span many NVLink domains), the dominant term, the
argument and output bytes a rank, and, for a run on the card, its peak
device memory. A count on the CPU is a count: its `device` says so, and
it has no peak.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import torch

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, peak_flops
from repro_torch.launch.op_analysis import analyze


def roofline_terms(flops_by_dtype: dict, bytes_accessed: float, coll_bytes: float):
    """(terms in s, the dominant term) for one card."""
    compute = sum(f / peak_flops(getattr(torch, dt)) for dt, f in flops_by_dtype.items())
    terms = {"compute_s": compute, "memory_s": bytes_accessed / HBM_BW,
             "collective_s": coll_bytes / NVLINK_BW}
    return terms, max(terms, key=terms.get)


def wharf_config(log2_n: int = 20, max_pending: int = 8):
    """The full wharf-stream config cut to 2^log2_n vertices in scale
    only: the edge capacity keeps its 128 slots a vertex, and the rewalk
    capacity is the walk count below 2^20 vertices (a 10,000-edge batch
    then affects most walks, and the full config's 2^20 would drop some
    unflagged)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("wharf-stream").make_config(False)
    if log2_n == 20:
        return dataclasses.replace(cfg, max_pending=max_pending)
    n = 1 << log2_n
    return dataclasses.replace(cfg, n_vertices=n, edge_capacity=n * 128,
                               rewalk_capacity=n * cfg.n_walks_per_vertex,
                               max_pending=max_pending)


def wharf_inputs(plan, cfg, seed: int, device, mean_degree: int = 100):
    """Real args of a wharf plan at `cfg`: an ER graph of `mean_degree`
    (uniform vertex pairs) and its corpus, uniform edge batches and keys,
    all drawn from `seed` on `device`; the serve cell's pending blocks
    after one on-demand batch, its queries half on stored walks."""
    from repro_torch import random as jr
    from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus
    from repro_torch.core.overlay import Overlay
    from repro_torch.core.update import WalkEngine
    from repro_torch.distr.engine import graph_to_dict, store_to_dict

    n = cfg.n_vertices
    gen = torch.Generator(device=device).manual_seed(seed)

    def ids(*shape):
        return torch.randint(0, n, shape, generator=gen, device=device).to(torch.int32)

    src, dst = ids(n * mean_degree // 2), ids(n * mean_degree // 2)
    graph = StreamingGraph.from_edges(src, dst, n, cfg.edge_capacity, device=device)
    del src, dst
    wcfg = WalkConfig(n_walks_per_vertex=cfg.n_walks_per_vertex, length=cfg.length,
                      chunk_b=cfg.chunk_b)
    key = jr.PRNGKey(seed, device)
    store = generate_corpus(jr.fold_in(key, 0), graph, wcfg)
    a = plan.args
    if plan.step_name == "walk_serve_step":
        eng = WalkEngine(graph=graph, store=store, cfg=wcfg, merge_policy="on-demand",
                         rewalk_capacity=cfg.rewalk_capacity, max_pending=cfg.max_pending)
        be = 10_000
        eng.update_batch(jr.fold_in(key, 1), ids(be), ids(be), ids(be // 5), ids(be // 5))
        st = eng.state
        qb = a[3].shape[0]
        w = torch.randint(0, store.n_walks, (qb,), generator=gen, device=device)
        p = torch.randint(0, store.length - 1, (qb,), generator=gen, device=device)
        walks = Overlay.build(st.store, st.pending).traverse(
            w, w // cfg.n_walks_per_vertex, store.length - 1)
        v = torch.where(torch.arange(qb, device=device) % 2 == 0,
                        walks[torch.arange(qb, device=device), p], ids(qb).to(torch.int64))
        emb = torch.randn((n, a[2].shape[1]), generator=gen, device=device)
        return (store_to_dict(st.store), st.pending, emb,
                v.to(torch.int32), w.to(torch.int32), p.to(torch.int32))
    if plan.step_name == "walk_update_step":
        be = a[2].shape[0]
        epoch = (store.slot_epoch.to(torch.int64) & 0xFFFFFFFF).max() + 1
        return (graph_to_dict(graph), store_to_dict(store), ids(be), ids(be),
                epoch.to(torch.int32), jr.fold_in(key, 2))
    nb, be = a[-4].shape
    de = a[-2].shape[1]
    stream = (jr.split(jr.fold_in(key, 3), nb), ids(nb, be), ids(nb, be), ids(nb, de),
              ids(nb, de))
    if plan.step_name == "walk_stream_step":
        return (graph_to_dict(graph), store_to_dict(store)) + stream
    # the sharded cell on one rank: its state stacked [1, ...]
    from repro_torch.distr.sharded import local_shard_state
    st = local_shard_state(graph, store, cfg.shard_spec(1), 0, cfg.rewalk_capacity,
                           cfg.max_pending)
    return (stacked_state(st),) + stream


def stacked_state(state) -> dict:
    """One shard's `EngineState` as the sharded plan's [1, ...]-stacked
    state dict."""
    from repro_torch.core.update import PendingBlocks
    from repro_torch.distr.engine import graph_to_dict, store_to_dict
    dev = state.store.device
    return {
        "graph": {k: v[None] for k, v in graph_to_dict(state.graph).items()},
        "store": {k: v[None] for k, v in store_to_dict(state.store).items()},
        "pending": PendingBlocks(*(t[None] for t in state.pending)),
        "n_pending": torch.tensor([state.n_pending], dtype=torch.int32, device=dev),
        "epoch": torch.tensor([state.epoch], dtype=torch.int64, device=dev).to(torch.int32),
        "last_affected": state.last_affected[None], "total_affected": state.total_affected[None],
        "overflow": state.overflow[None]}


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank process group for the sharded cell (S = 1), where none
    is initialized: gloo over a store on localhost, closed after."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    store = dist.TCPStore("localhost", 0, 1, True)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", index))
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(multi_pod: bool = False):
    """The 16 x 16 (or 2 x 16 x 16) production mesh over a "fake" process
    group of its 256 (512) ranks in this process (`mesh.fake_mesh`)."""
    from repro_torch.launch.mesh import fake_mesh as fake, production_shape
    return fake(*production_shape(multi_pod))


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _local_nbytes(tree) -> int:
    """The bytes of this rank's shards of a tree of DTensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import leaf_paths
    return sum(t.to_local().numel() * t.element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size()
               for t in leaf_paths(tree).values() if isinstance(t, torch.Tensor))


def _record(arch, shape, plan, tot, count_s: float, *, mesh: str, n_cards: int, device: str,
            launches=None, peak=None) -> dict:
    """A cell's record (module doc) from its counts `tot`, a rank's."""
    terms, dom = roofline_terms(tot.flops_by_dtype, tot.mem_bytes, tot.coll_total)
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "n_cards": n_cards, "device": device,
        "card": torch.cuda.get_device_name(0) if device.startswith("cuda") else None,
        "step": plan.step_name, "count_s": count_s,
        "flops_per_card": tot.flops, "flops_by_dtype": tot.flops_by_dtype,
        "bytes_per_card": tot.mem_bytes,
        "collective_bytes_per_card": tot.coll_total,
        "collective_breakdown": tot.coll_bytes, "collective_counts": tot.coll_counts,
        "kernel_calls": tot.kernel_calls, "kernel_bytes": tot.kernel_bytes,
        "launches": launches, "model_flops": plan.model_flops,
        "flops_ratio_model_over_count": (plan.model_flops / (tot.flops * n_cards)
                                         if tot.flops else None),
        "roofline": terms, "bottleneck": dom,
        "memory": {"argument_bytes": _local_nbytes(plan.args),
                   "output_bytes": tot.output_bytes, "peak_bytes": peak},
    }


def _say(rec: dict, where: str, per: str) -> None:
    print(f"[{where}] {rec['arch']} x {rec['shape']} ({rec['step']}): counted in "
          f"{rec['count_s']:.1f}s | {rec['flops_per_card']:.4g} FLOP{per} | "
          f"{rec['bytes_per_card']:.4g} B{per} | coll {rec['collective_bytes_per_card']:.4g} "
          f"B{per} | bottleneck {rec['bottleneck']}", flush=True)


def run_partitioned(arch: str, shape: str, mesh, *, smoke: bool = False,
                    verbose: bool = True) -> dict:
    """Count one rank's partition of an LM, GNN or recsys cell on `mesh`
    (a `DeviceMesh`; `fake_mesh` builds the production ones) on meta."""
    from repro_torch.launch.steps import build_cell, partition
    t0 = time.perf_counter()
    plan = partition(build_cell(arch, shape, mesh=mesh, smoke=smoke), mesh)
    tot = analyze(plan)
    rec = _record(arch, shape, plan, tot, time.perf_counter() - t0, mesh=mesh_name(mesh),
                  n_cards=mesh.size(), device="meta")
    if verbose:
        _say(rec, rec["mesh"], "/rank")
    return rec


def run_cell(arch: str, shape: str, *, smoke: bool = False, config=None, info=None,
             device=None, seed: int = 0, verbose: bool = True) -> dict:
    """Count one cell and set it against the roofline. LM, GNN and recsys
    cells count on meta at the full config (`smoke` for the smoke one);
    a wharf cell runs on real inputs at `config` (default: the full
    config) on `device` (the card unless the caller asks for the CPU).
    `info` stands for the shape's entry (a cell cut in batches)."""
    from repro_torch._device import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell
    family = get_arch(arch).family
    t0 = time.perf_counter()
    plan = build_cell(arch, shape, smoke=smoke, config=config, info=info)
    args, dev, peak = None, "meta", None
    if family == "wharf":
        d = resolve_device(device)
        dev = str(d)
        args = wharf_inputs(plan, config or get_arch(arch).make_config(smoke), seed, d)
        if d.type == "cuda":
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
    before = dict(ops.launches)
    if family == "wharf":
        with torch.no_grad(), one_rank_group(d):
            tot = analyze(plan, args)
    else:
        tot = analyze(plan, args)
    launches = {k: ops.launches[k] - before[k] for k in ops.KERNELS}
    if family == "wharf" and dev.startswith("cuda"):
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    rec = _record(arch, shape, plan, tot, time.perf_counter() - t0, mesh="1", n_cards=1,
                  device=dev, launches=launches if dev.startswith("cuda") else None, peak=peak)
    if verbose:
        _say(rec, dev, "")
    return rec


MESHES = {"1": [None], "single": [False], "multi": [True], "both": [False, True]}


def main(argv=None):
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH/SHAPE",
                    help="count only these cells (repeatable)")
    ap.add_argument("--mesh", choices=list(MESHES), default="both",
                    help="16x16 (single), 2x16x16 (multi), both, or 1: one card's step")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--include-wharf", action="store_true",
                    help="also count the wharf-stream cells (real inputs, one card)")
    ap.add_argument("--wharf-log2-n", type=int, default=20,
                    help="the wharf config's vertices, 2^N (20: uncut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the wharf cells' device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells, get_arch
    cells = list(all_cells())
    if not args.include_wharf:
        cells = [c for c in cells if get_arch(c[0]).family != "wharf"]
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.cell:
        cells = [c for c in cells if "/".join(c) in args.cell]
    try:
        with open(args.out) as f:
            results = json.load(f)
    except (OSError, json.JSONDecodeError):
        results = {}
    wcfg = None if args.smoke else wharf_config(args.wharf_log2_n)
    tag = "smoke" if args.smoke else "full"
    failures = []

    def record(key, fn):
        try:
            results[key] = fn()
        except Exception as e:  # noqa: BLE001  (a cell's failure is recorded; the rest run)
            failures.append((key, repr(e)))
            print(f"FAILED {key}: {e}")
            traceback.print_exc()
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    one_card = [c for c in cells if get_arch(c[0]).family == "wharf" or args.mesh == "1"]
    for arch, shape in one_card:
        wharf = get_arch(arch).family == "wharf"
        record(f"{arch}|{shape}|{tag}", lambda: run_cell(
            arch, shape, smoke=args.smoke, config=wcfg if wharf else None,
            device=args.device, seed=args.seed))
    sharded = [c for c in cells if c not in one_card]
    for multi in MESHES[args.mesh] if sharded else []:
        with fake_mesh(multi) as mesh:
            for arch, shape in sharded:
                record(f"{arch}|{shape}|{'multi' if multi else 'single'}",
                       lambda: run_partitioned(arch, shape, mesh, smoke=args.smoke))
    print(f"\n{len(results)} cells recorded in {args.out}; {len(failures)} failures")
    for k, e in failures:
        print("  FAIL", k, e)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
