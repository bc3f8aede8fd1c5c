"""Dry-run: count every (architecture x input shape) cell's work and set
it against the card's roofline (port of `repro/launch/dryrun.py`).

    python -m repro_torch.launch.dryrun                       # LM, GNN, recsys, both meshes
    python -m repro_torch.launch.dryrun --mesh single --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --cell dlrm-rm2/serve_p99 --cell gemma2-2b/decode_32k
    python -m repro_torch.launch.dryrun --mesh 1              # one card's step
    python -m repro_torch.launch.dryrun --mesh 1 --include-wharf --wharf-log2-n 14
    python -m repro_torch.launch.dryrun --mesh 1 --device cpu --include-wharf --wharf-log2-n 10
    python -m repro_torch.launch.dryrun --arch wharf-stream --include-wharf --mesh single \
        --wharf-log2-n 14 --wharf-rewalk-capacity 8192 --wharf-max-pending 2 --wharf-batches 1

The LM, GNN and recsys cells build at their full configs on the meta
device and are counted there (`op_analysis`: nothing is allocated, the
microbatch loop is counted once and scaled). As the reference's, the
default counts each cell partitioned on the 16 x 16 mesh (`--mesh single`)
and the 2 x 16 x 16 one (`multi`; `both`): the plan built on the mesh,
its args DTensors placed by the plan's shardings (`steps.partition`), the
counts those of one rank (rank 0, whose shard is the largest where a dim
does not divide), over a process group of the "fake" backend of 256 or 512
ranks made in this process. `--mesh 1` counts one card's step of the
whole cell. The wharf cells (`--include-wharf`) run on real inputs drawn
from `--seed` on `--device` (the card unless the caller asks for the
CPU), at the full config cut in scale (`--wharf-log2-n` vertices,
`--wharf-rewalk-capacity`, `--wharf-max-pending`, `--wharf-batches`).
Their shapes depend on the data, so DTensor cannot partition them: on a
mesh an order-1 cell runs the explicit partition (`distr/sharded.py`),
its 256 or 512 ranks lockstep threads of this process sharing the one
device (`launch/lockstep.py`), each building its row from the global
inputs, and rank 0 counted; its collectives must be the static count
(`static_collectives`). The serve cells replicate every argument: each
rank runs the whole read step with no collective, so one rank runs it,
counted. The order-2 cells count one card's step
on every mesh, their records saying why (`ORDER2_NOTE`). Results
accumulate in `--out`, one record a cell and mesh: keyed
`arch|shape|single` or `|multi` on a mesh, `arch|shape|full` (or
`|smoke`) on one card.

A record: the counted FLOPs (by dtype) and bytes a rank, collective bytes
and counts by kind a rank, the seven kernels' calls and bytes (and, on the
card, the launches `kernels/ops.py` counted in the run), `model_flops` and
its ratio to the count times the ranks (`model_flops / (flops * n_cards)`),
the roofline terms a card against the H100 constants of `launch/mesh.py`
(compute: FLOPs of bf16/f16 products at the bf16 peak, the rest at the f32
peak; memory: bytes at the HBM rate; collective: bytes at the NVLink rate,
though 256 cards span many NVLink domains), the dominant term, the
argument and output bytes a rank, and, for a run on the card, its peak
device memory (for lockstep ranks, of all of them together on the one
card). A count on the CPU is a count: its `device` says so, and it has no
peak. A wharf record adds the `cut` it ran at (and the notes a count under
it carries); a partitioned one `partition`, `counted_rank`, `run_s` and,
on the card, every rank's launches.
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


def wharf_config(log2_n: int = 20, max_pending: int = 8, rewalk_capacity: int = 0):
    """The full wharf-stream config cut to 2^log2_n vertices in scale
    only: the edge capacity keeps its 128 slots a vertex, and the rewalk
    capacity is `rewalk_capacity`, or else the walk count below 2^20
    vertices (a 10,000-edge batch then affects most walks, and the full
    config's 2^20 would drop some unflagged)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("wharf-stream").make_config(False)
    cap = {"rewalk_capacity": rewalk_capacity} if rewalk_capacity else {}
    if log2_n == 20:
        return dataclasses.replace(cfg, max_pending=max_pending, **cap)
    n = 1 << log2_n
    return dataclasses.replace(cfg, n_vertices=n, edge_capacity=n * 128,
                               rewalk_capacity=rewalk_capacity or n * cfg.n_walks_per_vertex,
                               max_pending=max_pending)


def _draws(cfg, seed: int, device, mean_degree: int):
    """The seeded draws every wharf input starts from: an ER graph of
    `mean_degree` (uniform vertex pairs) and its corpus, the generator
    (for the batches and queries that follow, in order) and the key."""
    from repro_torch import random as jr
    from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus
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
    return gen, ids, graph, store, key, wcfg


def _update_batch(ids, store, key, be: int):
    """(ins_src, ins_dst, new_epoch, key) of a walk-update step."""
    from repro_torch import random as jr
    epoch = (store.slot_epoch.to(torch.int64) & 0xFFFFFFFF).max() + 1
    return ids(be), ids(be), epoch.to(torch.int32), jr.fold_in(key, 2)


def _stream(ids, key, nb: int, be: int, de: int):
    """(keys, ins_src, ins_dst, del_src, del_dst) of an [nb, ...] stream."""
    from repro_torch import random as jr
    return (jr.split(jr.fold_in(key, 3), nb), ids(nb, be), ids(nb, be), ids(nb, de),
            ids(nb, de))


def wharf_inputs(plan, cfg, seed: int, device, mean_degree: int = 100):
    """Real args of a wharf plan built without a mesh at `cfg`: an ER
    graph of `mean_degree` (uniform vertex pairs) and its corpus, uniform
    edge batches and keys, all drawn from `seed` on `device`; the serve
    cell's pending blocks after one on-demand batch, its queries half on
    stored walks."""
    from repro_torch import random as jr
    from repro_torch.core.overlay import Overlay
    from repro_torch.core.update import WalkEngine
    from repro_torch.distr.engine import graph_to_dict, store_to_dict

    gen, ids, graph, store, key, wcfg = _draws(cfg, seed, device, mean_degree)
    n = cfg.n_vertices
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
        return (graph_to_dict(graph), store_to_dict(store)) + _update_batch(
            ids, store, key, a[2].shape[0])
    nb, be = a[-4].shape
    stream = _stream(ids, key, nb, be, a[-2].shape[1])
    if plan.step_name == "walk_stream_step":
        return (graph_to_dict(graph), store_to_dict(store)) + stream
    # the sharded cell on one rank: its state stacked [1, ...]
    from repro_torch.distr.sharded import local_shard_state
    st = local_shard_state(graph, store, cfg.shard_spec(1), 0, cfg.rewalk_capacity,
                           cfg.max_pending)
    return (stacked_state(st),) + stream


def wharf_mesh_inputs(plan, cfg, seed: int, device, mean_degree: int = 100,
                      one_card=None):
    """(args, setup, one-card args) of a wharf plan built on a mesh, from
    the draws of `wharf_inputs` (the same seed draws the same graph,
    corpus, batches and keys): the serve cell's args replicated (setup
    None); the explicit partition's [S, ...]-stacked state allocated,
    whose row r `setup(r)` writes (`steps.shard_row`), one rank at a time.
    With `one_card` (the cell's plan built without a mesh) the third item
    is its args from the same draws, the batches and keys the same
    tensors; else None."""
    from repro_torch.distr.engine import graph_to_dict, store_to_dict
    from repro_torch.launch.steps import shard_row
    from repro_torch.tree import tree_map
    if plan.step_name == "walk_serve_step":
        args = wharf_inputs(plan, cfg, seed, device, mean_degree)
        return args, None, None if one_card is None else args
    _, ids, graph, store, key, _ = _draws(cfg, seed, device, mean_degree)
    a = plan.args
    stacked = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=device), a[0])
    if plan.step_name == "walk_update_step":
        rest = _update_batch(ids, store, key, a[1].shape[0])
    else:
        nb, be = a[-4].shape
        rest = _stream(ids, key, nb, be, a[-2].shape[1])

    def setup(rank):
        shard_row(stacked, rank, graph, store, cfg)

    one_args = None
    if one_card is not None and one_card.step_name == "walk_stream_sharded_step":
        from repro_torch.distr.sharded import local_shard_state
        one_args = (stacked_state(local_shard_state(graph, store, cfg.shard_spec(1), 0,
                                                    cfg.rewalk_capacity,
                                                    cfg.max_pending)),) + rest
    elif one_card is not None:
        one_args = (graph_to_dict(graph), store_to_dict(store)) + rest
    return (stacked,) + rest, setup, one_args


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
    note = None
    if family == "wharf":
        d = resolve_device(device)
        info = dict(get_arch(arch).shapes[shape] if info is None else info)
        if d.type == "cpu" and info.get("megakernel") == "cuda":
            # the reference's "pallas" runs its interpret math off the TPU
            info["megakernel"] = "torch"
            note = "the fused step's plain version (megakernel 'torch') on the CPU"
    plan = build_cell(arch, shape, smoke=smoke, config=config, info=info)
    args, dev, peak = None, "meta", None
    if family == "wharf":
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
    if family == "wharf":
        rec["cut"] = _cut(config or get_arch(arch).make_config(smoke), info, 100)
        if note:
            rec["cut"]["notes"].append(note)
    if verbose:
        _say(rec, dev, "")
    return rec


ORDER2_NOTE = ("counted on one card: the explicit engine (distr/sharded.py) is order 1 "
               "only; a per-shard order-2 rewalk needs N(prev) from another shard")
PEAK_NOTE = "the device's peak of all the ranks together: every rank shares the one card"


def partitionable(shape: str) -> bool:
    """Whether a wharf cell runs partitioned on a mesh (its order is 1)."""
    from repro_torch.configs import get_arch
    return get_arch("wharf-stream").shapes[shape].get("order", 1) == 1


def cut_info(shape: str, n_batches: int = 0) -> dict:
    """The shape's entry, its stream cut to `n_batches` batches (0: not)."""
    from repro_torch.configs import get_arch
    info = dict(get_arch("wharf-stream").shapes[shape])
    if n_batches and "n_batches" in info:
        info["n_batches"] = n_batches
    return info


def _cut(cfg, info, mean_degree: int) -> dict:
    """The config's scale and the notes a count under it carries."""
    n_walks = cfg.n_vertices * cfg.n_walks_per_vertex
    cut = {"n_vertices": cfg.n_vertices, "edge_capacity": cfg.edge_capacity,
           "rewalk_capacity": cfg.rewalk_capacity, "max_pending": cfg.max_pending,
           "n_batches": info.get("n_batches"), "mean_degree": mean_degree, "notes": []}
    if cfg.rewalk_capacity < n_walks and info["kind"] != "walk_serve":
        cut["notes"].append(
            f"rewalk_capacity {cfg.rewalk_capacity} < {n_walks} walks: a batch drops the "
            f"affected walks beyond it without a flag, as the reference's _rewalk does")
    return cut


def _rank_nbytes(plan, n_ranks: int) -> int:
    """One rank's argument bytes: a row of the [S, ...]-stacked state, the
    rest whole."""
    stacked = plan.step_name != "walk_serve_step"
    return sum(_local_nbytes(a) // (n_ranks if stacked and i == 0 else 1)
               for i, a in enumerate(plan.args))


def static_collectives(plan, cfg, info, n_ranks: int) -> dict:
    """{kind: (count, bytes)} a rank of the explicit partition makes: a
    batch, one MIN all-reduce of the int64 [n_walks] keys and `length`
    all-to-alls of n_ranks x slab x 8 bytes; none in a replicated serve
    step."""
    if plan.step_name == "walk_serve_step":
        return {}
    nb = info.get("n_batches", 1)
    slab = cfg.shard_spec(n_ranks).slab
    return {"all-reduce": (nb, nb * cfg.n_vertices * cfg.n_walks_per_vertex * 8),
            "all-to-all": (nb * cfg.length, nb * cfg.length * n_ranks * slab * 8)}


def run_wharf_partitioned(shape: str, mesh, *, config, device=None, info=None, seed: int = 0,
                          counted: int = 0, mean_degree: int = 100,
                          verbose: bool = True) -> dict:
    """Count one rank of an order-1 wharf cell partitioned on `mesh`: its S
    ranks (the mesh's size) run as lockstep threads on `device` (the card
    unless the caller asks for the CPU; `launch/lockstep.py`), each
    building its row of the explicit partition from the global inputs
    drawn from `seed` (`wharf_mesh_inputs`), and rank `counted` under the
    work counter. The serve cells replicate every argument: each rank runs
    the whole read step and no collective joins the ranks, so one rank runs
    it, counted. Raises if the counted rank's collectives are not
    `static_collectives`."""
    from repro_torch._device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch import lockstep
    from repro_torch.launch.steps import build_cell
    if not partitionable(shape):
        raise ValueError(f"{shape}: {ORDER2_NOTE}")
    t0 = time.perf_counter()
    d = resolve_device(device)
    info = cut_info(shape) if info is None else info
    plan = build_cell("wharf-stream", shape, mesh=mesh, config=config, info=info)
    n = mesh.size()
    drawn = dict(ops.thread_launches())
    args, setup, _ = wharf_mesh_inputs(plan, config, seed, d, mean_degree)
    drawn = {k: v - drawn[k] for k, v in ops.thread_launches().items()}
    if d.type == "cuda":
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    replicated = plan.step_name == "walk_serve_step"
    # a replicated step joins no rank to another: the counted rank runs alone
    run = lockstep.run(lambda r, _: plan.fn(*args), 1 if replicated else n, device=d,
                       setup=setup, counted=0 if replicated else counted)
    if replicated:
        counted = 0
    peak = None
    if d.type == "cuda":
        torch.cuda.synchronize(d)
        peak = torch.cuda.max_memory_allocated(d)
    card = d.type == "cuda"
    want = static_collectives(plan, config, info, n)
    got = {k: (run.totals.coll_counts[k], run.totals.coll_bytes[k])
           for k in run.totals.coll_counts if run.totals.coll_counts[k]}
    if got != want:
        raise RuntimeError(f"{shape}: rank {counted}'s collectives {got} != the static "
                           f"count {want}")
    rec = _record("wharf-stream", shape, plan, run.totals, time.perf_counter() - t0,
                  mesh=mesh_name(mesh), n_cards=n, device=str(d),
                  launches=run.launches[counted] if card else None, peak=peak)
    rec["memory"]["argument_bytes"] = _rank_nbytes(plan, n)
    if not replicated:
        # the step returns the stacked rows: a rank's are a row of each
        from repro_torch.tree import leaf_paths
        rec["memory"]["output_bytes"] = sum(
            t.numel() * t.element_size() // (n if t.shape[0] == n else 1)
            for t in leaf_paths(run.outputs[counted]).values())
    rec["memory"]["peak_note"] = PEAK_NOTE
    rec.update(partition=("replicated: every rank runs the whole read step, no collective "
                          "joins them, so one rank ran, counted" if replicated
                          else "explicit vertex ranges (distr/sharded.py)"),
               counted_rank=counted, run_s=run.seconds,
               launches_by_rank=run.launches if card else None,
               input_launches=drawn if card else None,
               setup_launches=({k: sum(r[k] for r in run.setup_launches)
                                for k in run.setup_launches[0]} if card else None),
               cut=_cut(config, info, mean_degree))
    if verbose:
        _say(rec, rec["mesh"], "/rank")
        print(f"  {1 if replicated else n} lockstep ranks in {run.seconds:.1f}s, rank {counted} "
              f"counted | "
              f"collectives " + ", ".join(
                  f"{k} {rec['collective_counts'][k]:.0f} x" for k in rec["collective_counts"]
                  if rec["collective_counts"][k]) + f" | {rec['partition']}", flush=True)
        for note in rec["cut"]["notes"]:
            print(f"  cut: {note}", flush=True)
    return rec


MESHES = {"1": [None], "single": [False], "multi": [True], "both": [False, True]}


def _one_card(arch, shape, *, partitioned: bool, **kw) -> dict:
    """`run_cell`; a wharf order-2 cell asked for on a mesh says why it
    is one card's count."""
    rec = run_cell(arch, shape, **kw)
    if partitioned:
        rec["note"] = ORDER2_NOTE
        print(f"  {arch} x {shape}: {ORDER2_NOTE}", flush=True)
    return rec


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
                    help="also count the wharf-stream cells on real inputs: on a mesh the "
                         "order-1 cells partitioned (one rank of S lockstep ranks), the "
                         "order-2 cells one card's step")
    ap.add_argument("--wharf-log2-n", type=int, default=20,
                    help="the wharf config's vertices, 2^N (20: uncut)")
    ap.add_argument("--wharf-rewalk-capacity", type=int, default=0,
                    help="the wharf config's rewalk capacity (0: the walk count below 2^20 "
                         "vertices, else the config's)")
    ap.add_argument("--wharf-max-pending", type=int, default=8,
                    help="the wharf config's pending blocks before a merge")
    ap.add_argument("--wharf-batches", type=int, default=0,
                    help="cut the wharf stream cells to N batches (0: the shape's)")
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
    if args.smoke:
        from repro_torch.configs import get_arch as _arch
        wcfg = _arch("wharf-stream").make_config(True)
    else:
        wcfg = wharf_config(args.wharf_log2_n, args.wharf_max_pending,
                            args.wharf_rewalk_capacity)
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

    def wharf(arch):
        return get_arch(arch).family == "wharf"

    one_card = [c for c in cells if args.mesh == "1" or (wharf(c[0]) and not partitionable(c[1]))]
    for arch, shape in one_card:
        info = cut_info(shape, args.wharf_batches) if wharf(arch) else None
        record(f"{arch}|{shape}|{tag}", lambda: _one_card(
            arch, shape, smoke=args.smoke, config=wcfg if wharf(arch) else None, info=info,
            device=args.device, seed=args.seed, partitioned=args.mesh != "1"))
    sharded = [c for c in cells if c not in one_card]
    for multi in MESHES[args.mesh] if sharded else []:
        with fake_mesh(multi) as mesh:
            for arch, shape in sharded:
                key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                if wharf(arch):
                    record(key, lambda: run_wharf_partitioned(
                        shape, mesh, config=wcfg, device=args.device, seed=args.seed,
                        info=cut_info(shape, args.wharf_batches)))
                else:
                    record(key, lambda: run_partitioned(arch, shape, mesh, smoke=args.smoke))
    print(f"\n{len(results)} cells recorded in {args.out}; {len(failures)} failures")
    for k, e in failures:
        print("  FAIL", k, e)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
