"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
  1. the card's name and power limit; build the kernels (nvcc, in parallel)
  2. small end to end: the engine on the card (kernels) against the same
     engine on the CPU (plain versions), same keys, mixed stream: the
     states must be bit-identical; order 1, and order 2 with the rejection
     sampler, the factorized sampler unfused, and fused (hub vertices of
     degree > dmax make the rejection fallback run)
  3. full width, the `wharf-stream` configuration (configs/wharf_stream.py)
     at 2^18 vertices: corpus, 8 mixed batches through run_stream, merge,
     packed decode, traverse, point FINDNEXT — the order-1 main path, with
     the kernel launch counts read just after it; a host copy of the
     merged engine is kept for phase 3b
 3b. full width, the downstream maintainer over phase 3's configuration:
     the same graph, corpus and update keys through
     `EmbeddingMaintainer.run_stream`, SGNS at dim 128, window 5, 5
     negatives, 2^20 pairs a batch; its merged engine must equal phase 3's
     bit for bit, the first batch's loss per pair must be 6 ln 2 and leave
     the input table unchanged (the output table starts at 0); one more
     batch under torch.profiler
 3c. full width, serving: a `WalkQueryService` over phase 3b's maintainer
     (`engine_view()`, a pending block live): next_vertices on 2^16
     queries (kernel = plain backend, = the plain pair, unpair and
     FINDNEXT on a CPU copy of the overlay, every query on a stored walk
     found), walks_of on 1,024 vertices at capacity 1,024, the overlay
     walk matrix, neighborhoods and embedding neighbors (k = 10, f32 with
     TF32 off, card ids = CPU ids) — the serve path,
     counts read just after it, kernels 1-4 launched; a pin, then a
     merge, two more batches and a merge: the pinned answers stay
     bit-identical, the walk matrix = the post-merge traverse and = the
     merged store read with the plain unpair, walks_of = the post-merge
     segments as sets (plain decode and unpair); ppr_rows on an
     engine of its own at 2^15 vertices (the dense [n, n] table), built
     twice bit-identical and = the CPU's within rtol 1e-5; per query kind
     the synced time a query, batched (B = 1,024) and per call; the SLO
     summary and the service's counters
  4. full width, `wharf-stream` order 2 (node2vec, factorized, dmax 128)
     at 2^18 vertices, insert-only batches: one corpus, then the batches
     unfused and again fused from the same corpus and keys; the two runs'
     stores, slot_epoch and pending blocks must be bit-identical; merge,
     overlay traverse = post-merge traverse; one more batch of each path
     (the unfused one under torch.profiler) — the order-2 main paths, counts read just after:
     the corpus and the unfused batches launch the CSR intersect kernel,
     the fused batches the fused step and no intersect kernel, and no path
     builds a neighbor window (`intersect.neighbor_window` is never called)
  5. each kernel against its plain PyTorch version on the card, on the
     main paths' tensors plus edge cases, timed with CUDA events beside its
     bound (bytes at 3.35 TB/s or operations at 67 T/s; the bytes count
     each input read once, so a chunk or CSR segment that many queries or
     rows read counts once, and what the data needs): kernels 1-6 bit
     for bit; kernel 7 (the f32 SGNS step) within loss rtol 1e-5 and
     gradients rtol 1e-5 / atol 1e-6, its sums being taken in another order.
     `ms` is the mean of back-to-back runs on the same buffers (which may
     hit the 50 MB L2), `ms_cold` the median of 30 single runs, each after
     a 256 MB write and read that evict L2. Kernel 4 is also held and timed
     on the operands of the first prefix-read call of phase 4's profiled
     unfused batch. Kernels 5 and 6 are also timed in turns against the composition
     they replaced: the two neighbor windows built in torch (plus, for
     kernel 5, the windowed kernel, which no main path launches any more)
  6. the paper's comparison (§7.1, Figs. 7-8) on the card: `wharf-stream`
     (`configs.get_arch`) and its stream_10k_mixed shape at 2^18 vertices,
     an er graph (mean degree ~100) and the paper's R-MAT update stream
     (a = 0.5, b = c = 0.1, d = 0.3) drawn on the card by the port's
     generators (= the CPU's draws: the stream, the graph's first 2^16
     edges); Wharf, the inverted-index (II) and the tree baselines one
     after another from one corpus key, stream and key, each freed before
     the next: per-batch synced ms, affected walks, `nbytes` beside the
     peak device memory, launches by path. Checks: batch 1's affected
     count equal across the three; at order 1 the tree's walks = Wharf's
     stored triplets after every batch (and after the last, Wharf's
     overlay traverse of every walk = its triplets); the II = the tree at creation, and after batch 1
     the II's rewritten columns are the tree's shifted by the one column
     the reference's II writes ahead; every tree slot stored once, the
     columns lexsorted, each next = the owner of the next slot, every step
     an edge; every pair the II rewrote (from its first new vertex) an
     edge. Then II and tree over 2 order-2 batches of the
     stream_10k_n2v_factorized shape (kernel 5), and both on a 2^12-vertex
     graph on the card against the CPU, order 1 and order 2
  7. the sharded engine (distr/sharded.py) with 4 gloo ranks spawned on the
     one card (NCCL refuses two ranks on one device; gloo stages the CUDA
     tensors through host memory itself). 7a at 2^12 vertices: the same
     config, keys and mixed stream through both merge policies and once
     with metrics; the unsharded graph, every store array, slot_epoch and
     the traverse = the single-host card engine, each shard's card state
     = the same rank's CPU state, metrics ON = OFF, combined counters card
     = CPU, 1 + length collectives a batch; then one rank on NCCL = the
     single-host engine. 7b at full width: wharf-stream's
     stream_10k_sharded shape (10,000 inserts + 2,000 deletes a batch,
     on-demand) at 2^17 vertices on an er graph, 4 batches, after the
     single-host card engine on the same config and keys (its merged
     state kept on the host as .npy, its card memory freed first): each
     rank = its vertex range of the single-host state, bit for bit, the
     affected counts equal, no overflow; per batch the synced ms between
     barriers (max over ranks), the all_reduce's and all_to_alls' ms, the
     handoff volume and cross-shard share, each rank's peak memory and
     the card's, and each kernel's launches on this path
  8. the launcher (launch/train.py) through TrainLoop. 8a: its downstream
     and stream trainers at the wharf-stream smoke config, 6 steps and a
     checkpoint every 3, on the card and on the CPU with the same keys
     (engines bit for bit, affected walks, pairs and opt exact, tables
     rtol 2e-4 / atol 1e-5, loss rtol 1e-5), and a crash after step 2
     resumed by a fresh trainer (= the uninterrupted run; on the CPU bit
     for bit in every leaf). 8b: `--mode downstream` at full width on a
     cut copy of wharf-stream registered here (2^18 vertices, the
     launcher's R-MAT graph of 4 * 10,000 edges, rewalk_capacity 2^20,
     d 128, 2^16 pairs a step, a checkpoint every 4 steps, 2 kept): 6
     steps with the counts set to 0 just
     before and read just after (kernels 1, 2, 4, 7 launched, 5 and 6
     not), then 3 steps and a fresh trainer that resumes from the
     committed checkpoint for 3 more (engine bit for bit, opt and every
     step's affected walks and pairs exact, tables within tolerance; no
     affected count at the capacity, no MAV overflow); the step ms, the
     checkpoint's bytes, each save's host copy and write, the restore,
     the peak memory; `--mode stream` for 3 steps. 8c: the paper's
     downstream-quality check (§7.6) at cora_like's own sizes (2,708
     vertices, 5,429 edges, 7 classes) on the card, and its engine and
     full retrain on the CPU: walk matrices card = CPU, incremental
     accuracy within 0.10 of a full retrain's on the card, fewer pairs
     than one full retrain; then the whole check at the test's own sizes
     on the card and the CPU (walks and counts equal, the maintainer's
     tables within tolerance).
  9. the LM family and DLRM (models/transformer.py, models/dlrm.py), with
     the kernel counts set to 0 just before and read just after (none of
     the seven kernels lies on their paths). 9a: all five LM archs and
     dlrm-rm2 at their smoke configs in f32 (TF32 off), card against CPU:
     init bit for bit; forward, loss, gradients, prefill and decode within
     rtol 1e-4 / atol 1e-5 (DLRM 1e-5 / 1e-6), the MoE routing exactly;
     the launcher's `lm_trainer` for 4 steps, tokens exact. 9b: gemma2-2b
     at full width and depth in bf16 through the launcher (init timed, 3
     steps of 1 x 4,096 tokens, the closing ~26 GB save), then served from
     the trained weights (prefill of 4,096, 64 decode steps past the local
     window) against one forward over the 4,160 tokens; in f32 at depth 2
     decode = forward within 2e-3 and card = CPU within 1e-4. 9c:
     qwen2-moe-a2.7b at full width (8 of its 24 layers) in bf16, prefill
     of 2,048 (the rows each MoE layer drops) and 16 decode steps; f32 card
     = CPU at depth 1 with the routing exact. 9d: dlrm-rm2 at full width:
     serve_p99, serve_bulk, retrieval_cand and one train_batch step, card
     = CPU at B = 512. The cuts are printed as `reduced_lm`.
 10. the GNN family (models/gnn.py, launch/steps.py's cell plans), with the
     kernel counts set to 0 just before and read just after (its message
     passing is torch gathers and index_add: none of the seven kernels).
     10a: the four archs at their smoke configs in f32 (TF32 off), card
     against CPU: init bit for bit, forward, `_gnn_loss` and gradients
     within rtol 1e-4 / atol 1e-5; `sample_two_hop` ids and masks card =
     CPU; the plans of tests/test_dryrun.py's registry test build. 10b:
     every (arch, shape) cell of GNN_SHAPES at the full configs through
     `build_cell`'s `train_step`, 3 steps on inputs drawn on the card (a
     valid CSR for minibatch_lg), each step synced: the loss finite, the
     gradient norm exactly 0 on the three minibatch cells whose loss reads
     the step's params (the reference's), > 0 elsewhere; peak memory and
     model FLOP/s beside the f32 peak. meshgraphnet and equiformer-v2 on
     ogb_products are cut to fit (`reduced_gnn`). The `gnn` path of the
     kernels line is `walk_based_neighborhood` over phase 3's merged store
     (1,024 seeds, 10 walks, 2 hops), run after phase 5's order-1 kernels:
     kernels 1 and 4 launched, 3 and 5-7 not; = the plain backend and = the
     first 3 columns of the store's traverse.
 11. the cell plans and the dry-run tools (launch/steps.py's wharf plans,
     launch/op_analysis.py, dryrun.py, profile_cell.py), counted as one
     path. 11a: the 13 wharf-stream plans at the smoke config on the card
     and on the CPU from the same inputs (64 vertices, mean degree 10),
     every output leaf bit for bit but the serve cells' f32 top-k scores
     (within 1e-5, as phase 3c's; their ids exact) (the sharded cell on a one-rank
     NCCL group, gloo on the CPU; the fused-step cell "cuda" on the card,
     "torch" on the CPU); each kernel's calls counted by op_analysis on
     the card = its plain twin's calls on the CPU = the launch counts;
     kernels 1-6 launched. 11b: `dryrun.run_cell` over the 40 LM, GNN and
     recsys cells at their full configs on meta (the dry-run CLI in a
     process of its own, beside 11a), and stream_10k_pipelined
     (2 batches) and serve_batched_q256 at CONFIG's cut on the card: counted FLOPs
     and bytes, the ratio to `model_flops`, the roofline terms against
     the H100 constants (launch/mesh.py) and the dominant one, peak
     memory; a wharf record's kernel calls = its launches. 11c:
     `profile_cell` over stream_10k_pipelined (1 batch) at CONFIG's cut: the static
     table and the top device ops by device time, the kernels named.
     11d, the partitioned dry-run: 11d-a `dryrun --mesh both` over
     six LM, GNN and recsys cells on meta (a process of its own, started
     before phase 9): a rank's FLOPs, bytes and collective bytes by kind on the 16 x
     16 and 2 x 16 x 16 meshes, FLOPs x ranks >= 11b's one-card count;
     11d-b the sharded steps for real (launch/partitioned.py): four gloo
     ranks sharing the card on a (data 2, model 2) mesh run gemma2-2b's
     train and decode steps (full width, 2 layers, f32) and dlrm-rm2's
     serve_p99, each rank's output shards against the same step unsharded
     on the card, its collectives = the meta count of the same (2, 2)
     plan, no kernel launched (the counts set to 0 before and read 0
     after); ms a step (under the work counter) and each rank's peak GB.
     The cuts are printed as `reduced_plans`.
Phase 2 also runs a small maintainer on the card against the CPU and
against a plain engine, and the order-1 stream with `WalkConfig(metrics=
True)` on the card: its state equals the plain run's, its counters equal
the CPU's, and the metrics-OFF run calls the plain step loop's kernels;
it prints the exported summary. Each phase prints one JSON line.
"""
import bisect
import contextlib
import dataclasses
import inspect
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch import random as jr  # noqa: E402
from repro_torch.configs import GNN_SHAPES, all_cells, get_arch  # noqa: E402
from repro_torch.configs.base import ArchSpec, register  # noqa: E402
from repro_torch.configs.wharf_stream import WHARF_SHAPES, WharfStreamConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.convert import baseline_to_numpy, state_to_numpy  # noqa: E402
from repro_torch.core.baselines import IIEngine, TreeEngine  # noqa: E402
from repro_torch.data.streams import (cora_like, edge_batch_stream, er_edges,  # noqa: E402
                                      mixed_edge_stream)
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus  # noqa: E402
from repro_torch.core import pairing  # noqa: E402
from repro_torch.core.corpus import walk_start_vertex  # noqa: E402
from repro_torch.core.packed_store import CHUNK  # noqa: E402
from repro_torch.core.update import WalkEngine  # noqa: E402
from repro_torch.core.store import PAD_EPOCH  # noqa: E402
from repro_torch.core.utils import seg_searchsorted  # noqa: E402
from repro_torch.core.walkers import WalkModel  # noqa: E402
from repro_torch.core.graph import SENTINEL, edge_code  # noqa: E402
from repro_torch.distr import collectives, ranks  # noqa: E402
from repro_torch.distr.sharded import (consolidate, local_shard_state,  # noqa: E402
                                       sharded_run_stream, sharded_stream_step,
                                       unshard_state)
from repro_torch.downstream import EmbeddingMaintainer, MaintainerConfig  # noqa: E402
from repro_torch.kernels import _build, delta, intersect, megakernel, ops  # noqa: E402
from repro_torch.kernels import range_search, sgns, szudzik  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, partitioned, profile_cell, steps  # noqa: E402
from repro_torch.launch import mesh as card_mesh  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import dlrm, gnn, sampling  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.embeddings import (SGNSConfig, logistic_eval, sgns_init,  # noqa: E402
                                          train_epoch, window_pairs)
from repro_torch.core import update  # noqa: E402
from repro_torch.obs import export, slo  # noqa: E402
from repro_torch.serve import WalkQueryService, batched  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.runtime import TrainLoop  # noqa: E402

HBM_BYTES_PER_S = card_mesh.HBM_BW           # H100 SXM (NVIDIA data sheet)
SCALAR_OPS_PER_S = card_mesh.PEAK_FLOPS_F32   # H100 float32 outside the tensor cores
FLUSH_BYTES = 256 << 20       # a write this large evicts the H100's 50 MB L2
COLD_REPS = 30

# the wharf-stream configuration (src/repro/configs/wharf_stream.py:17-42)
# and its stream_10k_mixed traffic, cut in scale only
CONFIG = dict(n_vertices=1 << 18, edge_capacity=1 << 25, n_walks_per_vertex=10,
              length=80, chunk_b=128, mean_degree=100, batch_inserts=10_000,
              batch_deletes=2_000, n_batches=8, merge_policy="on-demand",
              merge_impl="interleave", max_pending=4)
REDUCED = {"n_vertices": "2^20 -> 2^18 (8 pending blocks of a 2^20 corpus exceed 80 GB)",
           "edge_capacity": "2^27 -> 2^25 (mean degree 100 at 2^18 vertices)",
           "max_pending": "8 -> 4 (device memory)",
           "rewalk_capacity": "2^20 -> n_walks (a batch affects most walks; "
                              "2^20 would drop affected walks unflagged)"}

# wharf-stream order 2: the stream_10k_n2v_factorized / _megakernel shapes
# (src/repro/configs/wharf_stream.py:26-32, 178-194), cut as CONFIG
N2V = dict(CONFIG, batch_deletes=0, n_batches=3, p=1.0, q=1.0,
           sampler="factorized", dmax=128)
N2V_REDUCED = dict(REDUCED, n_batches="3 timed batches and 1 more batch per path "
                   "(with 3 pending blocks; the run's time limit)",
                   profiled="the unfused path's extra batch only: the fused one "
                            "runs unprofiled (the profiler's trace of it took "
                            "~100 s of the run's time limit)")
ORDER1_KERNELS = ("szudzik_pair", "szudzik_unpair", "delta_decode",
                  "find_next_packed")

# the maintainer over CONFIG's engine: the repo's SGNSConfig widths
# (src/repro/models/embeddings.py:28-35; DeepWalk/node2vec's d = 128)
MAINT = dict(dim=128, window=5, n_negative=5, lr=0.01, skip_stale_prefix=True,
             max_pairs=1 << 20)
MAINT_REDUCED = dict(REDUCED, max_pairs="0 (every live pair: ~2.6M affected walks x 770 "
                     "pairs a batch) -> 2^20 pairs a batch (1,362 walks)",
                     n_batches="8 timed batches and 1 profiled batch")
# phase 3c: the service over the maintainer's engine; PPR on its own engine
SERVE = dict(next_queries=1 << 16, batch=1024, walks_of_capacity=1024, hops=2,
             k=10, pin_traverse_walks=1 << 14, per_call_reps=16, extra_batches=2,
             ppr_vertices=1 << 15, restart_prob=0.2, ppr_rtol=1e-5)
SERVE_REDUCED = dict(MAINT_REDUCED, ppr_vertices=(
    "2^18 -> 2^15 for ppr_rows only: the reference's dense [n, n] f32 table is "
    "275 GB at 2^18 and 4.3 GB at 2^15 (its own engine, the same config and a "
    "batch of 1,250 inserts and 250 deletes, the per-vertex rate of CONFIG)"))
SGNS_LOSS_RTOL = 1e-5
SGNS_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)

# phase 6: the paper's comparison on `wharf-stream` (configs/wharf_stream.py)
# and its stream_10k_mixed / stream_10k_n2v_factorized shapes, cut as CONFIG;
# an er graph of 2^18 * 50 undirected edges, the R-MAT stream at the
# generators' defaults (a = 0.5, b = c = 0.1, d = 0.3)
PAPER = dict(log2_n=18, edge_capacity=1 << 25, max_pending=4,
             graph_edges=(1 << 18) * 50, n2v_batches=2, cpu_prefix=1 << 16,
             seeds=dict(graph=2024, stream=2025, n2v_stream=2026, corpus=0,
                        update=1),
             small=dict(log2_n=12, graph_edges=(1 << 12) * 10, n_batches=2,
                        n_ins=200, n_del=40, n_walks_per_vertex=4, length=16))
PAPER_REDUCED = dict(REDUCED, n2v_batches=(
    "8 -> 2 order-2 batches (stream_10k_n2v_factorized), II and tree only "
    "(the run's time limit)"))

# phase 7: the sharded engine, S gloo ranks on the one card. 7a at 2^12
# vertices (card ranks = CPU ranks = the single-host engine); 7b at full
# width, wharf-stream's stream_10k_sharded shape
# (src/repro/configs/wharf_stream.py:172), cut as CONFIG and further by the
# four ranks' memory (PERF.md §6 has the reckoning)
SHARDED = dict(shards=4, seeds=dict(graph=3030, stream=3031, corpus=0, update=1),
               small=dict(log2_n=12, graph_edges=(1 << 12) * 10, edge_capacity=1 << 17,
                          n_batches=4, n_ins=200, n_del=40, n_walks_per_vertex=4,
                          length=16, max_pending=2),
               full=dict(log2_n=17, graph_edges=(1 << 17) * 50, edge_capacity=1 << 24,
                         n_batches=4, max_pending=2))
SHARDED_REDUCED = dict(
    n_vertices="2^20 -> 2^17 (four ranks on one card, each with the reference's "
               "[2, n_walks * 80] pending blocks: ~20 GB a rank at 2^18 by the "
               "reckoning, over the card's 80 GB)",
    edge_capacity="2^27 -> 2^24 (mean degree 100 at 2^17 vertices)",
    n_shards="8 -> 4 ranks, all on the one card (gloo: NCCL refuses two ranks "
             "on one device)",
    n_batches="8 -> 4 (the forced merge falls at batch 3; the run's time limit)",
    max_pending="8 -> 2 (device memory)",
    rewalk_capacity="2^20 -> n_walks, as phase 3; the slab follows it (the "
                    "config's default, the whole lane capacity)")

# phase 8: the launcher (src/repro/launch/train.py:62-187) through its
# TrainLoop. 8a at the wharf-stream smoke config; 8b `--mode downstream` on
# a cut copy of wharf-stream registered here only, with the launcher's own
# graph (R-MAT, 4 * batch_edges edges, :108) and its 2^16-pair budget, SGNS
# at DeepWalk's d = 128 (phase 3b's), a checkpoint every 4 steps (at 3 the
# loop would save step 2 twice, async and then the final blocking save,
# ~13 GB each); 8c is
# tests/test_downstream.py::test_incremental_matches_full_retrain at
# cora_like's own defaults (src/repro/data/streams.py)
TRAINER = dict(arch="wharf-stream-h100", log2_n=18, edge_capacity=1 << 25, max_pending=4,
               rewalk_capacity=1 << 20, batch_edges=10_000, dim=128, max_pairs=1 << 16,
               steps=6, crash_after=3, ckpt_every=4, keep=2, stream_steps=3,
               small=dict(batch_edges=32, dim=16, steps=6, crash_after=3, ckpt_every=3))
TRAINER_REDUCED = dict(
    n_vertices=REDUCED["n_vertices"], edge_capacity=REDUCED["edge_capacity"],
    max_pending=REDUCED["max_pending"],
    steps="6 uninterrupted steps, 3 + 3 resumed, 3 of --mode stream (the run's time limit)")
QUALITY = dict(n_vertices=2708, n_edges=5429, n_classes=7, n_walks_per_vertex=6,
               length=10, dim=32, window=3, n_negative=4, lr=0.002, snapshots=2,
               n_batches=3, batch_edges=12, epochs=4, batch=2048, gap=0.10,
               edge_capacity=1 << 14)   # the test's 8,192 holds fewer than the 2 x 5,357 edges
# the reference test's own sizes, where the CPU maintainer takes seconds:
# 8c holds the card's maintainer against it there
QUALITY_SMALL = dict(QUALITY, n_vertices=128, n_edges=512, n_classes=5,
                     edge_capacity=8192)
# the maintainer's tables, card against CPU or resumed against
# uninterrupted: the reference's tolerance for a scatter-added SGNS step
TABLE_TOL = dict(rtol=2e-4, atol=1e-5)

# phase 9: the LM family (src/repro/configs/lm_archs.py:35-67) and
# dlrm-rm2 (src/repro/configs/recsys_archs.py:13-17) with their shapes
# (src/repro/configs/base.py:9-32), cut as LM_REDUCED says. 9a at the
# smoke configs, card = CPU; 9b gemma2-2b trained through the launcher and
# served; 9c qwen2-moe-a2.7b served; 9d dlrm-rm2's four shapes
LM_ARCHS = ("mistral-nemo-12b", "qwen1.5-110b", "gemma2-2b", "qwen2-moe-a2.7b",
            "llama4-maverick-400b-a17b")
LM = dict(small=dict(batch=2, seq=16, steps=4),
          gemma=dict(arch="gemma2-2b", batch=1, seq=4096, steps=3, decode=64,
                     f32_layers=2, cpu_tokens=256),
          qwen=dict(arch="qwen2-moe-a2.7b", prefill=2048, decode=16, f32_layers=1,
                    cpu_tokens=512, over=dict(n_layers=8)),
          dlrm=dict(arch="dlrm-rm2", serve_p99=512, serve_bulk=262_144, retrieval=1_000_000,
                    train=65_536, reps=5),
          seeds=dict(tokens=9090, dlrm=9091))
LM_REDUCED = dict(
    train_4k="global batch 256 x 4,096 -> 1 x 4,096 (one chip's microbatch: "
             "src/repro/launch/steps.py:75 gives each chip one sequence), 3 steps",
    prefill_32k="32 x 32,768 tokens -> 1 x 4,096 (the reference materializes [S, S] "
                "scores: 34 GB a layer at 32k)",
    decode_32k="batch 128 at 32,768 -> 1 sequence, 64 steps after the 4,096 prefill "
               "(the full-depth K/V caches of 128 x 32k are 447 GB)",
    long_500k="not run (decode at 524,288 positions: a 55 GB cache at B = 1)",
    gemma_f32="depth 26 -> 2 for the f32 checks; card = CPU over the first 256 "
              "tokens (the CPU's time; the card's decode = forward runs the 4,160)",
    qwen_depth="qwen2-moe-a2.7b 24 -> 8 layers: its init draws 200M normals/s on an "
               "H100, 75 s at full depth and 51.5 s at 16 layers (10,304,915,456 "
               "stored parameters), over its share of the run's time limit",
    qwen_prefill="qwen2-moe-a2.7b serves 1 x 2,048 tokens and 16 decode steps; "
                 "f32 card = CPU at depth 1 over 512 tokens",
    mistral_qwen110_llama4="not run at full width: 9a only (smoke configs); "
                           "qwen1.5-110b and llama4-maverick need more than one card",
    dlrm_train="one train_batch step (B = 65,536)")
# card against CPU in f32 (TF32 off): the CPU tests' tolerance against JAX
LM_TOL = dict(rtol=1e-4, atol=1e-5)
DLRM_TOL = dict(rtol=1e-5, atol=1e-6)
# 9b's bf16 decode (one token through the cache) against one forward over
# the 4,160 tokens: the same weights and casts, but other product shapes,
# so other f32 sum orders and bf16 roundings in each of 26 layers. The
# logits are ~N(0, 1) (embedding std 0.02 x sqrt(2,304)), capped at 30
LM_BF16_TOL = dict(rtol=0.05, atol=0.25)

# phase 10: the GNN family (src/repro/configs/gnn_archs.py:9-48) through
# launch/steps.py's cell plans at the shapes of GNN_SHAPES
# (src/repro/configs/base.py:16-25). 10a at the smoke configs, card = CPU;
# 10b every (arch, shape) cell at the full config, `steps` train steps on
# inputs drawn on the card from a seed, cut as GNN_REDUCED says. The `gnn`
# path: walk_based_neighborhood (models/sampling.py) over phase 3's merged
# store, GraphSAGE's two hops (phase_gnn_sampler)
GNN_ARCHS = ("meshgraphnet", "equiformer-v2", "gat-cora", "graphsage-reddit")
GNN = dict(steps=3, seed=1010,
           small=dict(n=40, e=160, d_feat=8, csr_n=300, csr_e=2000, seeds=64,
                      fanout=(15, 10)),
           sampler=dict(seeds=1024, n_w=10, hops=2),
           # (arch, shape) -> the divisor of n_nodes and n_edges (the mean
           # degree kept): the cells whose saved activations exceed the card
           cuts={("meshgraphnet", "ogb_products"): 36,
                 ("equiformer-v2", "ogb_products"): 512})
GNN_REDUCED = dict(
    meshgraphnet_ogb_products=(
        "n_nodes 2,449,029 -> 68,028 and n_edges 61,859,140 -> 1,718,309 (1/36, the mean "
        "degree kept; padded to 68,096 and 1,718,784): 15 layers keep ~42 KB an edge for "
        "the backward (72.7 GB peak at 1/36 of the card's 85.0 GB; 1/32 peaked at 81.7 GB "
        "in a run of the cell alone and ran out of memory after the earlier phases, "
        "with 3.0 GB of the allocator's cache in fragments); "
        "the reference has no remat or edge chunking"),
    equiformer_v2_ogb_products=(
        "n_nodes 2,449,029 -> 4,783 and n_edges 61,859,140 -> 120,818 (1/512, the mean "
        "degree kept; padded to 5,120 and 120,832): 12 layers keep ~0.6 MB an edge "
        "([E, 29, 128] f32 three times a layer; 73.7 GB peak at 1/512, the largest "
        "share measured on the card; 1/448 extrapolates to ~84.2 GB, over what 1/32 of "
        "meshgraphnet could not get)"),
    gat_cora_and_graphsage_reddit_ogb_products="none (peaks 80.0 and 41.0 GB)",
    steps="3 train steps a cell",
    minibatch_lg="none: the sampled star subgraph (169,984 nodes, 168,960 edges) of "
                 "the full CSR (233,472 nodes, 114,616,320 edges)")
# card against CPU in f32 (TF32 off): phase 9a's tolerance
GNN_TOL = dict(rtol=1e-4, atol=1e-5)
# the minibatch cells whose loss reads the step's params, not the
# differentiated p (src/repro/launch/steps.py:356): gradient norm exactly 0
GNN_ZERO_GRAD = ("meshgraphnet", "equiformer-v2", "gat-cora")

# phase 11: the wharf family's cell plans (launch/steps.py) at the smoke
# config, card against CPU (11a); the dry-run (launch/dryrun.py) over the
# 40 LM, GNN and recsys cells at their full configs on meta and two wharf
# cells at CONFIG's cut (11b); the profile of the reference cell (11c)
PLANS = dict(seed=2222, mean_degree=10, dry_wharf=("stream_10k_pipelined",
                                                   "serve_batched_q256"),
             dry_batches=2, profile="stream_10k_pipelined", profile_batches=1, top=12)
PLANS_REDUCED = dict(REDUCED, wharf_config=(
    "the full wharf-stream config at CONFIG's cut (2^18 vertices, edge capacity 2^25, "
    "rewalk_capacity = n_walks, max_pending 4), an er graph of mean degree 100"),
    smoke_graph="11a: 64 vertices, mean degree 10 (the smoke config's edge capacity "
                "of 4,096 holds every pair)",
    n_batches="stream_10k_pipelined 8 -> 2 batches in 11b, 1 in 11c (the run's time "
              "limit: 8 batches took 25.6 s to count in 11b and 179 s to count, run "
              "and trace in 11c)")
# phase 11d: the partitioned dry-run (launch/dryrun.py --mesh both) of six
# cells on meta, in a process of its own from phase 9 on (11d-a), and the
# sharded steps run for real on four gloo ranks sharing the card, a (data
# 2, model 2) mesh, against the same steps unsharded on the card (11d-b,
# launch/partitioned.py): gemma2-2b at full width cut to one local/global
# pair in f32, one train step and one decode step; dlrm-rm2 serve_p99
PARTITION = dict(
    meta_cells=("gemma2-2b/train_4k", "gemma2-2b/decode_32k", "qwen2-moe-a2.7b/train_4k",
                "dlrm-rm2/serve_p99", "dlrm-rm2/train_batch",
                "graphsage-reddit/minibatch_lg"),
    mesh=(2, 2), seed=2323, layers=2,
    train={"kind": "train", "seq_len": 2048, "global_batch": 2},
    decode={"kind": "decode", "seq_len": 32768, "global_batch": 4})
PARTITION_REDUCED = dict(
    gemma2_2b="26 -> 2 layers (one local/global pair), bf16 -> f32, in 11d-b",
    train_4k="256 x 4,096 -> 2 x 2,048 tokens in 11d-b",
    decode_32k="128 -> 4 sequences of a 32,768-position cache in 11d-b",
    cells="6 of the 40 LM, GNN and recsys cells in 11d-a (the dry-run CLI sweeps all 40 "
          "on both meshes: `--mesh both`)")
PLAN_KERNELS = ("szudzik_pair", "szudzik_unpair", "delta_decode", "find_next_packed",
                "intersect_csr", "fused_rewalk_step")

KERNEL_META = {
    "szudzik_pair": ("src/repro_torch/kernels/csrc/szudzik.cu",
                     "src/repro/kernels/szudzik.py:109"),
    "szudzik_unpair": ("src/repro_torch/kernels/csrc/szudzik.cu",
                       "src/repro/kernels/szudzik.py:115"),
    "delta_decode": ("src/repro_torch/kernels/csrc/delta.cu",
                     "src/repro/kernels/delta.py:78"),
    "find_next_packed": ("src/repro_torch/kernels/csrc/range_search.cu",
                         "src/repro/kernels/range_search.py:42"),
    "intersect_next": ("src/repro_torch/kernels/csrc/intersect.cu",
                       "src/repro/kernels/intersect.py:199"),
    "intersect_csr": ("src/repro_torch/kernels/csrc/intersect.cu",
                      "src/repro/kernels/intersect.py:199"),
    "fused_rewalk_step": ("src/repro_torch/kernels/csrc/megakernel.cu",
                          "src/repro/kernels/megakernel.py:217"),
    "sgns_step": ("src/repro_torch/kernels/csrc/sgns.cu",
                  "src/repro/kernels/sgns.py:113"),
}
# the windowed intersect kernel serves the reference's windowed API; the
# samplers take the CSR kernel, so no main path launches it (phase 5 still
# holds it against its plain version and times it)
OFF_MAIN_PATH = ("intersect_next",)


_T0 = time.perf_counter()


def log(tag, **kw):
    """One JSON line per phase, with the seconds since the run started."""
    print(json.dumps({"phase": tag, "elapsed_s": time.perf_counter() - _T0, **kw}),
          flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int = COLD_REPS) -> float:
    """Median device time of fn() over `reps` single runs, after one
    warm-up. Before each run (not timed) FLUSH_BYTES are written, which
    evicts L2, then read back, which evicts the write's dirty lines: the run
    finds none of its operands in L2 and writes back no line of the flush."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for i in range(reps):
        flush.fill_(i & 0xFF)
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def sm_clock_mhz(cycles: int = 2_000_000) -> float:
    """The SM clock the card runs at now (MHz), from the device time of a
    spin of `cycles` SM clock cycles (`torch.cuda._sleep`): a latency-bound
    kernel slows with the clock, a bandwidth-bound one barely."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) * 1e3)


# ---------------------------------------------------------------- phase 2


def hub_edges(rng, n, m, hubs, hub_degree):
    """m uniform pairs plus `hubs` vertices of degree ~hub_degree."""
    src, dst = rng.integers(0, n, size=(2, m))
    hs = np.repeat(np.arange(hubs), hub_degree)
    return (np.concatenate([src, hs]),
            np.concatenate([dst, rng.integers(0, n, size=hs.shape[0])]))


def phase_small_e2e(dev):
    rng = np.random.default_rng(3)
    n = 512
    src, dst = hub_edges(rng, n, 6000, hubs=4, hub_degree=300)
    ins = rng.integers(0, n, size=(2, 6, 60))
    dels = rng.integers(0, n, size=(2, 6, 20))
    n2v = dict(order=2, p=0.5, q=2.0, dmax=128)
    runs = {"order1": (WalkModel(), "off"),
            "n2v_rejection": (WalkModel(sampler="rejection", **n2v), "off"),
            "n2v_factorized": (WalkModel(sampler="factorized", **n2v), "off"),
            "n2v_factorized_fused": (WalkModel(sampler="factorized", **n2v),
                                     "fused")}
    fields = {}
    for name, (model, mk) in runs.items():
        states = []
        ops.reset_launches()
        for d in (dev, torch.device("cpu")):
            megak = mk if mk == "off" else ("cuda" if d.type == "cuda" else "torch")
            cfg = WalkConfig(n_walks_per_vertex=4, length=16, model=model,
                             megakernel=megak)
            with (window_calls() if d.type == "cuda" else contextlib.nullcontext()) as wins:
                g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
                store = generate_corpus(jr.PRNGKey(1, d), g, cfg)
                eng = WalkEngine(graph=g, store=store, cfg=cfg,
                                 rewalk_capacity=n * 4, max_pending=4)
                eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
            if wins is not None:
                assert wins[0] == 0, f"{name}: the card path built neighbor windows"
            st = state_to_numpy(eng.state)
            st["walk_matrix"] = eng.walk_matrix().cpu().numpy()
            states.append(st)
        for k in states[0]:
            if not np.array_equal(states[0][k], states[1][k]):
                raise AssertionError(f"{name}: cuda vs cpu engine differ in {k}")
        assert ops.launches["intersect_next"] == 0, name
        if model.sampler == "factorized":     # the corpus, and unfused steps
            assert ops.launches["intersect_csr"] > 0, name
        if mk == "fused":
            assert ops.launches["fused_rewalk_step"] > 0, name
        fields[name] = len(states[0])
    log("small_e2e", ok=True, n_vertices=n, batches=6, hub_degree=300,
        fields_compared=fields)


def phase_small_maintainer(dev):
    """The maintainer on the card against the same maintainer on the CPU,
    from the same key (the card draws the CPU's tables bit for bit), and
    against a plain engine on the same update keys: the engines bit for bit, the pair and affected counts equal, the
    summed loss within rtol 1e-5 and the tables within rtol 2e-4 / atol
    1e-5 (the reference's tolerance; the card's scatter-add uses atomics).
    Under a pair budget, as at full width (the lane subsample): training
    every live pair at this size puts ~470 pairs a batch on each input
    row, where lr 0.01 diverges (tests/test_torch_cuda.py runs that case
    at lr 0.001)."""
    rng = np.random.default_rng(4)
    n = 512
    src, dst = hub_edges(rng, n, 6000, hubs=4, hub_degree=300)
    ins = rng.integers(0, n, size=(2, 6, 60))
    dels = rng.integers(0, n, size=(2, 6, 20))
    wcfg = WalkConfig(n_walks_per_vertex=4, length=16)
    mcfg = MaintainerConfig(walk=wcfg, n_vertices=n, rewalk_capacity=n * 4, max_pending=4,
                            **dict(MAINT, max_pairs=4096))
    runs = []
    for d in (torch.device("cpu"), dev):
        ops.reset_launches()    # the card's run comes last
        g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
        store = generate_corpus(jr.PRNGKey(1, d), g, wcfg)
        mt = EmbeddingMaintainer(graph=g, store=store, cfg=mcfg, key=jr.PRNGKey(3, d))
        init = {k: v.clone() for k, v in mt.params.items()}
        if d.type == "cuda":   # `normal` on the card = on the CPU, bit for bit
            for k, v in init.items():
                assert torch.equal(v.cpu(), runs[0]["init"][k]), f"initial {k} table"
        m = mt.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1],
                          train_key=jr.PRNGKey(5, d))
        plain = WalkEngine(graph=g, store=store, cfg=wcfg, rewalk_capacity=n * 4,
                           max_pending=4)
        plain.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        st, st_plain = state_to_numpy(mt.state.engine), state_to_numpy(plain.state)
        for k in st:
            if not np.array_equal(st[k], st_plain[k]):
                raise AssertionError(f"maintainer engine != plain engine in {k} ({d})")
        runs.append(dict(state=st, metrics=[t.cpu() for t in m], init=init,
                         params=mt.params))
    cpu, card = runs
    for k in cpu["state"]:
        if not np.array_equal(cpu["state"][k], card["state"][k]):
            raise AssertionError(f"maintainer: cuda vs cpu engine differ in {k}")
    (loss_c, pairs_c, aff_c), (loss_d, pairs_d, aff_d) = cpu["metrics"], card["metrics"]
    assert torch.equal(pairs_c, pairs_d) and torch.equal(aff_c, aff_d), "pair counts"
    torch.testing.assert_close(loss_d, loss_c, rtol=1e-5, atol=0)
    for k in ("in", "out"):
        torch.testing.assert_close(card["params"][k].cpu(), cpu["params"][k],
                                   rtol=2e-4, atol=1e-5)
    assert ops.launches["sgns_step"] == 6, ops.launches
    log("small_maintainer", ok=True, n_vertices=n, batches=6, max_pairs=4096,
        n_pairs=pairs_d.tolist(), n_affected=aff_d.tolist(),
        loss_rel_diff=float(((loss_d - loss_c).abs() / loss_c.abs()).max()))


def phase_small_metrics(dev):
    """The order-1 stream with `WalkConfig(metrics=True)` on the card: its
    state equals the plain (metrics OFF) run's, its counters the CPU's;
    the OFF run launches exactly the kernels of the plain step loop
    (`update.stream_step_aux` without metrics), in count."""
    rng = np.random.default_rng(5)
    n = 512
    src, dst = rng.integers(0, n, size=(2, 6000))
    ins = rng.integers(0, n, size=(2, 6, 60))
    dels = rng.integers(0, n, size=(2, 6, 20))

    def engine(d, metrics):
        cfg = WalkConfig(n_walks_per_vertex=4, length=16, metrics=metrics)
        g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=d)
        return WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(1, d), g, cfg),
                          cfg=cfg, rewalk_capacity=n * 4, max_pending=4)

    out, launches = {}, {}
    for name, d, metrics in (("off", dev, False), ("on", dev, True),
                             ("on_cpu", torch.device("cpu"), True)):
        eng = engine(d, metrics)
        ops.reset_launches()
        eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        launches[name] = dict(ops.launches)
        out[name] = eng
    plain = engine(dev, False)
    keys = jr.split(jr.PRNGKey(2, dev), ins.shape[1])
    state = plain.state
    ops.reset_launches()
    for i in range(ins.shape[1]):
        state, _ = update.stream_step_aux(
            state, keys[i], *(torch.from_numpy(a[i]).to(dev) for a in
                              (ins[0], ins[1], dels[0], dels[1])),
            plain.cfg, plain.rewalk_capacity, plain._mav_capacity(),
            plain.max_pending, plain.merge_policy, plain.merge_impl)
    launches["plain"] = dict(ops.launches)
    assert launches["off"] == launches["plain"], launches
    a, b = state_to_numpy(out["off"].state), state_to_numpy(out["on"].state)
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"metrics ON != OFF in {k}")
    summ = export.summary(out["on"].metrics)
    assert summ == export.summary(out["on_cpu"].metrics), "metrics: card != CPU"
    assert summ["steps"] == ins.shape[1] and summ["staleness"]["audit"]["invalid"] == 0
    log("small_metrics", ok=True, n_vertices=n, batches=ins.shape[1],
        state_equals_metrics_off=True, counters_equal_cpu=True,
        launches_off=launches["off"], launches_on=launches["on"], summary=summ)


# ---------------------------------------------------------------- phase 3


def uniform_pairs(gen, n, m, dev):
    return (torch.randint(0, n, (m,), generator=gen, device=dev),
            torch.randint(0, n, (m,), generator=gen, device=dev))


def phase_full(dev):
    c = CONFIG
    n = c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"])
    n_walks = n * cfg.n_walks_per_vertex
    gen = torch.Generator(device=dev)
    gen.manual_seed(2022)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni, nd = c["n_batches"], c["batch_inserts"], c["batch_deletes"]
    # nb batches for the main path and one more for the profiled batch
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    dels = [x.reshape(nb + 1, nd) for x in uniform_pairs(gen, n, (nb + 1) * nd, dev)]
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the main path, counted from here
    graph, t_graph = sync_time(lambda: StreamingGraph.from_edges(
        src, dst, n, c["edge_capacity"], device=dev))
    del src, dst
    store, t_corpus = sync_time(lambda: generate_corpus(
        jr.PRNGKey(0, dev), graph, cfg))
    eng = WalkEngine(graph=graph, store=store, cfg=cfg,
                     merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                     rewalk_capacity=n_walks, max_pending=c["max_pending"])
    del store
    key = jr.PRNGKey(1, dev)
    batch_ms, affected, batch_launches = [], [], []
    for i in range(nb):
        before = dict(ops.launches)
        aff, dt = sync_time(lambda: eng.run_stream(
            jr.fold_in(key, i), ins[0][i:i + 1], ins[1][i:i + 1],
            dels[0][i:i + 1], dels[1][i:i + 1]))
        batch_ms.append(dt * 1e3)
        affected.append(int(aff[0]))
        batch_launches.append({k: ops.launches[k] - before[k] for k in ORDER1_KERNELS})
    _, t_merge = sync_time(eng.merge)
    # the merged engine, for phase 3b's maintainer to equal bit for bit
    host_state = {k: v.to("cpu", copy=True)
                  for k, v in state_tensors(eng, pending=False).items()}
    store = eng.store
    decoded, t_decode = sync_time(lambda: store.packed_view().decode())
    g2 = torch.Generator(device=dev)
    g2.manual_seed(7)
    w = torch.randint(0, n_walks, (1 << 16,), generator=g2, device=dev)
    start = walk_start_vertex(w, cfg.n_walks_per_vertex)
    paths, t_trav = sync_time(lambda: store.traverse(w, start, cfg.length - 1))
    qp = torch.randint(0, cfg.length - 1, (1 << 16,), generator=g2, device=dev)
    qv = paths[torch.arange(1 << 16, device=dev), qp]
    (fn_v, fn_found), t_point = sync_time(lambda: store.find_next(qv, w, qp))
    launches = dict(ops.launches)   # ---- read just after the main path
    peak = torch.cuda.max_memory_allocated()

    assert not eng.mav_overflowed, "MAV gather overflow"
    assert all(a <= n_walks for a in affected), affected
    f, _ = ops.szudzik_unpair(store.code)
    assert torch.equal(torch.sort(f).values,
                       torch.arange(store.size, device=dev)), \
        "a slot f = w*l+p is not stored exactly once"
    del f
    assert torch.equal(decoded[:store.size], store.code), "packed decode != code"
    del decoded
    a, b = paths[:, :-1].reshape(-1), paths[:, 1:].reshape(-1)
    deg = eng.graph.degrees().to(torch.int64)
    ok = eng.graph.has_edge(a, b) | ((a == b) & (deg[a] == 0))
    assert bool(ok.all()), "a traversed step is not a graph edge"
    assert bool(fn_found.all()), "a point FINDNEXT on a stored walk missed"
    assert torch.equal(fn_v, paths[torch.arange(1 << 16, device=dev), qp + 1])
    pv, pf = store.find_next(qv, w, qp, backend="torch")
    assert torch.equal(pv, fn_v) and torch.equal(pf, fn_found), \
        "point FINDNEXT: kernel != plain"
    for k in ORDER1_KERNELS:
        assert launches[k] > 0, f"kernel {k} was not launched on the main path"
    prof = profile_batch(lambda: eng.run_stream(
        jr.fold_in(key, nb), ins[0][nb:], ins[1][nb:], dels[0][nb:], dels[1][nb:]))
    res = dict(config=CONFIG, n_walks=n_walks, triplets=store.size,
               chunks=store.n_chunks, edges=int(eng.graph.num_edges),
               graph_build_s=t_graph, corpus_build_s=t_corpus,
               batch_update_ms=batch_ms,
               affected_share=[x / n_walks for x in affected],
               merge_s=t_merge, decode_s=t_decode,
               traverse_2p16_walks_s=t_trav, point_findnext_2p16_s=t_point,
               peak_mem_gb=peak / 1e9, launches=launches,
               launches_per_batch=batch_launches, profiled_batch=prof)
    log("reduced", **REDUCED)
    log("full_width", **res)
    return res, dict(store=store, queries=(qv, w, qp), n_walks=n_walks, gen=g2,
                     host_state=host_state)


def phase_maintainer(dev, host_state):
    """Phase 3b: the downstream maintainer over phase 3's graph, corpus and
    update keys (the same generator draws), SGNS at MAINT's widths. The
    counts are set to 0 before the timed batches and read just after
    them; the operands of the last timed batch's SGNS call are kept for
    phase 5."""
    c = CONFIG
    n = c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"])
    n_walks = n * cfg.n_walks_per_vertex
    gen = torch.Generator(device=dev)
    gen.manual_seed(2022)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni, nd = c["n_batches"], c["batch_inserts"], c["batch_deletes"]
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    dels = [x.reshape(nb + 1, nd) for x in uniform_pairs(gen, n, (nb + 1) * nd, dev)]
    torch.cuda.reset_peak_memory_stats()
    graph = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"], device=dev)
    edges = int(graph.num_edges)
    del src, dst
    mcfg = MaintainerConfig(walk=cfg, n_vertices=n, rewalk_capacity=n_walks,
                            max_pending=c["max_pending"], merge_policy=c["merge_policy"],
                            merge_impl=c["merge_impl"], **MAINT)
    mt = EmbeddingMaintainer(graph=graph, store=generate_corpus(jr.PRNGKey(0, dev), graph, cfg),
                             cfg=mcfg, key=jr.PRNGKey(5, dev))
    del graph
    in0 = mt.params["in"].clone()
    key, tkey = jr.PRNGKey(1, dev), jr.PRNGKey(6, dev)   # key: phase 3's update key

    def batch(i):
        return mt.run_stream(jr.fold_in(key, i), ins[0][i:i + 1], ins[1][i:i + 1],
                             dels[0][i:i + 1], dels[1][i:i + 1],
                             train_key=jr.fold_in(tkey, i))

    batch_ms, n_pairs, n_affected, loss_per_pair = [], [], [], []
    ops.reset_launches()    # ---- the maintainer's batches, counted from here
    for i in range(nb):
        with (keep_operands("sgns_step", 0) if i == nb - 1
              else contextlib.nullcontext()) as got:
            m, dt = sync_time(lambda: batch(i))
        if i == 0:
            in_unchanged = torch.equal(mt.params["in"], in0)
        batch_ms.append(dt * 1e3)
        n_pairs.append(int(m.n_pairs[0]))
        n_affected.append(int(m.n_affected[0]))
        loss_per_pair.append(float(m.loss_sum[0]) / max(n_pairs[-1], 1))
    launches = dict(ops.launches)   # ---- read just after them
    peak = torch.cuda.max_memory_allocated() / 1e9
    del in0
    kept = got.pop()

    assert launches["sgns_step"] == nb, launches
    assert not mt.mav_overflowed, "MAV gather overflow"
    assert all(np.isfinite(loss_per_pair)), loss_per_pair
    assert all(0 < p <= mcfg.pair_batch for p in n_pairs), (n_pairs, mcfg.pair_batch)
    assert in_unchanged, "the input table changed in the first batch (out = 0, so du = 0)"
    six_ln2 = 6 * float(np.log(2.0))
    assert abs(loss_per_pair[0] / six_ln2 - 1) <= SGNS_LOSS_RTOL, (loss_per_pair[0], six_ln2)
    # merge; the engine must equal phase 3's plain engine bit for bit
    view = mt.engine_view()
    _, t_merge = sync_time(view.merge)
    for k, v in state_tensors(view, pending=False).items():
        if not torch.equal(v.cpu(), host_state[k]):
            raise AssertionError(f"maintainer engine != phase 3's engine in {k}")
    del view
    tables_finite = all(bool(torch.isfinite(t).all()) for t in mt.params.values())
    assert tables_finite, "a table holds a non-finite value"
    prof = profile_batch(lambda: batch(nb), kernel="sgns_kernel")
    res = dict(config=dict(CONFIG, **MAINT), n_walks=n_walks,
               pairs_per_walk=mcfg.pairs_per_walk, pair_batch=mcfg.pair_batch,
               lanes_trained=-(-mcfg.pair_batch // mcfg.pairs_per_walk),
               batch_ms=batch_ms, n_pairs=n_pairs, n_affected=n_affected,
               loss_per_pair=loss_per_pair, first_loss_per_pair_over_6ln2=loss_per_pair[0] / six_ln2,
               in_table_unchanged_after_batch_1=in_unchanged,
               engine_equals_phase3=True, merge_s=t_merge, peak_mem_gb=peak,
               launches=launches, profiled_batch=prof)
    log("reduced_maintainer", **MAINT_REDUCED)
    log("maintainer", **res)
    return res, kept, mt


# ---------------------------------------------------------------- phase 3c


def timed_queries(svc, kind: str, batch_args, call_args) -> dict:
    """Synced host time a query of one kind: one batched call of B queries
    (after a warm-up call of the same shape), then `per_call_reps` single
    calls -> {"batched_us_per_query", "per_call_us"}."""
    fn = getattr(svc, kind)
    fn(*batch_args)
    _, t_b = sync_time(lambda: fn(*batch_args))
    times = []
    for args in call_args:
        _, t = sync_time(lambda: fn(*args))
        times.append(t)
    b = SERVE["batch"]
    return {"batched_us_per_query": t_b / b * 1e6, "batch": b,
            "per_call_us": float(np.mean(times)) * 1e6, "calls": len(times)}


def pinned_answers(svc, snap, q, verts, w, start) -> dict:
    """What a pinned snapshot answers, read anew (no cache): FINDNEXT, the
    walks of some vertices, and the overlay's own traverse of walks w."""
    nxt, found = svc.next_vertices(*q, snapshot=snap)
    return {"next": nxt, "found": found,
            "walks_of": svc.walks_of(verts, capacity=SERVE["walks_of_capacity"],
                                     snapshot=snap),
            "traverse": snap.overlay.traverse(w, start, svc.engine.store.length - 1)}


def row_sets(rows) -> list:
    return [set(r[r >= 0].tolist()) for r in rows.cpu()]


def overlay_on_cpu(ov):
    """The overlay's tensors copied to the CPU, where every read takes the
    kernels' plain versions (pair, unpair and the packed FINDNEXT)."""
    st = ov.base
    base = st.replace(**{f.name: getattr(st, f.name).cpu()
                         for f in dataclasses.fields(st)
                         if torch.is_tensor(getattr(st, f.name))})
    return ov.replace(base=base, **{f.name: getattr(ov, f.name).cpu()
                                    for f in dataclasses.fields(ov)
                                    if f.name != "base"})


def walk_matrix_plain(st, slab: int = 1 << 24):
    """The walk matrix read off a merged store, with the plain unpair: the
    entry of slot f = w * l + p is owned by walk w's vertex at position p.
    Every slot must hold exactly one live entry."""
    t = st.n_walks * st.length
    assert st.size == t, (st.size, t)
    out = torch.full((t,), -1, dtype=torch.int64, device=st.device)
    for s in range(0, t, slab):
        f, _ = szudzik.unpair_plain(st.code[s:s + slab])
        assert bool(((f >= 0) & (f < t)).all()), "a merged code names no slot"
        assert torch.equal(st.epoch[s:s + slab], st.slot_epoch[f]), \
            "a merged entry is not live"
        out[f] = st.owner[s:s + slab].to(torch.int64)
    assert bool((out >= 0).all()), "a slot holds no entry after the merge"
    return out.reshape(st.n_walks, st.length)


def segment_walks_plain(st, verts):
    """The walk ids of each vertex's segment in a merged store, -1 padded:
    its chunks decoded by the plain FOR decode, its codes unpaired by the
    plain unpair."""
    lo, hi = st.offsets[verts].to(torch.int64), st.offsets[verts + 1].to(torch.int64)
    idx = lo[:, None] + torch.arange(int((hi - lo).max()), device=lo.device)[None]
    pos = idx.clamp(max=st.size - 1)
    chunks, inv = torch.unique(pos // CHUNK, return_inverse=True)
    codes = delta.decode_rows_plain(st.packed, st.widths, st.anchors_hi,
                                    st.anchors_lo, chunks)[inv, pos % CHUNK]
    f, _ = szudzik.unpair_plain(codes)
    return torch.where(idx < hi[:, None], f // st.length, -1)


def walks_of_vertices(eng, gen, cap: int):
    """B vertices drawn at random among those whose every walk walks_of at
    capacity `cap` returns: the base segment (live and stale entries) and
    the pending rows (not dead) of the vertex both fit in `cap` (the
    query's contract returns the first `cap` of each) -> (vertices,
    vertices that fit, max base segment)."""
    store, n = eng.store, eng.store.n_vertices
    seg = (store.offsets[1:] - store.offsets[:-1]).to(torch.int64)
    pend = eng.overlay()
    owners = pend.owner[pend.epoch != PAD_EPOCH].to(torch.int64)
    per_v = torch.bincount(owners, minlength=n)
    fits = torch.nonzero((seg <= cap) & (per_v <= cap)).reshape(-1)
    pick = torch.randperm(fits.numel(), generator=gen, device=fits.device)
    return fits[pick[:SERVE["batch"]]].sort().values, int(fits.numel()), int(seg.max())


def phase_serve(dev, mt):
    """Phase 3c: a WalkQueryService over phase 3b's maintainer, pending
    block live. The counts are set to 0 before the serve path (the live
    queries of every kind and the pinned reads) and read just after it;
    the checks against plain versions, merges and timings come after."""
    c, s = CONFIG, SERVE
    cap, b = s["walks_of_capacity"], s["batch"]
    eng = mt.engine_view()
    pending_at_first_query = eng.n_pending
    assert pending_at_first_query >= 1, "no pending block is live"
    svc = WalkQueryService(engine=eng)
    n, n_w, length = eng.store.n_vertices, eng.cfg.n_walks_per_vertex, eng.store.length
    n_walks = n * n_w
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    verts, fitting, max_seg = walks_of_vertices(eng, gen, cap)
    qw = torch.randint(0, n_walks, (s["next_queries"],), generator=gen, device=dev)
    qp = torch.randint(0, length - 1, (s["next_queries"],), generator=gen, device=dev)
    tw = torch.randint(0, n_walks, (s["pin_traverse_walks"],), generator=gen, device=dev)
    collector = slo.install(slo.ServeSLO())
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the serve path, counted from here
    wm, t_wm = sync_time(svc.walk_matrix)
    q = (wm[qw, qp], qw, qp)
    (nxt, found), t_next = sync_time(lambda: svc.next_vertices(*q))
    wof, t_wof = sync_time(lambda: svc.walks_of(verts, capacity=cap))
    nbh, t_nbh = sync_time(lambda: svc.neighborhoods(verts, hops=s["hops"]))
    svc.set_embedding_table(mt.embeddings)
    (e_ids, e_sc), t_emb = sync_time(lambda: svc.embedding_neighbors(verts, k=s["k"]))
    snap, t_pin = sync_time(svc.pin)
    pinned = pinned_answers(svc, snap, q, verts, tw, walk_start_vertex(tw, n_w))
    torch.cuda.synchronize()
    launches = dict(ops.launches)   # ---- read just after it
    for kname in ORDER1_KERNELS:
        assert launches[kname] > 0, f"kernel {kname} was not launched on the serve path"

    assert bool(found.all()), "a FINDNEXT on a stored walk missed"
    assert torch.equal(nxt, wm[qw, qp + 1]), "next_vertices != the walk matrix"
    plain = WalkQueryService(engine=eng, backend="torch")
    pn, pf = plain.next_vertices(*q)
    assert torch.equal(pn, nxt) and torch.equal(pf, found), \
        "next_vertices: kernel != plain backend"
    # one batch with the plain pair, unpair and FINDNEXT: a CPU copy
    cpu_ov = overlay_on_cpu(eng.overlay())
    (cn, cf), t_cpu_next = sync_time(lambda: batched.find_next_batch(
        cpu_ov, *(x.cpu() for x in q), backend="torch"))
    assert torch.equal(nxt.cpu(), cn) and torch.equal(found.cpu(), cf), \
        "next_vertices: card != the plain versions on the CPU"
    del cpu_ov, cn, cf
    assert torch.equal(nbh, wm[(verts[:, None] * n_w + torch.arange(n_w, device=dev))
                               .reshape(-1), :s["hops"] + 1].reshape(len(verts), n_w, -1)), \
        "neighborhoods != a gather of the walk matrix"
    table = mt.embeddings.cpu()
    c_ids, c_sc = batched.embedding_topk(batched.normalize_rows(table),
                                         verts.cpu(), s["k"])
    assert torch.equal(e_ids.cpu(), c_ids), "embedding_neighbors: card ids != CPU ids"
    emb_err = float((e_sc.cpu() - c_sc).abs().max())
    assert emb_err <= 1e-5, emb_err
    del table

    # the post-merge answers of the pinned state
    _, t_merge = sync_time(eng.merge)
    w_all = torch.arange(n_walks, device=dev)
    post, t_trav = sync_time(lambda: eng.store.traverse(
        w_all, walk_start_vertex(w_all, n_w), length - 1))
    assert torch.equal(post, wm), "overlay walk matrix != post-merge traverse"
    del post
    assert torch.equal(walk_matrix_plain(eng.store), wm), \
        "overlay walk matrix != the merged store read with the plain unpair"
    assert row_sets(wof) == row_sets(segment_walks_plain(eng.store, verts)), \
        "walks_of != the post-merge segments"

    # two more batches and a merge: the pinned answers stay bit-identical
    g2 = torch.Generator(device=dev)
    g2.manual_seed(2025)
    key = jr.PRNGKey(1, dev)
    nb = s["extra_batches"]
    ins = [x.reshape(nb, -1) for x in uniform_pairs(g2, n, nb * c["batch_inserts"], dev)]
    dels = [x.reshape(nb, -1) for x in uniform_pairs(g2, n, nb * c["batch_deletes"], dev)]
    for i in range(nb):
        eng.run_stream(jr.fold_in(key, c["n_batches"] + 1 + i), ins[0][i:i + 1],
                       ins[1][i:i + 1], dels[0][i:i + 1], dels[1][i:i + 1])
    eng.merge()
    again = pinned_answers(svc, snap, q, verts, tw, walk_start_vertex(tw, n_w))
    for k in pinned:
        if not torch.equal(again[k], pinned[k]):
            raise AssertionError(f"pinned {k} changed after {nb} batches and a merge")
    pin_bytes = snap.nbytes
    snap.release()
    assert eng.pins_active == 0
    del again, pinned, snap

    # per query kind: synced time a query, batched (B) and per call
    reps = s["per_call_reps"]
    single = [([int(v)],) for v in verts[:reps].tolist()]
    q1 = [(q[0][i:i + 1], q[1][i:i + 1], q[2][i:i + 1]) for i in range(reps)]
    timing = {
        "next_vertices": timed_queries(svc, "next_vertices",
                                       tuple(x[:b] for x in q), q1),
        "walks_of": timed_queries(svc, "walks_of", (verts, cap),
                                  [(v, cap) for (v,) in single]),
        "neighborhoods": timed_queries(svc, "neighborhoods", (verts, s["hops"]),
                                       [(v, s["hops"]) for (v,) in single]),
        "embedding_neighbors": timed_queries(svc, "embedding_neighbors",
                                             (verts, s["k"]),
                                             [(v, s["k"]) for (v,) in single]),
    }
    peak = torch.cuda.max_memory_allocated() / 1e9
    counters = svc.obs_counters()
    del svc, plain, wm, eng
    ppr = serve_ppr(dev, timing)
    summ = collector.summary()
    slo.uninstall()
    res = dict(n_vertices=n, n_walks=n_walks,
               pending_blocks_at_first_query=pending_at_first_query,
               launches=launches, walk_matrix_s=t_wm, next_vertices_2p16_s=t_next,
               walks_of_1024_s=t_wof, neighborhoods_1024_s=t_nbh,
               embedding_neighbors_1024_s=t_emb,
               walks_of_vertices_that_fit=fitting, max_base_segment=max_seg,
               pin=dict(bytes=pin_bytes, seconds=t_pin),
               merge_s=t_merge, post_merge_traverse_s=t_trav,
               next_vertices_kernel_equals_plain=True, pinned_bit_identical=True,
               walk_matrix_equals_post_merge=True, walks_of_equals_segments=True,
               next_vertices_plain_cpu_s=t_cpu_next,
               embedding_ids_equal_cpu=True, embedding_max_abs_err=emb_err,
               ppr=ppr, per_query=timing, peak_mem_gb=peak,
               obs_counters=counters, slo=summ)
    log("reduced_serve", **SERVE_REDUCED)
    log("serve", **res)
    return res


def serve_ppr(dev, timing):
    """ppr_rows on an engine of its own at SERVE's PPR vertex count (the
    dense table), a pending block live: the table built twice on the card
    is bit-identical and equals the CPU's within rtol 1e-5; its query times
    go into `timing`."""
    c, s = CONFIG, SERVE
    n = s["ppr_vertices"]
    scale = n / c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"], length=c["length"],
                     chunk_b=c["chunk_b"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    g = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"] // 8, device=dev)
    eng = WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(0, dev), g, cfg),
                     cfg=cfg, merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                     rewalk_capacity=n * cfg.n_walks_per_vertex,
                     max_pending=c["max_pending"])
    ins = uniform_pairs(gen, n, int(c["batch_inserts"] * scale), dev)
    dels = uniform_pairs(gen, n, int(c["batch_deletes"] * scale), dev)
    eng.run_stream(jr.PRNGKey(1, dev), ins[0][None], ins[1][None], dels[0][None],
                   dels[1][None])
    svc = WalkQueryService(engine=eng)
    verts = torch.randperm(n, generator=gen, device=dev)[:s["batch"]]
    rows, t_cold = sync_time(lambda: svc.ppr_rows(verts, s["restart_prob"]))
    wm = svc.walk_matrix()
    a, t_table = sync_time(lambda: batched.ppr_table(wm, n, s["restart_prob"]))
    b = batched.ppr_table(wm, n, s["restart_prob"])
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
        "the PPR table built twice on the card differs"
    del b
    assert torch.equal(rows, a[verts]), "ppr_rows != the table's rows"
    cpu = batched.ppr_table(wm.cpu(), n, s["restart_prob"]).to(dev)
    rel = ((a - cpu).abs() / cpu.abs().clamp(min=1e-30)).max().item()
    zeros_agree = bool(torch.equal(a == 0, cpu == 0))
    torch.testing.assert_close(a, cpu, rtol=s["ppr_rtol"], atol=0)
    bits_equal = bool(torch.equal(a.view(torch.int32), cpu.view(torch.int32)))
    del cpu, a
    timing["ppr_rows"] = timed_queries(svc, "ppr_rows", (verts, s["restart_prob"]),
                                       [([int(v)], s["restart_prob"])
                                        for v in verts[:s["per_call_reps"]].tolist()])
    return dict(n_vertices=n, n_walks=eng.store.n_walks, table_gb=n * n * 4 / 1e9,
                cold_rows_s=t_cold, table_build_s=t_table,
                deterministic_on_card=True, max_rel_diff_cpu=rel,
                zeros_agree_cpu=zeros_agree, bit_equal_cpu=bits_equal)


def n2v_stream(dev):
    """Phase 4's walk config and data from its seeded generator: the
    graph's edges, then the inserts of the timed batches and the profiled
    one -> (cfg, src, dst, ins, the generator)."""
    c = N2V
    n = c["n_vertices"]
    model = WalkModel(order=2, p=c["p"], q=c["q"], sampler=c["sampler"],
                      dmax=c["dmax"])
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"],
                     length=c["length"], chunk_b=c["chunk_b"], model=model,
                     megakernel="off")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2023)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    nb, ni = c["n_batches"], c["batch_inserts"]
    ins = [x.reshape(nb + 1, ni) for x in uniform_pairs(gen, n, (nb + 1) * ni, dev)]
    return cfg, src, dst, ins, gen


def n2v_graph(src, dst, dev):
    """Phase 4's graph from its edges."""
    return StreamingGraph.from_edges(src, dst, N2V["n_vertices"], N2V["edge_capacity"],
                                     device=dev)


def n2v_corpus(graph, cfg, dev):
    """Phase 4's corpus under its key."""
    return generate_corpus(jr.PRNGKey(0, dev), graph, cfg)


def n2v_engine(graph, store, cfg, megakernel: str):
    """Phase 4's engine over this graph and corpus."""
    c = N2V
    return WalkEngine(graph=graph, store=store, cfg=cfg._replace(megakernel=megakernel),
                      merge_policy=c["merge_policy"], merge_impl=c["merge_impl"],
                      rewalk_capacity=c["n_vertices"] * cfg.n_walks_per_vertex,
                      max_pending=c["max_pending"])


def n2v_batch(eng, ins, i: int):
    """Batch i of phase 4's stream under its key: the timed batches i <
    n_batches one insert row each, then (i = n_batches) the profiled batch,
    the remaining rows and an empty delete list -> the affected counts."""
    dev, nb = ins[0].device, N2V["n_batches"]
    key = jr.fold_in(jr.PRNGKey(1, dev), i)
    if i < nb:
        return eng.run_stream(key, ins[0][i:i + 1], ins[1][i:i + 1])
    no_dels = [torch.zeros((1, 0), dtype=torch.int64, device=dev)] * 2
    return eng.run_stream(key, ins[0][nb:], ins[1][nb:], *no_dels)


def phase_full_n2v(dev):
    """wharf-stream order 2 at full width: the corpus once, then the
    batches unfused and again fused from the same corpus and keys. The
    counts are set to 0 before the corpus and before each path's batches
    and read just after them."""
    c = N2V
    n = c["n_vertices"]
    cfg, src, dst, ins, gen = n2v_stream(dev)
    n_walks = n * cfg.n_walks_per_vertex
    nb = c["n_batches"]
    w = torch.randint(0, n_walks, (1 << 14,), generator=gen, device=dev)
    start = walk_start_vertex(w, cfg.n_walks_per_vertex)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()    # ---- the corpus, counted from here
    with window_calls() as wins:
        graph, t_graph = sync_time(lambda: n2v_graph(src, dst, dev))
        del src, dst
        store0, t_corpus = sync_time(lambda: n2v_corpus(graph, cfg, dev))
    launches = {"corpus": dict(ops.launches)}
    windows = {"corpus": wins[0]}
    peak = {"corpus": torch.cuda.max_memory_allocated() / 1e9}
    deg = graph.degrees().to(torch.int64)
    triplets = store0.size
    runs, saved, kept = {}, None, {}
    for path, mk in (("unfused", "off"), ("fused", "cuda")):
        eng = n2v_engine(graph, store0, cfg, mk)
        if path == "fused":
            del store0
        batch_ms, affected, batch_launches = [], [], []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()    # ---- this path's batches, counted from here
        with window_calls() as wins:
            for i in range(nb):
                before = dict(ops.launches)
                aff, dt = sync_time(lambda: n2v_batch(eng, ins, i))
                batch_ms.append(dt * 1e3)
                affected.append(int(aff[0]))
                batch_launches.append({k: ops.launches[k] - before[k]
                                       for k in ops.KERNELS})
        launches[path] = dict(ops.launches)   # ---- read just after them
        windows[path] = wins[0]
        peak[path] = torch.cuda.max_memory_allocated() / 1e9
        assert not eng.mav_overflowed, "MAV gather overflow"
        state = state_tensors(eng)
        if saved is None:
            saved = {k: v.to("cpu", copy=True) for k, v in state.items()}
        else:
            for k, v in state.items():
                if not torch.equal(v.cpu(), saved[k]):
                    raise AssertionError(f"order 2: fused != unfused in {k}")
            del saved
        del state
        # one more batch, with 3 pending blocks (the unfused path's under
        # the profiler; parsing a fused batch's trace took ~100 s of the
        # run's time limit); the operands of one call of each kernel named
        # here are kept for phase 5 (unfused: a rewalk step's kernel 5, and
        # the first prefix-read call's kernel 4, whose device time and
        # share of the prefix read the profile reports)
        if path == "unfused":
            keep = {"intersect_csr": cfg.length // 2, "find_next_packed": 0}
        else:
            keep = {"fused_rewalk_step": 5}
        with contextlib.ExitStack() as stack:
            got = {name: stack.enter_context(keep_operands(name, at))
                   for name, at in keep.items()}
            wins = stack.enter_context(window_calls())
            if path == "unfused":
                prof = profile_batch(lambda: n2v_batch(eng, ins, nb),
                                     kernel="search_kernel", layer="wharf.prefix")
            else:
                _, dt = sync_time(lambda: n2v_batch(eng, ins, nb))
                prof = dict(wall_ms=dt * 1e3, device_busy="not measured (not profiled)")
        windows[path] += wins[0]
        for name, g in got.items():
            assert g, f"{name}: operands not kept"
            kept[name] = g.pop()
            if path == "unfused":   # off the card while the fused path runs
                kept[name] = [t.cpu() if isinstance(t, torch.Tensor) else t
                              for t in kept[name]]
        # the overlay read (base + pending) = the read after the merge
        ov_paths, t_ov = sync_time(lambda: eng.overlay().traverse(
            w, start, cfg.length - 1))
        _, t_merge = sync_time(eng.merge)
        paths, t_trav = sync_time(lambda: eng.store.traverse(w, start, cfg.length - 1))
        assert torch.equal(ov_paths, paths), "overlay traverse != post-merge traverse"
        a, b = paths[:, :-1].reshape(-1), paths[:, 1:].reshape(-1)
        ok = eng.graph.has_edge(a, b) | ((a == b) & (eng.graph.degrees()[a] == 0))
        assert bool(ok.all()), "a traversed order-2 step is not a graph edge"
        runs[path] = dict(batch_update_ms=batch_ms,
                          affected_share=[x / n_walks for x in affected],
                          launches_per_batch=batch_launches, merge_s=t_merge,
                          overlay_traverse_2p14_s=t_ov,
                          traverse_2p14_walks_s=t_trav, profiled_batch=prof)
        if path == "fused":
            f, _ = ops.szudzik_unpair(eng.store.code)
            assert torch.equal(torch.sort(f).values,
                               torch.arange(eng.store.size, device=dev)), \
                "a slot f = w*l+p is not stored exactly once"
            del f
        del eng
    total = {k: sum(launches[p][k] for p in launches) for k in ops.KERNELS}
    assert launches["corpus"]["intersect_csr"] > 0
    assert launches["unfused"]["intersect_csr"] > 0
    assert launches["unfused"]["find_next_packed"] > 0
    assert launches["fused"]["fused_rewalk_step"] > 0
    assert launches["fused"]["intersect_csr"] == 0
    assert launches["unfused"]["fused_rewalk_step"] == 0
    assert total["intersect_next"] == 0, "a main path launched the windowed kernel"
    assert windows == dict.fromkeys(windows, 0), f"a card path built windows: {windows}"
    res = dict(config=N2V, n_walks=n_walks, triplets=triplets,
               edges=int(graph.num_edges), max_degree=int(deg.max()),
               vertices_over_dmax_share=float((deg > c["dmax"]).float().mean()),
               graph_build_s=t_graph, corpus_build_s=t_corpus, runs=runs,
               fused_equals_unfused=True, peak_mem_gb=peak,
               launches=launches, launches_total=total,
               neighbor_window_calls=windows)
    log("reduced_n2v", **N2V_REDUCED)
    log("full_width_n2v", **res)
    return res, kept


@contextlib.contextmanager
def keep_operands(name: str, k: int):
    """Within the block, `ops.<name>` keeps the operands of its k-th call
    (k = 0: the first) in the list it yields; every call goes to the
    wrapper itself, which counts its launch. The engine looks the wrapper
    up on `ops` at each call."""
    wrapped = getattr(ops, name)
    kept, calls = [], [0]

    def keep(*args):
        if calls[0] == k:
            kept.append(args)
        calls[0] += 1
        return wrapped(*args)

    setattr(ops, name, keep)
    try:
        yield kept
    finally:
        setattr(ops, name, wrapped)


@contextlib.contextmanager
def window_calls():
    """Within the block, count the calls of `intersect.neighbor_window`, the
    torch window builder that no card path of order 2 may call, in the
    one-element list it yields (`walkers._neighbor_window` goes through
    it)."""
    build = intersect.neighbor_window
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return build(*args, **kw)

    intersect.neighbor_window = counted
    try:
        yield calls
    finally:
        intersect.neighbor_window = build


def state_tensors(eng, pending: bool = True) -> dict:
    """Every tensor of an engine's state that the comparisons hold equal:
    graph codes, every store array (slot_epoch included), the counters and
    (unless `pending=False`) the pending blocks."""
    st = eng.state
    out = {"graph.codes": st.graph.codes, "total_affected": st.total_affected}
    for f in ("owner", "code", "epoch", "offsets", "vmin", "vmax", "packed",
              "widths", "anchors_hi", "anchors_lo", "last_hi", "last_lo",
              "slot_epoch"):
        out["store." + f] = getattr(st.store, f)
    if pending:
        for f in ("owner", "code", "epoch", "slot"):
            out["pending." + f] = getattr(st.pending, f)
    return out


LAYERS = ("wharf.", "maintainer.")   # the record_function scopes of the port


def profile_batch(run, kernel: str = None, layer: str = None):
    """One more batch, `run()`, under torch.profiler: wall time, the
    device's busy and idle share, the device and host time of each layer
    scope, the top operators by device time and, if named, the device
    time of the kernels whose name holds `kernel` and their share of the
    busy time and of the device time of the scope `layer`.

    Device time comes from the device's own records: every kernel counts
    toward busy time, and a layer's device time is that of the kernels
    that ran inside the layer's span on the device. (The port's kernels are
    launched through ctypes, inside no PyTorch operator, so the profiler
    links them to no host event: a sum of the host events' kernels leaves
    most of them out.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the profiler's raw records: `prof.events()` and `key_averages()` build
    # a Python tree of every host operator first (~100 s for one batch)
    spans, kerns, layers_host = {}, [], {}   # kerns: (start, end, name), us
    for e in prof.profiler.kineto_results.events():
        name, where = e.name(), e.device_type()
        if where == DeviceType.CUDA:
            if name.startswith(LAYERS):
                spans.setdefault(name, []).append((e.start_ns() / 1e3, e.end_ns() / 1e3))
            else:
                kerns.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name))
        elif where == DeviceType.CPU and name.startswith(LAYERS):
            layers_host[name] = layers_host.get(name, 0.0) + (e.end_ns() - e.start_ns()) / 1e6
    busy_ms = sum(t - s for s, t, _ in kerns) / 1e3
    if not busy_ms:
        return dict(wall_ms=wall * 1e3, device_busy="not measured")

    def inside(name, span_list):
        # a kernel is inside a span if a span that starts before it ends
        # after it: the spans by start, with the running latest end
        span_list = sorted(span_list)
        starts = [a for a, _ in span_list]
        ends = list(itertools.accumulate((b for _, b in span_list), max))
        total = 0.0
        for s, t, n in kerns:
            i = bisect.bisect_right(starts, s)
            if name in n and i and ends[i - 1] >= t:
                total += t - s
        return total / 1e3

    layers = {name: inside("", sp) for name, sp in spans.items()}
    by_name = {}
    for s, t, n in kerns:
        by_name[n] = by_name.get(n, 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / (wall * 1e3),
               layer_kernel_ms=layers, layer_host_ms=layers_host,
               top_kernels_ms={n[:100]: us / 1e3 for n, us in top})
    if kernel:
        k_ms = sum(t - s for s, t, n in kerns if kernel in n) / 1e3
        out[kernel] = dict(device_ms=k_ms, share_of_busy=k_ms / busy_ms)
        if layer:
            out[kernel]["share_of_" + layer] = inside(kernel, spans[layer]) / layers[layer]
    return out


# ---------------------------------------------------------------- phase 4


def bound(bytes_moved: float, ops_done: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def used_words(widths: torch.Tensor) -> torch.Tensor:
    w = widths.to(torch.int64)
    return torch.where(w == 64, 2 * delta.CHUNK, delta.CHUNK * w // 32)


def exact(a, b, what: str) -> float:
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: kernel != plain")
    return 0.0


def kernel_row(rows, name, err, fn, ms, plain_ms, bytes_moved, ops_done, shape,
               **extra):
    """One entry of the `kernels` line for the kernel call `fn`, timed warm
    by the caller (`ms`) and cold here (`ms_cold`), with the SM clock
    measured just after; `launches` is filled in by main() from the main
    paths' counts."""
    b_ms, b_by = bound(bytes_moved, ops_done)
    src, rep = KERNEL_META[name]
    rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=None, max_abs_err=err, ms=ms, ms_cold=cold_ms(fn),
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=shape, sm_clock_mhz=sm_clock_mhz(), **extra))


def search_work(pk, wd, ah, al, cidx, f_t, slab: int = 1 << 16):
    """Bytes and operations of a packed FINDNEXT call on these operands:
    each query's K indices (u32) and target and outputs (u32 v, found);
    each chunk that a query visits (up to and including its first chunk
    with a hit, all K on a miss) read once however many queries visit it
    (used words, width, anchor); per visited code of a query a decode
    step, an unpair and a compare (14 operations). Counted in slabs of
    queries -> (bytes, operations, visited chunks, distinct chunks)."""
    k = cidx.shape[1]
    dev = cidx.device
    seen = torch.zeros(pk.shape[0], dtype=torch.bool, device=dev)
    visited_total = 0
    for s in range(0, cidx.shape[0], slab):
        ci, ft = cidx[s:s + slab].to(torch.int64), f_t[s:s + slab]
        codes = delta.decode_rows_plain(pk, wd, ah, al, ci.reshape(-1))
        fk, _ = pairing.szudzik_unpair(codes)
        hit_k = (fk.reshape(-1, k, delta.CHUNK) == ft[:, None, None]).any(-1)
        visited = torch.where(hit_k.any(-1), hit_k.to(torch.int8).argmax(-1) + 1, k)
        vis_mask = torch.arange(k, device=dev)[None] < visited[:, None]
        seen[ci[vis_mask]] = True
        visited_total += int(visited.sum())
    nbytes = (cidx.numel() * 4.0 + f_t.numel() * 9.0
              + float((used_words(wd)[seen] * 4 + 12).sum()))
    return nbytes, 14.0 * delta.CHUNK * visited_total, visited_total, int(seen.sum())


def phase_kernels(dev, tensors):
    store = tensors["store"]
    rows = []

    def row(*args, **extra):
        kernel_row(rows, *args, **extra)

    # Bytes are counted at the reference's types, which the function needs:
    # vertex ids, slots, positions and epochs are u32 (4 B), codes u64.
    # pair: the rewalk emit shape (one code per lane, n_walks lanes), plus
    # operands at 0 and 2^32-1
    n_walks = tensors["n_walks"]
    f = torch.arange(n_walks, device=dev) * store.length + store.length - 1
    v = torch.randint(0, store.n_vertices, (n_walks,), generator=tensors["gen"],
                      device=dev)
    edge = torch.tensor([0, 2**32 - 1, 2**32 - 1, 0], device=dev)
    f = torch.cat([f, edge])
    v = torch.cat([v, edge.flip(0)])
    err = exact([szudzik.pair_cuda(f, v)], [pairing.szudzik_pair(f, v)], "pair")
    # views off a 16-byte boundary (both operands, or one), odd lengths
    for a, b in ((f[1:], v[1:]), (f[1:], v[:-1]), (f[:-1], v[1:]), (f[2:-1], v[2:-1])):
        exact([szudzik.pair_cuda(a, b)], [pairing.szudzik_pair(a, b)], "pair (views)")
    # the port's types: two int64 operands read, one int64 code written
    run = lambda: szudzik.pair_cuda(f, v)  # noqa: E731
    row("szudzik_pair", err, run, event_ms(run, 20),
        event_ms(lambda: pairing.szudzik_pair(f, v), 3), 16 * f.numel(),
        6 * f.numel(), list(f.shape),
        bound_ms_port_types=24 * f.numel() / HBM_BYTES_PER_S * 1e3)

    # unpair: the MAV gather's share of the store (2^24 codes) plus edge codes
    z = torch.cat([store.code[: 1 << 24], torch.tensor(
        [-(1 << 63), -(1 << 63) + 1, (1 << 63) - 1, (1 << 63) - 2,
         (2**32 - 1) ** 2 - (1 << 63)], device=dev)])
    err = exact(szudzik.unpair_cuda(z), pairing.szudzik_unpair(z), "unpair")
    run = lambda: szudzik.unpair_cuda(z)  # noqa: E731
    row("szudzik_unpair", err, run, event_ms(run, 20),
        event_ms(lambda: pairing.szudzik_unpair(z), 3), 16 * z.numel(),
        12 * z.numel(), list(z.shape))
    t_full = event_ms(lambda: szudzik.unpair_cuda(store.code), 3)
    rows[-1]["ms_full_store"] = t_full
    rows[-1]["bound_ms_full_store"] = 16 * store.size / HBM_BYTES_PER_S * 1e3

    # decode: every chunk of the store (PackedWalkStore.decode)
    pk, wd, ah, al = store.packed, store.widths, store.anchors_hi, store.anchors_lo
    idx = torch.arange(store.n_chunks, device=dev)
    err = exact([delta.decode_rows_cuda(pk, wd, ah, al, idx)],
                [delta.decode_rows_plain(pk, wd, ah, al, idx)], "decode")
    nbytes = float((used_words(wd) * 4 + 4 + 8 + 8 + 8 * delta.CHUNK).sum())
    run = lambda: delta.decode_rows_cuda(pk, wd, ah, al, idx)  # noqa: E731
    row("delta_decode", err, run, event_ms(run, 10),
        event_ms(lambda: delta.decode_rows_plain(pk, wd, ah, al, idx), 1),
        nbytes, 8.0 * delta.CHUNK * store.n_chunks, [store.n_chunks, delta.CHUNK])

    # search: the point-FINDNEXT windows of phase 3 (2^16 queries, K=8)
    qv, w, qp = tensors["queries"]
    f_t = w * store.length + qp
    lb = pairing.szudzik_pair(f_t, (store.vmin[qv].to(torch.int64) & 0xFFFFFFFF))
    lo = seg_searchsorted(store.code, store.offsets[qv], store.offsets[qv + 1],
                          lb, side="left")
    k = 8
    cidx = ((lo // delta.CHUNK)[:, None] + torch.arange(k, device=dev)[None]
            ).clamp(0, store.n_chunks - 1).to(torch.int32)
    # an edge case: the target's chunk last in the window (a hit at k = K-1)
    cidx_late = torch.roll(cidx, -1, dims=1)
    args = (pk, wd, ah, al)
    err = exact(range_search.find_next_packed_cuda(*args, cidx, f_t),
                range_search.find_next_packed_plain(*args, cidx, f_t), "search")
    exact(range_search.find_next_packed_cuda(*args, cidx_late, f_t),
          range_search.find_next_packed_plain(*args, cidx_late, f_t), "search K-1")
    # K = 1 and K = 32 windows (the kernel's bounds)
    for kk in (1, range_search.MAX_WINDOW):
        ck = ((lo // delta.CHUNK)[:, None] + torch.arange(kk, device=dev)[None]
              ).clamp(0, store.n_chunks - 1).to(torch.int32)
        exact(range_search.find_next_packed_cuda(*args, ck, f_t),
              range_search.find_next_packed_plain(*args, ck, f_t), f"search K={kk}")
    nbytes, nops, visited, distinct = search_work(*args, cidx, f_t)
    run = lambda: range_search.find_next_packed_cuda(*args, cidx, f_t)  # noqa: E731
    row("find_next_packed", err, run, event_ms(run, 20),
        event_ms(lambda: range_search.find_next_packed_plain(*args, cidx, f_t), 2),
        nbytes, nops, list(cidx.shape), visited_chunks=visited, distinct_chunks=distinct)
    return rows


def intersect_edge_rows(d, dev):
    """Empty windows, prev absent from v's window, prev v's only neighbor,
    u_group just below 1, rows with no common neighbor."""
    s = intersect.SENT
    nv = torch.full((6, d), s, dtype=torch.int64)
    npv = torch.full((6, d), s, dtype=torch.int64)
    nv[1, :3], npv[1, :2] = torch.tensor([4, 9, 11]), torch.tensor([9, 30])
    nv[2, :1], npv[2, :1] = 7, 3
    nv[3, :5], npv[3, :5] = torch.arange(1, 6), torch.tensor([2, 3, 8, 9, 10])
    nv[4, :], npv[4, :] = torch.arange(d), torch.arange(d) * 2
    nv[5, :2] = torch.tensor([100, 200])
    prev = torch.tensor([5, 2, 7, 3, 6, 1])
    u_g = torch.tensor([0.5, 0.3, 0.9, float(np.nextafter(np.float32(1), np.float32(0))),
                        0.99, 0.0], dtype=torch.float32)
    u_r = torch.tensor([0.5, 0.99, 0.2, 0.999, 0.0, 0.7], dtype=torch.float32)
    return [t.to(dev) for t in (nv, npv, prev, u_g, u_r)]


def csr_edge_case(dmax, dev):
    """A 512-vertex graph with four hubs of degree ~2 dmax (> dmax) and 16
    isolated vertices, and 4,096 rows: v and prev both hubs, v isolated,
    prev isolated, prev == v, prev a neighbor of v, and uniform pairs ->
    (codes, offsets, v, prev, u f32 [4096, 2])."""
    rng = np.random.default_rng(dmax)
    n, b = 512, 4096
    src, dst = rng.integers(0, n - 16, size=(2, 8000))
    hs = np.repeat(np.arange(4), 2 * dmax)
    src = np.concatenate([src, hs])
    dst = np.concatenate([dst, rng.integers(4, n - 16, size=hs.shape[0])])
    g = StreamingGraph.from_edges(src, dst, n, 1 << 15, device=dev)
    v, prev = rng.integers(0, n, size=(2, b))
    v[:8], prev[:8] = np.arange(8) % 4, (np.arange(8) + 1) % 4
    v[8:16] = n - 1 - np.arange(8)
    prev[16:24] = n - 1 - np.arange(8)
    prev[24:40] = v[24:40]
    for i in range(40, 72):
        nb = dst[src == v[i]]
        prev[i] = nb[i % nb.shape[0]] if nb.shape[0] else prev[i]
    u = rng.random((b, 2)).astype(np.float32)
    return [g.codes, g.offsets] + [torch.from_numpy(x).to(dev) for x in (v, prev, u)]


def segment_entries(offsets, verts, dmax):
    """min(deg, dmax) of each vertex: the codes its CSR row reads."""
    deg = (offsets[1:] - offsets[:-1]).to(torch.int64).clamp(max=dmax)
    return deg[verts]


def segment_bytes(offsets, dmax, *verts):
    """The CSR bytes rows of these vertices read, each segment once however
    many rows read it: 8 B a code (min(deg, dmax) codes) and its two
    offsets (u32)."""
    seen = torch.zeros(offsets.shape[0] - 1, dtype=torch.bool, device=offsets.device)
    for v in verts:
        seen[v] = True
    return float((segment_entries(offsets, seen.nonzero()[:, 0], dmax) * 8 + 8).sum())


def csr_work(offsets, v, prev, dmax):
    """Bytes and operations of the CSR step on these rows: the segments of
    the rows' v and prev (`segment_bytes`), each row's v and prev (u32) and
    two f32 uniforms, and the outputs (u32 nxt, found, overflow), each read
    or written once; ~30 operations (a binary search and a few ballots) per
    v entry of a row."""
    nv, np_ = segment_entries(offsets, v, dmax), segment_entries(offsets, prev, dmax)
    nbytes = segment_bytes(offsets, dmax, v, prev) + 22.0 * v.shape[0]
    return nbytes, 30.0 * float(nv.sum()), float((nv + np_).sum()) / (2 * v.shape[0])


def fused_work(store, step, nxt):
    """Bytes and operations one fused step needs on these inputs: every
    lane's scalars (two flags; lo, hi, ft, cur, slot_epoch as u32) and
    outputs (u32 nxt, u64 code, overflow); a pending hit's u32 next; the
    chunks FINDNEXT lanes visit, each once (a lane's run up to the chunk
    holding its hit, all K or up to hi if it misses), and a FINDNEXT
    lane's epoch; the CSR segments of the emitting lanes' cur and prev
    (`segment_bytes`) and an emitting lane's u32 prev and two f32
    uniforms."""
    k, dev = step.window, step.cur.device
    b = step.cur.shape[0]
    need = step.is_prefix & ~step.pend_hit & (step.lo < step.hi)
    emit = ~step.is_prefix
    c0 = step.lo // delta.CHUNK
    # the hit, if any, is the entry (cur, <ft, nxt>) of cur's segment
    code = pairing.szudzik_pair(step.ft, nxt)
    seg_hi = store.offsets[step.cur + 1].to(torch.int64)
    pos = seg_searchsorted(store.code, store.offsets[step.cur], seg_hi, code)
    hit = (pos < seg_hi) & (store.code[pos.clamp(max=store.size - 1)] == code)
    span = torch.minimum(torch.full_like(c0, k), torch.minimum(
        (step.hi - 1) // delta.CHUNK - c0 + 1, store.n_chunks - c0))
    last = pos // delta.CHUNK - c0 + 1
    visited = torch.where(hit & (last >= 1) & (last <= span), last, span)
    visited = torch.where(need, visited, 0)
    c = (c0[:, None] + torch.arange(k, device=dev)[None]).clamp(0, store.n_chunks - 1)
    in_v = torch.arange(k, device=dev)[None] < visited[:, None]
    seen = torch.zeros(store.n_chunks, dtype=torch.bool, device=dev)
    seen[c[in_v]] = True
    nv = segment_entries(step.offsets, step.cur[emit], step.dmax)
    nbytes = (35.0 * b + 4.0 * float(step.pend_hit.sum())
              + float((used_words(store.widths)[seen] * 4 + 12).sum())
              + 4.0 * float(need.sum())
              + segment_bytes(step.offsets, step.dmax, step.cur[emit], step.prev[emit])
              + 12.0 * float(emit.sum()))
    nops = 14.0 * delta.CHUNK * float(visited.sum()) + 30.0 * float(nv.sum())
    return nbytes, nops, int(need.sum()), int(emit.sum())


def in_turns(a, b, reps_a: int, reps_b: int):
    """Mean device times of a and b, timed a, b, b, a -> ([a1, a2], [b1, b2])."""
    t = [event_ms(f, r) for f, r in ((a, reps_a), (b, reps_b), (b, reps_b), (a, reps_a))]
    return [t[0], t[3]], [t[1], t[2]]


def prefix_read_search(dev, kept):
    """Kernel 4 on the operands of the first prefix-read call of phase 4's
    profiled unfused batch: held against its plain version, timed warm and
    cold beside its bound (`search_work`)."""
    args = [t.to(dev) for t in kept.pop("find_next_packed")]
    err = exact(range_search.find_next_packed_cuda(*args),
                range_search.find_next_packed_plain(*args), "search (prefix read)")
    nbytes, nops, visited, distinct = search_work(*args)
    b_ms, b_by = bound(nbytes, nops)

    def run():
        return range_search.find_next_packed_cuda(*args)

    return dict(shape=list(args[4].shape), max_abs_err=err, ms=event_ms(run, 10),
                ms_cold=cold_ms(run), sm_clock_mhz=sm_clock_mhz(), bound_ms=b_ms,
                bound_by=b_by, visited_chunks=visited, distinct_chunks=distinct,
                found_share=float(run()[1].float().mean()))


def phase_kernels_n2v(dev, kept):
    """Kernels 5 and 6 against their plain versions on the operands the
    order-2 main paths formed (kept in phase 4), plus edge cases, each
    timed in turns against the composition it replaced; and the windowed
    kernel 5 on the windows of the same rows."""
    rows = []
    codes, offsets, v, prev, u, dmax, inv_p, inv_q = [
        t.to(dev) if isinstance(t, torch.Tensor) else t for t in kept.pop("intersect_csr")]
    b = v.shape[0]
    csr = (codes, offsets, v, prev, u)
    got = intersect.factorized_csr_cuda(*csr, dmax, inv_p, inv_q)
    err = exact(got, intersect.factorized_csr_plain(*csr, dmax, inv_p, inv_q),
                "intersect_csr")
    cases = {"head": (csr[:2] + tuple(t[:1 << 16] for t in csr[2:]), dmax),
             "hubs-128": (csr_edge_case(128, dev), 128),
             "hubs-256": (csr_edge_case(256, dev), 256)}
    for p, q in ((0.25, 4.0), (4.0, 0.25), (1.0, 1.0)):
        w = intersect.inverse_weights(p, q)
        for name, (case, dm) in cases.items():
            exact(intersect.factorized_csr_cuda(*case, dm, *w),
                  intersect.factorized_csr_plain(*case, dm, *w),
                  f"intersect_csr {name} p={p} q={q}")
    del cases

    # the windowed kernel on the windows of the same rows (bytes: two u32
    # windows, u32 prev, two f32 uniforms; u32 nxt, found)
    def windows():
        return (intersect.neighbor_window(codes, offsets, v, dmax)[0],
                intersect.neighbor_window(codes, offsets, prev, dmax)[0])

    ug, ur = u[:, 0].contiguous(), u[:, 1].contiguous()
    wargs = (*windows(), prev, ug, ur)
    d = wargs[0].shape[1]
    got_w = intersect.factorized_cuda(*wargs, inv_p, inv_q)
    err_w = exact(got_w, intersect.factorized_plain(*wargs, inv_p, inv_q), "intersect")
    exact(got_w, got[:2], "windowed kernel != CSR kernel")
    edge = intersect_edge_rows(d, dev)
    head = [t[:1 << 16] for t in wargs]
    for p, q in ((0.25, 4.0), (4.0, 0.25), (1.0, 1.0)):
        w = intersect.inverse_weights(p, q)
        for case in (edge, head):
            exact(intersect.factorized_cuda(*case, *w),
                  intersect.factorized_plain(*case, *w), f"intersect p={p} q={q}")
    run = lambda: intersect.factorized_cuda(*wargs, inv_p, inv_q)  # noqa: E731
    kernel_row(rows, "intersect_next", err_w, run, event_ms(run, 20),
               event_ms(lambda: intersect.factorized_plain(*wargs, inv_p, inv_q), 1),
               8.0 * b * d + 17.0 * b, 30.0 * b * d, [b, d])
    del wargs, head, got_w

    def old_composition():
        nv, npv = windows()
        return intersect.factorized_cuda(nv, npv, prev, ug, ur, inv_p, inv_q)

    run = lambda: intersect.factorized_csr_cuda(*csr, dmax, inv_p, inv_q)  # noqa: E731
    t_csr, t_old = in_turns(run, old_composition, 20, 5)
    nbytes, nops, mean_entries = csr_work(offsets, v, prev, dmax)
    kernel_row(rows, "intersect_csr", err, run, sum(t_csr) / 2,
               event_ms(lambda: intersect.factorized_csr_plain(*csr, dmax, inv_p, inv_q), 1),
               nbytes, nops, [b, dmax], ms_turns=t_csr, old_composition_ms=t_old,
               mean_entries_per_segment=mean_entries,
               overflow_rows=int(got[2].sum()))
    del csr, got

    store, step = kept.pop("fused_rewalk_step")
    assert bool(step.pend_hit.any()) and bool((step.is_prefix & ~step.pend_hit).any()), \
        "the kept fused step has no pending hit or no FINDNEXT lane"
    got = megakernel.fused_step_cuda(store, step)
    err = exact(got, megakernel.fused_step_plain(store, step), "fused step")
    # every lane sampling; every FINDNEXT lane's window starting K-1 chunks
    # early (a hit in the first chunk moves to k = K-1); no pending hit
    z = torch.zeros_like(step.is_prefix)
    late = step._replace(lo=torch.where(step.is_prefix, (step.lo - (
        step.window - 1) * delta.CHUNK).clamp(min=0), step.lo))
    all_emit = step._replace(is_prefix=z)
    for name, var in (("all-emit", all_emit), ("hit-at-K-1", late),
                      ("no-pending", step._replace(pend_hit=z))):
        exact(megakernel.fused_step_cuda(store, var),
              megakernel.fused_step_plain(store, var), f"fused step {name}")
    nbytes, nops, n_find, n_emit = fused_work(store, step, got[0])
    nb_e, no_e, _, _ = fused_work(store, all_emit, got[0])

    def windows_of_lanes():   # what the fused scan built before every launch
        return (intersect.neighbor_window(step.codes, step.offsets, step.cur, step.dmax),
                intersect.neighbor_window(step.codes, step.offsets, step.prev, step.dmax))

    run = lambda: megakernel.fused_step_cuda(store, step)  # noqa: E731
    t_new, t_win = in_turns(run, windows_of_lanes, 10, 3)
    kernel_row(rows, "fused_rewalk_step", err, run, sum(t_new) / 2,
               event_ms(lambda: megakernel.fused_step_plain(store, step), 1),
               nbytes, nops, [step.cur.shape[0], step.dmax],
               findnext_lanes=n_find, emit_lanes=n_emit,
               overflow_lanes=int(got[2].sum()), k_window=step.window, ms_turns=t_new,
               window_build_ms=t_win,
               ms_all_emit=event_ms(lambda: megakernel.fused_step_cuda(store, all_emit), 10),
               bound_ms_all_emit=bound(nb_e, no_e)[0])
    return rows


def sgns_edge_cases(dev):
    """Rows with logits of exactly ±100 and all-zero rows (K = 5, D = 128),
    and random rows at B = 1, B = 13, K = 1, D = 64 and D = 256, entries
    N(0, 4/D) (rows of norm ~2, as in a maintained table; at unit entries
    the f32 roundings of the plain version alone exceed atol 1e-6)."""
    g = torch.Generator()
    g.manual_seed(11)

    def rnd(b, k, d):
        return [torch.randn(s, generator=g) * (2 / d ** 0.5)
                for s in ((b, d), (b, d), (b, k, d))]
    u, vp, vn = (torch.zeros(s) for s in ((6, 128), (6, 128), (6, 5, 128)))
    u[:4, 0] = 10.0
    vp[0, 0], vn[0, :, 0] = 10.0, -10.0                  # pos +100, negs -100
    vp[1, 0], vn[1, :, 0] = -10.0, 10.0                  # pos -100, negs +100
    vp[2, 0], vn[2, :, 0] = 10.0, 10.0
    vn[3, ::2, 0] = 10.0                                  # v+ zero, mixed negs
    cases = {"logits_pm100_and_zero_rows": [u, vp, vn], "B=1": rnd(1, 5, 128),
             "B=13": rnd(13, 5, 128), "K=1": rnd(4096, 1, 128),
             "D=64": rnd(4096, 5, 64), "D=256": rnd(4096, 5, 256)}
    return {k: [t.to(dev) for t in v] for k, v in cases.items()}


def sgns_err(got, want, what: str) -> float:
    """Hold kernel 7 to its plain version (loss rtol 1e-5; gradients rtol
    1e-5 / atol 1e-6: the kernel sums its dot products by warp shuffles,
    torch in another order) -> the largest absolute difference."""
    err = 0.0
    for name, g, w in zip(("loss", "du", "dvp", "dvn"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        tol = (dict(rtol=SGNS_LOSS_RTOL, atol=0.0) if name == "loss"
               else SGNS_GRAD_TOL)
        torch.testing.assert_close(g, w, msg=f"{what}: kernel != plain in {name}",
                                   **tol)
        err = max(err, float((g - w).abs().max()))
    return err


def phase_kernels_sgns(dev, kept):
    """Kernel 7 against its plain version on the operands the maintainer
    formed in its last timed batch (phase 3b), plus edge cases."""
    u, vp, vn = kept
    b, k, d = vn.shape
    err = sgns_err(sgns.sgns_cuda(u, vp, vn), sgns.sgns_plain(u, vp, vn), "sgns")
    edge = {name: sgns_err(sgns.sgns_cuda(*case), sgns.sgns_plain(*case), f"sgns {name}")
            for name, case in sgns_edge_cases(dev).items()}
    rows = []
    # bytes: u, v+ and K rows v- read once, du, dv+ and K rows dv- and the
    # loss written once (f32); operations a row: the K + 1 dot products,
    # du, dv+ and dv- ((5K + 4) D)
    run = lambda: sgns.sgns_cuda(u, vp, vn)  # noqa: E731
    kernel_row(rows, "sgns_step", err, run, event_ms(run, 20),
               event_ms(lambda: sgns.sgns_plain(u, vp, vn), 3),
               8.0 * (k + 2) * d * b + 4.0 * b, (5.0 * k + 4) * d * b, [b, k, d],
               edge_case_max_abs_err=edge)
    return rows


# ---------------------------------------------------------------- phase 6


def paper_setup():
    """Phase 6's configuration: wharf-stream's own config and shapes ->
    (config, stream_10k_mixed, order-1 WalkConfig, order-2 WalkConfig). The
    n2v shape overrides `order` and `sampler`, as the reference's cells."""
    arch = get_arch("wharf-stream")
    wcfg = arch.make_config()
    mixed = arch.shapes["stream_10k_mixed"]
    n2v = arch.shapes["stream_10k_n2v_factorized"]
    cfg2 = dataclasses.replace(wcfg, order=n2v["order"],
                               sampler=n2v["sampler"]).walk_config()
    return wcfg, mixed, wcfg.walk_config(), cfg2


def paper_engine(kind: str, graph, cfg, key, capacity: int, max_pending: int,
                 mixed=None):
    """One engine of the comparison on `graph`, its corpus from `key`."""
    if kind == "wharf":
        return WalkEngine(graph=graph, store=generate_corpus(key, graph, cfg),
                          cfg=cfg, merge_policy=mixed["merge_policy"],
                          merge_impl=mixed["merge_impl"],
                          rewalk_capacity=capacity, max_pending=max_pending)
    eng = {"ii": IIEngine, "tree": TreeEngine}[kind].create(key, graph, cfg)
    eng.rewalk_capacity = capacity
    return eng


def paper_batch(eng, stream, key, i: int) -> int:
    """Batch i of a stacked stream under fold_in(key, i) -> affected."""
    return int(eng.run_stream(jr.fold_in(key, i),
                              *(x[i:i + 1] for x in stream))[0])


def walk_matrix_of(eng) -> torch.Tensor:
    """The engine's walks as an int32 [n_walks, l] matrix: the II's
    sequences, the tree's owners by (walk, pos), Wharf's owners by slot
    f = w*l + p: every base triplet (f from its code, kernel 2), then the
    live pending row of each rewritten slot over it (no merge)."""
    if isinstance(eng, IIEngine):
        return eng.walks
    if isinstance(eng, TreeEngine):
        n_walks = eng.walk.shape[0] // eng.cfg.length
        m = torch.empty((n_walks, eng.cfg.length), dtype=torch.int32,
                        device=eng.walk.device)
        m[eng.walk.long(), eng.pos.long()] = eng.owner
        return m
    ov = eng.overlay()
    m = torch.empty(ov.row_of_slot.shape[0], dtype=torch.int32,
                    device=ov.base.device)
    m[ops.szudzik_unpair(ov.base.code)[0]] = ov.base.owner
    live = ov.row_of_slot >= 0
    m[live] = ov.owner[ov.row_of_slot[live].long()]
    return m.reshape(ov.base.n_walks, ov.base.length)


def overlay_walks(eng) -> torch.Tensor:
    """Wharf's walks read through the overlay (FINDNEXT from every walk's
    start, base and pending; kernels 1, 2 and 4), int32."""
    w = torch.arange(eng.store.n_walks, device=eng.store.device)
    start = walk_start_vertex(w, eng.cfg.n_walks_per_vertex)
    return eng.overlay().traverse(w, start, eng.cfg.length - 1).to(torch.int32)


def steps_are_edges(graph, a, b, what: str):
    """Every step a -> b an edge of `graph`, or an isolated vertex's
    self-step (the samplers' rule)."""
    a, b = a.reshape(-1).long(), b.reshape(-1).long()
    ok = graph.has_edge(a, b) | ((a == b) & (graph.degrees().long()[a] == 0))
    if not bool(ok.all()):
        raise AssertionError(f"{what}: {int((~ok).sum())} steps are not graph edges")


def tree_checks(tr) -> torch.Tensor:
    """Every (walk, pos) slot stored once; the columns lexsorted by
    (owner, walk, pos); each row's next the owner of its walk's next slot,
    the terminal slot pointing to itself; every step an edge -> the walk
    matrix."""
    length = tr.cfg.length
    slot = tr.walk.long() * length + tr.pos.long()
    if not torch.equal(torch.sort(slot).values,
                       torch.arange(slot.shape[0], device=slot.device)):
        raise AssertionError("tree: a (walk, pos) slot is not stored exactly once")
    key = tr.owner.long() * slot.shape[0] + slot
    if not bool((key[1:] > key[:-1]).all()):
        raise AssertionError("tree: the columns are not lexsorted")
    del slot, key
    m = walk_matrix_of(tr)
    nx = torch.empty_like(m)
    nx[tr.walk.long(), tr.pos.long()] = tr.nxt
    if not (torch.equal(nx[:, :-1], m[:, 1:]) and torch.equal(nx[:, -1], m[:, -1])):
        raise AssertionError("tree: a next is not the owner of the next slot")
    steps_are_edges(tr.graph, m[:, :-1], m[:, 1:], "tree")
    return m


def first_touched(walks, stream, i: int, n_vertices: int) -> torch.Tensor:
    """p_min of every walk for batch i's touched vertices (length where the
    walk has none): the II's MAV, scanning from the front."""
    touched = torch.zeros(n_vertices, dtype=torch.bool, device=walks.device)
    for x in stream:
        touched[x[i].long()] = True
    cols = torch.arange(walks.shape[1], device=walks.device)
    return torch.where(touched[walks.long()], cols, walks.shape[1]).amin(dim=1)


def ii_checks(before, ii, pm):
    """The walks the batch rewrote (p_min < l, every one of them: capacity
    = n_walks) keep columns 0..p_min, the others stay whole; every pair from
    the first rewritten column on is an edge of the current graph."""
    after, length = ii.walks, ii.walks.shape[1]
    cols = torch.arange(length, device=after.device)
    if not torch.equal(torch.where(cols <= pm[:, None], after, 0),
                       torch.where(cols <= pm[:, None], before, 0)):
        raise AssertionError("II: a column before a walk's p_min changed")
    new = cols[:-1] > pm[:, None]
    steps_are_edges(ii.graph, after[:, :-1][new], after[:, 1:][new], "II")


def ii_shifted_equal(ii_walks, tree_walks, pm) -> bool:
    """The reference's II writes at column p the vertex it samples at step p
    (the successor of p), the tree at p + 1: after one batch from one
    corpus and key at order 1, the II's row is the tree's up to p_min and
    the tree's shifted by one column after it."""
    length = ii_walks.shape[1]
    cols = torch.arange(length, device=ii_walks.device)
    src = torch.where(cols > pm[:, None], cols + 1, cols).clamp(max=length - 1)
    want = tree_walks.gather(1, src)
    keep = (cols < length - 1) | (pm[:, None] >= length - 1)
    return torch.equal(torch.where(keep, ii_walks, 0), torch.where(keep, want, 0))


def phase_paper(dev):
    """Phase 6 (see the module docstring). The counts are set to 0 before
    each engine is built and read just after its last batch."""
    c = PAPER
    wcfg, mixed, cfg1, cfg2 = paper_setup()
    n, log2_n = 1 << c["log2_n"], c["log2_n"]
    n_walks = n * cfg1.n_walks_per_vertex
    nb = mixed["n_batches"]
    seeds = c["seeds"]
    key_c, key_u = jr.PRNGKey(seeds["corpus"], dev), jr.PRNGKey(seeds["update"], dev)

    (src, dst), t_graph_draw = sync_time(lambda: er_edges(
        jr.PRNGKey(seeds["graph"], dev), c["graph_edges"], log2_n))
    stream, t_stream_draw = sync_time(lambda: mixed_edge_stream(
        jr.PRNGKey(seeds["stream"], dev), nb, mixed["batch_edges"],
        mixed["del_edges"], log2_n))
    n2v = edge_batch_stream(jr.PRNGKey(seeds["n2v_stream"], dev),
                            c["n2v_batches"], mixed["batch_edges"], log2_n)
    n2v = (*n2v, *[torch.zeros((c["n2v_batches"], 0), dtype=torch.int32,
                               device=dev)] * 2)
    # the card's draws = the CPU's: the whole stream, the graph's prefix
    cpu = torch.device("cpu")
    want = mixed_edge_stream(jr.PRNGKey(seeds["stream"], cpu), nb,
                             mixed["batch_edges"], mixed["del_edges"], log2_n)
    want += er_edges(jr.PRNGKey(seeds["graph"], cpu), c["cpu_prefix"], log2_n)
    got = (*stream, src[:c["cpu_prefix"]], dst[:c["cpu_prefix"]])
    for w, g in zip(want, got):
        if not torch.equal(w, g.cpu()):
            raise AssertionError("a generator's card draws != its CPU draws")
    graph = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"], device=dev)
    edges = int(graph.num_edges)
    del src, dst

    def run(kind, cfg, data, batches, path):
        """One engine over `batches` batches of `data`, freed on return ->
        (results, its walk matrices: at creation, then after each batch
        (the II: after batch 1 only), the II's p_min of batch 1)."""
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()    # ---- this engine, counted from here
        eng, t_create = sync_time(lambda: paper_engine(
            kind, graph, cfg, key_c, n_walks, c["max_pending"], mixed))
        mats, ms, affected, pm1 = [walk_matrix_of(eng)], [], [], None
        for i in range(batches):
            before = eng.walks if kind == "ii" else None
            aff, dt = sync_time(lambda: paper_batch(eng, data, key_u, i))
            ms.append(dt * 1e3)
            affected.append(aff)
            if kind == "ii":
                pm = first_touched(before, data, i, n)
                ii_checks(before, eng, pm)
                pm1 = pm if i == 0 else pm1
            if kind != "ii" or i == 0:
                mats.append(walk_matrix_of(eng))
        res = dict(create_s=t_create, batch_update_ms=ms, affected=affected)
        if kind == "wharf":
            # the read path: the overlay traverse = the triplets by slot
            if not torch.equal(overlay_walks(eng), mats[-1]):
                raise AssertionError("wharf: overlay traverse != the stored triplets")
            _, res["merge_s"] = sync_time(eng.merge)
            decoded = eng.store.packed_view().decode()
            if not torch.equal(decoded[:eng.store.size], eng.store.code):
                raise AssertionError("wharf: packed decode != code")
            del decoded
            res["nbytes"] = eng.store.nbytes_packed()
            res["nbytes_uncompressed"] = eng.store.nbytes_uncompressed()
        else:
            res["nbytes"] = eng.nbytes()
        launches[path] = dict(ops.launches)   # ---- read just after it
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if kind == "tree":
            tree_checks(eng)
        return res, mats, pm1

    launches, engines, checks = {}, {}, {}
    engines["wharf"], wharf_mats, _ = run("wharf", cfg1, stream, nb, "paper_wharf")
    engines["ii"], mats, pm = run("ii", cfg1, stream, nb, "paper_ii")
    checks["ii_equals_wharf_at_creation"] = torch.equal(mats[0], wharf_mats[0])
    checks["ii_shifted_equals_wharf_after_batch1"] = ii_shifted_equal(
        mats[1], wharf_mats[1], pm)
    engines["tree"], mats, _ = run("tree", cfg1, stream, nb, "paper_tree")
    checks["tree_equals_wharf_every_batch"] = all(
        torch.equal(a, b) for a, b in zip(mats, wharf_mats))
    del mats, wharf_mats
    checks["batch1_affected_equal"] = len({e["affected"][0] for e in engines.values()}) == 1
    checks["tree_affected_equals_wharf"] = (engines["tree"]["affected"]
                                            == engines["wharf"]["affected"])

    order2 = {}
    order2["ii"], ii_mats, _ = run("ii", cfg2, n2v, c["n2v_batches"], "paper_ii_n2v")
    order2["tree"], mats, _ = run("tree", cfg2, n2v, c["n2v_batches"], "paper_tree_n2v")
    checks["n2v_ii_equals_tree_at_creation"] = torch.equal(ii_mats[0], mats[0])
    del ii_mats, mats, graph
    checks["n2v_batch1_affected_equal"] = (order2["ii"]["affected"][0]
                                           == order2["tree"]["affected"][0])
    checks["small_card_equals_cpu"] = paper_small(dev, cfg1, cfg2)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 6 checks failed: {failed}")
    for k in ORDER1_KERNELS:
        assert launches["paper_wharf"][k] > 0, f"kernel {k} was not launched on Wharf's path"
    for p in ("paper_ii_n2v", "paper_tree_n2v"):
        assert launches[p]["intersect_csr"] > 0, f"kernel 5 was not launched on {p}"
    for p in launches:
        assert launches[p]["intersect_next"] == 0 and launches[p]["fused_rewalk_step"] == 0
    wb = engines["wharf"]["nbytes"]
    res = dict(config=dataclasses.asdict(wcfg), shape=mixed,
               n_vertices=n, n_walks=n_walks, edges=edges,
               graph_draw_s=t_graph_draw, stream_draw_s=t_stream_draw,
               engines=engines, order2=order2,
               nbytes_ratio={"tree_over_wharf": engines["tree"]["nbytes"] / wb,
                             "ii_over_wharf": engines["ii"]["nbytes"] / wb},
               checks=checks, launches=launches)
    log("reduced_paper", **PAPER_REDUCED)
    log("paper", **res)
    return res


def paper_small(dev, cfg1, cfg2) -> bool:
    """II and tree on a 2^12-vertex er graph, on the card and on the CPU
    from the same keys, order 1 and order 2: the same affected counts and
    state."""
    s = PAPER["small"]
    n = 1 << s["log2_n"]
    states = {}
    for d in (dev, torch.device("cpu")):
        src, dst = er_edges(jr.PRNGKey(7, d), s["graph_edges"], s["log2_n"])
        stream = mixed_edge_stream(jr.PRNGKey(8, d), s["n_batches"], s["n_ins"],
                                   s["n_del"], s["log2_n"])
        for kind, cls in (("ii", IIEngine), ("tree", TreeEngine)):
            for name, cfg in (("order1", cfg1), ("order2", cfg2)):
                cfg = cfg._replace(n_walks_per_vertex=s["n_walks_per_vertex"],
                                   length=s["length"])
                g = StreamingGraph.from_edges(src, dst, n, 1 << 17, device=d)
                eng = cls.create(jr.PRNGKey(9, d), g, cfg)
                eng.rewalk_capacity = n * cfg.n_walks_per_vertex
                aff = eng.run_stream(jr.PRNGKey(10, d), *stream).cpu().numpy()
                st = baseline_to_numpy(eng)
                st["affected"] = aff
                states.setdefault((kind, name), []).append(st)
    for key, (a, b) in states.items():
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"small {key}: card != cpu in {k}")
    return True



# ---------------------------------------------------------------- phase 7


def sharded_setup(log2_n: int, edge_capacity: int, max_pending: int, **over):
    """Phase 7b's configuration: `wharf-stream` and its stream_10k_sharded
    shape cut to 2^log2_n vertices, rewalk_capacity = n_walks (the slab,
    the config's default, follows it) -> (config, shape, WalkConfig,
    ShardSpec). `over` replaces more config fields (phase 7a)."""
    arch = get_arch("wharf-stream")
    shape = arch.shapes["stream_10k_sharded"]
    n = 1 << log2_n
    wcfg = arch.make_config()
    wcfg = dataclasses.replace(wcfg, n_vertices=n, edge_capacity=edge_capacity,
                               max_pending=max_pending, n_shards=SHARDED["shards"],
                               **over)
    wcfg = dataclasses.replace(wcfg, rewalk_capacity=n * wcfg.n_walks_per_vertex)
    return wcfg, shape, wcfg.walk_config(), wcfg.shard_spec()


def sharded_start(dev, wcfg, cfg, src, dst, corpus_seed: int):
    graph = StreamingGraph.from_edges(src, dst, wcfg.n_vertices, wcfg.edge_capacity,
                                      device=dev)
    return graph, generate_corpus(jr.PRNGKey(corpus_seed, dev), graph, cfg)


def rank_small(rank, p):
    """A rank of phase 7a: its shard of the same start state on the card and
    on the CPU, through the stream under both policies (and on-demand once
    with metrics); states, counters, collective calls and launches back."""
    p["wcfg"].select_backend(p["card"])
    out = {}
    for d in (torch.device(p["card"]), torch.device("cpu")):
        graph, store = sharded_start(d, p["wcfg"], p["cfg"], p["src"], p["dst"],
                                     p["seeds"]["corpus"])
        for name, policy, metrics in (("on-demand", "on-demand", False),
                                      ("eager", "eager", False),
                                      ("metrics", "on-demand", True)):
            st = local_shard_state(graph, store, p["spec"], rank,
                                   p["wcfg"].rewalk_capacity, p["wcfg"].max_pending)
            collectives.reset()
            ops.reset_launches()
            res = sharded_run_stream(
                st, jr.PRNGKey(p["seeds"]["update"], d), *p["stream"],
                cfg=p["cfg"]._replace(metrics=metrics), spec=p["spec"],
                capacity=p["wcfg"].rewalk_capacity,
                max_pending=p["wcfg"].max_pending, merge_policy=policy)
            out[d.type, name] = dict(
                state=state_to_numpy(res[0]), affected=res[1].cpu().numpy(),
                calls=dict(collectives.calls), launches=dict(ops.launches),
                metrics=ttree.tree_map(lambda t: t.cpu().numpy(), res[2]) if metrics else None)
    return out


def phase_sharded_small(dev, workdir):
    """Phase 7a: S = 4 gloo ranks on the card at 2^12 vertices, both merge
    policies and once with metrics: unsharded = the single-host card engine
    (graph, every store array, slot_epoch, traverse), per-shard card states
    = the same ranks' CPU states, metrics ON = OFF, combined counters card =
    CPU; then S = 1 on NCCL = the single-host engine."""
    c = SHARDED["small"]
    seeds = SHARDED["seeds"]
    wcfg, _, cfg, spec = sharded_setup(
        c["log2_n"], c["edge_capacity"], c["max_pending"],
        n_walks_per_vertex=c["n_walks_per_vertex"], length=c["length"])
    cpu = torch.device("cpu")
    src, dst = er_edges(jr.PRNGKey(seeds["graph"], cpu), c["graph_edges"], c["log2_n"])
    stream = mixed_edge_stream(jr.PRNGKey(seeds["stream"], cpu), c["n_batches"],
                               c["n_ins"], c["n_del"], c["log2_n"])
    p = dict(card=dev.type, wcfg=wcfg, cfg=cfg, spec=spec, seeds=seeds, src=src.numpy(),
             dst=dst.numpy(), stream=[a.numpy() for a in stream])
    nb, cap = c["n_batches"], wcfg.rewalk_capacity

    def single_host(policy):
        graph, store = sharded_start(dev, wcfg, cfg, p["src"], p["dst"], seeds["corpus"])
        eng = WalkEngine(graph=graph, store=store, cfg=cfg, merge_policy=policy,
                         rewalk_capacity=cap, max_pending=wcfg.max_pending)
        aff = eng.run_stream(jr.PRNGKey(seeds["update"], dev), *p["stream"])
        eng.merge()
        return eng, aff.cpu().numpy()

    def same_as_single_host(states, eng, aff, what):
        graph, store, ovf = unshard_state(states, wcfg.edge_capacity)
        assert not ovf, f"{what}: overflow"
        assert torch.equal(graph.codes, eng.graph.codes), f"{what}: graph codes"
        for f in dataclasses.fields(store):
            a, b = getattr(store, f.name), getattr(eng.store, f.name)
            same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            assert same, f"{what}: unsharded store.{f.name} != single-host"
        w = torch.arange(store.n_walks, device=dev)
        start = walk_start_vertex(w, cfg.n_walks_per_vertex)
        assert torch.equal(store.traverse(w, start, cfg.length - 1),
                           eng.store.traverse(w, start, cfg.length - 1)), \
            f"{what}: traverse"

    results = ranks.spawn(rank_small, SHARDED["shards"], p, workdir, backend="gloo",
                          threads=2)
    checks = {}
    for name in ("on-demand", "eager"):
        eng, aff = single_host(name)
        for r, res in enumerate(results):
            card, host = res[dev.type, name], res["cpu", name]
            for k in card["state"]:
                if not np.array_equal(card["state"][k], host["state"][k]):
                    raise AssertionError(f"7a {name}: shard {r} card != cpu in {k}")
            if not np.array_equal(card["affected"], aff):
                raise AssertionError(f"7a {name}: shard {r} affected != single-host")
            want = {"all_reduce": nb, "all_to_all": nb * cfg.length}
            assert card["calls"] == want, (name, r, card["calls"])
        states = [convert.state_from_numpy(res[dev.type, name]["state"], dev)
                  for res in results]
        same_as_single_host(states, eng, aff, f"7a {name}")
        checks[f"{name}_unsharded_equals_single_host"] = True
    for r, res in enumerate(results):
        on, off = res[dev.type, "metrics"]["state"], res[dev.type, "on-demand"]["state"]
        for k in on:
            if not np.array_equal(on[k], off[k]):
                raise AssertionError(f"7a: metrics ON != OFF on shard {r} in {k}")
    summ = {}
    for d in (dev.type, "cpu"):
        ms = [res[d, "metrics"]["metrics"] for res in results]
        summ[d] = export.summary(ttree.tree_map(
            lambda *ls: torch.stack([torch.from_numpy(np.asarray(x)) for x in ls]), *ms))
    assert summ[dev.type] == summ["cpu"], "7a: combined counters card != cpu"
    checks.update(metrics_on_equals_off=True, counters_card_equal_cpu=True)
    launches = {k: sum(res[dev.type, "on-demand"]["launches"][k] for res in results)
                for k in ops.KERNELS}
    for k in ("szudzik_pair", "szudzik_unpair"):
        assert launches[k] > 0, f"7a: kernel {k} was not launched by the card ranks"

    # S = 1 on NCCL: the route each rank takes when it has a card of its own
    eng, aff = single_host("on-demand")
    spec1 = wcfg.shard_spec(1)
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]   # gloo: a CPU rehearsal
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        tempfile.mkdtemp(prefix="nccl_", dir=workdir), "rendezvous"),
        world_size=1, rank=0)
    try:
        graph, store = sharded_start(dev, wcfg, cfg, p["src"], p["dst"], seeds["corpus"])
        st = local_shard_state(graph, store, spec1, 0, cap, wcfg.max_pending)
        st, aff1 = sharded_run_stream(st, jr.PRNGKey(seeds["update"], dev), *p["stream"],
                                      cfg=cfg, spec=spec1, capacity=cap,
                                      max_pending=wcfg.max_pending)
        assert dist.get_backend() == backend
    finally:
        dist.destroy_process_group()
    assert np.array_equal(aff1.cpu().numpy(), aff), "7a NCCL: affected"
    same_as_single_host([st], eng, aff, "7a NCCL S=1")
    checks["nccl_s1_equals_single_host"] = True
    log("sharded_small", ok=True, n_vertices=wcfg.n_vertices, shards=spec.n_shards,
        batches=nb, spec=dataclasses.asdict(spec), checks=checks, summary=summ[dev.type],
        launches_card_ranks=launches)
    return checks


def rank_full(rank, p):
    """A rank of phase 7b. It builds the start state in its turn (the ranks
    one after another, to bound the card's peak), keeps its shard, runs the
    batches (each bracketed by barriers and synchronized) and the closing
    merge, and holds its shard against its range of the single-host
    engine's merged state, read from the .npy files under p["ref"]."""
    wcfg, cfg, spec, seeds = p["wcfg"], p["cfg"], p["spec"], p["seeds"]
    wcfg.select_backend(p["card"])
    dev = torch.device(p["card"])
    n, cap = wcfg.n_vertices, wcfg.rewalk_capacity
    for k in range(spec.n_shards):
        if k == rank:
            src, dst = er_edges(jr.PRNGKey(seeds["graph"], dev), p["graph_edges"],
                                p["log2_n"])
            graph, store = sharded_start(dev, wcfg, cfg, src, dst, seeds["corpus"])
            state = local_shard_state(graph, store, spec, rank, cap, wcfg.max_pending)
            del src, dst, graph, store
            torch.cuda.empty_cache()
        dist.barrier()
    stream = mixed_edge_stream(jr.PRNGKey(seeds["stream"], dev), p["n_batches"],
                               p["shape"]["batch_edges"], p["shape"]["del_edges"],
                               p["log2_n"])
    keys = jr.split(jr.PRNGKey(seeds["update"], dev), p["n_batches"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset()
    collectives.set_timing(True)
    ops.reset_launches()    # ---- the sharded path, counted from here
    batches = []
    for i in range(p["n_batches"]):
        dist.barrier()
        torch.cuda.synchronize()
        sec0 = dict(collectives.seconds)
        t0 = time.perf_counter()
        state = sharded_stream_step(state, keys[i], *(x[i] for x in stream), cfg, cap,
                                    spec, rank, wcfg.max_pending,
                                    p["shape"]["merge_policy"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        free, total = torch.cuda.mem_get_info()
        batches.append(dict(
            ms=ms, affected=int(state.last_affected), n_pending=state.n_pending,
            all_reduce_ms=(collectives.seconds["all_reduce"] - sec0["all_reduce"]) * 1e3,
            all_to_all_ms=(collectives.seconds["all_to_all"] - sec0["all_to_all"]) * 1e3,
            card_used_gb=(total - free) / 1e9, **block_handoff(state, rank, spec)))
        dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = consolidate(state)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.launches)   # ---- read just after it
    calls = dict(collectives.calls)
    collectives.set_timing(False)
    peak = dict(allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    return dict(batches=batches, merge_ms=merge_ms, launches=launches, calls=calls,
                peak=peak, overflow=bool(state.overflow),
                checks=shard_equals_reference(state, rank, spec, p["ref"], n))


def block_handoff(state, rank, spec) -> dict:
    """The lanes this shard handed on in the batch just run, read from its
    version block (the pending row just written; on-demand): a non-terminal
    emitted triplet is a lane routed to the owner of its next vertex, and
    crosses shards when that is not this shard. The plain unpair (no kernel
    launch) gives the next vertex."""
    j = state.n_pending - 1
    length = state.store.length
    sel = torch.nonzero(state.pending.epoch[j] != PAD_EPOCH).reshape(-1)
    sel = sel[(sel % length) < length - 1]
    _, nxt = pairing.szudzik_unpair(state.pending.code[j][sel])
    cross = int((nxt // spec.vps != rank).sum())
    return dict(handoff_sent=int(sel.numel()), handoff_cross=cross)


def shard_equals_reference(state, rank, spec, ref, n) -> dict:
    """This shard against its vertex range of the single-host merged state:
    the live edge codes, the live triplet rows (and pads after them), the
    replicated slot_epoch, bit for bit."""
    dev = state.store.device
    lo, hi = rank * spec.vps, min((rank + 1) * spec.vps, n)
    load = lambda name: np.load(os.path.join(ref, name + ".npy"), mmap_mode="r")  # noqa: E731
    codes = load("graph_codes")
    bounds = edge_code(torch.tensor([lo, hi]), torch.tensor([0, 0])).numpy()
    a, b = np.searchsorted(codes, bounds)
    g = state.graph
    want = torch.from_numpy(np.array(codes[a:b])).to(dev)
    graph_ok = (int(g.num_edges) == b - a
                and torch.equal(g.codes[:b - a], want)
                and bool((g.codes[b - a:] == SENTINEL).all()))
    offsets = load("offsets")
    a, b = int(offsets[lo]), int(offsets[hi])
    st = state.store
    store_ok = int(st.offsets[n]) == b - a
    for f, pad in (("owner", n), ("code", SENTINEL), ("epoch", PAD_EPOCH)):
        want = torch.from_numpy(np.array(load(f)[a:b])).to(dev)
        col = getattr(st, f)
        store_ok = store_ok and torch.equal(col[:b - a], want) and bool(
            (col[b - a:] == pad).all())
    slot_ok = torch.equal(st.slot_epoch,
                          torch.from_numpy(np.array(load("slot_epoch"))).to(dev))
    return dict(graph=graph_ok, store=store_ok, slot_epoch=slot_ok)


def phase_sharded_full(dev, workdir):
    """Phase 7b: wharf-stream's stream_10k_sharded shape at full width with
    S = 4 gloo ranks on the one card, against the single-host card engine
    run first on the same config and keys (its merged state kept on the
    host, its card memory freed before the ranks start)."""
    c = SHARDED["full"]
    seeds = SHARDED["seeds"]
    wcfg, shape, cfg, spec = sharded_setup(c["log2_n"], c["edge_capacity"],
                                           c["max_pending"])
    n, nb, cap = wcfg.n_vertices, c["n_batches"], wcfg.rewalk_capacity

    torch.cuda.reset_peak_memory_stats()
    (src, dst), _ = sync_time(lambda: er_edges(jr.PRNGKey(seeds["graph"], dev),
                                               c["graph_edges"], c["log2_n"]))
    graph, store = sharded_start(dev, wcfg, cfg, src, dst, seeds["corpus"])
    del src, dst
    stream = mixed_edge_stream(jr.PRNGKey(seeds["stream"], dev), nb,
                               shape["batch_edges"], shape["del_edges"], c["log2_n"])
    eng = WalkEngine(graph=graph, store=store, cfg=cfg,
                     merge_policy=shape["merge_policy"], rewalk_capacity=cap,
                     max_pending=wcfg.max_pending)
    del graph, store
    aff, t_single = sync_time(lambda: eng.run_stream(jr.PRNGKey(seeds["update"], dev),
                                                     *stream))
    _, t_merge = sync_time(eng.merge)
    assert not eng.mav_overflowed
    ref = tempfile.mkdtemp(prefix="reference_", dir=workdir)
    g = eng.graph
    arrays = dict(graph_codes=g.codes[:int(g.num_edges)], offsets=eng.store.offsets,
                  owner=eng.store.owner, code=eng.store.code, epoch=eng.store.epoch,
                  slot_epoch=eng.store.slot_epoch)
    for name, t in arrays.items():
        np.save(os.path.join(ref, name + ".npy"), t.cpu().numpy())
    single = dict(run_stream_s=t_single, merge_s=t_merge,
                  affected=aff.cpu().tolist(),
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng, g, arrays, stream
    torch.cuda.empty_cache()

    p = dict(card=dev.type, wcfg=wcfg, cfg=cfg, spec=spec, seeds=seeds, shape=shape, ref=ref,
             n_batches=nb, log2_n=c["log2_n"], graph_edges=c["graph_edges"])
    results, t_ranks = sync_time(lambda: ranks.spawn(
        rank_full, spec.n_shards, p, workdir, backend="gloo", threads=2))
    checks = {"no_overflow": not any(r["overflow"] for r in results)}
    for k in ("graph", "store", "slot_epoch"):
        checks[f"unsharded_{k}_equals_single_host"] = all(r["checks"][k] for r in results)
    checks["affected_equal"] = all(
        [b["affected"] for b in r["batches"]] == single["affected"] for r in results)
    checks["collectives_per_batch"] = all(
        r["calls"] == {"all_reduce": nb, "all_to_all": nb * cfg.length} for r in results)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 7b checks failed: {failed}")
    launches = {k: sum(r["launches"][k] for r in results) for k in ops.KERNELS}
    for k in ("szudzik_pair", "szudzik_unpair"):
        assert launches[k] > 0, f"kernel {k} was not launched on the sharded path"
    per = [[r["batches"][i] for r in results] for i in range(nb)]
    sent = [sum(b["handoff_sent"] for b in bs) for bs in per]
    cross = [sum(b["handoff_cross"] for b in bs) for bs in per]
    res = dict(
        config=dataclasses.asdict(wcfg), shape=shape, spec=dataclasses.asdict(spec),
        n_batches=nb, single_host=single, ranks_s=t_ranks,
        batch_ms_max_over_ranks=[max(b["ms"] for b in bs) for bs in per],
        all_reduce_ms_max_over_ranks=[max(b["all_reduce_ms"] for b in bs) for bs in per],
        all_to_all_ms_max_over_ranks=[max(b["all_to_all_ms"] for b in bs) for bs in per],
        collectives="gloo on one card: CUDA tensors staged through host memory "
                    "inside gloo's calls, not NCCL across cards",
        merge_ms_max_over_ranks=max(r["merge_ms"] for r in results),
        handoff_sent=sent, handoff_cross=cross,
        handoff_cross_share=[x / max(y, 1) for x, y in zip(cross, sent)],
        rank_peak=[r["peak"] for r in results],
        card_used_gb_max=max(b["card_used_gb"] for r in results for b in r["batches"]),
        per_rank_batches=[r["batches"] for r in results],
        checks=checks, launches=launches)
    log("reduced_sharded", **SHARDED_REDUCED)
    log("sharded", **res)
    return res


# ---------------------------------------------------------------- phase 8


def register_trainer_config() -> str:
    """Register TRAINER's cut copy of wharf-stream for this process only
    (the package's `wharf-stream` stays as it is) -> its name."""
    t = TRAINER
    register(ArchSpec(
        name=t["arch"], family="wharf", shapes=WHARF_SHAPES,
        make_config=lambda smoke=False: WharfStreamConfig(
            name=t["arch"], n_vertices=1 << t["log2_n"],
            edge_capacity=t["edge_capacity"], max_pending=t["max_pending"],
            batch_edges=t["batch_edges"], rewalk_capacity=t["rewalk_capacity"]),
        notes="wharf-stream cut in scale to one H100 (chip_smoke.py phase 8b)"))
    return t["arch"]


def build_trainer(mode: str, arch: str, smoke: bool, dev, ckpt_dir: str,
                  ckpt_every: int, keep: int, batch_edges: int, dim: int = 64,
                  max_pairs: int = 1 << 16) -> dict:
    """The launcher's trainer for `mode` ("downstream" or "stream") on
    `dev` and its TrainLoop, as a (re)started process builds them."""
    on_restore = None
    if mode == "downstream":
        state, step_fn, batch_fn, on_restore = launch.downstream_trainer(
            arch, smoke, batch_edges, dim, max_pairs, device=dev)
    else:
        state, step_fn, batch_fn = launch.wharf_trainer(arch, smoke, batch_edges,
                                                        device=dev)
    loop = TrainLoop(step_fn=step_fn, batch_fn=batch_fn,
                     ckpt=CheckpointManager(ckpt_dir, keep=keep),
                     ckpt_every=ckpt_every, on_restore=on_restore, device=dev)
    # the walk engine of the step closure (the stream mode's carry holds
    # only the store's codes)
    held = inspect.getclosurevars(step_fn).nonlocals
    engine = ((lambda: held["mt"].state.engine) if mode == "downstream"
              else (lambda: held["engine"].state))
    return dict(loop=loop, state=state, engine=engine)


def run_trainer(tr: dict, steps: int, resume: bool = False) -> dict:
    """`steps` TrainLoop steps of a built trainer, after `loop.resume` when
    asked -> the final carry, per-step metrics and synced ms, the first
    step, the restore's seconds."""
    loop, state = tr["loop"], tr.pop("state")
    start, restore_s = 0, None
    if resume:
        (state, start), restore_s = sync_time(lambda: loop.resume(state))
    metrics, ms = {}, {}

    def on_metrics(step, dt, m):
        metrics[step] = m
        ms[step] = dt * 1e3

    state = loop.run(state, start, steps, on_metrics)
    return dict(state=state, metrics=metrics, ms=ms, start=start, restore_s=restore_s,
                engine=tr["engine"](), saves=loop.ckpt.saves,
                stragglers=loop.straggler.events)


def metrics_match(got: dict, want: dict, what: str) -> None:
    """Per-step metrics equal, the f32 loss within SGNS_LOSS_RTOL (the
    loop's straggler flag is a matter of timing, not compared)."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for step, m in want.items():
        g = {k: v for k, v in got[step].items() if k != "straggler"}
        m = {k: v for k, v in m.items() if k != "straggler"}
        assert set(g) == set(m), (what, step)
        for k, v in m.items():
            if k == "loss":
                assert abs(g[k] - v) <= SGNS_LOSS_RTOL * abs(v), (what, step, k)
            else:
                assert g[k] == v, (what, step, k, g[k], v)


def engines_equal(a, b, what: str) -> None:
    sa, sb = state_to_numpy(a), state_to_numpy(b)
    for k in sb:
        if not np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])):
            raise AssertionError(f"{what}: engines differ in {k}")


def tables_close(a: dict, b: dict, what: str) -> None:
    for k in ("in", "out"):
        torch.testing.assert_close(a[k].cpu(), b[k].cpu(), **TABLE_TOL,
                                   msg=lambda m: f"{what}, table {k}: {m}")


def carries_equal(a, b, what: str) -> None:
    """Every leaf of two carries (tensors and host ints) bit for bit."""
    want = ttree.leaf_paths(b)
    for k, v in ttree.leaf_paths(a).items():
        w = want[k]
        same = (torch.equal(v, w.to(v.device)) if isinstance(v, torch.Tensor)
                else v == w and type(v) is type(w))
        if not same:
            raise AssertionError(f"{what}: leaf {k} differs")


def phase_trainer_small(dev, workdir):
    """Phase 8a: the launcher's two wharf modes at the `wharf-stream` smoke
    config through TrainLoop (6 steps, a checkpoint every 3) on the card
    and on the CPU with the same keys, and a crash after step 2 followed
    by a fresh downstream trainer that resumes."""
    t = TRAINER["small"]
    kw = dict(ckpt_every=t["ckpt_every"], keep=3, batch_edges=t["batch_edges"],
              dim=t["dim"])
    runs = {}
    for d in (torch.device("cpu"), dev):
        for mode in ("downstream", "stream"):
            tr = build_trainer(mode, "wharf-stream", True, d,
                               tempfile.mkdtemp(prefix=f"{mode}_", dir=workdir), **kw)
            runs[d.type, mode] = run_trainer(tr, t["steps"])
        ck = tempfile.mkdtemp(prefix="resume_", dir=workdir)
        first = run_trainer(build_trainer("downstream", "wharf-stream", True, d, ck, **kw),
                            t["crash_after"])
        runs[d.type, "resumed"] = run_trainer(
            build_trainer("downstream", "wharf-stream", True, d, ck, **kw),
            t["steps"] - t["crash_after"], resume=True)
        runs[d.type, "first"] = first
    for mode in ("downstream", "stream"):
        cpu, card = runs["cpu", mode], runs[dev.type, mode]
        metrics_match(card["metrics"], cpu["metrics"], f"8a {mode}: card vs cpu")
        engines_equal(card["engine"], cpu["engine"], f"8a {mode}: card vs cpu")
    cpu, card = runs["cpu", "downstream"], runs[dev.type, "downstream"]
    tables_close(card["state"].params, cpu["state"].params, "8a: card vs cpu")
    for k in ("step", "pairs"):
        assert int(card["state"].opt[k]) == int(cpu["state"].opt[k]), k
    for d in ("cpu", dev.type):
        full, res = runs[d, "downstream"], runs[d, "resumed"]
        assert res["start"] == t["crash_after"], res["start"]
        metrics_match({**runs[d, "first"]["metrics"], **res["metrics"]}, full["metrics"],
                      f"8a resumed ({d})")
        if d == "cpu":
            carries_equal(res["state"], full["state"], "8a: resumed vs uninterrupted (cpu)")
        else:
            engines_equal(res["state"].engine, full["state"].engine,
                          "8a: resumed vs uninterrupted (card)")
            carries_equal(res["state"].opt, full["state"].opt, "8a: opt (card)")
            tables_close(res["state"].params, full["state"].params,
                         "8a: resumed vs uninterrupted (card)")
    log("trainer_small", ok=True, steps=t["steps"], crash_after=t["crash_after"],
        affected=[m["affected_walks"] for m in card["metrics"].values()],
        pairs=[m["pairs"] for m in card["metrics"].values()],
        stream_affected=[m["affected_walks"]
                         for m in runs[dev.type, "stream"]["metrics"].values()],
        ms_card=list(card["ms"].values()), ms_cpu=list(cpu["ms"].values()))


def nbytes_of(tree) -> int:
    """Bytes of a carry's leaves as a checkpoint stores them (an int as 8)."""
    return sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 8
               for v in ttree.tree_leaves(tree))


def phase_trainer(dev, workdir):
    """Phase 8b: the launcher's `--mode downstream` at full width (TRAINER:
    wharf-stream cut to 2^18 vertices, registered here), 6 uninterrupted
    steps with the counts set to 0 just before and read just after (an
    async save after step 3 runs beside steps 4-5); then a loop of 3 steps
    and a fresh trainer that resumes from its committed checkpoint and
    runs 3 more, every leaf of its engine and opt equal to the kept
    uninterrupted state's; then `--mode stream` for 3 steps."""
    t = TRAINER
    arch = register_trainer_config()
    kw = dict(ckpt_every=t["ckpt_every"], keep=t["keep"], batch_edges=t["batch_edges"],
              dim=t["dim"], max_pairs=t["max_pairs"])
    cap = t["rewalk_capacity"]
    torch.cuda.reset_peak_memory_stats()
    d_full = tempfile.mkdtemp(prefix="ckpt_full_", dir=workdir)
    tr, build_s = sync_time(lambda: build_trainer("downstream", arch, False, dev, d_full, **kw))
    ckpt_bytes = nbytes_of(tr["state"])
    free = shutil.disk_usage(workdir).free
    log("trainer_disk", workdir_free_bytes=free, checkpoint_bytes=ckpt_bytes,
        keep=t["keep"])
    need = (t["keep"] + 1) * ckpt_bytes
    if free < need:
        raise RuntimeError(f"phase 8b: {free / 1e9:.1f} GB free under {workdir}, "
                           f"the checkpoints need {need / 1e9:.1f} GB")
    ops.reset_launches()    # ---- the trainer's steps, counted from here
    full = run_trainer(tr, t["steps"])
    launches = dict(ops.launches)   # ---- read just after them
    peak = torch.cuda.max_memory_allocated() / 1e9
    del tr
    steps_m = full["metrics"]
    affected = [m["affected_walks"] for m in steps_m.values()]
    assert max(affected) < cap, f"an affected count reached rewalk_capacity {cap}"
    assert not bool(full["state"].engine.overflow), "MAV gather overflow"
    for k in ("szudzik_pair", "szudzik_unpair", "find_next_packed", "sgns_step"):
        assert launches[k] > 0, f"kernel {k} was not launched on the trainer path"
    for k in ("intersect_next", "intersect_csr", "fused_rewalk_step"):
        assert launches[k] == 0, f"kernel {k} was launched on the trainer path"
    kept = full.pop("state")     # on the card (13 GB) for the comparison below
    full.pop("engine")
    shutil.rmtree(d_full, ignore_errors=True)
    torch.cuda.empty_cache()

    # the pair saves only where each leg ends: the first leg's closing save
    # is the checkpoint the fresh trainer resumes from
    kw_pair = dict(kw, ckpt_every=t["steps"] + 1)
    d_pair = tempfile.mkdtemp(prefix="ckpt_pair_", dir=workdir)
    first = run_trainer(build_trainer("downstream", arch, False, dev, d_pair, **kw_pair),
                        t["crash_after"])
    first.pop("state"), first.pop("engine")
    torch.cuda.empty_cache()
    res = run_trainer(build_trainer("downstream", arch, False, dev, d_pair, **kw_pair),
                      t["steps"] - t["crash_after"], resume=True)
    assert res["start"] == t["crash_after"], res["start"]
    metrics_match({**first["metrics"], **res["metrics"]}, full["metrics"],
                  "8b: resumed vs uninterrupted")
    st = res.pop("state")
    res.pop("engine")
    carries_equal(st.engine, kept.engine, "8b: resumed vs uninterrupted engine")
    carries_equal(st.opt, kept.opt, "8b: opt")
    tables_close(st.params, kept.params, "8b: resumed vs uninterrupted")
    finite = all(bool(torch.isfinite(v).all()) for v in st.params.values())
    assert finite, "a table holds a non-finite value"
    del st, kept
    shutil.rmtree(d_pair, ignore_errors=True)
    torch.cuda.empty_cache()

    d_stream = tempfile.mkdtemp(prefix="ckpt_stream_", dir=workdir)
    stream = run_trainer(build_trainer("stream", arch, False, dev, d_stream, **kw),
                         t["stream_steps"])
    stream.pop("state"), stream.pop("engine")
    shutil.rmtree(d_stream, ignore_errors=True)
    torch.cuda.empty_cache()
    out = dict(
        config=dataclasses.asdict(get_arch(arch).make_config()), dim=t["dim"],
        max_pairs=t["max_pairs"], build_s=build_s, checkpoint_bytes=ckpt_bytes,
        step_ms=list(full["ms"].values()), stragglers=full["stragglers"],
        affected_walks=affected, pairs=[m["pairs"] for m in steps_m.values()],
        loss_per_pair=[m["loss"] / max(m["pairs"], 1) for m in steps_m.values()],
        saves=full["saves"], peak_mem_gb=peak,
        resumed=dict(first_ms=list(first["ms"].values()), ms=list(res["ms"].values()),
                     restore_s=res["restore_s"], saves=first["saves"] + res["saves"],
                     stragglers=first["stragglers"] + res["stragglers"]),
        stream=dict(ms=list(stream["ms"].values()), saves=stream["saves"],
                    affected_walks=[m["affected_walks"] for m in stream["metrics"].values()]),
        launches=launches,
        checks=dict(resumed_engine_equals_uninterrupted=True, opt_exact=True,
                    tables_within_tolerance=True, affected_below_capacity=True,
                    no_overflow=True))
    log("reduced_trainer", **TRAINER_REDUCED)
    log("trainer", **out)
    return out


def quality_run(d, q: dict, maintain: bool = True) -> dict:
    """tests/test_downstream.py::test_incremental_matches_full_retrain at
    the sizes `q` on device `d`: the warm retrain, the maintainer's
    incremental stream and the probe of its table, then the full retrain
    of the final corpus and its probe. With `maintain=False` (the CPU
    half at cora_like's size) a plain engine takes the maintainer's
    place, on the same update keys (the maintainer's engine equals it bit
    for bit, phase 2), and only the full retrain and its probe run: the
    plain versions' SGNS pairs of the stream (780k a batch) take ~2 min on
    the CPU."""
    n, n_w = q["n_vertices"], q["n_walks_per_vertex"]
    key = jr.PRNGKey(0, d)
    (src, dst), labels, _ = cora_like(key, n_vertices=n, n_edges=q["n_edges"],
                                      n_classes=q["n_classes"])
    n_stream = q["snapshots"] * q["n_batches"] * q["batch_edges"]
    n0 = src.shape[0] - n_stream
    wcfg = WalkConfig(n_walks_per_vertex=n_w, length=q["length"])
    scfg = SGNSConfig(n_vertices=n, dim=q["dim"], window=q["window"],
                      n_negative=q["n_negative"])

    def retrain(walks, seed):
        p = sgns_init(jr.PRNGKey(seed, d), scfg)
        k = jr.PRNGKey(seed, d)
        for _ in range(q["epochs"]):
            k, kk = jr.split(k)
            p, _ = train_epoch(kk, p, walks, scfg, batch=q["batch"])
        return p

    g = StreamingGraph.from_edges(src[:n0], dst[:n0], n, q["edge_capacity"], device=d)
    store = generate_corpus(jr.PRNGKey(1, d), g, wcfg)
    out = {}
    if maintain:
        mcfg = MaintainerConfig(walk=wcfg, n_vertices=n, dim=q["dim"], window=q["window"],
                                n_negative=q["n_negative"], rewalk_capacity=n * n_w,
                                lr=q["lr"])
        mt = EmbeddingMaintainer(graph=g, store=store, cfg=mcfg, key=jr.PRNGKey(2, d))
        w0 = mt.engine_view().walk_matrix()
        warm, out["warm_retrain_s"] = sync_time(lambda: retrain(w0, 3))
        mt.load_state(mt.state._replace(params=warm))
        stream = mt.run_stream
    else:
        eng = WalkEngine(graph=g, store=store, cfg=wcfg, rewalk_capacity=n * n_w)
        w0 = eng.walk_matrix()
        stream = eng.run_stream
    pairs_inc, t_inc, counts = 0, 0.0, []
    for snap in range(q["snapshots"]):
        lo = n0 + snap * q["n_batches"] * q["batch_edges"]
        hi = lo + q["n_batches"] * q["batch_edges"]
        m, dt = sync_time(lambda: stream(
            jr.fold_in(key, 10 + snap), src[lo:hi].reshape(q["n_batches"], -1),
            dst[lo:hi].reshape(q["n_batches"], -1)))
        t_inc += dt
        if maintain:
            pairs_inc += int(m.n_pairs.sum())
            counts.append((m.n_affected.tolist(), m.n_pairs.tolist()))
    if maintain:
        assert not mt.mav_overflowed, "MAV gather overflow"
        out.update(acc_inc=logistic_eval(mt.embeddings, labels), pairs_inc=pairs_inc,
                   incremental_s=t_inc, counts=counts,
                   tables={k: v.cpu() for k, v in mt.params.items()})
        w1 = mt.engine_view().walk_matrix()
    else:
        assert not eng.mav_overflowed, "MAV gather overflow"
        out["engine_stream_s"] = t_inc
        w1 = eng.walk_matrix()
    full, out["full_retrain_s"] = sync_time(lambda: retrain(w1, 100))
    out["acc_full"] = logistic_eval(full["in"], labels)
    out["full_pairs"] = q["epochs"] * window_pairs(w1, q["window"])[0].shape[0]
    out["walks"] = (w0.cpu(), w1.cpu())
    return out


def phase_quality(dev):
    """Phase 8c: the paper's downstream-quality check (§7.6) at cora_like's
    own sizes: on the card the whole check, on the CPU the engine and the
    full retrain (`quality_run`'s `maintain=False`). The walk matrices
    card = CPU, the incremental embeddings' accuracy within QUALITY["gap"]
    of a full retrain's on the card, with fewer pairs trained than one
    full retrain of the final corpus. Then the whole check at the
    reference test's sizes on the card and on the CPU: walks, affected
    and pair counts equal, the maintainer's tables within TABLE_TOL."""
    cpu_dev = torch.device("cpu")
    card = quality_run(dev, QUALITY)
    cpu = quality_run(cpu_dev, QUALITY, maintain=False)
    for a, b in zip(card.pop("walks"), cpu.pop("walks")):
        assert torch.equal(a, b), "8c: card and CPU walk matrices differ"
    q = QUALITY
    assert card["acc_inc"] >= card["acc_full"] - q["gap"], (card["acc_inc"], card["acc_full"])
    assert card["pairs_inc"] < card["full_pairs"], (card["pairs_inc"], card["full_pairs"])
    small = {"card": quality_run(dev, QUALITY_SMALL),
             "cpu": quality_run(cpu_dev, QUALITY_SMALL)}
    for a, b in zip(small["card"].pop("walks"), small["cpu"].pop("walks")):
        assert torch.equal(a, b), "8c small: card and CPU walk matrices differ"
    assert small["card"]["counts"] == small["cpu"]["counts"], "8c small: counts differ"
    tc, tp = small["card"].pop("tables"), small["cpu"].pop("tables")
    for k in tc:
        assert torch.allclose(tc[k], tp[k], **TABLE_TOL), f"8c small: the {k} tables differ"
    small["tables_max_abs_err"] = {k: float((tc[k] - tp[k]).abs().max()) for k in tc}
    small_card = small["card"]
    assert small_card["acc_inc"] >= small_card["acc_full"] - q["gap"], small_card
    card.pop("tables")
    card.pop("counts")
    log("quality", ok=True, sizes=q, card=card, cpu=cpu, small_sizes=QUALITY_SMALL,
        small=small)
    return card


# ---------------------------------------------------------------- phase 9


@contextlib.contextmanager
def tf32_off():
    """f32 products in f32 (no TF32) inside, as the card-vs-CPU checks
    need; the earlier settings after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def moe_routing():
    """Record each `transformer.moe_route` call's (top_e, pos, keep) while
    inside -> the list of calls (one a MoE layer a forward)."""
    calls, route = [], tfm.moe_route

    def rec(xt, router, m):
        out = route(xt, router, m)
        calls.append(tuple(t.cpu() for t in out[1:4]))
        return out

    tfm.moe_route = rec
    try:
        yield calls
    finally:
        tfm.moe_route = route


@contextlib.contextmanager
def synced_calls(module, name: str):
    """Record the synced seconds of each call of `module.name` inside."""
    seconds, fn = [], getattr(module, name)

    def timed(*a, **kw):
        out, dt = sync_time(lambda: fn(*a, **kw))
        seconds.append(dt)
        return out

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def to_device(tree, d):
    return ttree.tree_map(lambda t: t.to(d), tree)


def close(got, want, what: str, rtol: float, atol: float) -> float:
    """torch.testing.assert_close on the CPU -> the max abs difference."""
    got, want = got.detach().cpu(), want.detach().cpu()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return float((got.float() - want.float()).abs().max())


def trees_close(got, want, what: str, rtol: float, atol: float) -> float:
    w = ttree.leaf_paths(want)
    return max(close(v, w[k], f"{what} {k}", rtol, atol)
               for k, v in ttree.leaf_paths(got).items())


def routing_equal(a: list, b: list, what: str) -> int:
    """Two runs' MoE routing, call by call: top_e, pos and keep exactly ->
    the rows dropped beyond capacity."""
    assert len(a) == len(b) > 0, (what, len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        for name, u, v in zip(("top_e", "pos", "keep"), x, y):
            if not torch.equal(u, v):
                raise AssertionError(f"{what}: MoE layer {i} {name} differs")
    return sum(int((~keep).sum()) for _, _, keep in a)


def lm_small_run(arch: str, d) -> dict:
    """One smoke arch on device d (f32): init, forward, loss and
    gradients, prefill of 8 and one decode step from a 16-slot cache (as
    tests/test_archs.py), with the MoE routing of each."""
    cfg = get_arch(arch).make_config(True)
    params = tfm.init_params(jr.PRNGKey(0, d), cfg)
    toks = jr.randint(jr.PRNGKey(1, d), (2, 17), 0, cfg.vocab_size, dtype=torch.int32)
    out = {"params": params}
    with moe_routing() as route:
        with torch.no_grad():
            out["logits"] = tfm.forward(params, toks[:, :-1], cfg)
        out["loss"], out["grads"] = steps.value_and_grad(
            lambda p: tfm.lm_loss(p, toks, cfg), params)
        out["last"], pc = tfm.prefill(params, toks[:, :8], cfg)
        cache = tfm.init_kv_cache(cfg, 2, 16, device=d)
        cache["k"][:, :, :8], cache["v"][:, :, :8] = pc["k"], pc["v"]
        out["decode"], out["cache"] = tfm.decode_step(params, toks[:, 8:9], cache, 8, cfg)
    out["routing"] = route
    return out


def lm_trainer_run(d, workdir: str) -> dict:
    """The launcher's `lm_trainer` at gemma2-2b smoke through TrainLoop on
    device d -> tokens and metrics by step."""
    s = LM["small"]
    state, step_fn, batch_fn = launch.lm_trainer(LM["gemma"]["arch"], True, s["batch"],
                                                 s["seq"], device=d)
    tokens, metrics = {}, {}

    def batches(step, key):
        tokens[step] = batch_fn(step, key)
        return tokens[step]

    loop = TrainLoop(step_fn=step_fn, batch_fn=batches,
                     ckpt=CheckpointManager(tempfile.mkdtemp(dir=workdir), keep=1),
                     ckpt_every=s["steps"] + 1, device=d)
    loop.run(state, 0, s["steps"], lambda step, dt, m: metrics.__setitem__(step, m))
    return dict(tokens=tokens, metrics=metrics)


def phase_lm_small(dev, workdir):
    """Phase 9a: every LM arch's smoke config and DLRM's, card against CPU
    in f32 with TF32 off: init bit for bit, forward, loss and gradients,
    prefill and decode within LM_TOL, the MoE routing exact; then the
    launcher's `lm_trainer` at gemma2-2b smoke for 4 steps, tokens exact,
    loss and gradient norm within rtol 1e-5."""
    cpu = torch.device("cpu")
    out = {}
    with tf32_off():
        for arch in LM_ARCHS:
            a, b = lm_small_run(arch, dev), lm_small_run(arch, cpu)
            for k, v in ttree.leaf_paths(a["params"]).items():
                assert torch.equal(v.cpu(), ttree.leaf_paths(b["params"])[k]), (arch, k)
            err = {k: close(a[k], b[k], f"9a {arch} {k}", **LM_TOL)
                   for k in ("logits", "loss", "last", "decode")}
            for k in ("grads", "cache"):
                err[k] = trees_close(a[k], b[k], f"9a {arch} {k}", **LM_TOL)
            dropped = (routing_equal(a["routing"], b["routing"], f"9a {arch}")
                       if get_arch(arch).make_config(True).moe else None)
            out[arch] = dict(max_abs_err=err, moe_rows_dropped=dropped)
        d = dlrm_small(dev)
        runs = {k: lm_trainer_run(k, workdir) for k in (cpu, dev)}
    card, host = runs[dev], runs[cpu]
    assert sorted(card["tokens"]) == list(range(LM["small"]["steps"]))
    for s, t in host["tokens"].items():
        assert t.dtype == torch.int32 and torch.equal(card["tokens"][s].cpu(), t), s
        for k in ("loss", "gnorm"):
            want = host["metrics"][s][k]
            assert abs(card["metrics"][s][k] - want) <= 1e-5 * abs(want), (s, k)
    log("lm_small", ok=True, archs=out, dlrm=d,
        trainer=dict(steps=LM["small"]["steps"],
                     loss_card=[m["loss"] for m in card["metrics"].values()],
                     loss_cpu=[m["loss"] for m in host["metrics"].values()]))


def dlrm_inputs(cfg, b: int, gen, d):
    dense = torch.randn((b, cfg.n_dense), generator=gen, device=d)
    sparse = torch.randint(0, cfg.table_rows, (b, cfg.n_sparse, cfg.multi_hot),
                           generator=gen, device=d)
    labels = torch.randint(0, 2, (b,), generator=gen, device=d).float()
    return dense, sparse, labels


def dlrm_step(params, opt, batch, cfg):
    """The train_batch step of launch/steps.py:471-479: `dlrm_loss`, its
    gradients, one AdamW update at `AdamWConfig()`."""
    loss, grads = steps.value_and_grad(lambda p: dlrm.dlrm_loss(p, *batch, cfg), params)
    with torch.no_grad():
        params, opt, gnorm = adamw_update(grads, opt, params, AdamWConfig())
    return params, opt, loss, gnorm


def dlrm_small(dev) -> dict:
    """9a for DLRM: smoke config, card = CPU: init bit for bit; forward,
    loss, gradients and one train step at DLRM_TOL; retrieval too."""
    cfg = get_arch(LM["dlrm"]["arch"]).make_config(True)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(LM["seeds"]["dlrm"])
    batch = dlrm_inputs(cfg, 64, gen, cpu)
    cand = torch.randn((300, cfg.embed_dim), generator=gen)
    res = {}
    for d in (cpu, dev):
        p = dlrm.dlrm_init(jr.PRNGKey(0, d), cfg)
        b = [t.to(d) for t in batch]
        logits = dlrm.dlrm_forward(p, b[0], b[1], cfg)
        scores = dlrm.retrieval_score(p, b[0][:1], b[1][:1], cand.to(d), cfg)
        p2, _, loss, gnorm = dlrm_step(p, adamw_init(p), b, cfg)
        res[d.type] = dict(p=p, logits=logits, scores=scores, p2=p2, loss=loss, gnorm=gnorm)
    a, h = res[dev.type], res["cpu"]
    for k, v in ttree.leaf_paths(a["p"]).items():
        assert torch.equal(v.cpu(), ttree.leaf_paths(h["p"])[k]), ("9a dlrm init", k)
    err = {k: close(a[k], h[k], f"9a dlrm {k}", **DLRM_TOL)
           for k in ("logits", "scores", "loss", "gnorm")}
    err["params_after_step"] = trees_close(a["p2"], h["p2"], "9a dlrm step", **DLRM_TOL)
    return err


def lm_config(part: str):
    """The full-width config of LM[part], with the part's cuts."""
    p = LM[part]
    return get_arch(p["arch"]).make_config().replace(**p.get("over", {}))


def serve_lm(params, cfg, toks, n_prefill: int, n_decode: int) -> dict:
    """`prefill` over toks[:, :n_prefill], then n_decode `decode_step`s
    from its cache (max_len n_prefill + n_decode), each synced -> logits
    and times."""
    d = toks.device
    (last, pc), t_prefill = sync_time(lambda: tfm.prefill(params, toks[:, :n_prefill], cfg))
    cache = tfm.init_kv_cache(cfg, toks.shape[0], n_prefill + n_decode, device=d)
    cache["k"][:, :, :n_prefill], cache["v"][:, :, :n_prefill] = pc["k"], pc["v"]
    del pc
    logits, ms = [], []
    for i in range(n_decode):
        pos = n_prefill + i
        (lg, cache), dt = sync_time(lambda: tfm.decode_step(
            params, toks[:, pos:pos + 1], cache, pos, cfg))
        logits.append(lg[:, 0])
        ms.append(dt * 1e3)
    return dict(last=last, decoded=torch.stack(logits, dim=1), prefill_s=t_prefill,
                decode_ms=ms, cache_bytes=2 * cache["k"].numel() * cache["k"].element_size())


def phase_lm_gemma(dev, workdir) -> dict:
    """Phase 9b: gemma2-2b at full width and depth in bf16. The launcher's
    `lm_trainer` (init on the card, timed) through TrainLoop at batch 1 x
    4,096 tokens for 3 steps and its closing blocking save; then serving
    from the trained weights: a 4,096-token prefill and 64 decode steps
    (positions 4,096-4,159, past the local layers' window) against one
    forward over the 4,160 tokens within LM_BF16_TOL; then in f32 at depth
    2 (TF32 off) decode = forward within 2e-3 and card = CPU logits over
    the first `cpu_tokens` within rtol 1e-4 / atol 1e-4."""
    g = LM["gemma"]
    cfg = lm_config("gemma")
    torch.cuda.reset_peak_memory_stats()
    with synced_calls(tfm, "init_params") as init_s:
        (state, step_fn, batch_fn), build_s = sync_time(
            lambda: launch.lm_trainer(g["arch"], False, g["batch"], g["seq"], device=dev))
    params_bytes = nbytes_of(state["params"])
    state_bytes = nbytes_of(state)
    free = shutil.disk_usage(workdir).free
    log("lm_disk", workdir_free_bytes=free, checkpoint_bytes=state_bytes)
    if free < 1.2 * state_bytes:
        raise RuntimeError(f"phase 9b: {free / 1e9:.1f} GB free under {workdir}, "
                           f"the checkpoint needs {state_bytes / 1e9:.1f} GB")
    steps = {}

    def on_metrics(step, dt, m):
        steps[step] = dict(m, ms=dt * 1e3, tokens_per_s=g["batch"] * g["seq"] / dt,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    loop = TrainLoop(step_fn=step_fn, batch_fn=batch_fn,
                     ckpt=CheckpointManager(tempfile.mkdtemp(prefix="lm_", dir=workdir), keep=1),
                     ckpt_every=g["steps"] + 1, device=dev)
    torch.cuda.reset_peak_memory_stats()
    state = loop.run(state, 0, g["steps"], on_metrics)
    for s, m in steps.items():
        assert np.isfinite(m["loss"]) and np.isfinite(m["gnorm"]), (s, m)
    save = dict(loop.ckpt.saves[-1])
    shutil.rmtree(loop.ckpt.dir, ignore_errors=True)
    params = state["params"]
    del state, loop, step_fn, batch_fn
    torch.cuda.empty_cache()

    # serving from the trained weights, bf16
    torch.cuda.reset_peak_memory_stats()
    n, k = g["seq"], g["decode"]
    toks = jr.randint(jr.PRNGKey(LM["seeds"]["tokens"], dev), (1, n + k), 0,
                      cfg.vocab_size, dtype=torch.int32)
    srv = serve_lm(params, cfg, toks, n, k)
    with torch.no_grad():
        full, t_fwd = sync_time(lambda: tfm.forward(params, toks, cfg))
    want = full[:, n:]
    bf16_err = close(srv["decoded"], want, "9b bf16 decode vs forward", **LM_BF16_TOL)
    last_err = close(srv["last"], full[:, n - 1], "9b bf16 prefill vs forward", **LM_BF16_TOL)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, full, want, srv["decoded"]
    torch.cuda.empty_cache()

    # f32 at depth 2: decode = forward, card = CPU
    with tf32_off():
        c32 = cfg.replace(n_layers=g["f32_layers"], dtype=torch.float32, remat=False)
        p32 = tfm.init_params(jr.PRNGKey(0, dev), c32)
        s32 = serve_lm(p32, c32, toks, n, k)
        with torch.no_grad():
            f32_full = tfm.forward(p32, toks, c32)
        f32_err = close(s32["decoded"], f32_full[:, n:], "9b f32 decode vs forward",
                        rtol=2e-3, atol=2e-3)
        del f32_full, s32
        m = g["cpu_tokens"]
        with torch.no_grad():
            card = tfm.forward(p32, toks[:, :m], c32)
            host = tfm.forward(to_device(p32, "cpu"), toks[:, :m].cpu(), c32)
        cpu_err = close(card, host, "9b f32 card vs cpu", rtol=1e-4, atol=1e-4)
    del p32, card, host
    torch.cuda.empty_cache()
    return dict(
        config=dict(arch=g["arch"], n_layers=cfg.n_layers, d_model=cfg.d_model,
                    params=cfg.param_count(), params_bytes=params_bytes),
        init_s=init_s[0], build_s=build_s, train_steps=steps, save=save,
        state_bytes=state_bytes,
        serve=dict(prefill_tokens=n, prefill_s=srv["prefill_s"],
                   prefill_tokens_per_s=n / srv["prefill_s"], decode_steps=k,
                   decode_ms=srv["decode_ms"],
                   decode_tokens_per_s=k / (sum(srv["decode_ms"]) / 1e3),
                   kv_cache_bytes=srv["cache_bytes"], forward_4160_s=t_fwd,
                   peak_gb=serve_peak),
        max_abs_err=dict(bf16_decode_vs_forward=bf16_err, bf16_prefill_vs_forward=last_err,
                         f32_decode_vs_forward=f32_err, f32_card_vs_cpu=cpu_err))


def phase_lm_qwen(dev) -> dict:
    """Phase 9c: qwen2-moe-a2.7b at full width in bf16 (64 padded experts):
    init on the card, timed; a 2,048-token prefill (the rows each MoE layer
    drops beyond capacity counted) and 16 decode steps; then in f32 at
    depth 1, card = CPU over `cpu_tokens` with the routing exact."""
    q = LM["qwen"]
    cfg = lm_config("qwen")
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(lambda: tfm.init_params(jr.PRNGKey(0, dev), cfg))
    n, k = q["prefill"], q["decode"]
    toks = jr.randint(jr.PRNGKey(LM["seeds"]["tokens"] + 1, dev), (1, n + k), 0,
                      cfg.vocab_size, dtype=torch.int32)
    with moe_routing() as route:
        srv = serve_lm(params, cfg, toks, n, k)
    assert bool(torch.isfinite(srv["decoded"]).all()) and bool(torch.isfinite(srv["last"]).all())
    dropped = [int((~keep).sum()) for _, _, keep in route[:cfg.n_layers]]
    cap = max(1, int(n * cfg.moe.top_k * cfg.moe.capacity_factor / cfg.moe.n_experts))
    serve = dict(prefill_tokens=n, prefill_s=srv["prefill_s"],
                 prefill_tokens_per_s=n / srv["prefill_s"], decode_steps=k,
                 decode_ms=srv["decode_ms"],
                 decode_tokens_per_s=k / (sum(srv["decode_ms"]) / 1e3),
                 kv_cache_bytes=srv["cache_bytes"],
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    params_bytes = nbytes_of(params)
    del params, srv
    torch.cuda.empty_cache()
    with tf32_off():
        c32 = cfg.replace(n_layers=q["f32_layers"], dtype=torch.float32)
        p32 = tfm.init_params(jr.PRNGKey(0, dev), c32)
        m = q["cpu_tokens"]
        with torch.no_grad(), moe_routing() as r_card:
            card = tfm.forward(p32, toks[:, :m], c32)
        with torch.no_grad(), moe_routing() as r_host:
            host = tfm.forward(to_device(p32, "cpu"), toks[:, :m].cpu(), c32)
        f32_dropped = routing_equal(r_card, r_host, "9c f32 card vs cpu")
        cpu_err = close(card, host, "9c f32 card vs cpu", rtol=1e-4, atol=1e-4)
    del p32, card, host
    torch.cuda.empty_cache()
    return dict(
        config=dict(arch=q["arch"], n_layers=cfg.n_layers, d_model=cfg.d_model,
                    experts_stored=cfg.moe.e_padded, params_bytes=params_bytes),
        init_s=init_s, init_params_per_s=params_bytes / 2 / init_s, serve=serve,
        prefill_rows_dropped_per_layer=dropped, capacity=cap,
        f32_rows_dropped=f32_dropped, max_abs_err=dict(f32_card_vs_cpu=cpu_err))


def median_call_ms(fn, reps: int) -> tuple:
    """(first call's synced ms, median synced ms of `reps` more calls)."""
    _, first = sync_time(fn)
    times = [sync_time(fn)[1] * 1e3 for _ in range(reps)]
    return first * 1e3, float(np.median(times))


def phase_lm_dlrm(dev) -> dict:
    """Phase 9d: dlrm-rm2 at full width in f32 (26 tables of 1,000,000 x
    64): init on the card, timed; its serve_p99 (B = 512), serve_bulk
    (B = 262,144) and retrieval_cand (1 query x 1,000,000 candidates)
    shapes, each call synced; one train_batch step (B = 65,536); card =
    CPU at B = 512 within DLRM_TOL (TF32 off)."""
    c = LM["dlrm"]
    cfg = get_arch(c["arch"]).make_config()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(lambda: dlrm.dlrm_init(jr.PRNGKey(0, dev), cfg))
    gen = torch.Generator(device=dev).manual_seed(LM["seeds"]["dlrm"])
    out = dict(config=dict(dataclasses.asdict(cfg), dtype=str(cfg.dtype)), init_s=init_s,
               tables_bytes=nbytes_of(params["tables"]), calls={})
    with tf32_off(), torch.no_grad():
        for shape in ("serve_p99", "serve_bulk"):
            b = dlrm_inputs(cfg, c[shape], gen, dev)
            first, med = median_call_ms(lambda: dlrm.dlrm_forward(params, b[0], b[1], cfg),
                                        c["reps"])
            out["calls"][shape] = dict(batch=c[shape], first_ms=first, ms=med,
                                       rows_per_s=c[shape] / med * 1e3)
        q = dlrm_inputs(cfg, 1, gen, dev)
        cand = torch.randn((c["retrieval"], cfg.embed_dim), generator=gen, device=dev)
        scores = dlrm.retrieval_score(params, q[0], q[1], cand, cfg)
        assert scores.shape == (1, c["retrieval"]) and bool(torch.isfinite(scores).all())
        first, med = median_call_ms(
            lambda: dlrm.retrieval_score(params, q[0], q[1], cand, cfg), c["reps"])
        out["calls"]["retrieval_cand"] = dict(candidates=c["retrieval"], first_ms=first, ms=med)
        del cand, scores
        b = dlrm_inputs(cfg, c["serve_p99"], gen, dev)
        card = dlrm.dlrm_forward(params, b[0], b[1], cfg)
        card_loss = dlrm.dlrm_loss(params, *b, cfg)
        host_params = to_device(params, "cpu")
        hb = [t.cpu() for t in b]
        host = dlrm.dlrm_forward(host_params, hb[0], hb[1], cfg)
        host_loss = dlrm.dlrm_loss(host_params, *hb, cfg)
        del host_params
        out["max_abs_err"] = dict(logits=close(card, host, "9d card vs cpu", **DLRM_TOL),
                                  loss=close(card_loss, host_loss, "9d loss", **DLRM_TOL))
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    batch = dlrm_inputs(cfg, c["train"], gen, dev)
    opt = adamw_init(params)
    (params, opt, loss, gnorm), dt = sync_time(lambda: dlrm_step(params, opt, batch, cfg))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
    out["train_batch"] = dict(batch=c["train"], ms=dt * 1e3, loss=float(loss),
                              gnorm=float(gnorm), rows_per_s=c["train"] / dt,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, opt, batch
    torch.cuda.empty_cache()
    return out


def phase_lm(dev, workdir) -> dict:
    """Phase 9: the LM family and DLRM (9a-9d), with the kernel counts set
    to 0 just before and read just after: no path of theirs launches one
    of the seven kernels."""
    ops.reset_launches()    # ---- phase 9, counted from here
    phase_lm_small(dev, workdir)
    gemma = phase_lm_gemma(dev, workdir)
    log("lm_gemma", **gemma)
    qwen = phase_lm_qwen(dev)
    log("lm_qwen", **qwen)
    dl = phase_lm_dlrm(dev)
    log("lm_dlrm", **dl)
    launches = dict(ops.launches)   # ---- read just after
    assert not any(launches.values()), f"phase 9 launched a kernel: {launches}"
    log("reduced_lm", **LM_REDUCED)
    return dict(launches=launches)


# --------------------------------------------------------------- phase 10


def gnn_labels(arch, cfg, n: int, gen, dev):
    """n labels drawn on dev: normal targets for the regression archs,
    classes in range for the others."""
    if steps._regression(arch):
        return torch.randn((n, cfg.d_out), generator=gen, device=dev)
    return torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev,
                         dtype=torch.int32)


def gnn_batch(specs: dict, n: int, gen, dev) -> dict:
    """A full-batch plan's batch drawn on dev to `specs`' shapes: edges
    among n nodes (duplicates and self-loops as they fall), the rest
    normal."""
    return {k: (torch.randint(0, n, tuple(v.shape), generator=gen, device=dev,
                              dtype=torch.int32)
                if k in ("senders", "receivers")
                else torch.randn(tuple(v.shape), generator=gen, device=dev))
            for k, v in specs.items()}


def gnn_small_run(arch: str, d) -> dict:
    """One smoke arch on device d (f32): init, forward, `_gnn_loss` and its
    gradients on a small graph drawn on the CPU to the plan's batch specs."""
    c = GNN["small"]
    cfg, _ = steps._gnn_init(arch, get_arch(arch).make_config(True), c["d_feat"])
    params = gnn.INITS[arch](jr.PRNGKey(0, d), cfg)
    gen = torch.Generator().manual_seed(GNN["seed"])
    specs = steps._gnn_batch_specs(arch, c["n"], c["e"], c["d_feat"])
    batch = {k: v.to(d) for k, v in gnn_batch(specs, c["n"], gen, "cpu").items()}
    labels = gnn_labels(arch, cfg, c["n"], gen, "cpu").to(d)
    with torch.no_grad():
        out = steps._gnn_forward(arch, params, batch, cfg)
    loss, grads = steps.value_and_grad(
        lambda p: steps._gnn_loss(arch, p, batch, labels, cfg), params)
    return dict(params=params, out=out, loss=loss, grads=grads)


def phase_gnn_small(dev) -> dict:
    """Phase 10a: the four GNN archs at their smoke configs in f32 (TF32
    off), card against CPU: init bit for bit, forward, loss and gradients
    within GNN_TOL; `sample_two_hop` on a small random CSR, ids and masks
    card = CPU; the plans of tests/test_dryrun.py's registry test build."""
    cpu = torch.device("cpu")
    out = {}
    with tf32_off():
        for arch in GNN_ARCHS:
            a, b = gnn_small_run(arch, dev), gnn_small_run(arch, cpu)
            for k, v in ttree.leaf_paths(a["params"]).items():
                assert torch.equal(v.cpu(), ttree.leaf_paths(b["params"])[k]), (arch, k)
            err = {k: close(a[k], b[k], f"10a {arch} {k}", **GNN_TOL) for k in ("out", "loss")}
            err["grads"] = trees_close(a["grads"], b["grads"], f"10a {arch} grads", **GNN_TOL)
            out[arch] = err
    c = GNN["small"]
    rng = np.random.default_rng(GNN["seed"] + 1)
    src, dst = (torch.from_numpy(rng.integers(0, c["csr_n"] - 20, c["csr_e"])) for _ in range(2))
    seeds = torch.from_numpy(rng.integers(0, c["csr_n"], c["seeds"]))
    hops = {}
    for d in (cpu, dev):
        g = StreamingGraph.from_edges(src.to(d), dst.to(d), c["csr_n"], 1 << 13, device=d)
        hops[d.type] = sampling.sample_two_hop(jr.PRNGKey(GNN["seed"], d), g, seeds.to(d),
                                               *c["fanout"])
    for (x, mx), (y, my) in zip(hops[dev.type], hops["cpu"]):
        assert torch.equal(x.cpu(), y) and torch.equal(mx.cpu(), my), "10a sample_two_hop"
    dead = int((hops["cpu"][0][1] == 0).all(dim=1).sum())
    for arch, shape in (("gat-cora", "molecule"), ("dlrm-rm2", "serve_p99"),
                        ("graphsage-reddit", "full_graph_sm")):
        plan = steps.build_cell(arch, shape, smoke=True)
        assert plan.fn is not None and len(plan.args) >= 2, (arch, shape)
    return dict(archs=out, sampler=dict(seeds=c["seeds"], fanout=c["fanout"],
                                        seeds_of_degree_0=dead, card_equals_cpu=True))


def gnn_cell(arch: str, shape: str):
    """(plan, info, cfg) of one 10b cell: `build_cell`'s plan, on the shape
    cut as GNN["cuts"] says; cfg is the plan's (the shape's input widths)."""
    info = dict(GNN_SHAPES[shape])
    div = GNN["cuts"].get((arch, shape))
    if div is not None:
        info.update(n_nodes=info["n_nodes"] // div, n_edges=info["n_edges"] // div)
    plan = steps.build_cell(arch, shape, info=info)
    cfg = get_arch(arch).make_config(False)
    return plan, info, steps._gnn_init(arch, cfg, info.get("d_feat", 16))[0]


def gnn_inputs(arch, plan, info, cfg, gen, dev) -> list:
    """The plan's arguments after (params, opt), drawn on the card: a valid
    CSR for the sampled plan (offsets monotone from 0 to e), edges among
    the plan's nodes, labels in range, the rest normal."""
    args = plan.args[2:]
    if info["kind"] == "sampled":
        feats, offsets, neighbors, seeds, labels = args[:5]
        n, e = feats.shape[0], neighbors.shape[0]
        cuts = torch.sort(torch.randint(0, e + 1, (n - 1,), generator=gen, device=dev)).values
        off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cuts,
                         torch.full((1,), e, dtype=torch.int64, device=dev)]).to(torch.int32)
        return [torch.randn(tuple(feats.shape), generator=gen, device=dev), off,
                torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, n, tuple(seeds.shape), generator=gen, device=dev,
                              dtype=torch.int32),
                gnn_labels(arch, cfg, labels.shape[0], gen, dev)]
    spec, labels = args
    n = labels.shape[0]
    return [gnn_batch(spec, n, gen, dev), gnn_labels(arch, cfg, n, gen, dev)]


def mgn_input_scale(params, batch, cfg) -> float:
    """MeshGraphNet sums messages over its 15 layers with no norm, so N(0, 1)
    features give outputs ~1e9 at ogb_products' mean degree 25 and a
    gradient norm that overflows f32 (AdamW's clip then zeroes the update).
    At the init the forward is positively homogeneous in the features
    (ReLU MLPs, zero biases), so features scaled by 1/rms of its output
    give outputs of rms 1: the scale returned."""
    with torch.no_grad():
        out = steps._gnn_forward("meshgraphnet", params, batch, cfg)
        rms = float(torch.sqrt(torch.mean(out.double() ** 2)))
    del out
    torch.cuda.empty_cache()
    assert np.isfinite(rms) and rms > 0, rms
    return 1.0 / rms


def gnn_full_cell(arch: str, shape: str, dev) -> dict:
    """One 10b cell: the plan's `train_step` for GNN["steps"] steps from
    the bit-exact init, each synced; loss finite, the gradient norm exactly
    0 on the three minibatch cells that train nothing, finite and > 0
    elsewhere."""
    plan, info, cfg = gnn_cell(arch, shape)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(lambda: gnn.INITS[arch](jr.PRNGKey(0, dev), cfg))
    want = {k: tuple(v.shape) for k, v in ttree.leaf_paths(plan.args[0]).items()}
    assert {k: tuple(v.shape) for k, v in ttree.leaf_paths(params).items()} == want, (arch, shape)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(GNN["seed"])
    inputs = gnn_inputs(arch, plan, info, cfg, gen, dev)
    sampled = info["kind"] == "sampled"
    scale = None
    if arch == "meshgraphnet" and not sampled:
        scale = mgn_input_scale(params, inputs[0], cfg)
        for k in ("node_feat", "edge_feat"):
            inputs[0][k] *= scale
    key = jr.PRNGKey(GNN["seed"], dev)
    step_ms, losses, gnorms = [], [], []
    for i in range(GNN["steps"]):
        extra = [jr.fold_in(key, i)] if sampled else []
        (params, opt, loss, gnorm), dt = sync_time(
            lambda: plan.fn(params, opt, *inputs, *extra))
        step_ms.append(dt * 1e3)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    zero = sampled and arch in GNN_ZERO_GRAD
    assert all(np.isfinite(losses)), (arch, shape, losses)
    assert all(np.isfinite(g) and ((g == 0.0) if zero else (g > 0)) for g in gnorms), (
        arch, shape, gnorms)
    best = min(step_ms) / 1e3
    # model_flops counts forward and backward (x3); the zero-gradient cells
    # run the forward alone
    flops_run = plan.model_flops / 3.0 if zero else plan.model_flops
    n, e = ((inputs[0].shape[0], inputs[2].shape[0]) if sampled
            else (inputs[1].shape[0], inputs[0]["senders"].shape[0]))
    res = dict(n_nodes=n, n_edges=e, cut=GNN["cuts"].get((arch, shape)), init_s=init_s,
               input_scale=scale, step_ms=step_ms,
               loss=losses, gnorm=gnorms, zero_gradient=zero,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               model_flops=plan.model_flops, flops_run=flops_run,
               flops_run_per_s=flops_run / best,
               share_of_f32_peak=flops_run / best / SCALAR_OPS_PER_S)
    del params, opt, inputs, plan
    torch.cuda.empty_cache()
    return res


def phase_gnn_full(dev) -> dict:
    """Phase 10b: every (arch, shape) cell of the four GNN archs at the full
    config (cut as GNN_REDUCED says) through the cell plans."""
    cells = {}
    for arch in GNN_ARCHS:
        for shape in GNN_SHAPES:
            cells[f"{arch}/{shape}"] = gnn_full_cell(arch, shape, dev)
    return dict(steps=GNN["steps"], f32_peak_ops_per_s=SCALAR_OPS_PER_S,
                tf32=torch.backends.cuda.matmul.allow_tf32, cells=cells)


def phase_gnn(dev) -> dict:
    """Phase 10: the GNN family (10a, 10b), with the kernel counts set to 0
    just before and read just after: the models' message passing is torch
    (gathers, index_add), no kernel of the port."""
    ops.reset_launches()    # ---- phase 10, counted from here
    small = phase_gnn_small(dev)
    log("gnn_small", ok=True, **small)
    full = phase_gnn_full(dev)
    log("gnn_full", ok=True, **full)
    launches = dict(ops.launches)   # ---- read just after
    assert not any(launches.values()), f"phase 10 launched a kernel: {launches}"
    log("reduced_gnn", **GNN_REDUCED)
    return dict(launches=launches)


def phase_gnn_sampler(dev, store, n_w: int, length: int) -> dict:
    """The `gnn` path: `walk_based_neighborhood` over phase 3's merged store
    at GraphSAGE's two hops for GNN["sampler"]["seeds"] seed vertices, its
    kernel launches counted alone (kernels 1 and 4, FINDNEXT); = the plain
    backend's, and = the first hops + 1 columns of `store.traverse` of the
    same walks."""
    c = GNN["sampler"]
    gen = torch.Generator(device=dev).manual_seed(GNN["seed"] + 2)
    seeds = torch.randint(0, store.n_vertices, (c["seeds"],), generator=gen, device=dev)
    ops.reset_launches()    # ---- the gnn path, counted from here
    paths, dt = sync_time(lambda: sampling.walk_based_neighborhood(
        store, seeds, n_w, length, c["hops"]))
    launches = dict(ops.launches)   # ---- read just after
    plain, dt_plain = sync_time(lambda: sampling.walk_based_neighborhood(
        store, seeds, n_w, length, c["hops"], backend="torch"))
    assert torch.equal(paths, plain), "walk_based_neighborhood: kernel != plain"
    w = (seeds[:, None] * n_w + torch.arange(n_w, device=dev)[None]).reshape(-1)
    full = store.traverse(w, torch.repeat_interleave(seeds, n_w), length - 1)
    assert torch.equal(paths.reshape(-1, c["hops"] + 1), full[:, :c["hops"] + 1]), \
        "walk_based_neighborhood != the traverse's first columns"
    assert torch.equal(paths[:, :, 0], seeds[:, None].expand(-1, n_w))
    for k in ("szudzik_pair", "find_next_packed"):
        assert launches[k] > 0, f"the gnn path did not launch {k}"
    for k in ("delta_decode", "intersect_next", "intersect_csr", "fused_rewalk_step",
              "sgns_step"):
        assert launches[k] == 0, f"the gnn path launched {k}"
    res = dict(seeds=c["seeds"], n_w=n_w, hops=c["hops"], walks=int(w.numel()),
               ms=dt * 1e3, plain_ms=dt_plain * 1e3, launches=launches)
    log("gnn_sampler", **res)
    return res


# ---------------------------------------------------------------- phase 11


# the serve plans' top-k scores (output 5): an f32 product whose sums the
# card takes in another order; phase 3c's tolerance, the ids exact
PLAN_SCORE_ATOL = 1e-5


def plan_outputs_equal(got, want, what: str, close=()) -> float:
    """Every leaf of a plan's card output = the CPU's, bit for bit, but
    the leaves `close`, within PLAN_SCORE_ATOL; -> their max abs error."""
    g, w = ttree.leaf_paths(got), ttree.leaf_paths(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys()))
    err = 0.0
    for k, v in w.items():
        if k in close:
            err = max(err, float((g[k].cpu() - v).abs().max()))
            assert err <= PLAN_SCORE_ATOL, (what, k, err)
        else:
            assert torch.equal(g[k].cpu(), v), f"{what}: {k} card != CPU"
    return err


def run_plan_counted(plan, args, d) -> tuple:
    """`plan.fn` on `args` under op_analysis (a one-rank group for the
    sharded cell) -> (outputs, Totals)."""
    with torch.no_grad(), dryrun.one_rank_group(d):
        return op_analysis.counted_run(plan, args)[:2]


def phase_wharf_plans(dev) -> dict:
    """11a: the 13 wharf plans at the smoke config on the card and on the
    CPU from the same inputs (drawn on the CPU, copied): every output leaf
    bit for bit (the serve cells' f32 scores within PLAN_SCORE_ATOL); each
    kernel's calls counted by op_analysis on the card = its plain twin's
    calls on the CPU = the card's launch counts; kernels 1-6 launched. The fused-step cell runs "cuda" on the card and "torch"
    (the same math) on the CPU."""
    cpu = torch.device("cpu")
    spec = get_arch("wharf-stream")
    cfg = spec.make_config(True)
    saved = megakernel.default_backend_request()
    cells, total = {}, dict.fromkeys(ops.KERNELS, 0)
    ops.reset_launches()    # ---- the plans' path, counted from here
    try:
        for shape, info in spec.shapes.items():
            plan = steps.build_cell("wharf-stream", shape, smoke=True)
            args = dryrun.wharf_inputs(plan, cfg, PLANS["seed"], cpu, PLANS["mean_degree"])
            card_args = ttree.tree_map(lambda t: t.to(dev), args)
            before = dict(ops.launches)
            (got, tot), dt = sync_time(lambda: run_plan_counted(plan, card_args, dev))
            launched = {k: ops.launches[k] - before[k] for k in ops.KERNELS}
            megakernel.set_default_backend(saved)
            host_info = dict(info, megakernel="torch") if info.get("megakernel") else info
            host_plan = steps.build_cell("wharf-stream", shape, smoke=True, info=host_info)
            want, host_tot = run_plan_counted(host_plan, args, cpu)
            megakernel.set_default_backend(saved)
            close = ("5",) if plan.step_name == "walk_serve_step" else ()
            err = plan_outputs_equal(got, want, shape, close)
            calls = {k: int(v) for k, v in tot.kernel_calls.items()}
            assert calls == {k: int(v) for k, v in host_tot.kernel_calls.items()}, (
                shape, calls, host_tot.kernel_calls)
            assert calls == launched, (shape, calls, launched)
            for k in ops.KERNELS:
                total[k] += calls[k]
            cells[shape] = dict(ms=dt * 1e3, calls={k: v for k, v in calls.items() if v})
            if close:
                cells[shape]["score_max_abs_err"] = err
    finally:
        megakernel.set_default_backend(saved)
    launches = dict(ops.launches)   # ---- read just after
    assert launches == total, (launches, total)
    for k in PLAN_KERNELS:
        assert launches[k] > 0, f"the wharf plans did not launch {k}"
    return dict(cells=cells, launches=launches)


def dry_record(rec: dict) -> dict:
    """The dry-run record's numbers for the phase line."""
    keep = ("flops_per_card", "bytes_per_card", "collective_bytes_per_card", "model_flops",
            "flops_ratio_model_over_count", "roofline", "bottleneck", "count_s", "memory")
    out = {k: rec[k] for k in keep}
    out["kernel_calls"] = {k: v for k, v in rec["kernel_calls"].items() if v}
    return out


def start_meta_dryrun(workdir: str):
    """The dry-run CLI over the 40 meta cells in a process of its own,
    beside 11a (it needs no card) -> (process, its output file, its log)."""
    out = os.path.join(workdir, "dryrun_meta.json")
    log_path = os.path.join(workdir, "dryrun_meta.log")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(_ROOT, "src"), os.environ.get("PYTHONPATH")) if p))
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 "--mesh", "1", "--out", out], env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, out, log_path


def phase_dryrun(dev, meta) -> dict:
    """11b: the dry-run's 40 LM, GNN and recsys cells at their full configs
    on meta (`meta`: the CLI's process, started before 11a), and
    PLANS["dry_wharf"] at CONFIG's cut on the card: every record's counts
    finite and > 0 (bytes; FLOPs on the meta cells) and its terms; the
    wharf records' kernel calls = the card's launches in the counted run."""
    cfg = dryrun.wharf_config(18, max_pending=CONFIG["max_pending"])
    assert (cfg.n_vertices, cfg.edge_capacity) == (CONFIG["n_vertices"], CONFIG["edge_capacity"])
    cells = {}
    launches = dict.fromkeys(ops.KERNELS, 0)
    for shape in PLANS["dry_wharf"]:
        info = dict(WHARF_SHAPES[shape])
        if "n_batches" in info:
            info["n_batches"] = PLANS["dry_batches"]
        rec = dryrun.run_cell("wharf-stream", shape, config=cfg, info=info, device=dev,
                              seed=PLANS["seed"], verbose=False)
        got = rec["launches"]
        assert got == {k: int(v) for k, v in rec["kernel_calls"].items()}, (shape, got)
        assert rec["bytes_per_card"] > 0 and rec["memory"]["peak_bytes"] > 0, shape
        for k in ops.KERNELS:
            launches[k] += got[k]
        cells[f"wharf-stream/{shape}"] = dry_record(rec)
        torch.cuda.empty_cache()
    proc, out, log_path = meta
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    wait_s = time.perf_counter() - t0
    with open(log_path) as f:
        tail = f.read()[-2000:]
    assert rc == 0, f"the meta dry-run failed (rc {rc}): {tail}"
    with open(out) as f:
        records = json.load(f)
    for key, rec in records.items():
        arch, shape, _ = key.split("|")
        assert rec["flops_per_card"] > 0 and rec["bytes_per_card"] > 0, key
        cells[f"{arch}/{shape}"] = dry_record(rec)
    assert len(cells) == 42, len(cells)
    return dict(card_constants=dict(peak_flops_bf16=card_mesh.PEAK_FLOPS_BF16,
                                    peak_flops_f32=card_mesh.PEAK_FLOPS_F32,
                                    hbm_bw=card_mesh.HBM_BW, nvlink_bw=card_mesh.NVLINK_BW),
                meta_wait_s=wait_s, cells=cells, launches=launches)


def phase_profile_cell(dev) -> dict:
    """11c: `profile_cell` over PLANS["profile"] at CONFIG's cut: the static
    table and one run's top device ops, the port's kernels named."""
    cfg = dryrun.wharf_config(18, max_pending=CONFIG["max_pending"])
    before = dict(ops.launches)
    info = dict(WHARF_SHAPES[PLANS["profile"]], n_batches=PLANS["profile_batches"])
    prof = profile_cell.profile_cell("wharf-stream", PLANS["profile"], config=cfg, info=info,
                                     device=dev, seed=PLANS["seed"], top=PLANS["top"])
    launches = {k: ops.launches[k] - before[k] for k in ops.KERNELS}
    dt = prof["device_ops"]
    named = {r["kernel"] for r in dt["top"] if r["kernel"]}
    assert dt["busy_ms"] and 0 < dt["busy_ms"] <= dt["wall_ms"], "profile_cell: device time"
    tot = prof["totals"]
    # the profiled run (the counted run's inputs, copied) launches what the
    # count saw, and the trace names each of those kernels
    assert {k: r["calls"] for k, r in dt["kernels"].items()} == {
        k: int(v) for k, v in tot.kernel_calls.items() if v}, (dt["kernels"], tot.kernel_calls)
    torch.cuda.empty_cache()
    return dict(static=[list(r) for r in prof["static"]], device_ops=dt,
                kernels_named=sorted(named), launches=launches,
                totals=dict(flops=tot.flops, bytes=tot.mem_bytes,
                            kernel_calls={k: v for k, v in tot.kernel_calls.items() if v}))


def start_partitioned_dryrun(workdir: str):
    """11d-a's dry-run CLI (`--mesh both`) over PARTITION["meta_cells"] in
    a process of its own -> (process, its output file, its log)."""
    out = os.path.join(workdir, "dryrun_partitioned.json")
    log_path = os.path.join(workdir, "dryrun_partitioned.log")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(_ROOT, "src"), os.environ.get("PYTHONPATH")) if p))
    cells = [a for c in PARTITION["meta_cells"] for a in ("--cell", c)]
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 "--mesh", "both", "--out", out] + cells,
                                env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log_path


def phase_partitioned_meta(meta, one_card: dict) -> dict:
    """11d-a: the six cells counted partitioned on the 16 x 16 and 2 x 16
    x 16 meshes on meta: a rank's FLOPs, bytes and collective bytes by
    kind, the model ratio and the seconds of each record; each FLOPs and
    bytes > 0, FLOPs x ranks >= the one-card count (`one_card`: 11b's
    records by "arch/shape")."""
    proc, out, log_path = meta
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    wait_s = time.perf_counter() - t0
    with open(log_path) as f:
        tail = f.read()[-2000:]
    assert rc == 0, f"the partitioned dry-run failed (rc {rc}): {tail}"
    with open(out) as f:
        records = json.load(f)
    assert len(records) == 2 * len(PARTITION["meta_cells"]), sorted(records)
    cells = {}
    for key, rec in records.items():
        assert rec["flops_per_card"] > 0 and rec["bytes_per_card"] > 0, key
        whole = one_card[f"{rec['arch']}/{rec['shape']}"]["flops_per_card"]
        assert rec["flops_per_card"] * rec["n_cards"] >= whole, (key, whole)
        cells[key] = dict(mesh=rec["mesh"], n_cards=rec["n_cards"],
                          flops_per_rank=rec["flops_per_card"],
                          bytes_per_rank=rec["bytes_per_card"],
                          collective_bytes_per_rank={k: v for k, v in
                                                     rec["collective_breakdown"].items() if v},
                          collective_counts={k: v for k, v in rec["collective_counts"].items()
                                             if v},
                          model_ratio=rec["flops_ratio_model_over_count"],
                          count_s=rec["count_s"])
    return dict(wait_s=wait_s, cells=cells)


def phase_partitioned_run(dev, workdir) -> dict:
    """11d-b: PARTITION's sharded steps on four gloo ranks sharing the
    card against the same steps unsharded on the card (launch/
    partitioned.py): every rank's output shards within tolerance (the
    train step's loss, gradient norm and parameters rtol 1e-4 / atol 1e-5,
    the parameters where AdamW's first step is not eps-dominated, and its
    first moments within rtol 1e-4 and 1e-5 of each shard's largest:
    `partitioned._adamw_compare`; the decode step's logits and cache rtol
    1e-5 and atol 1e-6 of each shard's largest |value|; DLRM's logits rtol
    1e-5 / atol 1e-6), its collectives by kind and bytes = the meta
    count of the same (2, 2) plan, no kernel launched; ms a step, each
    rank's peak GB and the largest parameter error over every element."""
    torch.cuda.empty_cache()     # the ranks share the card with this process
    gemma = dataclasses.replace(get_arch("gemma2-2b").make_config(False),
                                n_layers=PARTITION["layers"], dtype=torch.float32)
    # the train step at full width: 98% of the tied embedding's gradients
    # lie below AdamW's eps, where its first step moves a parameter by
    # lr * g / eps, 3e4 times the gradients' f32 rounding (partitioned.
    # _adamw_compare); the second moments are left uncompared (memory)
    cells = [dict(arch="gemma2-2b", shape="train_4k", info=PARTITION["train"], config=gemma,
                  skip=("1/v",), adamw_eps=True),
             # the logits at full width within 1e-6 of the largest |logit|:
             # 5.7e-6 off at |logit| 0.4 measured on one H100 (phase 9b's f32
             # decode is 2.29e-5 off between the card and the CPU)
             dict(arch="gemma2-2b", shape="decode_32k", info=PARTITION["decode"], config=gemma,
                  tol=dict(partitioned.FORWARD_TOL, scaled=True)),
             dict(arch="dlrm-rm2", shape="serve_p99",
                  config=get_arch("dlrm-rm2").make_config(False))]
    ops.reset_launches()
    results = []
    with tf32_off():
        # the train step's args and outputs alone, then the other two: this
        # process holds a call's args and outputs while its ranks run
        for group in (cells[:1], cells[1:]):
            results += partitioned.check(group, mesh_shape=PARTITION["mesh"],
                                         seed=PARTITION["seed"], device=dev, workdir=workdir)
    assert sum(ops.launches.values()) == 0, dict(ops.launches)
    out = {}
    for r in results:
        for i, rr in enumerate(r["ranks"]):
            bad = {k: c for k, c in rr["compare"].items() if c["excess"] > 0}
            assert not bad, (r["cell"], i, bad)
            assert partitioned.collectives_match(r["meta"], rr["collectives"], i), (
                r["cell"], i, rr["collectives"], r["meta"])
            assert sum(rr["launches"].values()) == 0, (r["cell"], i, rr["launches"])
        out[r["cell"]] = dict(
            unsharded_ms=r["unsharded_ms"], ms_by_rank=[rr["ms"] for rr in r["ranks"]],
            peak_gb_by_rank=[rr["peak_gb"] for rr in r["ranks"]],
            collectives=r["ranks"][0]["collectives"],
            max_abs_err=max(c["max_abs_err"] for rr in r["ranks"]
                            for c in rr["compare"].values()))
    return out


def phase_plans(dev, workdir, part_meta) -> dict:
    """Phase 11 (11a, 11b, 11c, 11d), its kernel launches summed; 11b's
    meta cells are counted by a process of its own while 11a runs, 11d-a's
    by another (`part_meta`, started before phase 9 in `workdir`); the
    processes are ended and `workdir` removed after."""
    meta = start_meta_dryrun(workdir)
    try:
        a = phase_wharf_plans(dev)
        log("wharf_plans", ok=True, **a)
        b = phase_dryrun(dev, meta)
        log("dryrun", ok=True, **b)
        c = phase_profile_cell(dev)
        log("profile_cell", ok=True, **c)
        log("partitioned_meta", ok=True, **phase_partitioned_meta(part_meta, b["cells"]))
        log("partitioned_run", ok=True, **phase_partitioned_run(dev, workdir))
    finally:
        for proc, _, _ in (meta, part_meta):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    log("reduced_plans", **PLANS_REDUCED, **PARTITION_REDUCED)
    return dict(launches={k: a["launches"][k] + b["launches"][k] + c["launches"][k]
                          for k in ops.KERNELS})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    _, t_build = sync_time(_build.lib)
    log("build", seconds=t_build, library=_build.library_path().name)
    phase_small_e2e(dev)
    phase_small_maintainer(dev)
    phase_small_metrics(dev)
    full, tensors = phase_full(dev)
    kernels = phase_kernels(dev, tensors)
    log("kernels_order1")
    gnn_path = phase_gnn_sampler(dev, tensors["store"], CONFIG["n_walks_per_vertex"],
                                 CONFIG["length"])
    host_state = tensors.pop("host_state")
    del tensors
    maint, kept, mt = phase_maintainer(dev, host_state)
    del host_state
    sgns_rows = phase_kernels_sgns(dev, kept)
    log("kernels_sgns")
    del kept
    serve = phase_serve(dev, mt)
    del mt
    n2v, kept = phase_full_n2v(dev)
    prefix_read = prefix_read_search(dev, kept)
    kernels += phase_kernels_n2v(dev, kept) + sgns_rows
    log("kernels_n2v")
    del kept
    paper = phase_paper(dev)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=_ROOT)
    try:
        phase_sharded_small(dev, workdir)
        sharded = phase_sharded_full(dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=_ROOT)
    try:
        phase_trainer_small(dev, workdir)
        trainer = phase_trainer(dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_quality(dev)
    # 11d-a's partitioned counts need no card: they count beside phases 9
    # and 10 (beside 11a they slowed its CPU half)
    plans_dir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=_ROOT)
    part_meta = start_partitioned_dryrun(plans_dir)
    try:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=_ROOT)
        try:
            lm = phase_lm(dev, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gnn_full = phase_gnn(dev)
    except BaseException:
        part_meta[0].kill()
        part_meta[0].wait()
        shutil.rmtree(plans_dir, ignore_errors=True)
        raise
    plans = phase_plans(dev, plans_dir, part_meta)
    next(r for r in kernels if r["name"] == "find_next_packed")["prefix_read"] = prefix_read
    # each kernel's launches on the main paths: order 1 (phase 3), the
    # maintainer (phase 3b), the serve path (phase 3c), and the order-2
    # corpus, unfused and fused batches (phase 4), and the paper's
    # comparison (phase 6: Wharf, II, tree; II and tree at order 2), the
    # sharded engine's four ranks (phase 7b), the launcher's
    # downstream trainer (phase 8b), the LM family and DLRM (phase 9,
    # none), the GNN family: the walk-based sampler over phase 3's
    # store and phase 10 (none), and the cell plans (phase 11)
    for r in kernels:
        by_path = {"order1": full["launches"][r["name"]],
                   "maintainer": maint["launches"][r["name"]],
                   "serve": serve["launches"][r["name"]],
                   **{p: n2v["launches"][p][r["name"]] for p in n2v["launches"]},
                   **{p: paper["launches"][p][r["name"]] for p in paper["launches"]},
                   "sharded": sharded["launches"][r["name"]],
                   "trainer": trainer["launches"][r["name"]],
                   "lm": lm["launches"][r["name"]],
                   "gnn": gnn_path["launches"][r["name"]] + gnn_full["launches"][r["name"]],
                   "plans": plans["launches"][r["name"]]}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        if r["name"] in OFF_MAIN_PATH:
            assert r["launches"] == 0, f"kernel {r['name']} was launched on a main path"
        else:
            assert r["launches"] > 0, f"kernel {r['name']} was not launched on a main path"
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
