"""Where kernels 4 (packed FINDNEXT, `repro_find_next_packed`) and 1
(Szudzik pair, `repro_szudzik_pair`) spend their time: each built as
committed and with one part of its work changed, timed on the same
operands, warm (mean of back-to-back runs) and cold (median of single runs
after a 256 MB write and read that evict L2: `chip_smoke.cold_ms`), in
turns. Also kernels 3 and 6 with each of the two loaders of a chunk's
words that kernel 4's design had to choose between.

Kernel 4 variants (each a text edit of `csrc/range_search.cu`, or the
design it replaced; all but `loads_only` and `no_unpair`, which compute
something else, are exact and held against the plain version):

  committed    the kernel as committed
  speculative  chunk j+1's width, anchor and words fetched while chunk j
               is decoded
  meta_all     the width and anchor of all K chunks of a query fetched in
               the pipeline (lane j < K: chunk j's), as an earlier
               design of this kernel did, not only chunk 0's
  loads_only   the pipeline's loads, then an XOR of the first chunk's
               words: no decode, no unpair, no later chunk
  no_unpair    the codes compared raw with the target (the tool passes the
               code of the plain version's answer as the target, so the
               same chunks are visited): no hit test
  unpair       the hit test by a full unpair of every code (an exact isqrt:
               a double sqrt and integer fix-up loops), as the first port,
               at 3 blocks an SM (at 4 it spills)
  dsqrt        the direct hit test with a correctly rounded double sqrt in
               place of the rsqrt estimate and its Newton step, at 3
               blocks an SM (at 4 it spills)
  blocksB      as committed, compiled for B = 3, 5 or 6 resident blocks of
               8 warps an SM (committed: 4), so for at most 85, 51 or 42
               registers a thread
  first_port   the port's first kernel 4, which this design replaced: one
               warp a query, no pipeline, scalar word loads, a grid sized
               from a literal 132 SMs
  wrapper      the committed kernel through its Python wrapper
               (`range_search.find_next_packed_cuda`, as chip_smoke times
               it)

Kernel 1 variants (of `csrc/szudzik.cu`; all exact):

  committed    as committed (no cache hint)
  streaming    the same loads and stores with the streaming hint (evict
               first: `__ldcs`, `__stcs`)
  first_port   the port's first kernel 1: one element a thread, 8-byte
               accesses, a grid capped at 132 x 64 blocks
  wrapper      the committed kernel through its Python wrapper
               (`szudzik.pair_cuda`, as chip_smoke times it): back to back,
               the wrapper's host time per call shows when it exceeds the
               kernel's

Kernels 3 and 6 (`csrc/delta.cu`, `csrc/megakernel.cu`), through their
wrappers, exact:

  committed    u64.cuh's `chunk_words`: one vector load a width class
  scalar       the same words with 4-byte loads, as kernels 3 and 6 read
               them before kernel 4's redesign

Operands: a `wharf-stream` corpus at chip_smoke's scale (2^18 vertices,
mean degree 100, 10 walks a vertex of length 80: 209,715,200 triplets in
1,638,400 chunks). Kernel 4: K = 8 windows of point queries on stored
triplets, built as `WalkStore.find_next` builds them, at 2^16 queries
(chip_smoke's phase-5 shape) and 2^21 (the size of an order-2 prefix-read
call); then chip_smoke's profiled unfused order-2 batch (phase 4's graph,
corpus and keys, the batch after three, with three pending blocks) under
torch.profiler with the first port's kernel 4 and the committed one, in turns, each
from a fresh engine (`wharf.prefix` and `search_kernel` device time), and
the exact variants timed over the whole sequence of that batch's kernel-4
calls. Kernel 1: chip_smoke's phase-5 pair operands
(2,621,444 elements). Kernel 3: every chunk of the corpus. Kernel 6: the
sixth fused-step call of the first fused batch of phase 4's stream (a
fresh engine), the call chip_smoke keeps from its profiled fused batch.
Bounds come from chip_smoke's `search_work` (each visited chunk once).

It also prints ptxas's report (`nvcc -Xptxas -v`) of the committed
`szudzik.cu` and `range_search.cu`, and each variant's registers and
spills. Needs the card and nvcc:

    python3 tools/kernel4_variants.py [--reps 20] [--cold 30]
        [--parts pair,search,profiled,loaders]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (CONFIG, N2V, bound, card_line, cold_ms, event_ms,  # noqa: E402
                        keep_operands, n2v_batch, n2v_corpus, n2v_engine, n2v_graph,
                        n2v_stream, profile_batch, search_work, uniform_pairs)
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus, pairing  # noqa: E402
from repro_torch.core.utils import seg_searchsorted  # noqa: E402
from repro_torch.kernels import (_build, delta, megakernel, ops, range_search,  # noqa: E402
                                 szudzik)

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
K = 8
QUERIES = {"phase5": 1 << 16, "prefix_read": 1 << 21}

# the kernels the committed ones replaced, as they were (u64.cuh's decode_chunk_warp
# keeps their loads and arithmetic)
_FIRST_PORT_SEARCH = r"""
#include <cuda_runtime.h>
#include "u64.cuh"
namespace {
constexpr int kWarpsPerBlock = 8;
__global__ void search_kernel(const uint32_t* __restrict__ packed,
                              const uint32_t* __restrict__ widths,
                              const uint32_t* __restrict__ a_hi,
                              const uint32_t* __restrict__ a_lo,
                              const int* __restrict__ cidx,
                              const long long* __restrict__ f_targets,
                              long long* __restrict__ v_out,
                              bool* __restrict__ found_out, long long n_q, int k) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long q = blockIdx.x * (long long)kWarpsPerBlock + (threadIdx.x >> 5);
       q < n_q; q += warps) {
    const repro::u64 ft = (repro::u64)f_targets[q];
    repro::u64 best = 0;
    bool found = false;
    for (int j = 0; j < k; ++j) {
      const long long c = cidx[q * k + j];
      repro::u64 code[repro::kCodesPerLane];
      repro::decode_chunk_warp(packed + c * repro::kWords, widths[c], a_hi[c],
                               a_lo[c], lane, code);
      repro::u64 v_hit = 0;
      bool hit = false;
#pragma unroll
      for (int i = 0; i < repro::kCodesPerLane; ++i) {
        repro::u64 f, v;
        repro::szudzik_unpair(code[i], f, v);
        if (f == ft) {
          hit = true;
          if (v > v_hit) v_hit = v;
        }
      }
      if (__any_sync(0xFFFFFFFFu, hit)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          repro::u64 other = __shfl_xor_sync(0xFFFFFFFFu, v_hit, off);
          if (other > v_hit) v_hit = other;
        }
        best = v_hit;
        found = true;
        break;
      }
    }
    if (lane == 0) {
      v_out[q] = (long long)best;
      found_out[q] = found;
    }
  }
}
}  // namespace
extern "C" int repro_find_next_packed(const uint32_t* packed, const uint32_t* widths,
                                      const uint32_t* a_hi, const uint32_t* a_lo,
                                      const int* cidx, const long long* f_targets,
                                      long long* v_out, bool* found_out, long long n_q,
                                      int k, void* stream) {
  if (n_q > 0) {
    long long blocks = (n_q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const long long cap = 132LL * 64;
    int grid = (int)(blocks < cap ? blocks : cap);
    search_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        packed, widths, a_hi, a_lo, cidx, f_targets, v_out, found_out, n_q, k);
  }
  return (int)cudaGetLastError();
}
"""

_FIRST_PORT_PAIR = r"""
#include <cuda_runtime.h>
#include "u64.cuh"
namespace {
__global__ void pair_kernel(const long long* __restrict__ x,
                            const long long* __restrict__ y,
                            long long* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = repro::rebias(repro::szudzik_pair((repro::u64)x[i], (repro::u64)y[i]));
  }
}
}  // namespace
extern "C" int repro_szudzik_pair(const long long* x, const long long* y,
                                  long long* out, long long n, void* stream) {
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    const long long cap = 132LL * 64;
    pair_kernel<<<(int)(blocks < cap ? blocks : cap), 256, 0, (cudaStream_t)stream>>>(
        x, y, out, n);
  }
  return (int)cudaGetLastError();
}
"""

_BLOCKS3 = ("constexpr int kMinBlocksPerSm = 4;", "constexpr int kMinBlocksPerSm = 3;")
_SEARCH_EDITS = {
    "committed": [],
    "speculative": [
        ("  for (int j = 0;;) {\n    repro::u64 code[repro::kCodesPerLane];\n",
         "  for (int j = 0;;) {\n    uint32_t wn[repro::kLaneWords];\n"
         "    uint32_t widthn = 0, a_hin = 0, a_lon = 0;\n"
         "    if (j + 1 < a.k) {\n      const int cn = __shfl_sync(kFull, m.c, j + 1);\n"
         "      widthn = a.widths[cn];\n      a_hin = a.a_hi[cn];\n      a_lon = a.a_lo[cn];\n"
         "      load_chunk(a, cn, widthn, lane, wn);\n    }\n"
         "    repro::u64 code[repro::kCodesPerLane];\n"),
        ("    if (++j >= a.k) return;\n    const int c = __shfl_sync(kFull, m.c, j);\n"
         "    width = a.widths[c];\n    a_hi = a.a_hi[c];\n    a_lo = a.a_lo[c];\n"
         "    load_chunk(a, c, width, lane, w);\n",
         "    if (++j >= a.k) return;\n    width = widthn;\n    a_hi = a_hin;\n    a_lo = a_lon;\n"
         "#pragma unroll\n    for (int i = 0; i < repro::kLaneWords; ++i) w[i] = wn[i];\n")],
    "meta_all": [
        ("  uint32_t width, a_hi, a_lo;\n  repro::u64 ft;\n};",
         "  uint32_t width, a_hi, a_lo;\n  repro::u64 ft;\n  uint32_t wj, hj, lj;\n};"),
        ("  return QueryMeta{s.c, a.widths[c0], a.a_hi[c0], a.a_lo[c0], s.ft};",
         "  QueryMeta m{s.c, a.widths[c0], a.a_hi[c0], a.a_lo[c0], s.ft, 0, 0, 0};\n"
         "  if ((int)(threadIdx.x & 31) < a.k) {\n    m.wj = a.widths[s.c];\n"
         "    m.hj = a.a_hi[s.c];\n    m.lj = a.a_lo[s.c];\n  }\n  return m;"),
        ("    width = a.widths[c];\n    a_hi = a.a_hi[c];\n    a_lo = a.a_lo[c];\n",
         "    width = __shfl_sync(kFull, m.wj, j);\n    a_hi = __shfl_sync(kFull, m.hj, j);\n"
         "    a_lo = __shfl_sync(kFull, m.lj, j);\n")],
    "loads_only": [
        ("  best = 0;\n  found = false;\n",
         "  best = 0;\n  found = false;\n  {\n    uint32_t acc = 0;\n#pragma unroll\n"
         "    for (int i = 0; i < repro::kLaneWords; ++i) acc ^= w[i];\n"
         "    best = __reduce_xor_sync(kFull, acc);\n    found = true;\n    return;\n  }\n")],
    "no_unpair": [
        ("  if (m.ft > repro::kMaxRoot) return;", ""),
        ("      if (hit_code(code[i], m.ft, lo_code, hi_code, v)) {",
         "      v = code[i];\n      if (code[i] == m.ft) {")],
    "unpair": [
        ("      repro::u64 v;\n      if (hit_code(code[i], m.ft, lo_code, hi_code, v)) {",
         "      repro::u64 f, v;\n      repro::szudzik_unpair(code[i], f, v);\n"
         "      if (f == m.ft) {"), _BLOCKS3],
    "dsqrt": [
        ("  double r;\n  asm(\"rsqrt.approx.ftz.f64 %0, %1;\" : \"=d\"(r) : \"d\"(x));\n"
         "  const double s0 = x * r;\n  const double s1 = fma(fma(-s0, s0, x), 0.5 * r, s0);\n",
         "  const double s1 = sqrt(x);\n"), _BLOCKS3],
    **{f"blocks{b}": [("constexpr int kMinBlocksPerSm = 4;", f"constexpr int kMinBlocksPerSm = {b};")]
       for b in (3, 5, 6)},
}
SEARCH_EXACT = ("committed", "speculative", "meta_all", "unpair", "dsqrt", "blocks3", "blocks5",
                "blocks6", "first_port")

_PAIR_EDITS = {
    "committed": [],
    "streaming": [("__ldg(", "__ldcs(", 3),
                  ("os[s] = make_longlong2(pair1(a[u].x, b[u].x), pair1(a[u].y, b[u].y));",
                   "__stcs(os + s, make_longlong2(pair1(a[u].x, b[u].x), pair1(a[u].y, b[u].y)));")],
}


# kernels 3 and 6 with the scalar loader the vector one replaced: a lane's
# words of a chunk with 4-byte loads
_SCALAR_LOADER = r"""
__device__ __forceinline__ void chunk_words_scalar(const uint32_t* __restrict__ row,
                                                   uint32_t width, int lane,
                                                   uint32_t (&w)[kLaneWords]) {
  const int base = lane * kCodesPerLane;
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) w[j] = 0;
  if (width == 8) {
    w[0] = row[lane];
  } else if (width == 16) {
    w[0] = row[2 * lane];
    w[1] = row[2 * lane + 1];
  } else {
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) w[j] = row[base + j];
    if (width == 64) {
#pragma unroll
      for (int j = 0; j < kCodesPerLane; ++j) w[4 + j] = row[kChunk + base + j];
    }
  }
}

"""
_HEADER_EDITS = {
    "committed": [],
    "scalar": [("// Load and decode chunk `row` (kernels 3 and 6)",
                _SCALAR_LOADER + "// Load and decode chunk `row` (kernels 3 and 6)"),
               ("  chunk_words(row, width, lane, w);\n  decode_chunk_words(",
                "  chunk_words_scalar(row, width, lane, w);\n  decode_chunk_words(")],
}
LOADER_KERNELS = {"decode": "delta.cu", "fused": "megakernel.cu"}


def edited(name: str, edits) -> str:
    text = (CSRC / name).read_text()
    for old, new, *count in edits:
        n = count[0] if count else 1
        assert text.count(old) == n, f"edit anchor not found {n} times: {old!r}"
        text = text.replace(old, new)
    return text


def ptxas_lines(log: str) -> list:
    """The entry names and their register/stack/spill lines."""
    keep = ("Compiling entry function", "registers", "stack frame")
    return [ln.split("info    :", 1)[-1].strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def build_all(tmp: Path, parts) -> dict:
    """One nvcc a variant of the kernels of `parts`, all started together
    -> {(kernel, variant): (library, nvcc log)}."""
    sources = {}
    if "search" in parts or "profiled" in parts:
        sources.update({("search", n): (edited("range_search.cu", e), [])
                        for n, e in _SEARCH_EDITS.items()})
        sources[("search", "first_port")] = (_FIRST_PORT_SEARCH, [])
    if "pair" in parts:
        sources.update({("pair", n): (edited("szudzik.cu", e), [])
                        for n, e in _PAIR_EDITS.items()})
        sources[("pair", "first_port")] = (_FIRST_PORT_PAIR, [])
    if "loaders" in parts:
        sources.update({(kern, n): ((CSRC / f).read_text(), e)
                        for kern, f in LOADER_KERNELS.items() for n, e in _HEADER_EDITS.items()})
    nvcc = _build._nvcc()
    jobs = {}
    for (kern, name), (text, header_edits) in sources.items():
        d = tmp / f"{kern}_{name}"
        d.mkdir()
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(edited(h.name, header_edits) if h.name == "u64.cuh"
                                    else h.read_text())
        (d / "k.cu").write_text(text)
        jobs[(kern, name)] = (d / "lib.so", subprocess.Popen(
            [nvcc, *_build.FLAGS, "-Xptxas", "-v", "-shared", str(d / "k.cu"),
             "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        out[key] = (lib, log)
    return out


def corpus_store(dev):
    """The order-1 corpus of chip_smoke's phase 3 (its graph and key), no
    batches applied."""
    c = CONFIG
    n = c["n_vertices"]
    cfg = WalkConfig(n_walks_per_vertex=c["n_walks_per_vertex"], length=c["length"],
                     chunk_b=c["chunk_b"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(2022)
    src, dst = uniform_pairs(gen, n, n * c["mean_degree"] // 2, dev)
    graph = StreamingGraph.from_edges(src, dst, n, c["edge_capacity"], device=dev)
    del src, dst
    return generate_corpus(jr.PRNGKey(0, dev), graph, cfg), gen


def point_queries(store, q: int, gen):
    """K-chunk windows of q point FINDNEXTs on uniformly drawn stored
    triplets, as `WalkStore.find_next` forms them -> (cidx, f targets)."""
    dev = store.code.device
    i = torch.randint(0, store.size, (q,), generator=gen, device=dev)
    v = store.owner[i].to(torch.int64) & 0xFFFFFFFF
    f, _ = pairing.szudzik_unpair(store.code[i])
    lb = pairing.szudzik_pair(f, store.vmin[v].to(torch.int64) & 0xFFFFFFFF)
    lo = seg_searchsorted(store.code, store.offsets[v], store.offsets[v + 1], lb, side="left")
    cidx = ((lo // delta.CHUNK)[:, None] + torch.arange(K, device=dev)[None]
            ).clamp(0, store.n_chunks - 1).to(torch.int32)
    return cidx, f


def lib_search(lib, stream):
    """A library's kernel 4 behind the wrapper's signature (ops.find_next_packed)."""
    def search(packed, widths, a_hi, a_lo, cidx, ft):
        q, k = cidx.shape
        v = torch.empty(q, dtype=torch.int64, device=packed.device)
        found = torch.empty(q, dtype=torch.bool, device=packed.device)
        _build.check(lib.repro_find_next_packed(
            packed.data_ptr(), widths.data_ptr(), a_hi.data_ptr(), a_lo.data_ptr(),
            cidx.data_ptr(), ft.data_ptr(), v.data_ptr(), found.data_ptr(), q, k, stream),
            "search")
        return v, found
    return search


def profiled_prefix_read(dev, search, keep=None) -> dict:
    """chip_smoke's profiled unfused order-2 batch (its phase 4's graph,
    corpus, engine and batches, through chip_smoke's helpers: the timed
    batches first), with `ops.find_next_packed` replaced by `search` in
    that batch -> `profile_batch`'s record (`wharf.prefix` and
    `search_kernel` device ms). `keep`, a list, gets the operands of every
    call."""
    cfg, src, dst, ins, _ = n2v_stream(dev)
    graph = n2v_graph(src, dst, dev)
    del src, dst
    eng = n2v_engine(graph, n2v_corpus(graph, cfg, dev), cfg, "off")
    del graph
    nb = N2V["n_batches"]
    for i in range(nb):
        n2v_batch(eng, ins, i)
    wrapped = ops.find_next_packed

    def swapped(*call_args):
        if keep is not None:
            keep.append(call_args)
        return search(*call_args)

    ops.find_next_packed = swapped
    try:
        return profile_batch(lambda: n2v_batch(eng, ins, nb), kernel="search_kernel",
                             layer="wharf.prefix")
    finally:
        ops.find_next_packed = wrapped


def fused_step_operands(dev):
    """The operands of the sixth fused-step call (as chip_smoke keeps them)
    of the first fused batch of phase 4's stream, from a fresh engine ->
    (store, step)."""
    cfg, src, dst, ins, _ = n2v_stream(dev)
    graph = n2v_graph(src, dst, dev)
    del src, dst
    eng = n2v_engine(graph, n2v_corpus(graph, cfg, dev), cfg, "cuda")
    with keep_operands("fused_rewalk_step", 5) as got:
        n2v_batch(eng, ins, 0)
    assert got, "fused_rewalk_step: operands not kept"
    return got.pop()


def through(lib, fn):
    """`fn` (a kernel wrapper call) with the kernel library swapped for
    `lib`, a variant's."""
    def run():
        saved = _build._lib
        _build._lib = lib
        try:
            return fn()
        finally:
            _build._lib = saved
    return run


def in_turns(fns: dict, reps: int, cold: int) -> dict:
    """Each variant timed warm and cold twice, in the order a, b, ..., b, a."""
    names = list(fns)
    out = {n: {"ms": [], "ms_cold": []} for n in names}
    for n in names + names[::-1]:
        out[n]["ms"].append(event_ms(fns[n], reps))
        out[n]["ms_cold"].append(cold_ms(fns[n], cold))
    return out


def pair_part(libs, stream, reps: int, cold: int) -> None:
    """Kernel 1's variants on chip_smoke's phase-5 operands."""
    dev = torch.device("cuda")
    n_walks = CONFIG["n_vertices"] * CONFIG["n_walks_per_vertex"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    edge = torch.tensor([0, 2**32 - 1, 2**32 - 1, 0], device=dev)
    x = torch.cat([torch.arange(n_walks, device=dev) * CONFIG["length"]
                   + CONFIG["length"] - 1, edge])
    y = torch.cat([torch.randint(0, CONFIG["n_vertices"], (n_walks,), generator=gen,
                                 device=dev), edge.flip(0)])
    want = pairing.szudzik_pair(x, y)
    out = torch.empty_like(x)
    fns = {}
    for (kern, name), lib in libs.items():
        if kern == "pair":
            def run(lib=lib):
                _build.check(lib.repro_szudzik_pair(x.data_ptr(), y.data_ptr(),
                                                    out.data_ptr(), x.numel(), stream),
                             "pair")
            run()
            assert torch.equal(out, want), f"pair {name} != plain"
            fns[name] = run
    fns["wrapper"] = lambda: szudzik.pair_cuda(x, y)
    print(json.dumps({"kernel": "szudzik_pair", "shape": list(x.shape),
                      "bound_ms": 16 * x.numel() / 3.35e12 * 1e3,
                      "bound_ms_port_types": 24 * x.numel() / 3.35e12 * 1e3,
                      "times": in_turns(fns, reps, cold)}), flush=True)


def search_part(libs, stream, reps: int, cold: int) -> None:
    """Kernel 4's variants on point queries of a corpus."""
    dev = torch.device("cuda")
    store, gen = corpus_store(dev)
    pk = (store.packed, store.widths, store.anchors_hi, store.anchors_lo)
    for label, q in QUERIES.items():
        cidx, ft = point_queries(store, q, gen)
        want_v, want_f = range_search.find_next_packed_plain(*pk, cidx, ft)
        # the raw (un-biased) code of each answer, or one stored nowhere
        raw = torch.where(want_f, pairing.szudzik_pair(ft, want_v) ^ (-(1 << 63)), -1)
        v = torch.empty(q, dtype=torch.int64, device=dev)
        found = torch.empty(q, dtype=torch.bool, device=dev)
        fns = {}
        for (kern, name), lib in libs.items():
            if kern != "search":
                continue
            target = raw if name == "no_unpair" else ft

            def run(lib=lib, target=target):
                _build.check(lib.repro_find_next_packed(
                    *(t.data_ptr() for t in pk), cidx.data_ptr(), target.data_ptr(),
                    v.data_ptr(), found.data_ptr(), q, K, stream), "search")
            run()
            if name in SEARCH_EXACT:
                assert torch.equal(v, want_v) and torch.equal(found, want_f), \
                    f"search {name} != plain ({label})"
            if name == "no_unpair":
                assert torch.equal(found, want_f), f"no_unpair visits other chunks ({label})"
            fns[name] = run
        fns["wrapper"] = lambda: range_search.find_next_packed_cuda(*pk, cidx, ft)  # noqa: E731
        nbytes, nops, visited, distinct = search_work(*pk, cidx, ft)
        b_ms, b_by = bound(nbytes, nops)
        print(json.dumps({"kernel": "find_next_packed", "queries": label,
                          "shape": list(cidx.shape), "visited_chunks": visited,
                          "distinct_chunks": distinct,
                          "found_share": float(want_f.float().mean()), "bound_ms": b_ms,
                          "bound_by": b_by, "exact": list(SEARCH_EXACT),
                          "times": in_turns(fns, reps, cold)}), flush=True)


def profiled_part(libs, stream) -> None:
    """The profiled order-2 batch with the first port's kernel 4 and the
    committed one, in turns, each from a fresh engine; then the exact
    variants over every kernel-4 call of that batch (kept from the first
    committed run), back to back."""
    dev = torch.device("cuda")
    designs = {name: lib_search(libs[("search", name)], stream)
               for name in ("first_port", "committed")}
    profiles, calls = {name: [] for name in designs}, []
    for name in ("first_port", "committed", "committed", "first_port"):
        prof = profiled_prefix_read(dev, designs[name],
                                    calls if name == "committed" and not calls else None)
        profiles[name].append(dict(
            wharf_prefix_device_ms=prof["layer_kernel_ms"]["wharf.prefix"],
            search_kernel_device_ms=prof["search_kernel"]["device_ms"],
            device_busy_ms=prof["device_busy_ms"], wall_ms=prof["wall_ms"]))
        torch.cuda.empty_cache()
    print(json.dumps({"kernel": "find_next_packed", "queries": "profiled_prefix_read",
                      "profiles": profiles}), flush=True)

    q_max = max(cl[4].shape[0] for cl in calls)
    v = torch.empty(q_max, dtype=torch.int64, device=dev)
    found = torch.empty(q_max, dtype=torch.bool, device=dev)
    fns = {}
    for (kern, name), lib in libs.items():
        if kern != "search" or name not in SEARCH_EXACT:
            continue

        def run(lib=lib):
            for cl in calls:
                q = cl[4].shape[0]
                _build.check(lib.repro_find_next_packed(
                    *(t.data_ptr() for t in cl[:4]), cl[4].data_ptr(), cl[5].data_ptr(),
                    v.data_ptr(), found.data_ptr(), q, cl[4].shape[1], stream), "search")
        fns[name] = run
    for cl in calls[:3] + calls[-3:]:   # the largest and the smallest calls, exact
        q = cl[4].shape[0]
        want_v, want_f = range_search.find_next_packed_plain(*cl)
        for name, run_one in (("committed", libs[("search", "committed")]),
                              ("first_port", libs[("search", "first_port")])):
            _build.check(run_one.repro_find_next_packed(
                *(t.data_ptr() for t in cl[:4]), cl[4].data_ptr(), cl[5].data_ptr(),
                v.data_ptr(), found.data_ptr(), q, cl[4].shape[1], stream), name)
            assert torch.equal(v[:q], want_v) and torch.equal(found[:q], want_f), \
                f"search {name} != plain (prefix read)"
    print(json.dumps({"kernel": "find_next_packed", "queries": "prefix_read_calls",
                      "calls": len(calls),
                      "queries_total": sum(cl[4].shape[0] for cl in calls),
                      "queries_per_call": [cl[4].shape[0] for cl in calls],
                      "times_all_calls": in_turns(fns, 3, 3)}), flush=True)


def loaders_part(libs, reps: int, cold: int) -> None:
    """Kernels 3 and 6 with the committed vector loader and the scalar one,
    through their wrappers, exact against their plain versions: kernel 3
    on every chunk of the corpus, kernel 6 on a fused step of phase 4's
    stream."""
    dev = torch.device("cuda")
    store, _ = corpus_store(dev)
    pk = (store.packed, store.widths, store.anchors_hi, store.anchors_lo)
    idx = torch.arange(store.n_chunks, device=dev)
    want = delta.decode_rows_plain(*pk, idx)
    fns = {}
    for name in _HEADER_EDITS:
        run = through(libs[("decode", name)], lambda: delta.decode_rows_cuda(*pk, idx))
        assert torch.equal(run(), want), f"decode {name} != plain"
        fns[name] = run
    print(json.dumps({"kernel": "delta_decode", "shape": [store.n_chunks, delta.CHUNK],
                      "times": in_turns(fns, reps, cold)}), flush=True)
    del store, pk, idx, want, fns
    torch.cuda.empty_cache()

    fstore, step = fused_step_operands(dev)
    want = megakernel.fused_step_plain(fstore, step)
    fns = {}
    for name in _HEADER_EDITS:
        run = through(libs[("fused", name)], lambda: megakernel.fused_step_cuda(fstore, step))
        got = run()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"fused {name} != plain"
        fns[name] = run
    print(json.dumps({"kernel": "fused_rewalk_step", "lanes": step.cur.shape[0],
                      "findnext_lanes": int((step.is_prefix & ~step.pend_hit).sum()),
                      "times": in_turns(fns, reps, cold)}), flush=True)


PARTS = ("pair", "search", "profiled", "loaders")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cold", type=int, default=30)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {', '.join(PARTS)} (default: all)")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts: unknown {sorted(set(parts) - set(PARTS))}")
    if not torch.cuda.is_available():
        print("kernel4_variants: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(Path(tmp), parts)
        for key, src in ((("pair", "committed"), "szudzik.cu"),
                         (("search", "committed"), "range_search.cu")):
            if key in built:
                print(json.dumps({"ptxas": src, "lines": ptxas_lines(built[key][1])}),
                      flush=True)
        print(json.dumps({"registers": {f"{k}/{n}": [ln for ln in ptxas_lines(log)
                                                     if "registers" in ln or "spill" in ln]
                                        for (k, n), (_, log) in built.items()}}), flush=True)
        libs = {}
        for key, (path, _) in built.items():
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _build.SIGNATURES.items():
                if hasattr(lib, name):
                    getattr(lib, name).argtypes = argtypes
                    getattr(lib, name).restype = ctypes.c_int
            libs[key] = lib
        if "pair" in parts:
            pair_part(libs, stream, args.reps, args.cold)
        if "search" in parts:
            search_part(libs, stream, args.reps, args.cold)
            torch.cuda.empty_cache()
        if "profiled" in parts:
            profiled_part(libs, stream)
        if "loaders" in parts:
            loaders_part(libs, args.reps, args.cold)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
