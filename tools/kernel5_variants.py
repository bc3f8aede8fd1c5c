"""Where kernel 5's time goes: the CSR entry (`repro_intersect_csr`) built
as committed and with one part of its work taken out, each timed on the
same rows, on two graphs.

Variants (each a text edit of `csrc/intersect.cuh`; `committed`,
`padded` and `bloom` are exact and held against the plain version, the
others compute something else):

  committed   the kernel as committed (membership: a binary search of
              prev's row in shared memory)
  padded      the same search with a pad word after every 32 entries of
              the shared row (fewer bank conflicts, one more add and
              shift a step)
  bloom       membership by a Bloom filter of prev's row in shared memory
              and a warp-wide compare of each entry it passes, one entry
              a turn (a design tried before the search)
  loads_only  the row's loads, then an XOR of its entries: no work
  no_loads    the segments' entries made up from their offsets (no
              segment is read; scalars and offsets still are)
  no_member   membership by an equality of entry j with entry j (no
              search)
  no_select   the three group counts but no rank-select

Graphs (2^18 vertices, dmax 128, 2,621,440 rows: the order-2 rewalk's
batch in chip_smoke's phase 4; prev is a neighbor of v):

  uniform   13,107,200 random undirected edges (mean degree ~100): v and
            prev share almost no neighbor
  cliques   2,048 disjoint cliques of 128 vertices (degree 127): v and
            prev share 126 neighbors

It also prints ptxas's report (`nvcc -Xptxas -v`) of the committed
`intersect.cu` and `megakernel.cu`. Needs the card and nvcc:

    python3 tools/kernel5_variants.py [--reps 20]
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
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import StreamingGraph  # noqa: E402
from repro_torch.kernels import _build, intersect  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
DMAX = 128
N = 1 << 18
ROWS = 2_621_440

_BLOOM = """
// The filter bit of x: a multiplicative hash to log2(1024 NSUB) bits.
template <int NSUB>
__device__ __forceinline__ uint32_t bloom_bit(uint32_t x) {
  constexpr int kBits = NSUB == 4 ? 12 : NSUB == 8 ? 13 : NSUB == 16 ? 14 : 15;
  return (x * 0x9E3779B1u) >> (32 - kBits);
}

// Membership of each valid v entry xv[j] (not SENT, not prev) in prev's
// entries xp (registers of the whole warp; SENT past the row, never equal
// to a valid entry): a Bloom filter of prev's entries in the warp's scratch
// filt (1024 NSUB bits, one hash), probed once per v entry, and each entry
// it passes broadcast to the warp and compared with every prev entry.
template <int NSUB>
__device__ __forceinline__ void member_warp(const uint32_t (&xv)[NSUB],
                                            const uint32_t (&xp)[NSUB], const bool (&ok)[NSUB],
                                            int nsub, uint32_t* filt, int lane,
                                            bool (&in)[NSUB]) {
  const unsigned full = 0xFFFFFFFFu;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NSUB; ++j) filt[j * 32 + lane] = 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
    if (xp[j] != kSent) {
      const uint32_t h = bloom_bit<NSUB>(xp[j]);
      atomicOr(&filt[h >> 5], 1u << (h & 31));
    }
  __syncwarp();
  bool cand[NSUB];
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
    const uint32_t h = bloom_bit<NSUB>(xv[j]);
    cand[j] = ok[j] && ((filt[h >> 5] >> (h & 31)) & 1u);
    in[j] = false;
  }
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
    if (j < nsub) {
      unsigned bal = __ballot_sync(full, cand[j]);
      while (bal) {                     // warp-uniform: one candidate a turn
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        const uint32_t x = __shfl_sync(full, xv[j], src);
        bool eq = false;
#pragma unroll
        for (int k = 0; k < NSUB; ++k) eq |= xp[k] == x;
        const bool hit = __any_sync(full, eq);
        if (lane == src) in[j] = hit;
      }
    }
  }
}

"""

_CALL = "  member_sorted<NSUB>(xv, xp, nsub, sh, lane, in);\n"

_PAD_ROW = """// prev's row with entry i at word i + i / 32
struct PaddedRow {
  uint32_t* p;
  __device__ __forceinline__ uint32_t& operator[](int i) const { return p[i + (i >> 5)]; }
};

"""
_SEARCH_HEAD = "uint32_t* sh, int lane, bool (&in)[NSUB]) {\n"

_EDITS = {
    "committed": [],
    "loads_only": [(
        "  bool ok[NSUB], in[NSUB];\n",
        "  bool ok[NSUB], in[NSUB];\n  {\n    unsigned acc = 0;\n#pragma unroll\n"
        "    for (int j = 0; j < NSUB; ++j) acc ^= xv[j] ^ xp[j];\n"
        "    nxt = __reduce_xor_sync(full, acc);\n    found = true;\n    return;\n  }\n")],
    "no_loads": [("return i < n ? (uint32_t)codes[start + i] : kSent;",
                  "return i < n ? (uint32_t)(start + 3 * i) : kSent;")],
    "no_member": [(_CALL, "#pragma unroll\n  for (int j = 0; j < NSUB; ++j) in[j] = xv[j] == xp[j];\n")],
    "no_select": [("  // the sub-slot holding the r-th member",
                   "  nxt = c0 + c1 + c2 + r;\n  return;\n  // the sub-slot holding the r-th member")],
    "padded": [("return 32 * NSUB;", "return 33 * NSUB;"),
               ("// Membership of each of a lane's entries", _PAD_ROW + "// Membership of each of a lane's entries"),
               (_SEARCH_HEAD, "uint32_t* sh_raw, int lane, bool (&in)[NSUB]) {\n"
                "  const PaddedRow sh{sh_raw};\n")],
    "bloom": [("// The group-then-member selection", _BLOOM + "// The group-then-member selection"),
              (_CALL, "  member_warp<NSUB>(xv, xp, ok, nsub, sh, lane, in);\n")],
}
EXACT = ("committed", "padded", "bloom")


def variant_header(edits) -> str:
    text = (CSRC / "intersect.cuh").read_text()
    for old, new in edits:
        assert text.count(old) == 1, f"edit anchor not found once: {old!r}"
        text = text.replace(old, new)
    return text


def ptxas_lines(log: str) -> list:
    """The entry names and their register/stack/spill lines."""
    keep = ("Compiling entry function", "registers", "stack frame")
    return [ln.split("info    :", 1)[-1].strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def build_all(tmp: Path) -> dict:
    """One nvcc a variant (and one for megakernel.cu's report), all started
    together -> {name: (library or None, nvcc log)}."""
    nvcc = _build._nvcc()
    flags = [*_build.FLAGS, "-Xptxas", "-v"]
    jobs = {}
    for name, edits in _EDITS.items():
        d = tmp / name
        d.mkdir()
        (d / "intersect.cuh").write_text(variant_header(edits))
        (d / "intersect.cu").write_text((CSRC / "intersect.cu").read_text())
        jobs[name] = (d / "lib.so", subprocess.Popen(
            [nvcc, *flags, "-shared", str(d / "intersect.cu"), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    jobs["megakernel.cu"] = (None, subprocess.Popen(
        [nvcc, *flags, "-I", str(CSRC), "-c", str(CSRC / "megakernel.cu"),
         "-o", str(tmp / "megakernel.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (lib, log)
    return out


def uniform_graph(dev, gen) -> StreamingGraph:
    src = torch.randint(0, N, (N * 50,), generator=gen, device=dev)
    dst = torch.randint(0, N, (N * 50,), generator=gen, device=dev)
    return StreamingGraph.from_edges(src, dst, N, 1 << 25, device=dev)


def clique_graph(dev, size: int = 128) -> StreamingGraph:
    i, j = torch.triu_indices(size, size, 1, device=dev)
    base = (torch.arange(N // size, device=dev) * size)[:, None]
    src, dst = (base + i).reshape(-1), (base + j).reshape(-1)
    return StreamingGraph.from_edges(src, dst, N, 1 << 26, device=dev)


def rows_on(graph, dev, gen):
    """v uniform, prev a uniform neighbor of v (v itself when isolated),
    u uniform [ROWS, 2]."""
    off = graph.offsets.to(torch.int64)
    v = torch.randint(0, N, (ROWS,), generator=gen, device=dev)
    deg = off[v + 1] - off[v]
    r = torch.randint(0, 1 << 30, (ROWS,), generator=gen, device=dev) % deg.clamp(min=1)
    prev = torch.where(deg > 0, graph.codes[off[v] + r] & 0xFFFFFFFF, v)
    u = torch.rand((ROWS, 2), generator=gen, device=dev)
    # each segment (its entries and two offsets) read once however many
    # rows read it; a row's v, prev and u read once; nxt, found, overflow
    # written once
    seen = torch.zeros(N, dtype=torch.bool, device=dev)
    seen[v] = True
    seen[prev] = True
    seg = (off[1:] - off[:-1]).clamp(max=DMAX)[seen]
    nbytes = float((seg * 8 + 8).sum()) + ROWS * (16 + 8 + 10)
    return v, prev, u, nbytes, float(deg.float().mean())


def event_ms(fn, reps: int) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel5_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    P, LL, F, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(Path(tmp))
        for name in ("committed", "megakernel.cu"):
            print(json.dumps({"ptxas": name, "lines": ptxas_lines(built[name][1])}), flush=True)
        libs = {}
        for name, (path, log) in built.items():
            if path is None:
                continue
            lib = ctypes.CDLL(str(path))
            lib.repro_intersect_csr.argtypes = [P, P, P, P, P, I, F, F, P, P, P, LL, P]
            libs[name] = lib
        inv_p, inv_q = intersect.inverse_weights(1.0, 1.0)
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device=dev)
        gen.manual_seed(2023)
        for gname, make in (("uniform", lambda: uniform_graph(dev, gen)),
                            ("cliques", lambda: clique_graph(dev))):
            graph = make()
            v, prev, u, nbytes, mean_deg = rows_on(graph, dev, gen)
            want = intersect.factorized_csr_plain(graph.codes, graph.offsets, v, prev, u,
                                                  DMAX, inv_p, inv_q)
            nxt = torch.empty(ROWS, dtype=torch.int64, device=dev)
            found = torch.empty(ROWS, dtype=torch.bool, device=dev)
            over = torch.empty(ROWS, dtype=torch.bool, device=dev)
            times = {name: [] for name in libs}
            for _ in range(2):            # in turns: each variant twice
                for name, lib in libs.items():
                    def run(lib=lib):
                        err = lib.repro_intersect_csr(
                            graph.codes.data_ptr(), graph.offsets.data_ptr(), v.data_ptr(),
                            prev.data_ptr(), u.data_ptr(), DMAX, inv_p, inv_q,
                            nxt.data_ptr(), found.data_ptr(), over.data_ptr(), ROWS, stream)
                        _build.check(err, name)
                    times[name].append(event_ms(run, args.reps))
                    if name in EXACT:
                        assert torch.equal(nxt, want[0]) and torch.equal(found, want[1]) \
                            and torch.equal(over, want[2]), f"{name} != plain on {gname}"
            print(json.dumps({
                "graph": gname, "rows": ROWS, "dmax": DMAX, "mean_degree_of_v": mean_deg,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "ms": times, "exact": list(EXACT)}), flush=True)
            del graph, v, prev, u, want, nxt, found, over
            torch.cuda.empty_cache()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
