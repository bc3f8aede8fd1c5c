// Kernel 4: packed FINDNEXT over K candidate chunks per query.
//
// Replaces the Pallas kernel src/repro/kernels/range_search.py
// `_search_kernel` (launched by `find_next_packed`, range_search.py:76).
// There the grid is (Q, K): scalar prefetch of chunk_idx selects which
// packed chunk is DMAed at each step, and the (v, found) output block is
// carried across the sequential k steps with first-hit-wins.
//
// Bound on the card: bytes, and it depends on the data. A query reads its
// K chunk indices and f target and writes (v, found); it then reads the
// packed words of the chunks it visits, up to and including the first one
// with a hit. Per code: one decode step and a test of f == f_target.
//
// What set the time of the first port (one warp a query, an unpair of
// every code): the unpair's exact isqrt (two u64 <-> double conversions, a
// correctly rounded double sqrt and two fix-up loops a code) took as long
// as the loads, and a query's three dependent reads (its chunk indices;
// each chunk's width and anchor; the chunk's words) left a warp waiting on
// three round trips to memory.
//
// Design: one warp per query, queries q, q+S, q+2S, ... of a warp (S = the
// grid's warps; the grid is the card's resident blocks, 4 an SM). A query's
// scalars take two round trips: lane j < K reads cidx[q, j] (one coalesced
// load) and every lane f_targets[q]; then every lane reads chunk 0's width
// and anchor (one broadcast load each). A chunk's words come with one
// vector load a lane by width class (u64.cuh `chunk_words`). The three
// stages are pipelined in registers across the warp's queries: before
// query q is decoded, the warp issues chunk 0's words of query q+S, the
// width and anchor of q+2S and the indices and target of q+3S, each
// depending only on loads issued an iteration earlier. A later chunk j
// (index from lane j) has its width, anchor and words fetched only when
// chunk j-1 has no hit: a query visits about one chunk, and fetching all K
// chunks' widths and anchors up front cost 3K 32-byte sectors a query
// beside its ~1 KB of words, a speculative fetch of chunk j+1 bytes the
// bound does not count; both measured slower. The warp decodes the chunk
// (`decode_chunk_words`) and tests its four codes a lane with `hit_code`,
// which needs no unpair: the codes with first operand f_target are one
// range plus the perfect squares shifted by f_target, told apart by one
// rounded sqrt. A warp max-reduce takes the largest v among the hits, and
// the first chunk with a hit ends the query: the first-hit-wins rule of
// range_search.py:52-61 (later chunks never change the result). K <= 32,
// since chunk j's scalars sit in lane j.
#include <cuda_runtime.h>

#include "u64.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocksPerSm = 4;   // 64 registers a thread, 32 warps an SM
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const uint32_t* packed;
  const uint32_t* widths;
  const uint32_t* a_hi;
  const uint32_t* a_lo;
  const int* cidx;
  const long long* f_targets;
  long long* v_out;
  bool* found_out;
  long long n_q;
  int k;
};

// Stage 1 of a query: lane j < k holds chunk index j, every lane the
// target. A query past the last (q >= n_q, met only by the pipeline's
// look-ahead) gets chunk 0 and target 0: its loads read chunk 0, which
// exists whenever there is a query, and its result is never used.
struct QueryIdx {
  int c;
  repro::u64 ft;
};

// Stage 2: every lane also holds chunk 0's width and anchor.
struct QueryMeta {
  int c;
  uint32_t width, a_hi, a_lo;
  repro::u64 ft;
};

__device__ __forceinline__ QueryIdx query_idx(const Args& a, long long q, int lane) {
  if (q >= a.n_q) return QueryIdx{0, 0};
  return QueryIdx{lane < a.k ? a.cidx[q * a.k + lane] : 0, (repro::u64)a.f_targets[q]};
}

__device__ __forceinline__ QueryMeta query_meta(const Args& a, const QueryIdx& s) {
  const int c0 = __shfl_sync(kFull, s.c, 0);
  return QueryMeta{s.c, a.widths[c0], a.a_hi[c0], a.a_lo[c0], s.ft};
}

// The words of chunk c a lane decodes.
__device__ __forceinline__ void load_chunk(const Args& a, int c, uint32_t width, int lane,
                                           uint32_t (&w)[repro::kLaneWords]) {
  repro::chunk_words(a.packed + (long long)c * repro::kWords, width, lane, w);
}

// Round-to-nearest sqrt of t (< 2^64) as an integer, within 0.5 of the
// root when t is a perfect square: the double rsqrt estimate (MUFU.RSQ64H,
// about 2^-22 relative) refined by one Newton step (about 2^-40), then
// rounded by the 1.5 * 2^52 magic add. The t = 0 lane gives garbage, which
// the caller never uses (its z > b test fails).
__device__ __forceinline__ repro::u64 round_sqrt(repro::u64 t) {
  const double x = __ull2double_rn(t);
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double s0 = x * r;
  const double s1 = fma(fma(-s0, s0, x), 0.5 * r, s0);
  return (repro::u64)__double_as_longlong(s1 + 6755399441055744.0) - 0x4338000000000000ULL;
}

// Whether code z (raw) has first operand ft (< 2^32), and its second: the
// x >= y branch of Szudzik's pairing holds exactly the codes a..b = ft^2 +
// ft .. ft^2 + 2 ft (y = z - a); the x < y branch the codes z > b whose
// z - ft is a perfect square y^2 (y > ft follows). Exact for every u64
// code, with one rounded sqrt and no fix-up loop (the unpair's isqrt needs
// the root of every code; this test only whether z - ft is a square).
__device__ __forceinline__ bool hit_code(repro::u64 z, repro::u64 ft, repro::u64 a,
                                         repro::u64 b, repro::u64& v) {
  const repro::u64 d = z - a;   // wraps above ft when z < a
  const repro::u64 t = z - ft;
  const repro::u64 y = round_sqrt(t);
  const bool low = d <= ft, high = z > b && y * y == t;
  v = low ? d : y;
  return low || high;
}

// One query, its first chunk's words already loaded: decode and test the
// chunks in order until one has a hit -> (largest v among that chunk's
// hits, found), on every lane. Chunk j > 0's index comes from lane j, its
// width and anchor and then its words from memory.
__device__ __forceinline__ void search_query(const Args& a, const QueryMeta& m,
                                             const uint32_t (&w0)[repro::kLaneWords], int lane,
                                             repro::u64& best, bool& found) {
  uint32_t w[repro::kLaneWords];
#pragma unroll
  for (int i = 0; i < repro::kLaneWords; ++i) w[i] = w0[i];
  uint32_t width = m.width, a_hi = m.a_hi, a_lo = m.a_lo;
  best = 0;
  found = false;
  if (m.ft > repro::kMaxRoot) return;   // no code has f >= 2^32
  const repro::u64 lo_code = m.ft * m.ft + m.ft, hi_code = lo_code + m.ft;
  for (int j = 0;;) {
    repro::u64 code[repro::kCodesPerLane];
    repro::decode_chunk_words(w, width, a_hi, a_lo, lane, code);
    repro::u64 v_hit = 0;
    bool hit = false;
#pragma unroll
    for (int i = 0; i < repro::kCodesPerLane; ++i) {
      repro::u64 v;
      if (hit_code(code[i], m.ft, lo_code, hi_code, v)) {
        hit = true;
        if (v > v_hit) v_hit = v;
      }
    }
    if (__any_sync(kFull, hit)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const repro::u64 other = __shfl_xor_sync(kFull, v_hit, off);
        if (other > v_hit) v_hit = other;
      }
      best = v_hit;
      found = true;
      return;
    }
    if (++j >= a.k) return;
    const int c = __shfl_sync(kFull, m.c, j);
    width = a.widths[c];
    a_hi = a.a_hi[c];
    a_lo = a.a_lo[c];
    load_chunk(a, c, width, lane, w);
  }
}

// The queries q0, q0 + S, q0 + 2S, ... of one warp, software-pipelined (see
// the note at the top).
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
search_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long S = (long long)gridDim.x * kWarpsPerBlock;
  long long q = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= a.n_q) return;
  QueryMeta m0 = query_meta(a, query_idx(a, q, lane));
  QueryMeta m1 = query_meta(a, query_idx(a, q + S, lane));
  QueryIdx s2 = query_idx(a, q + 2 * S, lane);
  uint32_t w0[repro::kLaneWords];
  load_chunk(a, __shfl_sync(kFull, m0.c, 0), m0.width, lane, w0);
  for (; q < a.n_q; q += S) {
    // issue the later queries' loads first; nothing below waits on them
    uint32_t w1[repro::kLaneWords];
    load_chunk(a, __shfl_sync(kFull, m1.c, 0), m1.width, lane, w1);
    const QueryMeta m2 = query_meta(a, s2);
    const QueryIdx s3 = query_idx(a, q + 3 * S, lane);
    repro::u64 best;
    bool found;
    search_query(a, m0, w0, lane, best, found);
    if (lane == 0) {
      a.v_out[q] = (long long)best;
      a.found_out[q] = found;
    }
    m0 = m1;
    m1 = m2;
    s2 = s3;
#pragma unroll
    for (int i = 0; i < repro::kLaneWords; ++i) w0[i] = w1[i];
  }
}

}  // namespace

// packed int32 [C, 256] (16-byte aligned), widths / anchors int32 [C],
// cidx int32 [n_q, k] with 1 <= k <= 32, f_targets int64 [n_q] ->
// v_out int64 [n_q], found_out bool [n_q].
extern "C" int repro_find_next_packed(const uint32_t* packed, const uint32_t* widths,
                                      const uint32_t* a_hi, const uint32_t* a_lo,
                                      const int* cidx, const long long* f_targets,
                                      long long* v_out, bool* found_out, long long n_q,
                                      int k, void* stream) {
  if (k < 1 || k > kMaxK || ((uintptr_t)packed & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n_q <= 0) return (int)cudaGetLastError();
  static int resident[repro::kMaxDevices] = {};
  const Args a{packed, widths, a_hi, a_lo, cidx, f_targets, v_out, found_out, n_q, k};
  long long grid = (n_q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = repro::resident_blocks(search_kernel, kWarpsPerBlock * 32, resident);
  if (grid > cap) grid = cap;
  search_kernel<<<(int)grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
