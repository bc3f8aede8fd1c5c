// Kernel 5: the exact factorized node2vec step, two entries.
//
// Replaces the Pallas kernel src/repro/kernels/intersect.py
// `_intersect_kernel` (launched by `factorized_next_pallas`,
// intersect.py:216). There an (8, D) tile of rows is classified with an
// all-pairs [D, D] equality on the VPU, and the group masses and the
// rank-select are computed per row (`_choose_math`).
//
//   repro_intersect_csr   the card's main path: each row reads the CSR
//                         segments of v and prev itself, the first
//                         min(deg, dmax) biased edge codes of each (the dst
//                         is the low word), and reports deg > dmax
//   repro_intersect_next  the reference's windowed API: int64 windows
//                         [B, D] built outside the kernel
//
// Bound on the card: bytes. A CSR row needs its two segments (8 bytes a
// code, min(deg, dmax) codes each), four offsets, v, prev and two uniforms,
// and writes (nxt, found, overflow). Reading the segments in the kernel
// removes the two [B, dmax] int64 windows the caller had to build before
// every launch (a gather of 16 dmax bytes a row read and written, twice),
// and a row of degree 100 reads 100 codes, not a padded 128. The work per
// row (membership, three counts, a rank-select: a few hundred warp
// instructions) is not far below the time of the row's bytes, so the
// design keeps it small and overlaps it with the loads.
//
// Design: one warp per row, rows strided over a grid sized to the card's
// resident warps. Both rows stay in registers as u32 (NSUB entries a lane:
// 4 at dmax 128). Prev's row is stored in the warp's shared slice as u32
// (512 B at dmax 128), and each v entry is binary-searched there, a lane's
// searches interleaved; the group counts are warp reductions and the r-th member of
// the chosen group is found by a warp prefix count over the sub-slots
// (intersect.cuh).
// Latency is hidden by a register pipeline across the warp's rows: before
// classifying row q the warp issues the entry loads of row q+S (S = the
// grid's warp count), the offsets of row q+2S and the v, prev and uniforms
// of row q+3S, each depending only on loads issued an iteration earlier,
// so one row's three dependent global reads (scalars, offsets, segments)
// overlap the classification of the rows before it. Registers rather than
// cp.async: the segments are loaded as 8-byte codes and kept as their low
// 4 bytes, a narrowing cp.async cannot do, and 4 NSUB u32 registers a lane
// (16 at dmax 128) are cheap.
#include <cuda_runtime.h>

#include "intersect.cuh"

namespace {

// Warps a block: 16, or 8 from NSUB 16 on, whose registers would not fit
// 16 warps' share (128 a thread) without spilling.
template <int NSUB>
constexpr int warps_per_block() { return NSUB < 16 ? 16 : 8; }

// Per-row scalars of a source (v is unused by windows).
struct Scalars {
  long long v, prev;
  float ug, ur;
  bool ok;               // the row exists (q < b)
};

// Rows from int64 windows [b, d]: the segments are the windows' rows.
struct WindowSrc {
  const long long* nbrs_v;
  const long long* nbrs_p;
  const long long* prev;
  const float* u_group;
  const float* u_rank;
  long long* nxt_out;
  bool* found_out;
  long long b;
  int d;

  __device__ Scalars scalars(long long q) const {
    if (q >= b) return Scalars{0, 0, 0.f, 0.f, false};
    return Scalars{q, prev[q], u_group[q], u_rank[q], true};
  }
  __device__ repro::CsrSegs segs(const Scalars& s) const {
    if (!s.ok) return repro::CsrSegs{0, 0, 0, 0, false};
    return repro::CsrSegs{s.v * d, s.v * d, d, d, false};
  }
  template <int NSUB>
  __device__ void load(const repro::CsrSegs& g, int nsub, int lane, uint32_t (&xv)[NSUB],
                       uint32_t (&xp)[NSUB]) const {
    const int n = g.nv ? nsub : 0;   // a missing row loads nothing
    repro::load_entries<NSUB>(repro::WindowRow{nbrs_v + g.sv}, n, lane, xv);
    repro::load_entries<NSUB>(repro::WindowRow{nbrs_p + g.sp}, n, lane, xp);
  }
  __device__ void write(long long q, const repro::CsrSegs&, long long nxt, bool found) const {
    nxt_out[q] = nxt;
    found_out[q] = found;
  }
};

// Rows from the CSR segments of v and prev.
struct CsrSrc {
  const long long* codes;
  const int* offsets;
  const long long* v;
  const long long* prev;
  const float* u;        // [b, 2]: u_group, u_rank
  long long* nxt_out;
  bool* found_out;
  bool* overflow_out;
  long long b;
  int dmax;

  __device__ Scalars scalars(long long q) const {
    if (q >= b) return Scalars{0, 0, 0.f, 0.f, false};
    const float2 uu = reinterpret_cast<const float2*>(u)[q];
    return Scalars{v[q], prev[q], uu.x, uu.y, true};
  }
  __device__ repro::CsrSegs segs(const Scalars& s) const {
    if (!s.ok) return repro::CsrSegs{0, 0, 0, 0, false};
    return repro::csr_segs(offsets, s.v, s.prev, dmax);
  }
  template <int NSUB>
  __device__ void load(const repro::CsrSegs& g, int nsub, int lane, uint32_t (&xv)[NSUB],
                       uint32_t (&xp)[NSUB]) const {
    repro::load_entries<NSUB>(repro::CsrRow{codes, g.sv, g.nv}, nsub, lane, xv);
    repro::load_entries<NSUB>(repro::CsrRow{codes, g.sp, g.np}, nsub, lane, xp);
  }
  __device__ void write(long long q, const repro::CsrSegs& g, long long nxt, bool found) const {
    nxt_out[q] = nxt;
    found_out[q] = found;
    overflow_out[q] = g.over;
  }
};

// The rows q0, q0 + S, q0 + 2S, ... of one warp, software-pipelined (see
// the note at the top).
template <int NSUB, class Src>
__global__ void __launch_bounds__(warps_per_block<NSUB>() * 32)
intersect_rows(Src src, int nsub, float inv_p, float inv_q) {
  extern __shared__ uint32_t sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* scratch = sh + warp * repro::scratch_words<NSUB>();
  const long long S = (long long)gridDim.x * (blockDim.x >> 5);
  long long q = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= src.b) return;
  Scalars s0 = src.scalars(q), s1 = src.scalars(q + S), s2 = src.scalars(q + 2 * S);
  repro::CsrSegs g0 = src.segs(s0), g1 = src.segs(s1);
  uint32_t xv0[NSUB], xp0[NSUB];
  src.template load<NSUB>(g0, nsub, lane, xv0, xp0);
  for (; q < src.b; q += S) {
    // issue the later rows' loads first; nothing below waits on them
    uint32_t xv1[NSUB], xp1[NSUB];
    src.template load<NSUB>(g1, nsub, lane, xv1, xp1);
    const repro::CsrSegs g2 = src.segs(s2);
    const Scalars s3 = src.scalars(q + 3 * S);
    long long nxt;
    bool found;
    repro::choose_warp<NSUB>(xv0, xp0, nsub, scratch, s0.prev, s0.ug, s0.ur, inv_p, inv_q,
                             lane, nxt, found);
    if (lane == 0) src.write(q, g0, nxt, found);
    s0 = s1;
    s1 = s2;
    s2 = s3;
    g0 = g1;
    g1 = g2;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      xv0[j] = xv1[j];
      xp0[j] = xp1[j];
    }
  }
}

// Launch over a grid of at most the card's resident blocks (every warp then
// walks many rows, which the pipeline needs); the warps' scratch fits the
// default 48 KB of shared memory a block.
template <int NSUB, class Src>
int launch_rows(const Src& src, int nsub, float inv_p, float inv_q, cudaStream_t stream) {
  const size_t per_warp = repro::scratch_words<NSUB>() * sizeof(uint32_t);
  int warps = (int)(49152 / per_warp);
  if (warps > warps_per_block<NSUB>()) warps = warps_per_block<NSUB>();
  const size_t smem = (size_t)warps * per_warp;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_rows<NSUB, Src>,
                                                warps * 32, smem);
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long blocks = (src.b + warps - 1) / warps;
  const int grid = (int)(blocks < cap ? blocks : cap);
  intersect_rows<NSUB, Src><<<grid, warps * 32, smem, stream>>>(src, nsub, inv_p, inv_q);
  return (int)cudaGetLastError();
}

template <class Src>
int dispatch(const Src& src, int nsub, float inv_p, float inv_q, cudaStream_t stream) {
  switch (repro::nsub_bound(nsub)) {
    case 4: return launch_rows<4>(src, nsub, inv_p, inv_q, stream);
    case 8: return launch_rows<8>(src, nsub, inv_p, inv_q, stream);
    case 16: return launch_rows<16>(src, nsub, inv_p, inv_q, stream);
    case 32: return launch_rows<32>(src, nsub, inv_p, inv_q, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Windows [b, d] with d a multiple of 32 and at most 32 * kMaxSubSlots.
extern "C" int repro_intersect_next(const long long* nbrs_v, const long long* nbrs_p,
                                    const long long* prev, const float* u_group,
                                    const float* u_rank, float inv_p, float inv_q,
                                    long long* nxt_out, bool* found_out, long long b,
                                    int d, void* stream) {
  if (d % 32 != 0 || d <= 0 || d > 32 * repro::kMaxSubSlots)
    return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaGetLastError();
  const WindowSrc src{nbrs_v, nbrs_p, prev, u_group, u_rank, nxt_out, found_out, b, d};
  return dispatch(src, d / 32, inv_p, inv_q, (cudaStream_t)stream);
}

// CSR segments: codes int64 [E] (biased edge codes, sorted by source),
// offsets int32 [N+1], v and prev int64 [b], u f32 [b, 2];
// 1 <= dmax <= 32 * kMaxSubSlots.
extern "C" int repro_intersect_csr(const long long* codes, const int* offsets,
                                   const long long* v, const long long* prev, const float* u,
                                   int dmax, float inv_p, float inv_q, long long* nxt_out,
                                   bool* found_out, bool* overflow_out, long long b,
                                   void* stream) {
  if (dmax <= 0 || dmax > 32 * repro::kMaxSubSlots) return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaGetLastError();
  const CsrSrc src{codes, offsets, v, prev, u, nxt_out, found_out, overflow_out, b, dmax};
  return dispatch(src, (dmax + 31) / 32, inv_p, inv_q, (cudaStream_t)stream);
}
