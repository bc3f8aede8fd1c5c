// Kernel 6: one fused rewalk step per walk lane.
//
// Replaces the Pallas kernel src/repro/kernels/megakernel.py
// `_fused_kernel_body` (through `_kernel_factorized` / `_kernel_external`,
// launched by `_fused_step_pallas`, megakernel.py:299). There the grid is
// (B, K): scalar prefetch selects lane b's k-th candidate chunk, which is
// decoded and hit-tested with first-hit-wins carried across the sequential
// k steps; at the last k the lane's factorized sample, the finalize and the
// Szudzik write-back run in-register.
//
// Bound on the card: bytes, and it depends on the data. Every lane reads
// its per-lane scalars and writes (nxt, code). A prefix lane (p < p_min)
// that the pending overlay does not answer reads the packed words and
// epochs of its candidate chunks up to the first hit; an emitting lane in
// factorized mode reads the CSR segments of cur and prev (8 bytes a code,
// min(deg, dmax) codes each) and their offsets. The integer work (decode,
// unpair, binary search) is far below the card's rate.
//
// Design: one warp per lane, no TPU tiling. The warp walks the K chunks
// from the chunk of `lo` in order with the shared warp decode (u64.cuh),
// unpairs its four codes per lane, tests
//     pos in [lo, hi) && f == ft && epoch[pos] == slot_epoch
// and stops at the first chunk with a hit (warp max of v among the hits):
// WalkStore.find_next's search and verification under the one-live-entry-
// per-slot invariant. An emitting lane in factorized mode runs kernel 5's
// CSR body (intersect.cuh): the segments of cur and prev into registers
// as u32, the membership test and the selection, and deg > dmax into
// `overflow`, so the caller builds no neighbor
// windows. Every lane then runs `finalize_math` and the pair. Unlike
// kernel 5, lanes are not pipelined: a lane's work depends on its kind,
// and the FINDNEXT half keeps its design.
// The FINDNEXT result is read only by prefix lanes not answered by pending
// and the sample only by emitting lanes, so each lane runs only the stage
// it reads: the outputs are the reference's, bit for bit.
#include <cuda_runtime.h>

#include "intersect.cuh"
#include "u64.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;

struct StepArgs {
  // the packed store: FOR chunks and the uncompressed epochs
  const uint32_t* packed;
  const uint32_t* widths;
  const uint32_t* a_hi;
  const uint32_t* a_lo;
  const uint32_t* epoch;
  long long n_chunks;
  int k_window;
  // per lane
  const long long* lo;
  const long long* hi;
  const long long* ft;
  const uint32_t* want;
  const long long* cur;
  const long long* prev;
  const long long* pend_nxt;
  const bool* pend_hit;
  const bool* is_prefix;
  const float* u;            // [B, 2] (factorized mode)
  const long long* codes;    // the graph's CSR (factorized mode)
  const int* offsets;
  const long long* ext_nxt;  // [B] (external mode)
  int dmax;
  int factorized;
  int is_term;
  float inv_p;
  float inv_q;
  long long* nxt_out;
  long long* code_out;
  bool* overflow_out;
  long long b;
};

// First-hit-wins FINDNEXT over the lane's candidate chunks.
__device__ __forceinline__ void find_next_warp(const StepArgs& a, long long q, int lane,
                                               long long& v_out, bool& found) {
  const long long lo = a.lo[q], hi = a.hi[q];
  const repro::u64 ft = (repro::u64)a.ft[q];
  const uint32_t we = a.want[q];
  v_out = 0;
  found = false;
  if (lo >= hi) return;
  const long long c0 = lo / repro::kChunk;
  for (int k = 0; k < a.k_window; ++k) {
    // the window clip(c0 + k, 0, n_chunks - 1) of the reference: a chunk
    // past hi, or the last chunk repeated, holds no new position in range
    const long long c = c0 + k;
    if (c > a.n_chunks - 1 || c * repro::kChunk >= hi) break;
    repro::u64 code[repro::kCodesPerLane];
    repro::decode_chunk_warp(a.packed + c * repro::kWords, a.widths[c], a.a_hi[c],
                             a.a_lo[c], lane, code);
    repro::u64 v_hit = 0;
    bool hit = false;
#pragma unroll
    for (int i = 0; i < repro::kCodesPerLane; ++i) {
      const long long pos = c * repro::kChunk + lane * repro::kCodesPerLane + i;
      if (pos < lo || pos >= hi) continue;
      repro::u64 f, v;
      repro::szudzik_unpair(code[i], f, v);
      if (f == ft && a.epoch[pos] == we) {
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
      v_out = (long long)v_hit;
      found = true;
      return;
    }
  }
}

template <int NSUB>
__global__ void fused_step_kernel(StepArgs a) {
  extern __shared__ uint32_t sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_block = blockDim.x >> 5;
  const int nsub = (a.dmax + 31) / 32;
  uint32_t* scratch = sh + warp * repro::scratch_words<NSUB>();
  const long long warps = (long long)gridDim.x * warps_per_block;
  for (long long q = (long long)blockIdx.x * warps_per_block + warp; q < a.b; q += warps) {
    const long long cur = a.cur[q];
    long long nxt;
    bool over = false;
    if (a.is_prefix[q]) {
      // traverse: pending precedence, then the base FINDNEXT, else stay
      if (a.pend_hit[q]) {
        nxt = a.pend_nxt[q];
      } else {
        long long fn_v;
        bool fn_found;
        find_next_warp(a, q, lane, fn_v, fn_found);
        nxt = fn_found ? fn_v : cur;
      }
    } else if (a.factorized) {
      const long long prev = a.prev[q];
      const repro::CsrSegs g = repro::csr_segs(a.offsets, cur, prev, a.dmax);
      uint32_t xv[NSUB], xp[NSUB];
      repro::load_entries<NSUB>(repro::CsrRow{a.codes, g.sv, g.nv}, nsub, lane, xv);
      repro::load_entries<NSUB>(repro::CsrRow{a.codes, g.sp, g.np}, nsub, lane, xp);
      long long s_nxt;
      bool s_found;
      repro::choose_warp<NSUB>(xv, xp, nsub, scratch, prev, a.u[2 * q], a.u[2 * q + 1],
                               a.inv_p, a.inv_q, lane, s_nxt, s_found);
      nxt = s_found ? s_nxt : cur;
      over = g.over;
    } else {
      nxt = a.ext_nxt[q];
    }
    if (lane == 0) {
      const long long eff = a.is_term ? cur : nxt;
      a.nxt_out[q] = nxt;
      a.code_out[q] = repro::rebias(
          repro::szudzik_pair((repro::u64)a.ft[q], (repro::u64)eff));
      a.overflow_out[q] = over;
    }
  }
}

template <int NSUB>
int launch(const StepArgs& a, int warps, cudaStream_t stream) {
  const size_t per_warp = a.factorized ? repro::scratch_words<NSUB>() * sizeof(uint32_t) : 0;
  if (per_warp && (size_t)warps * per_warp > 49152) warps = (int)(49152 / per_warp);
  const size_t smem = (size_t)warps * per_warp;
  const long long blocks = (a.b + warps - 1) / warps;
  const long long cap = 132LL * 32;
  const int grid = (int)(blocks < cap ? blocks : cap);
  fused_step_kernel<NSUB><<<grid, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// packed int32 [C, 256], 16-byte aligned. Factorized mode: codes int64
// [E], offsets int32 [N+1], u f32 [B, 2], 1 <= dmax <= 32 * kMaxSubSlots.
// overflow_out[q]: an emitting factorized lane whose cur or prev has more
// than dmax neighbors (false elsewhere).
extern "C" int repro_fused_rewalk_step(
    const uint32_t* packed, const uint32_t* widths, const uint32_t* a_hi,
    const uint32_t* a_lo, const uint32_t* epoch, long long n_chunks, int k_window,
    const long long* lo, const long long* hi, const long long* ft, const uint32_t* want,
    const long long* cur, const long long* prev, const long long* pend_nxt,
    const bool* pend_hit, const bool* is_prefix, const float* u, const long long* codes,
    const int* offsets, const long long* ext_nxt, int dmax, int factorized,
    int is_term, float inv_p, float inv_q, long long* nxt_out, long long* code_out,
    bool* overflow_out, long long b, void* stream) {
  if (factorized && (dmax <= 0 || dmax > 32 * repro::kMaxSubSlots))
    return (int)cudaErrorInvalidValue;
  if (n_chunks <= 0 || k_window <= 0 || ((uintptr_t)packed & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaGetLastError();
  const StepArgs a{packed, widths, a_hi, a_lo, epoch, n_chunks, k_window, lo, hi, ft, want,
                   cur, prev, pend_nxt, pend_hit, is_prefix, u, codes, offsets, ext_nxt,
                   factorized ? dmax : 0, factorized, is_term, inv_p, inv_q, nxt_out,
                   code_out, overflow_out, b};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (factorized ? repro::nsub_bound((dmax + 31) / 32) : 4) {
    case 4: return launch<4>(a, kMaxWarpsPerBlock, s);
    case 8: return launch<8>(a, kMaxWarpsPerBlock, s);
    case 16: return launch<16>(a, kMaxWarpsPerBlock, s);
    case 32: return launch<32>(a, kMaxWarpsPerBlock, s);
  }
  return (int)cudaErrorInvalidValue;
}
