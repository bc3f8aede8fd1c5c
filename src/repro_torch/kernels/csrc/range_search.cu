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
// with a hit. Per code: one decode step, one unpair (a double sqrt and a
// short integer fix-up) and a compare.
//
// Design: one warp per query. The warp walks k in order, decodes chunk
// cidx[q, k] with the shared warp decode (u64.cuh), unpairs its four codes
// per lane and tests f == f_target. A warp max-reduce takes the largest v
// among the hits, and the loop stops at the first chunk with a hit: the
// first-hit-wins rule of range_search.py:52-61 (later chunks never change
// the result). Blocks run in any order; nothing carries between them.
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
