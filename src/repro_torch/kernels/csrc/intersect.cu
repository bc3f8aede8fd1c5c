// Kernel 5: the exact factorized node2vec step.
//
// Replaces the Pallas kernel src/repro/kernels/intersect.py
// `_intersect_kernel` (launched by `factorized_next_pallas`,
// intersect.py:216). There an (8, D) tile of rows is classified with an
// all-pairs [D, D] equality on the VPU, and the group masses and the
// rank-select are computed per row (`_choose_math`).
//
// Bound on the card: bytes. A row needs its two u32 windows (8 D bytes),
// prev and two uniforms, and writes (nxt, found); the work per entry is a
// binary search of log2(D) steps in shared memory and a few ballots, far
// below the card's integer rate, so the 3.35 TB/s HBM rate is the limit.
// The windows arrive as int64 (kernels/intersect.py), so the kernel reads
// 16 D bytes a row, twice what the function needs.
//
// Design: one warp per row, no TPU tiling. The warp copies the row's prev
// window into its slice of shared memory, classifies its own window entries
// (4 a lane at D = 128) by binary search there, counts the three groups
// with __ballot_sync/__popc, and selects the r-th member of the chosen
// group by a warp prefix count (intersect.cuh). Rows are independent, so
// blocks run in any order.
#include <cuda_runtime.h>

#include "intersect.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;

__global__ void intersect_kernel(const long long* __restrict__ nbrs_v,
                                 const long long* __restrict__ nbrs_p,
                                 const long long* __restrict__ prev,
                                 const float* __restrict__ u_group,
                                 const float* __restrict__ u_rank, float inv_p,
                                 float inv_q, long long* __restrict__ nxt_out,
                                 bool* __restrict__ found_out, long long b, int d) {
  extern __shared__ long long sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_block = blockDim.x >> 5;
  long long* sh_p = sh + (long long)warp * d;
  const long long warps = (long long)gridDim.x * warps_per_block;
  for (long long q = (long long)blockIdx.x * warps_per_block + warp; q < b; q += warps) {
    repro::load_window_shared(nbrs_p + q * d, sh_p, d, lane);
    long long nxt;
    bool found;
    repro::choose_warp(nbrs_v + q * d, sh_p, d, prev[q], u_group[q], u_rank[q],
                       inv_p, inv_q, lane, nxt, found);
    if (lane == 0) {
      nxt_out[q] = nxt;
      found_out[q] = found;
    }
  }
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
  if (b > 0) {
    // the prev windows of a block's warps fit the default 48 KB of shared memory
    int warps = (int)(49152 / ((size_t)d * sizeof(long long)));
    if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
    const size_t smem = (size_t)warps * d * sizeof(long long);
    long long blocks = (b + warps - 1) / warps;
    const long long cap = 132LL * 32;
    int grid = (int)(blocks < cap ? blocks : cap);
    intersect_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
        nbrs_v, nbrs_p, prev, u_group, u_rank, inv_p, inv_q, nxt_out, found_out, b, d);
  }
  return (int)cudaGetLastError();
}
