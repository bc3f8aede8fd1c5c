// Kernel 3: frame-of-reference decode of FOR-packed chunks.
//
// Replaces the Pallas kernel src/repro/kernels/delta.py `_decode_kernel`
// (launched by `decode_chunks`, delta.py:93), which decodes blocks of 8
// chunks with a branch-free unpack of every width class and a 64-bit prefix
// sum built from two 16-bit-limb u32 cumsums.
//
// Bound on the card: bytes. Per decoded chunk it reads the used packed
// words (128 * w / 32 u32, 1 KiB for w = 64), the width and the anchor, and
// writes 128 int64 codes (1 KiB); a few integer operations per code.
//
// Design: one warp per chunk, four codes per lane (u64.cuh
// `decode_chunk_warp`): the lane unpacks only its chunk's width class, a
// warp inclusive scan over __shfl_up_sync makes the exact u64 prefix sum,
// and each lane stores its four codes as 32 contiguous bytes. The chunks to
// decode come as an index list, so one kernel serves both the full decode
// and the gathered decode of candidate chunks.
#include <cuda_runtime.h>

#include "u64.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void decode_kernel(const uint32_t* __restrict__ packed,
                              const uint32_t* __restrict__ widths,
                              const uint32_t* __restrict__ a_hi,
                              const uint32_t* __restrict__ a_lo,
                              const long long* __restrict__ rows,
                              long long* __restrict__ out, long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = blockIdx.x * (long long)kWarpsPerBlock + (threadIdx.x >> 5);
       r < n_rows; r += warps) {
    const long long c = rows[r];
    repro::u64 code[repro::kCodesPerLane];
    repro::decode_chunk_warp(packed + c * repro::kWords, widths[c], a_hi[c],
                             a_lo[c], lane, code);
    long long* dst = out + r * repro::kChunk + lane * repro::kCodesPerLane;
#pragma unroll
    for (int j = 0; j < repro::kCodesPerLane; ++j) dst[j] = repro::rebias(code[j]);
  }
}

}  // namespace

// packed int32 [C, 256] (16-byte aligned), widths / anchors int32 [C],
// rows int64 [n_rows] -> out int64 [n_rows, 128].
extern "C" int repro_delta_decode(const uint32_t* packed, const uint32_t* widths,
                                  const uint32_t* a_hi, const uint32_t* a_lo,
                                  const long long* rows, long long* out,
                                  long long n_rows, void* stream) {
  if (((uintptr_t)packed & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const long long cap = 132LL * 64;
    int grid = (int)(blocks < cap ? blocks : cap);
    decode_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        packed, widths, a_hi, a_lo, rows, out, n_rows);
  }
  return (int)cudaGetLastError();
}
