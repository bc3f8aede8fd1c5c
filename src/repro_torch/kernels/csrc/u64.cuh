// Code shared by the port's Hopper kernels (sm_90a): Szudzik pair, exact
// unpair, a warp-wide FOR chunk decode, and a host-side grid size.
//
// The TPU kernels emulate u64 arithmetic with (hi, lo) u32 pairs and 16-bit
// limb products because the TPU has no 64-bit integers. Hopper has native
// `unsigned long long`, so the arithmetic here is plain u64. Codes cross the
// kernel boundary in the port's biased int64 form (u64 bits XOR 2^63, see
// repro_torch/_u64.py) and are un-biased on load.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

typedef unsigned long long u64;

constexpr u64 kBias = 0x8000000000000000ULL;
constexpr u64 kMaxRoot = 0xFFFFFFFFULL;
constexpr int kChunk = 128;          // codes per chunk
constexpr int kWords = 2 * kChunk;   // packed u32 words per chunk
constexpr int kCodesPerLane = kChunk / 32;

__device__ __forceinline__ u64 unbias(long long b) { return (u64)b ^ kBias; }
__device__ __forceinline__ long long rebias(u64 z) { return (long long)(z ^ kBias); }

// Szudzik(x, y) = y^2 + x if x < y else x^2 + x + y (operands < 2^32).
__device__ __forceinline__ u64 szudzik_pair(u64 x, u64 y) {
  return x < y ? y * y + x : x * x + x + y;
}

// floor(sqrt(z)), exact for every u64. The double-precision seed is within
// one of the root; the integer fix-up makes it exact. The clamp at 2^32-1
// keeps r*r from wrapping (isqrt(2^64-1) = 2^32-1), as pairing.py does.
__device__ __forceinline__ u64 isqrt_u64(u64 z) {
  u64 r = (u64)sqrt((double)z);
  if (r > kMaxRoot) r = kMaxRoot;
  while (r * r > z) --r;
  while (r < kMaxRoot && (r + 1) * (r + 1) <= z) ++r;
  return r;
}

__device__ __forceinline__ void szudzik_unpair(u64 z, u64& x, u64& y) {
  u64 s = isqrt_u64(z);
  u64 rem = z - s * s;
  if (rem < s) { x = rem; y = s; } else { x = s; y = rem - s; }
}

// One warp decodes one FOR-packed chunk (kernels/delta.py layout): lane L
// owns codes 4L..4L+3. Width 8: word L holds the lane's four deltas; width
// 16: words 2L, 2L+1; width 32 (and any other value but 8, 16, 64, as the
// reference's select does): words 4L..4L+3; width 64: raw (hi, lo) words i
// and 128+i. A lane's words go to w[8]: w[0] (width 8), w[0..1] (width
// 16), w[0..3] (width 32), or the hi words in w[0..3] and the lo words in
// w[4..7] (width 64); the other entries are 0.
constexpr int kLaneWords = 8;

// A lane's words with one vector load a class (rows 16-byte aligned: the
// C entries refuse packed words that are not): a u32 (width 8), a uint2
// (16), a uint4 (32), two uint4 (64).
__device__ __forceinline__ void chunk_words(const uint32_t* __restrict__ row,
                                                uint32_t width, int lane,
                                                uint32_t (&w)[kLaneWords]) {
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) w[j] = 0;
  if (width == 8) {
    w[0] = __ldg(row + lane);
  } else if (width == 16) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(row) + lane);
    w[0] = a.x;
    w[1] = a.y;
  } else {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row) + lane);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    if (width == 64) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + kChunk) + lane);
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    }
  }
}

// A lane's four raw (un-biased) codes from its words. The prefix sum of the
// deltas is exact in u64: a per-lane sum then a warp inclusive scan with
// __shfl_up_sync (every lane of the warp takes part); the anchor is added
// mod 2^64.
__device__ __forceinline__ void decode_chunk_words(const uint32_t (&w)[kLaneWords],
                                                   uint32_t width, uint32_t a_hi,
                                                   uint32_t a_lo, int lane,
                                                   u64 out[kCodesPerLane]) {
  if (width == 64) {
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) out[j] = ((u64)w[j] << 32) | (u64)w[4 + j];
    return;
  }
  u64 d[kCodesPerLane];
  if (width == 8) {
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) d[j] = (w[0] >> (8 * j)) & 0xFFu;
  } else if (width == 16) {
    d[0] = w[0] & 0xFFFFu; d[1] = w[0] >> 16;
    d[2] = w[1] & 0xFFFFu; d[3] = w[1] >> 16;
  } else {
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) d[j] = w[j];
  }
  u64 local[kCodesPerLane];
  u64 acc = 0;
#pragma unroll
  for (int j = 0; j < kCodesPerLane; ++j) { acc += d[j]; local[j] = acc; }
  u64 incl = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    u64 up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += up;
  }
  const u64 prefix = (((u64)a_hi << 32) | (u64)a_lo) + (incl - acc);
#pragma unroll
  for (int j = 0; j < kCodesPerLane; ++j) out[j] = prefix + local[j];
}

// Load and decode chunk `row` (kernels 3 and 6): returns the lane's four
// raw codes in out[].
__device__ __forceinline__ void decode_chunk_warp(const uint32_t* __restrict__ row,
                                                  uint32_t width, uint32_t a_hi,
                                                  uint32_t a_lo, int lane,
                                                  u64 out[kCodesPerLane]) {
  uint32_t w[kLaneWords];
  chunk_words(row, width, lane, w);
  decode_chunk_words(w, width, a_hi, a_lo, lane, out);
}

// Host side: the card's resident blocks of `kernel` at `threads` a block
// (SMs x blocks an SM from the occupancy calculator), looked up once a
// device into the caller's `cache` (0 until looked up). The lookups cost
// host time, and the small kernels are launched thousands of times a run.
constexpr int kMaxDevices = 64;

template <class Kernel>
long long resident_blocks(Kernel kernel, int threads, int (&cache)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = blocks;
  return blocks;
}

}  // namespace repro
