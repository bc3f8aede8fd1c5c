// Device functions shared by the port's four Hopper kernels (sm_90a):
// Szudzik pair, exact unpair, and a warp-wide FOR chunk decode.
//
// The TPU kernels emulate u64 arithmetic with (hi, lo) u32 pairs and 16-bit
// limb products because the TPU has no 64-bit integers. Hopper has native
// `unsigned long long`, so the arithmetic here is plain u64. Codes cross the
// kernel boundary in the port's biased int64 form (u64 bits XOR 2^63, see
// repro_torch/_u64.py) and are un-biased on load.
#pragma once

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
// and 128+i. The prefix sum of the deltas is exact in u64: a per-lane sum
// then a warp inclusive scan with __shfl_up_sync; the anchor is added mod
// 2^64. Returns the four raw (un-biased) codes in out[].
__device__ __forceinline__ void decode_chunk_warp(const uint32_t* __restrict__ row,
                                                  uint32_t width, uint32_t a_hi,
                                                  uint32_t a_lo, int lane,
                                                  u64 out[kCodesPerLane]) {
  const int base = lane * kCodesPerLane;
  if (width == 64) {
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j)
      out[j] = ((u64)row[base + j] << 32) | (u64)row[kChunk + base + j];
    return;
  }
  u64 d[kCodesPerLane];
  if (width == 8) {
    uint32_t w = row[lane];
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) d[j] = (w >> (8 * j)) & 0xFFu;
  } else if (width == 16) {
    uint32_t w0 = row[2 * lane], w1 = row[2 * lane + 1];
    d[0] = w0 & 0xFFFFu; d[1] = w0 >> 16;
    d[2] = w1 & 0xFFFFu; d[3] = w1 >> 16;
  } else {
#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) d[j] = row[base + j];
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

}  // namespace repro
