// Kernels 1 and 2: batched Szudzik pair and unpair.
//
// Replaces the Pallas kernels src/repro/kernels/szudzik.py `_pair_kernel`
// and `_unpair_kernel` (launched by `_tiled_call`, szudzik.py:126). Those
// tile u32 (hi, lo) pairs into (8, 128) blocks and emulate u64 with 16-bit
// limbs and a 32-step bit-restoring isqrt.
//
// Bound on the card: bytes. Pair reads two int64 operands and writes one
// int64 code (24 B/element); unpair reads 8 B and writes 16 B. A handful
// of integer operations per element (one double sqrt for unpair) is far
// below the 67 TFLOP/s float / integer rate, so the 3.35 TB/s HBM rate is
// the limit.
//
// Design: one thread per element, grid-stride loop, native u64 arithmetic
// (u64.cuh). Loads and stores of neighbouring threads are neighbouring
// 8-byte words, so every access is coalesced.
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

__global__ void unpair_kernel(const long long* __restrict__ z,
                              long long* __restrict__ x,
                              long long* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    repro::u64 a, b;
    repro::szudzik_unpair(repro::unbias(z[i]), a, b);
    x[i] = (long long)a;
    y[i] = (long long)b;
  }
}

constexpr int kThreads = 256;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // enough resident blocks to fill 132 SMs
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int repro_szudzik_pair(const long long* x, const long long* y,
                                  long long* out, long long n, void* stream) {
  if (n > 0)
    pair_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, y, out, n);
  return (int)cudaGetLastError();
}

extern "C" int repro_szudzik_unpair(const long long* z, long long* x, long long* y,
                                    long long n, void* stream) {
  if (n > 0)
    unpair_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(z, x, y, n);
  return (int)cudaGetLastError();
}
