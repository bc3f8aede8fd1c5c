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
// Pair design: a grid of the card's resident blocks (SMs x blocks an SM,
// from the occupancy calculator), each thread taking two consecutive
// elements a step with 16-byte loads of x and y and a 16-byte store of the
// codes, kPairUnroll steps a turn: every load of a turn is issued before the
// first code is formed, so 2 kPairUnroll 16-byte loads a thread are in
// flight. Steps are strided by the grid's thread count, so neighbouring
// threads touch neighbouring 16-byte words and every thread's share differs
// from another's by at most one step (no tail wave). No cache hint: the
// streaming hint (evict first) measured as fast alone, but the callers read
// the codes again at once (the prefix read's segmented binary searches read
// them 29 times), and evict-first codes may leave L2 before those reads
// (not measured). `out` is 16-byte aligned (the wrapper allocates it; the
// C entry refuses another); an odd last element is done by thread 0. An
// operand view may start at any 8-byte offset: one that is not 16-byte
// aligned takes two 8-byte loads a step (a template argument, so the loop
// has no branch).
//
// Unpair design: one thread per element, grid-stride loop, native u64
// arithmetic (u64.cuh). Loads and stores of neighbouring threads are
// neighbouring 8-byte words, so every access is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "u64.cuh"

namespace {

constexpr int kPairThreads = 256;
constexpr int kPairUnroll = 4;   // two-element steps a thread has in flight

__device__ __forceinline__ long long pair1(long long x, long long y) {
  return repro::rebias(repro::szudzik_pair((repro::u64)x, (repro::u64)y));
}

// Elements 2i and 2i+1 of p: one 16-byte load, or two 8-byte ones where p
// is not 16-byte aligned.
template <bool kAligned>
__device__ __forceinline__ longlong2 load2(const long long* __restrict__ p, long long i) {
  if (kAligned) return __ldg(reinterpret_cast<const longlong2*>(p) + i);
  return make_longlong2(__ldg(p + 2 * i), __ldg(p + 2 * i + 1));
}

// out[i] = pair(x[i], y[i]) for i < n; out is 16-byte aligned, x iff XA,
// y iff YA.
template <bool XA, bool YA>
__global__ void __launch_bounds__(kPairThreads)
pair_kernel(const long long* __restrict__ xs, const long long* __restrict__ ys,
            long long* __restrict__ out, long long n) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long T = (long long)gridDim.x * blockDim.x;
  if (t == 0 && (n & 1)) out[n - 1] = pair1(xs[n - 1], ys[n - 1]);
  longlong2* os = reinterpret_cast<longlong2*>(out);
  const long long steps = n >> 1;
  for (long long i = t; i < steps; i += kPairUnroll * T) {
    longlong2 a[kPairUnroll], b[kPairUnroll];
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      const long long s = i + u * T;
      if (s < steps) {
        a[u] = load2<XA>(xs, s);
        b[u] = load2<YA>(ys, s);
      }
    }
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      const long long s = i + u * T;
      if (s < steps) os[s] = make_longlong2(pair1(a[u].x, b[u].x), pair1(a[u].y, b[u].y));
    }
  }
}

template <bool XA, bool YA>
void launch_pair(const long long* x, const long long* y, long long* out, long long n,
                 cudaStream_t stream) {
  static int resident[repro::kMaxDevices] = {};
  const long long steps = n >> 1;
  long long grid = (steps + kPairThreads - 1) / kPairThreads;
  const long long cap = repro::resident_blocks(pair_kernel<XA, YA>, kPairThreads, resident);
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  pair_kernel<XA, YA><<<(int)grid, kPairThreads, 0, stream>>>(x, y, out, n);
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// x, y: int64 [n], each 8-byte aligned (any torch view); out: int64 [n],
// 16-byte aligned.
extern "C" int repro_szudzik_pair(const long long* x, const long long* y,
                                  long long* out, long long n, void* stream) {
  if (!aligned16(out)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const bool xa = aligned16(x), ya = aligned16(y);
  cudaStream_t s = (cudaStream_t)stream;
  if (xa && ya) launch_pair<true, true>(x, y, out, n, s);
  else if (xa) launch_pair<true, false>(x, y, out, n, s);
  else if (ya) launch_pair<false, true>(x, y, out, n, s);
  else launch_pair<false, false>(x, y, out, n, s);
  return (int)cudaGetLastError();
}

extern "C" int repro_szudzik_unpair(const long long* z, long long* x, long long* y,
                                    long long n, void* stream) {
  if (n > 0)
    unpair_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(z, x, y, n);
  return (int)cudaGetLastError();
}
