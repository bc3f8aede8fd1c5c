// Kernel 7: the fused skip-gram negative-sampling (SGNS) step.
//
// Replaces the Pallas kernel src/repro/kernels/sgns.py `_sgns_kernel`
// (launched by `sgns_fused`, sgns.py:132). There an (8, D) tile of rows,
// D padded to 128 lanes, computes the K negative logits as a batched
// [8, D] x [D, K] MXU product and the closed-form gradients (`_sgns_math`)
// without writing the logits to memory.
//
// Bound on the card: bytes. A row reads u, v+ and K rows v- (4 (K + 2) D
// bytes) and writes du, dv+ and K rows dv- (as many) and one loss; its
// arithmetic is about 4 (K + 1) D flops, under 0.6 flop a byte, where the
// card's f32 rate over its 3.35 TB/s is 20. So nothing needs the tensor
// cores, and the kernel's one aim is to move each byte once.
//
// Design: one warp per row, no tiling. Each lane owns 4 consecutive
// columns of every 128-column chunk of the row (float4 loads and stores
// when D % 4 == 0 and the rows are 16-byte aligned, scalar otherwise,
// masked at the ragged edge). Pass 1 accumulates the K + 1 dot products
// chunk by chunk, then warp-shuffle sums give every lane the logits, the
// loss and the K + 1 gates in registers. Pass 2 writes the gradients,
// last chunk first: the last chunk is still in registers, so at D <= 128
// every input byte is read once; wider rows read their earlier chunks
// again (mostly from L1/L2). K is a template argument (1..kMaxK), so a
// lane's K negative columns stay in registers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 16;
constexpr int kChunk = 128;   // columns a warp covers per step: 32 lanes x 4
constexpr int kWarps = 8;     // warps (rows in flight) per block

__device__ __forceinline__ void load4(const float* __restrict__ p, int col, int d, bool vec,
                                      float (&x)[4]) {
  if (vec) {
    if (col < d) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + col));
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = col + i < d ? __ldg(p + col + i) : 0.f;
}

__device__ __forceinline__ void store4(float* __restrict__ p, int col, int d, bool vec,
                                       const float (&x)[4]) {
  if (vec) {
    if (col < d) *reinterpret_cast<float4*>(p + col) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < d) p[col + i] = x[i];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// log(1 + e^x), stable for large |x| (torch.logaddexp(0, x) on the card)
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// torch.sigmoid on the card: 1 / (1 + e^-x)
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    sgns_kernel(const float* __restrict__ u, const float* __restrict__ vp,
                const float* __restrict__ vn, float* __restrict__ loss_out,
                float* __restrict__ du, float* __restrict__ dvp, float* __restrict__ dvn,
                long long b, int d, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < b; r += warps) {
    const float* ur = u + r * d;
    const float* pr = vp + r * d;
    const float* nr = vn + r * K * d;
    float xu[4], xp[4], xn[K][4];
    float pos = 0.f, neg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) neg[k] = 0.f;
    // pass 1: the K + 1 logits
    for (int c = 0; c < n_chunks; ++c) {
      const int col = c * kChunk + 4 * lane;
      load4(ur, col, d, vec, xu);
      load4(pr, col, d, vec, xp);
#pragma unroll
      for (int k = 0; k < K; ++k) load4(nr + (long long)k * d, col, d, vec, xn[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pos += xu[i] * xp[i];
#pragma unroll
        for (int k = 0; k < K; ++k) neg[k] += xu[i] * xn[k][i];
      }
    }
    pos = warp_sum(pos);
    float neg_loss = 0.f, gn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      neg[k] = warp_sum(neg[k]);
      neg_loss += softplus(neg[k]);
      gn[k] = sigmoid(neg[k]);
    }
    const float gp = -sigmoid(-pos);
    if (lane == 0) loss_out[r] = softplus(-pos) + neg_loss;
    // pass 2: the gradients, last chunk (still in registers) first
    for (int c = n_chunks - 1; c >= 0; --c) {
      const int col = c * kChunk + 4 * lane;
      if (c != n_chunks - 1) {
        load4(ur, col, d, vec, xu);
        load4(pr, col, d, vec, xp);
#pragma unroll
        for (int k = 0; k < K; ++k) load4(nr + (long long)k * d, col, d, vec, xn[k]);
      }
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc += gn[k] * xn[k][i];
        o[i] = gp * xp[i] + acc;
      }
      store4(du + r * d, col, d, vec, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = gp * xu[i];
      store4(dvp + r * d, col, d, vec, o);
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = gn[k] * xu[i];
        store4(dvn + (r * K + k) * d, col, d, vec, o);
      }
    }
  }
}

template <int K>
void launch(const float* u, const float* vp, const float* vn, float* loss, float* du, float* dvp,
            float* dvn, long long b, int d, bool vec, cudaStream_t stream) {
  const long long blocks = (b + kWarps - 1) / kWarps;
  const long long cap = 132LL * 16;
  const int grid = (int)(blocks < cap ? blocks : cap);
  sgns_kernel<K><<<grid, kWarps * 32, 0, stream>>>(u, vp, vn, loss, du, dvp, dvn, b, d, vec);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// u, vp [b, d], vn [b, k, d] f32, row-major and contiguous; loss [b], du,
// dvp [b, d], dvn [b, k, d]. Needs b >= 1, d >= 1, 1 <= k <= kMaxK.
extern "C" int repro_sgns_step(const float* u, const float* vp, const float* vn, float* loss,
                               float* du, float* dvp, float* dvn, long long b, int k, int d,
                               void* stream) {
  if (b < 1 || d < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(u) && aligned16(vp) && aligned16(vn) &&
                   aligned16(du) && aligned16(dvp) && aligned16(dvn);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define REPRO_SGNS_CASE(K_) \
  case K_:                  \
    launch<K_>(u, vp, vn, loss, du, dvp, dvn, b, d, vec, s); \
    break;
    REPRO_SGNS_CASE(1) REPRO_SGNS_CASE(2) REPRO_SGNS_CASE(3) REPRO_SGNS_CASE(4)
    REPRO_SGNS_CASE(5) REPRO_SGNS_CASE(6) REPRO_SGNS_CASE(7) REPRO_SGNS_CASE(8)
    REPRO_SGNS_CASE(9) REPRO_SGNS_CASE(10) REPRO_SGNS_CASE(11) REPRO_SGNS_CASE(12)
    REPRO_SGNS_CASE(13) REPRO_SGNS_CASE(14) REPRO_SGNS_CASE(15) REPRO_SGNS_CASE(16)
#undef REPRO_SGNS_CASE
  }
  return (int)cudaGetLastError();
}
