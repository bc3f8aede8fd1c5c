// Device code of the exact factorized node2vec step, shared by the
// intersect kernels (kernel 5, windowed and CSR entries) and the fused
// rewalk step (kernel 6).
//
// One warp owns one row. A row is a sorted list of neighbor ids padded with
// kSent = 0xFFFFFFFF to nsub * 32 entries. Entry j*32 + lane belongs to lane
// `lane` in sub-slot j, so every load of a sub-slot is 32 neighbouring
// 8-byte words, and rank order (position order) is sub-slot first, lane
// second. A row loader says where a row's entries come from: a window row
// (int64 [B, d] windows built outside the kernel, values below 2^32) or a
// CSR segment (the first min(deg, dmax) biased edge codes of a vertex,
// whose low word is the neighbor). Both give u32 entries, and both rows
// stay in registers, NSUB entries a lane.
//
// Membership of v's entries in prev's row (the "common" group) is one
// path for every row: prev's row is stored in the warp's shared slice as
// u32, and every v entry is binary-searched there (`member_sorted`). Its
// cost does not depend on how many neighbors v and prev share.
#pragma once

#include <stdint.h>

namespace repro {

constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr int kMaxSubSlots = 32;     // D <= 1024: 32 entries a lane

// A row of an int64 window: entry i is window[i] (i < d, every entry read).
struct WindowRow {
  const long long* p;
  __device__ __forceinline__ uint32_t operator()(int i) const { return (uint32_t)p[i]; }
};

// A CSR segment: entry i is the low word of codes[start + i] for i < n, and
// kSent past it (nothing is read there).
struct CsrRow {
  const long long* codes;
  long long start;
  int n;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return i < n ? (uint32_t)codes[start + i] : kSent;
  }
};

// The two CSR segments of a row (the rows of v and prev, each cut to
// dmax) and whether either vertex has more than dmax neighbors.
struct CsrSegs {
  long long sv, sp;
  int nv, np;
  bool over;
};

__device__ __forceinline__ CsrSegs csr_segs(const int* __restrict__ offsets, long long v,
                                            long long prev, int dmax) {
  const long long sv = offsets[v], sp = offsets[prev];
  const int dv = (int)(offsets[v + 1] - sv), dp = (int)(offsets[prev + 1] - sp);
  return CsrSegs{sv, sp, dv < dmax ? dv : dmax, dp < dmax ? dp : dmax,
                 dv > dmax || dp > dmax};
}

// A row's entries into registers: x[j] = entry j*32 + lane (kSent for
// sub-slots past nsub). NSUB is a compile-time bound on nsub, so x stays in
// registers.
template <int NSUB, class Row>
__device__ __forceinline__ void load_entries(const Row& row, int nsub, int lane,
                                             uint32_t (&x)[NSUB]) {
#pragma unroll
  for (int j = 0; j < NSUB; ++j) x[j] = j < nsub ? row(j * 32 + lane) : kSent;
}

// A warp's shared scratch: prev's row, 32 NSUB words.
template <int NSUB>
__host__ __device__ constexpr int scratch_words() { return 32 * NSUB; }

// Membership of each of a lane's entries xv[j] in prev's row xp (registers
// of the whole warp, sorted in rank order, SENT past the row), as the plain
// version's `member_sorted` (searchsorted, clamp, equality): prev's row
// goes to the warp's shared slice and each v entry is binary-searched
// there. The NSUB lower-bound searches run interleaved and branch-free,
// log2(32 nsub) steps each with the same trip count on every lane: their
// shared-memory reads overlap, and the warp never diverges. After the loop
// the entry is at base or base + 1. A valid entry never equals SENT, so
// searching the SENT-padded row gives the plain version's booleans.
template <int NSUB>
__device__ __forceinline__ void member_sorted(const uint32_t (&xv)[NSUB],
                                              const uint32_t (&xp)[NSUB], int nsub,
                                              uint32_t* sh, int lane, bool (&in)[NSUB]) {
  __syncwarp();   // every lane has finished reading the previous row
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
    if (j < nsub) sh[j * 32 + lane] = xp[j];
  __syncwarp();
  const int n = 32 * nsub;
  int base[NSUB];
#pragma unroll
  for (int j = 0; j < NSUB; ++j) base[j] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
      base[j] = sh[base[j] + half] < xv[j] ? base[j] + half : base[j];
    len -= half;
  }
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
    in[j] = sh[base[j]] == xv[j] ||
            (base[j] + 1 < n && sh[base[j] + 1] == xv[j]);
}

// The group-then-member selection of `intersect._choose_math` for one row.
// xv, xp: the row's v and prev entries (registers); sh: the warp's shared
// scratch (scratch_words<NSUB>()). The f32 mass arithmetic is written with round-to-nearest
// intrinsics, which the compiler never contracts into FMAs, in the
// reference's order: m0 = c0 * inv_p, m1 = c1,
// m2 = c2 * inv_q, t = u_group * ((m0 + m1) + m2), grp = (t >= m0) +
// (t >= m0 + m1), clamped to the last non-empty group,
// r = min(int(u_rank * cg), cg - 1).
// Classes: 0 not valid, 1 == prev, 2 common, 3 far. The r-th member of the
// chosen group is found by a warp prefix count (ballot, popc) over the
// sub-slots in order. All lanes return the result.
template <int NSUB>
__device__ __forceinline__ void choose_warp(const uint32_t (&xv)[NSUB],
                                            const uint32_t (&xp)[NSUB], int nsub,
                                            uint32_t* sh, long long prev,
                                            float u_group, float u_rank, float inv_p,
                                            float inv_q, int lane, long long& nxt,
                                            bool& found) {
  const unsigned full = 0xFFFFFFFFu;
  bool ok[NSUB], in[NSUB];
#pragma unroll
  for (int j = 0; j < NSUB; ++j) ok[j] = xv[j] != kSent && (long long)xv[j] != prev;
  member_sorted<NSUB>(xv, xp, nsub, sh, lane, in);
  // the group counts: c0 alone, c1 and c2 in the halves of one word (each
  // at most 32 NSUB <= 1024), summed over the warp
  int cls[NSUB];
  unsigned n0 = 0, n12 = 0;
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
    cls[j] = xv[j] == kSent ? 0 : (!ok[j] ? 1 : (in[j] ? 2 : 3));
    n0 += cls[j] == 1;
    n12 += cls[j] == 2 ? 1u : (cls[j] == 3 ? 0x10000u : 0u);
  }
  const int c0 = (int)__reduce_add_sync(full, n0);
  n12 = __reduce_add_sync(full, n12);
  const int c1 = (int)(n12 & 0xFFFFu), c2 = (int)(n12 >> 16);
  found = (c0 + c1 + c2) > 0;
  const float m0 = __fmul_rn((float)c0, inv_p);
  const float m1 = (float)c1;
  const float m2 = __fmul_rn((float)c2, inv_q);
  const float m01 = __fadd_rn(m0, m1);
  const float t = __fmul_rn(u_group, __fadd_rn(m01, m2));
  int grp = (t >= m0 ? 1 : 0) + (t >= m01 ? 1 : 0);
  const int last = c2 > 0 ? 2 : (c1 > 0 ? 1 : 0);
  if (grp > last) grp = last;
  const int cg = grp == 0 ? c0 : (grp == 1 ? c1 : c2);
  int r = __float2int_rz(__fmul_rn(u_rank, (float)cg));
  if (r > cg - 1) r = cg - 1;
  // the sub-slot holding the r-th member, and within it the lane: each
  // lane keeps its candidate, one shuffle at the end
  int before = 0, src = 0;
  uint32_t pick = 0;
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
    if (j < nsub) {
      const bool m = cls[j] == grp + 1;
      const unsigned bal = __ballot_sync(full, m);
      const int cnt = __popc(bal);
      if (before <= r && r < before + cnt) {   // warp-uniform: the member is here
        const int pre = __popc(bal & ((1u << lane) - 1u));
        src = __ffs(__ballot_sync(full, m && pre == r - before)) - 1;
        pick = xv[j];
      }
      before += cnt;
    }
  }
  const uint32_t val = __shfl_sync(full, pick, src);
  nxt = found ? (long long)val : 0;
}

// The sub-slot bound a kernel is instantiated for: the least of 4, 8, 16,
// 32 that holds nsub (0 when nsub exceeds kMaxSubSlots).
inline int nsub_bound(int nsub) {
  for (int b = 4; b <= kMaxSubSlots; b *= 2)
    if (nsub <= b) return b;
  return 0;
}

}  // namespace repro
