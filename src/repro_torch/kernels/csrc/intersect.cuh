// Device code of the exact factorized node2vec step, shared by the
// intersect kernel (kernel 5) and the fused rewalk step (kernel 6).
//
// One warp owns one row. Windows are int64 values below 2^32, sorted,
// padded with kSent = 0xFFFFFFFF (kernels/intersect.py). Entry j*32 + lane
// of the row belongs to lane `lane` in sub-slot j, so every load of a
// sub-slot is 32 neighbouring 8-byte words, and rank order (position order)
// is sub-slot first, lane second.
#pragma once

#include <stdint.h>

namespace repro {

constexpr long long kSent = 0xFFFFFFFFLL;
constexpr int kMaxSubSlots = 32;     // per-lane 2-bit classes in one u64: D <= 1024

// Copy the prev window of a row into this warp's shared slice (after every
// lane has finished reading the slice's previous row).
__device__ __forceinline__ void load_window_shared(const long long* __restrict__ row,
                                                   long long* sh, int d, int lane) {
  __syncwarp();
  for (int i = lane; i < d; i += 32) sh[i] = row[i];
  __syncwarp();
}

// x in the sorted window sh[0..d)? Lower bound by binary search (the plain
// version's `member_sorted`: searchsorted, clamp, equality).
__device__ __forceinline__ bool member_sorted(const long long* sh, int d, long long x) {
  int lo = 0, hi = d;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (sh[mid] < x) lo = mid + 1; else hi = mid;
  }
  if (lo > d - 1) lo = d - 1;
  return sh[lo] == x;
}

// The group-then-member selection of `intersect._choose_math` for one row.
// nv_row: the row's v window (global memory); sh_p: its prev window in
// shared memory. The f32 mass arithmetic is written with round-to-nearest
// intrinsics, which the compiler never contracts into FMAs, in the
// reference's order: m0 = c0 * inv_p, m1 = c1, m2 = c2 * inv_q,
// t = u_group * ((m0 + m1) + m2), grp = (t >= m0) + (t >= m0 + m1),
// clamped to the last non-empty group, r = min(int(u_rank * cg), cg - 1).
// Classes: 0 not valid, 1 == prev, 2 common, 3 far (2 bits per sub-slot).
// The r-th member of the chosen group is found by a warp prefix count
// (ballot, popc) over the sub-slots in order. All lanes return the result.
__device__ __forceinline__ void choose_warp(const long long* __restrict__ nv_row,
                                            const long long* sh_p, int d, long long prev,
                                            float u_group, float u_rank, float inv_p,
                                            float inv_q, int lane, long long& nxt,
                                            bool& found) {
  const unsigned full = 0xFFFFFFFFu;
  const int nsub = d >> 5;
  unsigned long long cls = 0;
  int c0 = 0, c1 = 0, c2 = 0;
  for (int j = 0; j < nsub; ++j) {
    const long long x = nv_row[j * 32 + lane];
    int c = 0;
    if (x != kSent) {
      if (x == prev) c = 1;
      else c = member_sorted(sh_p, d, x) ? 2 : 3;
    }
    cls |= (unsigned long long)c << (2 * j);
    c0 += __popc(__ballot_sync(full, c == 1));
    c1 += __popc(__ballot_sync(full, c == 2));
    c2 += __popc(__ballot_sync(full, c == 3));
  }
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
  nxt = 0;
  if (!found) return;
  const unsigned long long want = (unsigned long long)(grp + 1);
  int before = 0;
  for (int j = 0; j < nsub; ++j) {
    const bool m = ((cls >> (2 * j)) & 3ULL) == want;
    const unsigned bal = __ballot_sync(full, m);
    const int cnt = __popc(bal);
    if (r < before + cnt) {               // warp-uniform: the member is here
      const int pre = __popc(bal & ((1u << lane) - 1u));
      const bool mine = m && pre == r - before;
      const int src = __ffs(__ballot_sync(full, mine)) - 1;
      const long long val = mine ? nv_row[j * 32 + lane] : 0;
      nxt = __shfl_sync(full, val, src);
      return;
    }
    before += cnt;
  }
}

}  // namespace repro
