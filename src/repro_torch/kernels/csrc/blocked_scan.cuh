// Blocked-16 inclusive scan helpers shared by the port's kernels, in the
// order XLA CPU takes an f32 cumsum (repro_torch/numerics.py:
// blocked_cumsum): sequential within 16-element blocks, the block totals
// scanned by the same rule, each block's exclusive prefix added to its
// elements.  Level 0 (the elements' own blocks) is scanned by the caller,
// in registers (scan_line: a lane's line of two blocks).  The upper levels
// go by shuffles for at most 64 blocks held a line a lane
// (scan_line_upper), else in memory by one warp (scan_upper); the
// exclusive prefixes of up to 256 groups of 16 blocks by one warp's
// shuffles (group_prefixes), of up to 4,096 by a CTA, a thread a
// supergroup of 16 groups (supergroup_prefixes).
#pragma once

#include <cuda_runtime.h>

namespace blocked_scan {

constexpr int kBlock = 16;      // scan block width
constexpr int kMaxLevels = 4;   // upper scan levels; covers T <= 16**5

// The upper levels of a scan, at most kMax of them (kMax = kMaxLevels
// unless a kernel asks for more: 8 covers every T of an int32).
template <int kMax>
struct LevelsOf {
  int n;                        // upper levels: 1 .. n
  int len[kMax];                // entries in each upper level
  int off[kMax];                // offset of each level in the f32 scratch
  int size;                     // total f32 scratch
};
using Levels = LevelsOf<kMaxLevels>;

// Level 1 holds the block totals of the cdf (ceil(T/16) entries); each
// further level the block totals of the one below, up to a level of at
// most 16 entries, which one thread scans.
template <int kMax = kMaxLevels>
__host__ __device__ inline LevelsOf<kMax> scan_levels(int T) {
  LevelsOf<kMax> lv{};
  int len = (T + kBlock - 1) / kBlock;
  for (;;) {
    lv.len[lv.n] = len;
    lv.off[lv.n] = lv.size;
    lv.size += len;
    ++lv.n;
    if (len <= kBlock || lv.n == kMax) break;
    len = (len + kBlock - 1) / kBlock;
  }
  return lv;
}

// The threads that scan together: one warp.
struct Warp {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// Inclusive blocked-16 scan of the upper levels, in place, through any
// pointer (shared or device memory).  Called by the whole group; returns
// synchronised.
template <class Group, int kMax>
__device__ inline void scan_upper(float* s_up, const LevelsOf<kMax>& lv,
                                  Group g) {
  const int rank = g.rank(), size = g.size();
  // The level loops run over the constant kMax, so that lv's fields are
  // read at constant indices (registers, not local memory).
#pragma unroll
  for (int k = 0; k + 1 < kMax; ++k) {
    if (k + 1 >= lv.n) break;
    float* x = s_up + lv.off[k];
    float* tot = s_up + lv.off[k + 1];
    for (int b = rank; b < lv.len[k + 1]; b += size) {
      const int lo = b * kBlock, n = min(kBlock, lv.len[k] - lo);
      float v[kBlock];                    // read at once, then added
#pragma unroll
      for (int e = 0; e < kBlock; ++e) v[e] = e < n ? x[lo + e] : 0.f;
      float acc = v[0];
#pragma unroll
      for (int e = 1; e < kBlock; ++e) {
        if (e < n) {
          acc = __fadd_rn(acc, v[e]);
          x[lo + e] = acc;
        }
      }
      tot[b] = acc;
    }
    g.sync();
  }
  if (rank == 0) {
    float* x = s_up + lv.off[lv.n - 1];
    const int n = lv.len[lv.n - 1];
    float v[kBlock];
#pragma unroll
    for (int e = 0; e < kBlock; ++e) v[e] = e < n ? x[e] : 0.f;
    float acc = v[0];
#pragma unroll
    for (int e = 1; e < kBlock; ++e) {
      if (e < n) {
        acc = __fadd_rn(acc, v[e]);
        x[e] = acc;
      }
    }
    for (int j = kBlock; j < n; ++j) {   // only past 16**(kMax + 1)
      acc = __fadd_rn(acc, x[j]);
      x[j] = acc;
    }
  }
  g.sync();
#pragma unroll
  for (int k = kMax - 2; k >= 0; --k) {
    if (k + 1 >= lv.n) continue;
    float* x = s_up + lv.off[k];
    const float* tot = s_up + lv.off[k + 1];
    for (int j = kBlock + rank; j < lv.len[k]; j += size)
      x[j] = __fadd_rn(x[j], tot[j / kBlock - 1]);
    g.sync();
  }
}

// Level 0 of one lane's line of two blocks, in place: each block's entries
// scanned in order, the two chains interleaved; t0 and t1 are the blocks'
// local totals.  Only the first `n` entries are scanned (all 2 * kBlock
// unless kMasked); the rest are left as they are.
template <bool kMasked>
__device__ __forceinline__ void scan_line(float (&c)[2 * kBlock], int n,
                                          float& t0, float& t1) {
  float a0 = c[0], a1 = c[kBlock];
#pragma unroll
  for (int j = 1; j < kBlock; ++j) {
    if (!kMasked || j < n) {
      a0 = __fadd_rn(a0, c[j]);
      c[j] = a0;
    }
    if (!kMasked || kBlock + j < n) {
      a1 = __fadd_rn(a1, c[kBlock + j]);
      c[kBlock + j] = a1;
    }
  }
  t0 = a0;
  t1 = a1;
}

// Level 1 of a scan held a line a lane: lane l holds blocks 2l and 2l + 1,
// with local totals t0 and t1.  Returns in ya, yb the blocks' inclusive
// level-1 values within their group of 16 blocks (8 lanes), the group's
// blocks added in order: the group's total is yb of its last lane.
__device__ __forceinline__ void scan_line_groups(float t0, float t1,
                                                 float& ya, float& yb) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, i = lane & 7, base = lane & ~7;
  float acc = 0.f;                       // the group's blocks before ours
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const float a = __shfl_sync(kFull, t0, base + j);
    const float b = __shfl_sync(kFull, t1, base + j);
    if (j < i) acc = __fadd_rn(j == 0 ? a : __fadd_rn(acc, a), b);
  }
  ya = i == 0 ? t0 : __fadd_rn(acc, t0);
  yb = __fadd_rn(ya, t1);
}

// The upper levels of a scan held a line a lane, for at most 64 level-0
// blocks (T <= 1024): lane l holds blocks 2l and 2l + 1, with local totals
// t0 and t1 (anything past the last block).  In registers and shuffles,
// in the blocked-16 order: level 1 sequential within groups of 16 blocks
// (scan_line_groups), level 2 (at most 4 group totals) sequential, each
// group's exclusive prefix added to its blocks.  Returns the exclusive
// prefixes p0 and p1 of the lane's two blocks (+0 for block 0) and the
// scan's last entry as it forms it: the last block's local total plus that
// block's exclusive prefix.  Called by the whole warp.
__device__ __forceinline__ void scan_line_upper(float t0, float t1, int nb,
                                                float& p0, float& p1,
                                                float& total) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float ya, yb;
  scan_line_groups(t0, t1, ya, yb);
  const int g = lane >> 3;               // the groups before ours
  const float g0 = __shfl_sync(kFull, yb, 7);
  const float g1 = __shfl_sync(kFull, yb, 15);
  const float g2 = __shfl_sync(kFull, yb, 23);
  if (g > 0) {
    float pre = g0;
    if (g > 1) pre = __fadd_rn(pre, g1);
    if (g > 2) pre = __fadd_rn(pre, g2);
    ya = __fadd_rn(ya, pre);
    yb = __fadd_rn(yb, pre);
  }
  p1 = ya;
  p0 = __shfl_up_sync(kFull, yb, 1);
  if (lane == 0) p0 = 0.f;
  const int ob = nb - 1;
  const float last = nb == 1 ? t0
                     : (ob & 1) ? __fadd_rn(t1, p1) : __fadd_rn(t0, p0);
  total = __shfl_sync(kFull, last, ob >> 1);
}

// The exclusive prefixes of ng <= 256 group totals x[0 .. ng) (the totals
// of groups of 16 blocks: level 2 of a scan of up to 65,536 entries), in
// the blocked-16 order: sequential within supergroups of 16 groups, the
// at most 16 supergroup totals sequential, each supergroup's exclusive
// prefix added to its groups.  Lane l holds groups 8l .. 8l + 7, so lanes
// 2s and 2s + 1 hold supergroup s.  Writes pre[g] for g < ng: +0 for
// group 0, else the inclusive value of group g - 1, as scan_line_upper
// forms it for at most 64 blocks.  Called by one whole warp.
__device__ inline void group_prefixes(const float* x, int ng, float* pre) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, s = lane >> 1;
  float v[8], inc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 8 * lane + e < ng ? x[8 * lane + e] : 0.f;
  float a = v[0];                        // the lane's own values in order
  inc[0] = a;
#pragma unroll
  for (int e = 1; e < 8; ++e) inc[e] = a = __fadd_rn(a, v[e]);
  const float left = __shfl_up_sync(kFull, a, 1);
  if (lane & 1) {                        // on from the even lane's total
    a = __fadd_rn(left, v[0]);
    inc[0] = a;
#pragma unroll
    for (int e = 1; e < 8; ++e) inc[e] = a = __fadd_rn(a, v[e]);
  }
  float sp = 0.f;                        // supergroups before ours, in order
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    const float t = __shfl_sync(kFull, a, 2 * k + 1);
    if (k < s) sp = k == 0 ? t : __fadd_rn(sp, t);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int g = 8 * lane + e;
    if (g + 1 < ng) pre[g + 1] = s > 0 ? __fadd_rn(inc[e], sp) : inc[e];
  }
  if (lane == 0) pre[0] = 0.f;
}

// The exclusive prefixes of ng <= 4,096 group totals x[0 .. ng) (level 2
// of a scan of up to 1,048,576 entries), in the blocked-16 order:
// sequential within supergroups of 16 groups, one thread a supergroup;
// the at most 256 supergroup totals (sg) scanned by group_prefixes into
// their exclusive prefixes (spre), by warp 0; each supergroup's prefix
// added to its groups.  Writes pre[g] for g < ng as group_prefixes does
// for ng <= 256.  sg and spre hold ceil(ng / 16) floats each.  Called by
// the whole CTA, of at least ceil(ng / 16) threads; returns synchronised.
__device__ inline void supergroup_prefixes(const float* x, int ng,
                                           float* pre, float* sg,
                                           float* spre) {
  const int ns = (ng + kBlock - 1) / kBlock, s = threadIdx.x;
  const int g0 = s * kBlock, n = min(kBlock, ng - g0);
  if (s < ns) {                          // the supergroup's total
    float a = x[g0];
#pragma unroll
    for (int e = 1; e < kBlock; ++e)
      if (e < n) a = __fadd_rn(a, x[g0 + e]);
    sg[s] = a;
  }
  __syncthreads();
  if (threadIdx.x < 32) group_prefixes(sg, ns, spre);
  __syncthreads();
  if (s < ns) {                          // its own values again (rather
    const float p = spre[s];             // than kept in registers across
    float a = x[g0];                     // the scan), each plus its prefix
#pragma unroll
    for (int e = 0; e < kBlock; ++e) {
      if (e > 0 && e < n) a = __fadd_rn(a, x[g0 + e]);
      if (g0 + e + 1 < ng) pre[g0 + e + 1] = s > 0 ? __fadd_rn(a, p) : a;
    }
    if (s == 0) pre[0] = 0.f;
  }
  __syncthreads();
}

}  // namespace blocked_scan
