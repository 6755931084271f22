// Blocked-16 inclusive scan helpers shared by the port's kernels, in the
// order XLA CPU takes an f32 cumsum (repro_torch/numerics.py:
// blocked_cumsum): sequential within 16-element blocks, the block totals
// scanned by the same rule, each block's exclusive prefix added to its
// elements.  Level 0 (the elements' own blocks) is scanned by the caller;
// these helpers scan the upper levels in shared memory, by the whole CTA
// or by one warp.
#pragma once

#include <cuda_runtime.h>

namespace blocked_scan {

constexpr int kBlock = 16;      // scan block width
constexpr int kMaxLevels = 4;   // upper scan levels; covers T <= 16**5

struct Levels {
  int n;                        // upper levels: 1 .. n
  int len[kMaxLevels];          // entries in each upper level
  int off[kMaxLevels];          // offset of each level in the f32 scratch
  int size;                     // total f32 scratch
};

// Level 1 holds the block totals of the cdf (ceil(T/16) entries); each
// further level the block totals of the one below, up to a level of at
// most 16 entries, which one thread scans.
__host__ __device__ inline Levels scan_levels(int T) {
  Levels lv{};
  int len = (T + kBlock - 1) / kBlock;
  for (;;) {
    lv.len[lv.n] = len;
    lv.off[lv.n] = lv.size;
    lv.size += len;
    ++lv.n;
    if (len <= kBlock || lv.n == kMaxLevels) break;
    len = (len + kBlock - 1) / kBlock;
  }
  return lv;
}

// The threads that scan together: the whole CTA, or one warp.
struct Cta {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};
struct Warp {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// Inclusive blocked-16 scan of the upper levels, in place.  Called by the
// whole group; returns synchronised.
template <class Group>
__device__ inline void scan_upper(float* s_up, const Levels& lv, Group g) {
  const int rank = g.rank(), size = g.size();
  // The level loops run over the constant kMaxLevels, so that lv's
  // fields are read at constant indices (registers, not local memory).
#pragma unroll
  for (int k = 0; k + 1 < kMaxLevels; ++k) {
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
    for (int j = kBlock; j < n; ++j) {   // only past 16**5 entries
      acc = __fadd_rn(acc, x[j]);
      x[j] = acc;
    }
  }
  g.sync();
#pragma unroll
  for (int k = kMaxLevels - 2; k >= 0; --k) {
    if (k + 1 >= lv.n) continue;
    float* x = s_up + lv.off[k];
    const float* tot = s_up + lv.off[k + 1];
    for (int j = kBlock + rank; j < lv.len[k]; j += size)
      x[j] = __fadd_rn(x[j], tot[j / kBlock - 1]);
    g.sync();
  }
}

// The scan by the whole CTA.
__device__ inline void scan_upper(float* s_up, const Levels& lv) {
  scan_upper(s_up, lv, Cta{});
}

}  // namespace blocked_scan
