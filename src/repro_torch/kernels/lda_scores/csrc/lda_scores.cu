// CGS conditional and inverse-CDF draw kernel, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/lda_scores/lda_scores.py:
// lda_scores_pallas (body _kernel).  Per token: p_t = (n_td + alpha) *
// (n_wt + beta) / (n_t + beta_bar) over the T topics, the cumsum c of p,
// norm = c[T-1] and the draw z = #{t : c_t <= u * norm}.  Two forms of
// one kernel (template <bool kPass>):
//   * the rows form, lda_scores_pallas itself: token i reads row i of the
//     gathered (n, T) n_td and n_wt rows and the one shared n_t, and
//     writes z and norm;
//   * the pass form, the draw of the vectorized nomad pass
//     (src/repro/core/nomad.py:_vectorized_pass): token s reads rows
//     doc_row[s], wrd_row[s] and nt_row[s] of the flat n_td, n_wt and n_t
//     tables, minus its own count (one at topic z[s]) in each, and its draw
//     is clipped to [0, T-1].  The caller passes the tokens of one cell
//     only.  The tables are read only: the caller applies the exact
//     integer deltas after the launch, so every token sees the counts as
//     they were when the pass began.
//
// Layout.  One warp per token at a time; each warp takes a run of a few
// consecutive tokens (as many as spread the launch over the card's
// resident warps kWaves times, at most 32; the tokens of a cell pass come
// sorted by worker and word, so a run mostly shares its n_wt and n_t
// rows) and draws them one after another.  Lane l holds line l of each
// 1024-topic chunk: topics 32l .. 32l + 31, two scan blocks.  Per token:
//   * the lane reads its line of the three rows as 16-byte vectors (eight
//     loads a row, all in flight at once), and asks L1 for its lines of
//     the next token's n_td and n_wt rows, so that their round trip to L2
//     overlaps this token;
//   * p is formed and level 0 scanned in registers;
//   * for T <= 1024 the upper levels of the scan go by shuffles in
//     registers (blocked_scan.cuh: scan_line_upper); above, the lines of
//     earlier chunks (16-byte aligned, past the upper levels) and the block
//     totals go to the warp's slice of shared memory and the warp scans
//     them there (scan_upper);
//   * the lanes count c <= u * norm and __reduce_add_sync sums.
// That stored layout keeps the level-0 cdf of every chunk but the last in
// shared memory, so it fits only up to T = 7,168 (211,968 of the 232,448
// bytes a block may use; lda_scores.py:placement).  Above, the deep layout
// (lda_scores_deep_kernel) holds only the upper levels, about T/15 floats
// a warp, and forms each line's products twice: pass 1 scans level 0 in
// registers and stores the block totals, scan_upper scans them, and pass
// 2 forms and scans the line again and counts with each block's prefix.
// Both passes round alike, so the cdf is the one the stored layout
// forms.  The levels of the 8 warps sit in shared memory up to T =
// 108,944; above, each warp's lie in a device scratch that the wrapper
// allocates (a slice for each warp of a grid of at most two CTAs an SM,
// whose warps then loop over the runs of tokens).
// In the pass form the token's own count is taken out of one topic only:
// every lane forms p at that topic from three scalar loads, and the lane
// that holds it puts it in place of its entry (in both passes of the deep
// layout).
//
// Exactness.  z must equal the plain version's (ref.py) bit for bit, and
// z depends on every rounding of c, so every float op rounds where the
// reference rounds it:
//   * the cumsum is XLA CPU's blocked-16 order (repro_torch/numerics.py):
//     sequential within 16-element blocks, the block totals scanned by the
//     same rule, each block's exclusive prefix added to its elements;
//   * norm is c[T-1] as that scan forms it, the last block's local total
//     plus its exclusive prefix, not a separate reduction;
//   * no fma contraction: the reference has no product that is added
//     (p is a product divided, then scanned), and every float op here is
//     written as __fadd_rn, __fmul_rn or __fdiv_rn, which nvcc never
//     contracts; the build relies on no flag such as -fmad=false;
//   * the draw is an integer count, exact in any order of the lanes.
//
// Bound.  Per drawn token the kernel reads two T-wide i32 rows (8 KiB at
// T = 1024; the n_t row is the same for every token of a worker and stays
// in cache) and does about 7 T float operations, so it is bound by bytes:
// 8 T B a token against 7 T operations, at 3.35 TB/s and 67 TFLOP/s.  The
// rows are mostly L2 (and, within a run, L1) hits; what bounds a launch is
// how many tokens' loads the resident warps keep in flight, and the
// conversions and divisions of p.  The deep layout reads each row twice
// (from L2 where a run's rows stay there) and does the products, their
// conversions and divisions and the level-0 scan twice.  PERF.md keeps
// the measured time beside the bound.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "../../csrc/blocked_scan.cuh"

namespace {

using blocked_scan::kBlock;
using blocked_scan::Levels;
using blocked_scan::scan_levels;
using blocked_scan::scan_line;
using blocked_scan::scan_line_upper;
using blocked_scan::scan_upper;
using blocked_scan::Warp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // warps a CTA
constexpr int kMinBlocks = 2;        // CTAs an SM: at most 128 registers
constexpr int kLine = 2 * kBlock;    // topics of a lane's line
constexpr int kUnits = kLine / 4;    // its 16-byte units
constexpr int kChunk = 32 * kLine;   // topics of a chunk: a line a lane
constexpr int kMaxRun = 32;          // tokens a warp, at most (a lane each)
constexpr int kWaves = 4;            // runs a resident warp takes, about
constexpr int kSmemLimit = 232448;   // dynamic shared memory of a block
constexpr int kDeepLevels = 8;       // the deep layout's upper levels: any T
// The largest T: every topic index a lane forms, up to T + 2 kChunk, fits
// an int (lda_scores.py:MAX_TOPICS).
constexpr int kMaxT = 2147483647 - 2 * kChunk;

// Where a warp's stored lines start in its shared memory: past the upper
// scan levels, 16-byte aligned.
__host__ __device__ inline int lines_at(int T) {
  return (scan_levels(T).size + 3) & ~3;
}

// f32 entries of one warp's shared memory: the upper scan levels, then
// the level-0 cdf of its lines of every chunk but the last.
// lda_scores.py:smem_bytes mirrors it.
__host__ __device__ inline int warp_floats(int T) {
  return lines_at(T) + (T - 1) / kChunk * kChunk;
}

// Whether the stored layout fits: T <= 7,168.
inline bool stored_fits(int T) {
  return T <= 8 * kChunk && kWarps * 4 * warp_floats(T) <= kSmemLimit;
}

// f32 entries of one warp's upper levels in the deep layout, 16-byte
// aligned.  lda_scores.py:level_floats mirrors it.
__host__ __device__ inline int deep_floats(int T) {
  return (scan_levels<kDeepLevels>(T).size + 3) & ~3;
}

// Whether the deep layout's levels of all warps fit shared memory: T <=
// 108,944.
inline bool deep_in_smem(int T) {
  return static_cast<int64_t>(kWarps) * 4 * deep_floats(T) <= kSmemLimit;
}

// The block's shared memory for T (lda_scores.py:smem_bytes mirrors it).
inline int smem_for(int T) {
  if (T <= kChunk || stored_fits(T)) return kWarps * 4 * warp_floats(T);
  return deep_in_smem(T) ? kWarps * 4 * deep_floats(T) : 0;
}

// K 16-byte units of a T-row from `lo`: vector loads with `vec` (T a
// multiple of 4, rows 16-byte aligned), else 4-byte ones; 0 past T.
template <int K>
__device__ __forceinline__ void load_units(int4 (&r)[K],
                                           const int* __restrict__ row,
                                           int lo, int T, bool vec) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int t = lo + 4 * j;
    if (vec) {
      r[j] = t < T ? __ldg(reinterpret_cast<const int4*>(row + t))
                   : make_int4(0, 0, 0, 0);
    } else {
      r[j].x = t < T ? __ldg(row + t) : 0;
      r[j].y = t + 1 < T ? __ldg(row + t + 1) : 0;
      r[j].z = t + 2 < T ? __ldg(row + t + 2) : 0;
      r[j].w = t + 3 < T ? __ldg(row + t + 3) : 0;
    }
  }
}

__device__ __forceinline__ float score(int a, int b, int c, float alpha,
                                       float beta, float beta_bar) {
  return __fdiv_rn(__fmul_rn(__fadd_rn(__int2float_rn(a), alpha),
                             __fadd_rn(__int2float_rn(b), beta)),
                   __fadd_rn(__int2float_rn(c), beta_bar));
}

// p of a line: the n_td and n_wt units already loaded, the n_t row's read
// a unit at a time (the same row for a run's tokens: an L1 hit).
__device__ __forceinline__ void line_scores(float (&c)[kLine],
                                            const int4 (&A)[kUnits],
                                            const int4 (&B)[kUnits],
                                            const int* __restrict__ c_row,
                                            int lo, int T, bool vec,
                                            float alpha, float beta,
                                            float beta_bar) {
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    int4 C[1];
    load_units<1>(C, c_row, lo + 4 * j, T, vec);
    c[4 * j] = score(A[j].x, B[j].x, C[0].x, alpha, beta, beta_bar);
    c[4 * j + 1] = score(A[j].y, B[j].y, C[0].y, alpha, beta, beta_bar);
    c[4 * j + 2] = score(A[j].z, B[j].z, C[0].z, alpha, beta, beta_bar);
    c[4 * j + 3] = score(A[j].w, B[j].w, C[0].w, alpha, beta, beta_bar);
  }
}

// Asks L1 for the lane's lines of a T-row ahead of their loads.
__device__ __forceinline__ void prefetch_lines(const int* row, int lo0,
                                               int T) {
  for (int lo = lo0; lo < T; lo += kChunk)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(row + lo));
}

// Where a lane keeps 16-byte unit j of its line in shared memory: units
// in the order j ^ (lane & 7), so that eight lanes hit eight bank groups.
__device__ __forceinline__ int unit_off(int j) {
  return ((j ^ (threadIdx.x & 7)) << 2) + (threadIdx.x & 31) * kLine;
}

// Entries of one line (level-0 cdf c, its two blocks' exclusive prefixes
// p0 and p1) that are <= uval; only the first `n` unless kMasked is
// false.  The first block's prefix is +0, and c + 0 compares as c does.
template <bool kMasked>
__device__ __forceinline__ int count_le(const float (&c)[kLine], int n,
                                        float p0, float p1, float uval) {
  int le = 0;
#pragma unroll
  for (int j = 0; j < kLine; ++j)
    if (!kMasked || j < n)
      le += __fadd_rn(c[j], j < kBlock ? p0 : p1) <= uval;
  return le;
}

// kOne: T <= 1024, one line a lane, nothing in shared memory.
template <bool kPass, bool kOne>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    lda_scores_kernel(const int* __restrict__ n_td,
                      const int* __restrict__ n_wt,
                      const int* __restrict__ n_t,
                      const float* __restrict__ u,
                      const int* __restrict__ doc_row,
                      const int* __restrict__ wrd_row,
                      const int* __restrict__ nt_row,
                      const int* __restrict__ z_in, int* __restrict__ z_out,
                      float* __restrict__ norm_out, int64_t N, int T,
                      int run, bool vec, float alpha, float beta,
                      float beta_bar) {
  extern __shared__ __align__(16) float smem[];
  const int nch = kOne ? 1 : (T + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * run;
  if (first >= N) return;                       // the whole warp leaves
  const int n = N - first < run ? static_cast<int>(N - first) : run;
  const int64_t s = first + lane;               // lane i: token i's ids
  int dr = 0, wr = 0, tr = 0, zi = -1;
  float ui = 0.f;
  if (lane < n) {
    if (kPass) {
      zi = z_in[s];
      dr = doc_row[s];
      wr = wrd_row[s];
      tr = nt_row[s];
    } else {
      dr = wr = static_cast<int>(s);
    }
    ui = u[s];
  }
  const int lo0 = lane * kLine;
  for (int i = 0; i < n; ++i) {
    const int d = __shfl_sync(kFull, dr, i), w = __shfl_sync(kFull, wr, i);
    const int tt = __shfl_sync(kFull, tr, i);
    const int own = __shfl_sync(kFull, zi, i);
    const float uu = __shfl_sync(kFull, ui, i);
    const int d_next = __shfl_sync(kFull, dr, i + 1 < n ? i + 1 : i);
    const int w_next = __shfl_sync(kFull, wr, i + 1 < n ? i + 1 : i);
    const int* a_row = n_td + static_cast<size_t>(d) * T;
    const int* b_row = n_wt + static_cast<size_t>(w) * T;
    const int* c_row = n_t + static_cast<size_t>(tt) * T;
    // The pass form's own topic: p with one count out of each row.
    const bool excl = kPass && own >= 0 && own < T;
    float p_own = 0.f;
    if (excl)
      p_own = score(__ldg(a_row + own) - 1, __ldg(b_row + own) - 1,
                    __ldg(c_row + own) - 1, alpha, beta, beta_bar);

    float c[kLine], t0 = 0.f, t1 = 0.f;
    int lo = lo0;
    for (int ch = 0; ch < nch; ++ch, lo += kChunk) {
      int4 A[kUnits], B[kUnits];
      load_units(A, a_row, lo, T, vec);
      load_units(B, b_row, lo, T, vec);
      if (ch == 0 && i + 1 < n) {               // the next token's lines
        prefetch_lines(n_td + static_cast<size_t>(d_next) * T, lo0, T);
        prefetch_lines(n_wt + static_cast<size_t>(w_next) * T, lo0, T);
      }
      line_scores(c, A, B, c_row, lo, T, vec, alpha, beta, beta_bar);
      if (kPass) {
        const int x = excl ? own - lo : -1;     // own's entry, if here
#pragma unroll
        for (int j = 0; j < kLine; ++j) c[j] = j == x ? p_own : c[j];
      }
      if (lo < T) {
        if (lo + kLine <= T)
          scan_line<false>(c, kLine, t0, t1);
        else
          scan_line<true>(c, T - lo, t0, t1);
        if (!kOne) {
          float* s_up = smem + warp * warp_floats(T);
          float* line = s_up + lines_at(T) + ch * kChunk;
          s_up[lo / kBlock] = t0;
          if (lo + kBlock < T) s_up[lo / kBlock + 1] = t1;
          if (ch + 1 < nch) {
#pragma unroll
            for (int j = 0; j < kUnits; ++j)
              *reinterpret_cast<float4*>(line + unit_off(j)) = make_float4(
                  c[4 * j], c[4 * j + 1], c[4 * j + 2], c[4 * j + 3]);
          }
        }
      }
    }
    int le = 0;
    float norm;
    if (kOne) {
      // The upper levels in registers.
      float p0, p1;
      scan_line_upper(t0, t1, (T + kBlock - 1) / kBlock, p0, p1, norm);
      const float uval = __fmul_rn(uu, norm);
      if (lo0 + kLine <= T)
        le = count_le<false>(c, kLine, p0, p1, uval);
      else if (lo0 < T)
        le = count_le<true>(c, T - lo0, p0, p1, uval);
    } else {
      // The block totals and upper levels in the warp's shared memory.
      const Levels lv = scan_levels(T);
      const int nb = lv.len[0];
      float* s_up = smem + warp * warp_floats(T);
      const float* s_c = s_up + lines_at(T);
      __syncwarp();
      scan_upper(s_up, lv, Warp{});
      // norm = c[T-1] as the blocked scan forms it: the last block's
      // local total plus the exclusive prefix of that block.
      const int ob = nb - 1;
      const float last =
          __shfl_sync(kFull, (ob & 1) ? t1 : t0, (ob >> 1) & 31);
      norm = __fadd_rn(last, s_up[nb - 2]);
      const float uval = __fmul_rn(uu, norm);
      lo = lo0;
      for (int ch = 0; ch < nch; ++ch, lo += kChunk) {
        if (lo >= T) break;
        const int b = lo / kBlock;
        const float p0 = b > 0 ? s_up[b - 1] : 0.f, p1 = s_up[b];
        if (ch + 1 < nch) {                     // a full line, stored
          float e[kLine];
#pragma unroll
          for (int j = 0; j < kUnits; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(
                s_c + ch * kChunk + unit_off(j));
            e[4 * j] = x.x;
            e[4 * j + 1] = x.y;
            e[4 * j + 2] = x.z;
            e[4 * j + 3] = x.w;
          }
          le += count_le<false>(e, kLine, p0, p1, uval);
        } else if (lo + kLine <= T) {
          le += count_le<false>(c, kLine, p0, p1, uval);
        } else {
          le += count_le<true>(c, T - lo, p0, p1, uval);
        }
      }
      __syncwarp();                    // s_up is the next token's
    }
    le = __reduce_add_sync(kFull, le);
    if (lane == i) {
      z_out[s] = kPass ? min(max(le, 0), T - 1) : le;
      if (!kPass) norm_out[s] = norm;
    }
  }
}

// One lane's line of a token's p from `lo`, the token's own count taken
// out at topic `own` in the pass form (x = own - lo: its entry, if here),
// and level 0 scanned in place, block totals t0 and t1.  The deep layout
// forms a line so in each of its passes.
template <bool kPass>
__device__ __forceinline__ void deep_line(float (&c)[kLine], float& t0,
                                          float& t1, const int* a_row,
                                          const int* b_row,
                                          const int* c_row, int lo, int T,
                                          bool vec, int x, float p_own,
                                          float alpha, float beta,
                                          float beta_bar) {
  int4 A[kUnits], B[kUnits];
  load_units(A, a_row, lo, T, vec);
  load_units(B, b_row, lo, T, vec);
  line_scores(c, A, B, c_row, lo, T, vec, alpha, beta, beta_bar);
  if (kPass) {
#pragma unroll
    for (int j = 0; j < kLine; ++j) c[j] = j == x ? p_own : c[j];
  }
  if (lo + kLine <= T)
    scan_line<false>(c, kLine, t0, t1);
  else
    scan_line<true>(c, T - lo, t0, t1);
}

// The deep layout, T > 7,168 (see the top of this file).  `levels` is the
// device scratch of the warps' upper levels (deep_floats each, a slice a
// warp of the grid), or null where they lie in shared memory.  A warp
// takes the runs first, first + gridDim.x * kWarps * run, ...: one run
// where the grid covers the tokens, several where the scratch bounds it.
template <bool kPass>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    lda_scores_deep_kernel(const int* __restrict__ n_td,
                           const int* __restrict__ n_wt,
                           const int* __restrict__ n_t,
                           const float* __restrict__ u,
                           const int* __restrict__ doc_row,
                           const int* __restrict__ wrd_row,
                           const int* __restrict__ nt_row,
                           const int* __restrict__ z_in,
                           int* __restrict__ z_out,
                           float* __restrict__ norm_out, float* levels,
                           int64_t N, int T, int run, bool vec, float alpha,
                           float beta, float beta_bar) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * run;
  float* const s_up = levels != nullptr ? levels + gw * deep_floats(T)
                                        : smem + warp * deep_floats(T);
  const auto lv = scan_levels<kDeepLevels>(T);
  const int nb = lv.len[0], ob = nb - 1;
  const int lo0 = lane * kLine;
  for (int64_t first = gw * run; first < N; first += step) {
    const int n = N - first < run ? static_cast<int>(N - first) : run;
    const int64_t s = first + lane;             // lane i: token i's ids
    int dr = 0, wr = 0, tr = 0, zi = -1;
    float ui = 0.f;
    if (lane < n) {
      if (kPass) {
        zi = z_in[s];
        dr = doc_row[s];
        wr = wrd_row[s];
        tr = nt_row[s];
      } else {
        dr = wr = static_cast<int>(s);
      }
      ui = u[s];
    }
    for (int i = 0; i < n; ++i) {
      const int d = __shfl_sync(kFull, dr, i), w = __shfl_sync(kFull, wr, i);
      const int tt = __shfl_sync(kFull, tr, i);
      const int own = __shfl_sync(kFull, zi, i);
      const float uu = __shfl_sync(kFull, ui, i);
      const int* a_row = n_td + static_cast<size_t>(d) * T;
      const int* b_row = n_wt + static_cast<size_t>(w) * T;
      const int* c_row = n_t + static_cast<size_t>(tt) * T;
      const bool excl = kPass && own >= 0 && own < T;
      float p_own = 0.f;
      if (excl)
        p_own = score(__ldg(a_row + own) - 1, __ldg(b_row + own) - 1,
                      __ldg(c_row + own) - 1, alpha, beta, beta_bar);
      // Pass 1: the block totals.
      float c[kLine], t0 = 0.f, t1 = 0.f;
      for (int lo = lo0; lo < T; lo += kChunk) {
        deep_line<kPass>(c, t0, t1, a_row, b_row, c_row, lo, T, vec,
                         excl ? own - lo : -1, p_own, alpha, beta,
                         beta_bar);
        s_up[lo / kBlock] = t0;
        if (lo + kBlock < T) s_up[lo / kBlock + 1] = t1;
      }
      __syncwarp();
      scan_upper(s_up, lv, Warp{});
      // norm = c[T-1] as the blocked scan forms it: the last block's
      // local total (the last chunk's, still in its lane) plus the
      // exclusive prefix of that block.
      const float last =
          __shfl_sync(kFull, (ob & 1) ? t1 : t0, (ob >> 1) & 31);
      const float norm = __fadd_rn(last, s_up[nb - 2]);
      const float uval = __fmul_rn(uu, norm);
      // Pass 2: the line again, counted with its blocks' prefixes.
      int le = 0;
      for (int lo = lo0; lo < T; lo += kChunk) {
        float e0, e1;
        deep_line<kPass>(c, e0, e1, a_row, b_row, c_row, lo, T, vec,
                         excl ? own - lo : -1, p_own, alpha, beta,
                         beta_bar);
        const int b = lo / kBlock;
        const float p0 = b > 0 ? s_up[b - 1] : 0.f, p1 = s_up[b];
        le += lo + kLine <= T ? count_le<false>(c, kLine, p0, p1, uval)
                              : count_le<true>(c, T - lo, p0, p1, uval);
      }
      __syncwarp();                    // s_up is the next token's
      le = __reduce_add_sync(kFull, le);
      if (lane == i) {
        z_out[s] = kPass ? min(max(le, 0), T - 1) : le;
        if (!kPass) norm_out[s] = norm;
      }
    }
  }
}

// Tokens a warp: the launch's tokens spread over the card's resident warps
// kWaves times, 1 .. kMaxRun.
template <bool kPass, bool kOne, bool kDeep = false>
int run_length(int64_t N, int smem) {
  static int cached_smem = -1, cached_warps = 0;
  if (smem != cached_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if constexpr (kDeep)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lda_scores_deep_kernel<kPass>, kWarps * 32, smem);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lda_scores_kernel<kPass, kOne>, kWarps * 32, smem);
    cached_warps = std::max(per_sm, 1) * std::max(sms, 1) * kWarps;
    cached_smem = smem;
  }
  const int64_t slots = static_cast<int64_t>(cached_warps) * kWaves;
  const int64_t run = (N + slots - 1) / slots;
  return static_cast<int>(std::min<int64_t>(kMaxRun,
                                            std::max<int64_t>(1, run)));
}

template <bool kPass, bool kOne>
int launch(const void* n_td, const void* n_wt, const void* n_t,
           const void* u, const void* doc_row, const void* wrd_row,
           const void* nt_row, const void* z_in, void* z_out, void* norm,
           int64_t N, int T, float alpha, float beta, float beta_bar,
           int smem, cudaStream_t stream) {
  const auto kernel = lda_scores_kernel<kPass, kOne>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec =
      T % 4 == 0 && aligned(n_td) && aligned(n_wt) && aligned(n_t);
  const int run = run_length<kPass, kOne>(N, smem);
  const int64_t warps = (N + run - 1) / run;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const int*>(n_td), static_cast<const int*>(n_wt),
      static_cast<const int*>(n_t), static_cast<const float*>(u),
      static_cast<const int*>(doc_row), static_cast<const int*>(wrd_row),
      static_cast<const int*>(nt_row), static_cast<const int*>(z_in),
      static_cast<int*>(z_out), static_cast<float*>(norm), N, T, run, vec,
      alpha, beta, beta_bar);
  return static_cast<int>(cudaGetLastError());
}

// The deep layout: `levels` the device scratch of `slots` warps (a
// multiple of kWarps), or null with the levels in shared memory.
template <bool kPass>
int launch_deep(const void* n_td, const void* n_wt, const void* n_t,
                const void* u, const void* doc_row, const void* wrd_row,
                const void* nt_row, const void* z_in, void* z_out,
                void* norm, void* levels, int slots, int64_t N, int T,
                float alpha, float beta, float beta_bar, int smem,
                cudaStream_t stream) {
  const auto kernel = lda_scores_deep_kernel<kPass>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec =
      T % 4 == 0 && aligned(n_td) && aligned(n_wt) && aligned(n_t);
  const int run = run_length<kPass, false, true>(N, smem);
  const int64_t warps = (N + run - 1) / run;
  int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (levels != nullptr) blocks = std::min<int64_t>(blocks, slots / kWarps);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const int*>(n_td), static_cast<const int*>(n_wt),
      static_cast<const int*>(n_t), static_cast<const float*>(u),
      static_cast<const int*>(doc_row), static_cast<const int*>(wrd_row),
      static_cast<const int*>(nt_row), static_cast<const int*>(z_in),
      static_cast<int*>(z_out), static_cast<float*>(norm),
      static_cast<float*>(levels), N, T, run, vec, alpha, beta, beta_bar);
  return static_cast<int>(cudaGetLastError());
}

// The form and the layout for T.
template <bool kPass>
int launch_for(int T, const void* n_td, const void* n_wt, const void* n_t,
               const void* u, const void* doc_row, const void* wrd_row,
               const void* nt_row, const void* z_in, void* z_out,
               void* norm, void* levels, int slots, int64_t N, float alpha,
               float beta, float beta_bar, int smem, cudaStream_t stream) {
  if (T <= kChunk)
    return launch<kPass, true>(n_td, n_wt, n_t, u, doc_row, wrd_row, nt_row,
                               z_in, z_out, norm, N, T, alpha, beta,
                               beta_bar, smem, stream);
  if (stored_fits(T))
    return launch<kPass, false>(n_td, n_wt, n_t, u, doc_row, wrd_row,
                                nt_row, z_in, z_out, norm, N, T, alpha, beta,
                                beta_bar, smem, stream);
  return launch_deep<kPass>(n_td, n_wt, n_t, u, doc_row, wrd_row, nt_row,
                            z_in, z_out, norm, levels, slots, N, T, alpha,
                            beta, beta_bar, smem, stream);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Pointers are device pointers to contiguous arrays.
// Rows form (doc_row == nullptr): n_td, n_wt (N, T) i32 rows, n_t (T,)
// i32, u (N,) f32 -> z_out (N,) i32, norm (N,) f32.  Pass form: n_td,
// n_wt, n_t flat (rows, T) i32 tables; doc_row, wrd_row, nt_row, z_in
// (N,) i32, u (N,) f32 -> z_out (N,) i32 (norm unused).  `smem` must be
// what lda_scores.py:smem_bytes gives.  Where the deep layout's levels lie
// in device memory (smem 0, T > 108,944), `levels` is a scratch of `slots`
// warps' deep_floats(T) f32 each, `slots` a positive multiple of kWarps
// (lda_scores.py:scratch_slots); else both are unused.
extern "C" int lda_scores_launch(const void* n_td, const void* n_wt,
                                 const void* n_t, const void* u,
                                 const void* doc_row, const void* wrd_row,
                                 const void* nt_row, const void* z_in,
                                 void* z_out, void* norm, void* levels,
                                 int slots, int64_t N, int T, float alpha,
                                 float beta, float beta_bar, int smem,
                                 void* stream) {
  const bool pass = doc_row != nullptr;
  if (N < 1 || T < 1 || T > kMaxT || smem != smem_for(T))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem == 0 && (levels == nullptr || slots < kWarps || slots % kWarps))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem != 0) levels = nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  return pass ? launch_for<true>(T, n_td, n_wt, n_t, u, doc_row, wrd_row,
                                 nt_row, z_in, z_out, norm, levels, slots, N,
                                 alpha, beta, beta_bar, smem, s)
              : launch_for<false>(T, n_td, n_wt, n_t, u, doc_row, wrd_row,
                                  nt_row, z_in, z_out, norm, levels, slots,
                                  N, alpha, beta, beta_bar, smem, s);
}
