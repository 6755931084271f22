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
// Layout.  One warp per token, 8 warps a CTA.  Each warp takes 32
// consecutive tokens, reads their z and row ids with one coalesced load
// each, and draws them one after another (a ballot names the lanes that
// hold a token; the token's ids reach every lane by shuffle).  Per token
// the warp reads the three rows coalesced (lane l takes topics l, l + 32,
// ...), forms p and stores it in the warp's own slice of shared memory (T
// f32, one pad word after every 16, so that lane l, which owns scan
// blocks l, l + 32, ..., reads its block without bank conflicts).  Each
// lane scans its blocks in place; the block totals and the upper levels
// of the scan (about T / 15 f32) sit beside them and the warp scans
// those; then the lanes count c <= u * norm over the topics they read.
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
// warps of a CTA and the CTAs of a launch run independent tokens, so rows
// stream at the card's rate as long as enough tokens are drawn in one
// launch; a cell whose tokens fill a few warps only waits on those warps'
// dependent loads.  PERF.md keeps the measured time beside the bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/blocked_scan.cuh"

namespace {

using blocked_scan::kBlock;
using blocked_scan::Levels;
using blocked_scan::scan_levels;
using blocked_scan::scan_upper;
using blocked_scan::Warp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;          // warps a CTA

// Shared index of entry t of a padded T-array: one pad word per 16.
__device__ __forceinline__ int pad(int t) { return t + t / kBlock; }

// f32 entries of one warp's shared memory: the padded p / cumsum row and
// the upper scan levels.  lda_scores.py:smem_bytes mirrors it.
__host__ __device__ inline int warp_floats(int T) {
  return T + (T + kBlock - 1) / kBlock + scan_levels(T).size;
}

// One token's draw by the whole warp from the rows a, b and c: returns z
// (clipped in the pass form) and sets norm.  `own` is the topic whose
// count is excluded in the pass form.
template <bool kPass>
__device__ int draw_token(const int* __restrict__ a,
                          const int* __restrict__ b,
                          const int* __restrict__ c, int own, float u,
                          float* s_p, float* s_up, const Levels& lv, int T,
                          float alpha, float beta, float beta_bar,
                          float& norm) {
  const int lane = threadIdx.x & 31;
  const int nb = lv.len[0];
  for (int t = lane; t < T; t += 32) {
    const int d = kPass && t == own ? 1 : 0;
    const float p = __fdiv_rn(
        __fmul_rn(__fadd_rn(__int2float_rn(__ldg(a + t) - d), alpha),
                  __fadd_rn(__int2float_rn(__ldg(b + t) - d), beta)),
        __fadd_rn(__int2float_rn(__ldg(c + t) - d), beta_bar));
    s_p[pad(t)] = p;
  }
  __syncwarp();
  for (int blk = lane; blk < nb; blk += 32) {   // level 0, in place
    const int lo = blk * kBlock, hi = min(lo + kBlock, T);
    float acc = s_p[pad(lo)];
    for (int t = lo + 1; t < hi; ++t) {
      acc = __fadd_rn(acc, s_p[pad(t)]);
      s_p[pad(t)] = acc;
    }
    s_up[blk] = acc;
  }
  __syncwarp();
  const float last = s_up[nb - 1];   // the last block's local total
  __syncwarp();
  scan_upper(s_up, lv, Warp{});
  norm = nb > 1 ? __fadd_rn(last, s_up[nb - 2]) : last;
  const float uval = __fmul_rn(u, norm);
  int le = 0;
  for (int t = lane; t < T; t += 32) {
    const int blk = t / kBlock;
    const float cdf =
        blk > 0 ? __fadd_rn(s_p[pad(t)], s_up[blk - 1]) : s_p[pad(t)];
    le += cdf <= uval;
  }
  le = __reduce_add_sync(kFull, le);
  __syncwarp();                      // the shared slice is the next token's
  return kPass ? min(max(le, 0), T - 1) : le;
}

template <bool kPass>
__global__ void __launch_bounds__(kWarps * 32)
    lda_scores_kernel(const int* __restrict__ n_td,
                      const int* __restrict__ n_wt,
                      const int* __restrict__ n_t,
                      const float* __restrict__ u,
                      const int* __restrict__ doc_row,
                      const int* __restrict__ wrd_row,
                      const int* __restrict__ nt_row,
                      const int* __restrict__ z_in, int* __restrict__ z_out,
                      float* __restrict__ norm_out, int64_t N, int T,
                      float alpha, float beta, float beta_bar) {
  extern __shared__ float smem[];
  const Levels lv = scan_levels(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s_p = smem + warp * warp_floats(T);
  float* s_up = s_p + T + lv.len[0];
  const int64_t s0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  if (s0 >= N) return;               // the whole warp leaves together
  const int64_t s = s0 + lane;
  const bool m = s < N;
  int dr = 0, wr = 0, tr = 0, zi = -1;
  float ui = 0.f;
  if (m) {
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
  for (unsigned todo = __ballot_sync(kFull, m); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int d = __shfl_sync(kFull, dr, src);
    const int w = __shfl_sync(kFull, wr, src);
    const int t = __shfl_sync(kFull, tr, src);
    const int own = __shfl_sync(kFull, zi, src);
    const float uu = __shfl_sync(kFull, ui, src);
    float norm;
    const int z = draw_token<kPass>(
        n_td + static_cast<size_t>(d) * T, n_wt + static_cast<size_t>(w) * T,
        n_t + static_cast<size_t>(t) * T, own, uu, s_p, s_up, lv, T, alpha,
        beta, beta_bar, norm);
    if (lane == src) {
      z_out[s] = z;
      if (!kPass) norm_out[s] = norm;
    }
  }
}

template <bool kPass>
int launch(const void* n_td, const void* n_wt, const void* n_t,
           const void* u, const void* doc_row, const void* wrd_row,
           const void* nt_row, const void* z_in, void* z_out, void* norm,
           int64_t N, int T, float alpha, float beta, float beta_bar,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lda_scores_kernel<kPass>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = (N + 31) / 32;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  lda_scores_kernel<kPass><<<static_cast<unsigned>(blocks), kWarps * 32,
                             smem, stream>>>(
      static_cast<const int*>(n_td), static_cast<const int*>(n_wt),
      static_cast<const int*>(n_t), static_cast<const float*>(u),
      static_cast<const int*>(doc_row), static_cast<const int*>(wrd_row),
      static_cast<const int*>(nt_row), static_cast<const int*>(z_in),
      static_cast<int*>(z_out), static_cast<float*>(norm), N, T, alpha,
      beta, beta_bar);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Pointers are device pointers to contiguous arrays.
// Rows form (doc_row == nullptr): n_td, n_wt (N, T) i32 rows, n_t (T,)
// i32, u (N,) f32 -> z_out (N,) i32, norm (N,) f32.  Pass form: n_td,
// n_wt, n_t flat (rows, T) i32 tables; doc_row, wrd_row, nt_row, z_in
// (N,) i32, u (N,) f32 -> z_out (N,) i32 (norm unused).  `smem` must be
// what lda_scores.py:smem_bytes gives.
extern "C" int lda_scores_launch(const void* n_td, const void* n_wt,
                                 const void* n_t, const void* u,
                                 const void* doc_row, const void* wrd_row,
                                 const void* nt_row, const void* z_in,
                                 void* z_out, void* norm, int64_t N, int T,
                                 float alpha, float beta, float beta_bar,
                                 int smem, void* stream) {
  const bool pass = doc_row != nullptr;
  if (N < 1 || T < 1 || smem != kWarps * 4 * warp_floats(T))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return pass ? launch<true>(n_td, n_wt, n_t, u, doc_row, wrd_row, nt_row,
                             z_in, z_out, norm, N, T, alpha, beta, beta_bar,
                             smem, s)
              : launch<false>(n_td, n_wt, n_t, u, doc_row, wrd_row, nt_row,
                              z_in, z_out, norm, N, T, alpha, beta, beta_bar,
                              smem, s);
}
