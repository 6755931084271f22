// Fused F+LDA sweep kernel, written by hand for Hopper (sm_90a).
//
// Replaces six Pallas kernels of src/repro/kernels/fused_sweep/fused_sweep.py,
// all built on the tile body _sweep_tile:
//   * fused_sweep_pallas: one token stream against one (J, T) word-topic
//     block (the serial sweep, cgs.sweep_fplda_word(backend="fused"));
//   * fused_sweep_cells_pallas: one nomad worker's queue of k dense cell
//     rows, read as one stream of k * L slots whose tile of L slots is a
//     cell (cot[i] = i), so each cell addresses its own block;
//   * fused_sweep_ragged_pallas: one nomad worker's ragged queue stream,
//     where cell_of_tile picks the word-topic block of each tile;
//   * fused_sweep_docs_pallas, fused_sweep_cells_docs_pallas and
//     fused_sweep_ragged_docs_pallas: the same three with n_td paged
//     through a (doc_rows, T) slab in shared memory (below).
// Per token, in the reference's order (ref.py:52-114): rebuild the F+tree
// at a word boundary, decrement, set_leaf, compact the doc row (dense
// r-mode) or update the doc's side table (sparse), r-cumsum, draw from the
// r bucket or the q tree, increment, set_leaf.
//
// Layout.  One CTA per stream; the launch covers W streams, one per nomad
// worker, in round r: CTA b sweeps chunk c = (b + r) % C of the (W, C, S)
// token arrays (C = 1 for a single stream) over tiles [tile_start,
// tile_start + num_tiles).  The TPU's sequential tile grid is the token
// loop inside the CTA.  Shared memory holds the F+tree (2T f32), the
// stream's own n_t copy (T i32), the compacted (topics, counts) vector
// (2 cap i32) and the upper scan levels; n_td (unless paged) and n_wt
// stay in global memory and the CTA reads one row of each per token.  The
// F+tree is zeroed once per launch and carried across cells, as the cell
// grid carries it (fused_sweep.py:343-353).  No two CTAs of a
// launch touch the same row: their documents are their own worker's, their
// word-topic blocks their own chunk's.  One thread per topic (T <= 1024).
//
// Exactness.  z and every table must equal the plain version's
// (kernels/fused_sweep/ref.py) bit for bit, so every float op is rounded
// where the reference rounds it.  nvcc would contract a*b + c into an fma
// by default, so every float op is written as an intrinsic: __fadd_rn,
// __fmul_rn and __fdiv_rn, which nvcc never contracts, and __fmaf_rn where
// XLA CPU contracts:
//   * u_val = u01 * fma(alpha, q_total, r_mass) on the r side (in_r and the
//     r-bucket pick);
//   * x = fma(u01, alpha*q_total + r_mass, -r_mass) / max(alpha*q_total,
//     1e-30) on the q side, with that norm rounded as written.
// The r-cumsum rounds the products first and scans in the blocked-16
// order (../../csrc/blocked_scan.cuh); its last entry r_mass is the last
// block's local total plus that block's exclusive prefix, as the blocked
// scan forms it.  The tree's root is the sum of the leaves in runs of 32,
// each run in order, then the run totals in order (XLA CPU's reduction);
// the other nodes sum sibling pairs.  set_leaf adds value - leaf down the
// path and re-sums nothing.  A masked token still rebuilds the tree at a
// boundary; the rest of its step is a no-op and is skipped.
//
// Bound.  Each valid token reads its n_td row (4T B in dense r-mode, the
// side-table row of 8 cap B in sparse), writes back two entries, and at a
// word boundary reads an n_wt row; about 10 T operations per token (the
// compaction, the cap-long scan, the pick) and 2 (log2 T + 1) path adds.
// Memory moves far less than the card's 3.35 TB/s could; the chain is
// serial, so each CTA runs its tokens one after another, each a dozen
// __syncthreads deep.  Latency per token bounds the kernel, and W CTAs
// run at once.  PERF.md keeps the time beside the bound.
//
// Paging.  With dto (W, C, n_dt) set, position p of a stream lies in slab
// g = dto[b, c, p / dtile]: rows [g * doc_rows, (g + 1) * doc_rows) of the
// worker's shard, which every valid token of that tile addresses
// (build_layout(doc_tile=...)'s grouped order; the wrapper,
// fused_sweep.py:slab_of_tokens, refuses a map that breaks this before the
// launch, and the kernel does not check it again).  The CTA pulls the slab
// into shared memory at the call's first tile, writes it back and pulls
// the next where the map switches, and writes it back after the last tile
// (fused_sweep.py:575-592, :653); the doc rows are then read from shared
// memory.  Every copy is clamped to the shard's I_max rows, so the last,
// partial slab of worker b never reaches worker b + 1's rows.  The side
// tables of sparse r-mode stay in global memory (fused_sweep.py:689).

#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/blocked_scan.cuh"

namespace {

using blocked_scan::kBlock;
using blocked_scan::Levels;
using blocked_scan::scan_levels;
using blocked_scan::scan_upper;

constexpr int kRootRun = 32;    // leaves summed in order for the root
constexpr int kRed = 32;        // per-warp reduction slots

struct SweepArgs {
  const int* tok_doc;   // (W, C, S)
  const int* tok_wrd;
  const int* tok_valid;
  const int* tok_bound;
  int* z;               // (W, C, S), updated in place
  const float* u;       // (W, S): CTA b's uniforms
  const int* cot;       // (W, C, n_tiles) tile -> queue-local cell
  const int* dto;       // (W, C, n_dt) dtile -> slab, or null (unpaged)
  int* n_td;            // (W * I_max, T)
  int* n_wt;            // (B * J_max, T)
  int* n_t;             // (W, T): each CTA's own copy
  float* F;             // (W, 2T) out
  int* topics;          // (W * I_max, cap) or null (dense r-mode)
  int* counts;
  int C, S, n_tiles, tile, tile_start, num_tiles, r, k, I_max, J_max, T, cap;
  int dtile, n_dt, doc_rows;
  float alpha, beta, beta_bar;
};

// Shared memory: i32 slab[doc_rows * T] when paging (first, so that it is
// 16-byte aligned); f32 F[2T]; i32 n_t[T], topics[cap], counts[cap],
// red[2 * kRed + 8]; f32 root run totals[kRootRun] and the upper scan
// levels of cap.  fused_sweep.py:fused_sweep_smem_bytes mirrors it.
__host__ __device__ inline int smem_bytes(int T, int cap, int doc_rows) {
  return 4 * (2 * T + T + 2 * cap + 2 * kRed + 8 + kRootRun +
              scan_levels(cap).size + doc_rows * T);
}

// Copies slab g of a shard between global n_td (`shard` = its row 0) and
// shared memory, clamped to the shard's I_max rows; to_smem picks the
// direction.  16 bytes a thread and step where the rows are aligned to
// them, 4 otherwise.  Called by the whole CTA; returns synchronised.
__device__ __forceinline__ void slab_copy(int* shard, int* slab, int g,
                                          int doc_rows, int I_max, int T,
                                          bool to_smem) {
  const int n = max(min(doc_rows, I_max - g * doc_rows), 0) * T;
  int* rows_g = shard + static_cast<std::size_t>(g) * doc_rows * T;
  if (n % 4 == 0 && (reinterpret_cast<std::uintptr_t>(rows_g) & 15) == 0) {
    int4* glob = reinterpret_cast<int4*>(rows_g);
    int4* sh = reinterpret_cast<int4*>(slab);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      if (to_smem)
        sh[i] = glob[i];
      else
        glob[i] = sh[i];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (to_smem)
        slab[i] = rows_g[i];
      else
        rows_g[i] = slab[i];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float q_of(int nwt, int nt, float beta,
                                      float beta_bar) {
  return __fdiv_rn(__fadd_rn(__int2float_rn(nwt), beta),
                   __fadd_rn(__int2float_rn(nt), beta_bar));
}

// F[T + t] = value as update(t, value - F[T + t]): the delta goes down the
// path from the leaf to the root.  One thread.
__device__ __forceinline__ void set_leaf(float* F, int T, int t,
                                         float value) {
  const float delta = __fsub_rn(value, F[T + t]);
  for (int node = T + t; node >= 1; node >>= 1)
    F[node] = __fadd_rn(F[node], delta);
}

// Block-wide sum of one int per thread; every thread gets the total.
// `slot` holds kRed ints; returns synchronised.
__device__ __forceinline__ int block_sum(int v, int* slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) slot[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += slot[w];
  __syncthreads();
  return total;
}

// #{j : topics[j] < t and counts[j] > 0}: where t sits in the table.
__device__ __forceinline__ int slot_of(const int* top, const int* cnt,
                                       int cap, int t, int* slot) {
  const int j = threadIdx.x;
  return block_sum(j < cap && top[j] < t && cnt[j] > 0, slot);
}

// At most 1024 threads, so at most 64 registers a thread.  kPaged picks
// the paged build, so that the unpaged one keeps n_td rows as plain
// global pointers and does no paging work.
template <bool kPaged>
__global__ void __launch_bounds__(1024) fused_sweep_kernel(SweepArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int T = a.T, cap = a.cap, tid = threadIdx.x;
  const Levels lv = scan_levels(cap);
  const int nb = lv.len[0];                     // level-0 scan blocks
  int* s_slab = smem;                           // doc_rows * T when paged
  float* s_F = reinterpret_cast<float*>(smem + (kPaged ? a.doc_rows * T : 0));
  int* s_nt = reinterpret_cast<int*>(s_F) + 2 * T;
  int* s_top = s_nt + T;
  int* s_cnt = s_top + cap;
  int* s_red = s_cnt + cap;                     // 2 * kRed + 8
  float* s_root = reinterpret_cast<float*>(s_red + 2 * kRed + 8);
  float* s_up = s_root + kRootRun;
  int* s_tnew = s_red + 2 * kRed;               // scalar slots
  const bool sparse = a.topics != nullptr;

  const int b = blockIdx.x;
  const int c = (b + a.r) % a.C;
  const std::size_t stream = static_cast<std::size_t>(b) * a.C + c;
  const int* tdoc = a.tok_doc + stream * a.S;
  const int* twrd = a.tok_wrd + stream * a.S;
  const int* tval = a.tok_valid + stream * a.S;
  const int* tbnd = a.tok_bound + stream * a.S;
  int* zs = a.z + stream * a.S;
  const int* cot = a.cot + stream * a.n_tiles;
  const float* us = a.u + static_cast<std::size_t>(b) * a.S;
  const int* dto = kPaged ? a.dto + stream * a.n_dt : nullptr;
  const std::size_t doc0 = static_cast<std::size_t>(b) * a.I_max;
  int* shard = a.n_td + doc0 * T;
  int g_cur = -1;                               // the slab held, if any
  int next_dtile = 0;                           // where the map may switch
  const std::size_t blk0 = static_cast<std::size_t>(c) * a.k;
  int* nt_g = a.n_t + static_cast<std::size_t>(b) * T;

  for (int t = tid; t < T; t += blockDim.x) s_nt[t] = nt_g[t];
  for (int i = tid; i < 2 * T; i += blockDim.x) s_F[i] = 0.f;
  __syncthreads();

  const int lo = a.tile_start * a.tile;
  const int hi = lo + a.num_tiles * a.tile;
  if (kPaged) next_dtile = lo;
  for (int p = lo; p < hi; ++p) {
    if (kPaged && p == next_dtile) {            // uniform across the CTA
      const int g = dto[p / a.dtile];
      next_dtile = (p / a.dtile + 1) * a.dtile;
      if (g != g_cur) {
        if (g_cur >= 0)
          slab_copy(shard, s_slab, g_cur, a.doc_rows, a.I_max, T, false);
        slab_copy(shard, s_slab, g, a.doc_rows, a.I_max, T, true);
        g_cur = g;
      }
    }
    const bool valid = tval[p] != 0, bound = tbnd[p] != 0;
    if (!valid && !bound) continue;             // uniform across the CTA
    const std::size_t wrow =
        (blk0 + cot[p / a.tile]) * a.J_max + twrd[p];
    int* nwt_row = a.n_wt + wrow * T;

    if (bound) {                                // rebuild the F+tree
      for (int t = tid; t < T; t += blockDim.x)
        s_F[T + t] = q_of(nwt_row[t], s_nt[t], a.beta, a.beta_bar);
      __syncthreads();
      for (int n = T >> 1; n >= 2; n >>= 1) {
        for (int i = n + tid; i < 2 * n; i += blockDim.x)
          s_F[i] = __fadd_rn(s_F[2 * i], s_F[2 * i + 1]);
        __syncthreads();
      }
      const int run = min(kRootRun, T), runs = T / run;
      if (tid < runs) {
        const float* x = s_F + T + tid * run;
        float acc = x[0];
        for (int j = 1; j < run; ++j) acc = __fadd_rn(acc, x[j]);
        s_root[tid] = acc;
      }
      __syncthreads();
      if (tid == 0) {
        float acc = s_root[0];
        for (int j = 1; j < runs; ++j) acc = __fadd_rn(acc, s_root[j]);
        s_F[1] = acc;
      }
      __syncthreads();
    }
    if (!valid) continue;

    const int d = tdoc[p];
    int* ntd_row = kPaged ? s_slab + (d - g_cur * a.doc_rows) * T
                          : shard + static_cast<std::size_t>(d) * T;
    const int t_old = zs[p];
    if (tid == 0) {                             // decrement, set_leaf
      ntd_row[t_old] -= 1;
      const int nw = --nwt_row[t_old];
      const int nt = --s_nt[t_old];
      set_leaf(s_F, T, t_old, q_of(nw, nt, a.beta, a.beta_bar));
    }
    __syncthreads();

    // The compacted vector: s_top / s_cnt (cap entries) and m, the number
    // of entries with a positive count.
    int m;
    if (!sparse) {
      const int t = tid;
      const int v = t < T ? ntd_row[t] : 0;
      const bool active = v > 0;
      const unsigned bal = __ballot_sync(0xffffffffu, active);
      const int lane = tid & 31, warp = tid >> 5;
      if (lane == 0) s_red[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        before += w < warp ? s_red[w] : 0;
        total += s_red[w];
      }
      const int rank = before + __popc(bal & ((1u << lane) - 1u));
      if (active && rank < cap) {
        s_top[rank] = t;
        s_cnt[rank] = v;
      }
      if (tid >= total && tid < cap) {
        s_top[tid] = 0;
        s_cnt[tid] = 0;
      }
      m = min(total, cap);
      __syncthreads();
    } else {
      int* top_g = a.topics + (doc0 + d) * cap;
      int* cnt_g = a.counts + (doc0 + d) * cap;
      const int j = tid;
      int tj = 0, cj = 0, tn = 0, cn = 0;
      if (j < cap) {
        tj = top_g[j];
        cj = cnt_g[j];
        tn = j + 1 < cap ? top_g[j + 1] : 0;
        cn = j + 1 < cap ? cnt_g[j + 1] : 0;
        s_top[j] = tj;
        s_cnt[j] = cj;
      }
      __syncthreads();
      const int pos = slot_of(s_top, s_cnt, cap, t_old, s_red);
      const int newc = s_cnt[min(pos, cap - 1)] - 1;
      __syncthreads();
      if (j < cap) {                            // rbucket.decrement
        if (newc == 0) {
          if (j >= pos) {
            s_top[j] = tn;
            s_cnt[j] = cn;
          }
        } else if (j == pos) {
          s_cnt[j] = newc;
        }
      }
      __syncthreads();
      m = block_sum(j < cap && s_cnt[j] > 0, s_red);
    }

    // r-cumsum over the compacted vector: thread i owns scan block i.
    float cl[kBlock];
    const int blo = tid * kBlock;
    if (tid < nb) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        const int j = blo + e;
        if (j < cap) {
          const float pr = __fmul_rn(__int2float_rn(s_cnt[j]),
                                     s_F[T + s_top[j]]);
          acc = e == 0 ? pr : __fadd_rn(acc, pr);
          cl[e] = acc;
        }
      }
      s_up[tid] = acc;
      if (tid == nb - 1) s_red[kRed] = __float_as_int(acc);
    }
    __syncthreads();
    scan_upper(s_up, lv);
    const float last = __int_as_float(s_red[kRed]);
    const float r_mass = nb > 1 ? __fadd_rn(last, s_up[nb - 2]) : last;
    const float q_total = s_F[1];
    const float u01 = us[p];
    const float u_val = __fmul_rn(u01, __fmaf_rn(a.alpha, q_total, r_mass));
    int le = 0;
    if (tid < nb) {
      const float pre = tid > 0 ? s_up[tid - 1] : 0.f;
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        if (blo + e < cap) {
          const float cdf = tid > 0 ? __fadd_rn(cl[e], pre) : cl[e];
          le += cdf <= u_val;
        }
      }
    }
    le = block_sum(le, s_red);
    if (tid == 0) {                             // draw, increment, set_leaf
      int t_new;
      if (u_val < r_mass) {
        t_new = s_top[min(le, max(m - 1, 0))];
      } else {
        const float aq = __fmul_rn(a.alpha, q_total);
        const float num = __fmaf_rn(u01, __fadd_rn(aq, r_mass), -r_mass);
        float x = __fdiv_rn(num, fmaxf(aq, 1e-30f));
        x = fminf(fmaxf(x, 0.f), 0.99999988f);  // f32(1 - 1e-7)
        float uu = __fmul_rn(x, s_F[1]);
        int i = 1;
        while (i < T) {
          const float left = s_F[2 * i];
          const bool go = uu >= left && s_F[2 * i + 1] > 0.f;
          if (go) uu = __fsub_rn(uu, left);
          i = 2 * i + go;
        }
        t_new = i - T;
      }
      ntd_row[t_new] += 1;
      const int nw = ++nwt_row[t_new];
      const int nt = ++s_nt[t_new];
      set_leaf(s_F, T, t_new, q_of(nw, nt, a.beta, a.beta_bar));
      zs[p] = t_new;
      s_tnew[0] = t_new;
    }
    __syncthreads();

    if (sparse) {                               // rbucket.increment
      const int t_new = s_tnew[0];
      const int j = tid;
      const int pos = slot_of(s_top, s_cnt, cap, t_new, s_red);
      const int at = min(pos, cap - 1);
      const bool present = s_cnt[at] > 0 && s_top[at] == t_new;
      if (j < cap) {
        int tj = s_top[j], cj = s_cnt[j];
        if (present) {
          if (j == pos) cj += 1;
        } else if (j > pos) {
          tj = s_top[j - 1];
          cj = s_cnt[j - 1];
        } else if (j == pos) {
          tj = t_new;
          cj = 1;
        }
        a.topics[(doc0 + d) * cap + j] = tj;
        a.counts[(doc0 + d) * cap + j] = cj;
      }
      __syncthreads();
    }
  }
  if (kPaged && g_cur >= 0)                     // the flush
    slab_copy(shard, s_slab, g_cur, a.doc_rows, a.I_max, T, false);
  for (int t = tid; t < T; t += blockDim.x) nt_g[t] = s_nt[t];
  float* F_g = a.F + static_cast<std::size_t>(b) * 2 * T;
  for (int i = tid; i < 2 * T; i += blockDim.x) F_g[i] = s_F[i];
}

}  // namespace

// Launches W CTAs on `stream`; returns the cudaError_t of the launch (0 on
// success).  Pointers are device pointers to contiguous arrays with the
// shapes of SweepArgs; topics and counts are both null in dense r-mode,
// dto is null unless n_td is paged (then dtile, n_dt, doc_rows >= 1).
// `smem` must be what fused_sweep_smem_bytes gives.
extern "C" int fused_sweep_launch(
    const void* tok_doc, const void* tok_wrd, const void* tok_valid,
    const void* tok_bound, void* z, const void* u, const void* cot,
    const void* dto, void* n_td, void* n_wt, void* n_t, void* F,
    void* topics, void* counts, int W, int C, int S, int n_tiles, int tile,
    int tile_start, int num_tiles, int r, int k, int I_max, int J_max, int T,
    int cap, int dtile, int n_dt, int doc_rows, float alpha, float beta,
    float beta_bar, int smem, void* stream) {
  const int threads = T < 32 ? 32 : T;
  const bool paged = dto != nullptr;
  if (!paged) dtile = n_dt = doc_rows = 0;
  if (W < 1 || C < 1 || T < 2 || T > 1024 || (T & (T - 1)) || cap < 1 ||
      cap > T || tile < 1 || tile_start < 0 || num_tiles < 0 ||
      (tile_start + num_tiles) > n_tiles || n_tiles * tile > S ||
      (topics == nullptr) != (counts == nullptr) ||
      (paged && (dtile < 1 || doc_rows < 1 ||
                 static_cast<long long>(n_dt) * dtile <
                     static_cast<long long>(tile_start + num_tiles) * tile)) ||
      smem != smem_bytes(T, cap, doc_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(SweepArgs) =
      paged ? fused_sweep_kernel<true> : fused_sweep_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  SweepArgs a{static_cast<const int*>(tok_doc),
              static_cast<const int*>(tok_wrd),
              static_cast<const int*>(tok_valid),
              static_cast<const int*>(tok_bound),
              static_cast<int*>(z),
              static_cast<const float*>(u),
              static_cast<const int*>(cot),
              static_cast<const int*>(dto),
              static_cast<int*>(n_td),
              static_cast<int*>(n_wt),
              static_cast<int*>(n_t),
              static_cast<float*>(F),
              static_cast<int*>(topics),
              static_cast<int*>(counts),
              C, S, n_tiles, tile, tile_start, num_tiles, r, k, I_max, J_max,
              T, cap, dtile, n_dt, doc_rows, alpha, beta, beta_bar};
  kernel<<<W, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
