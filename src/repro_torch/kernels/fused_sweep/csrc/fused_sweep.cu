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
// loop inside the CTA.  Where a stream's state fits a block's shared
// memory, shared memory holds the F+tree (2T f32), the stream's own n_t
// copy (T i32), in dense r-mode the token's n_td row (unless paged), the
// compacted (topics, values) vector and the scan and root scratch; n_wt,
// n_td (unless paged) and the sparse side tables stay in global memory.
// Where it does not (layout(): T >= 16,384 with r_cap = T, or a slab of
// doc_rows * T too large), the kernel spills: the doc rows are read and
// written where they lie in n_td (the paged forms too: their slab map is
// still checked by the wrapper), the scan and root scratch stay in shared
// memory, then the F+tree, the values and topics tables and n_t (sparse:
// the tables first) while they fit; the F+tree that does not fit lives in the
// output F row, n_t in the stream's own n_t row, the two tables in the
// stream's slice of a scratch buffer the wrapper allocates.  Every array
// is then reached through a generic pointer; the fitting layout is built
// apart (kSpill = false), so that its loads stay shared-memory loads.
// The F+tree is zeroed once per launch and carried across cells, as the
// cell grid carries it (fused_sweep.py:343-353).  No two CTAs of a launch
// touch the same row: their documents are their own worker's, their
// word-topic blocks their own chunk's.  Any power-of-two T from 1 to
// kMaxTopics runs (T = 1 as one warp with a two-entry tree, whose leaf is
// its root); threads take several topics each.  Above T = 65,536 only
// the scan and root scratch stay in shared memory (four upper scan
// levels, 17,476 words at cap = 262,144, and 8,457 root words): the
// F+tree, n_t and both tables are in device memory, every device offset
// a product in size_t (n_wt passes 2^31 entries at T = 262,144 from
// 8,192 word rows on).
//
// Who does what.  The chain is serial within a stream, so the per-token
// step is latency: one warp (warp 0) owns it and synchronises with
// __syncwarp, shuffles and warp votes only.  The CTA's other warps join
// where the work is T-wide and not per token: the F+tree rebuild at a
// word boundary, the slab copies of the paged build, and the final
// write-back.  Every warp reads the token metadata 32 positions at a time,
// one a lane, the next 32 while it works on these, and finds the events
// (valid tokens, boundaries, slab switches) by ballot, so all warps meet
// at the same __syncthreads.  In warp 0's step:
//   * n_t is read and written in shared memory, the word's n_wt row in
//     global memory (a copy of the row in shared memory measured no faster:
//     PERF.md, tools/time_fused.py);
//   * the doc's n_td row arrives by cp.async (16 bytes a lane) while the
//     decrement's set_leaf runs; topic t's global entry is read and
//     written by the lane that copies it, so its own program order orders
//     them;
//   * the dense compaction reads 4 topics a lane, 512 a round: a round's
//     reads, ballots and counts are independent, and every lane stores
//     every entry (an inactive one into a dump slot past cap), so that no
//     lane branches; the vector comes out in ascending topic order;
//   * set_leaf adds the same delta to the log2 T + 1 nodes of the path,
//     one lane a node, in one step;
//   * the r-cumsum's level 0 gives lane l the 16-entry blocks l, l + 32,
//     ... (four 16-byte reads of a block padded to 20 words); the upper
//     levels are the warp variant of blocked_scan.cuh; blocks wholly past
//     the last active entry are +0 and are not read.
// Sparse r-mode reads the doc's side table by cp.async as well, keeps it
// in shared memory as it was read and applies rbucket.decrement by index
// (entry pos removed), so the table is never shifted in place; counts
// are per lane, then one reduction.  A compacted table (active entries
// first, then (0, 0): what build_side_table makes and both updates keep)
// has only +0 products past its active entries and changes in its first
// m + 1 entries only; any other table is read and written whole.
//
// Measured (PERF.md, tools/step_phases.py): a warp's votes, shuffles and
// shared-memory reads take tens of cycles each, so the step is set by how
// many of them depend on one another, and a branch on per-lane data costs
// a reconvergence; the loops are shaped by that.
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
// scan forms it.  The upper scan runs over all cap / 16 block totals,
// zeros included, since with three upper levels the prefixes past the
// last active block need not round as the last active one does.  The
// tree's root is the sum of the leaves in runs of 32, each run in order,
// then the run totals in runs of 32, and so on until one value is left
// (XLA CPU's reduction); the other nodes sum sibling pairs.  set_leaf adds
// value - leaf down the path and re-sums nothing.  A masked token still
// rebuilds the tree at a boundary; the rest of its step is a no-op and is
// skipped.
//
// Bound.  Each valid token reads its n_td row (4T B in dense r-mode, the
// side-table row of 8 cap B in sparse), writes back two entries, and at a
// word boundary reads an n_wt row; about T + 3 cap operations per token
// (the compaction, the scan and the count) and 2 (log2 T + 1) path adds.
// Memory moves far less than the card's 3.35 TB/s could; the chain is
// serial, so each CTA runs its tokens one after another and the latency
// of one warp's step bounds the kernel.  PERF.md keeps the time beside
// the bound.
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
#include "../../csrc/step_probes.cuh"


namespace {

using blocked_scan::kBlock;
using blocked_scan::Levels;
using blocked_scan::scan_levels;
using blocked_scan::scan_upper;
using blocked_scan::Warp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRootRun = 32;     // values summed in order at each root level
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kVecTopics = 128;  // T from which n_td rows move 16 B a lane
constexpr int kRound = 4;        // 128-topic groups a compaction round
constexpr int kMaxTopics = 262144;  // the largest T held to the plain version
// Step probe counters: phases 0 .. 7, then valid tokens, rebuilds and the
// total.
constexpr int kProbeValid = 8, kProbeRebuilds = 9, kProbeTotal = 10;

// Entries of a table of n with one pad word after every kBlock, and the
// padded index of entry j: lane l reading entry 16 b + e of block b = l
// hits bank (17 l + e) % 32, so a warp's level-0 scan is conflict free.
__host__ __device__ inline int padded(int n) {
  return n + (n + kBlock - 1) / kBlock;
}
__device__ __forceinline__ int pad(int j) { return j + j / kBlock; }
// The same with four pad words after every kBlock: each block starts 16-
// byte aligned and lane l's four 16-byte reads of block l are conflict
// free (the dense r-mode products).
__host__ __device__ inline int padded4(int n) {
  return (n + kBlock - 1) / kBlock * (kBlock + 4);
}
__device__ __forceinline__ int pad4(int j) {
  return j / kBlock * (kBlock + 4) + j % kBlock;
}
// i32 entries of the values table (f32 products in dense r-mode, with a
// dump slot at cap; i32 counts in sparse), rounded up to 16 bytes.
__host__ __device__ inline int values_size(int cap, bool sparse) {
  return ((sparse ? padded(cap) : padded4(cap + 1)) + 3) & ~3;
}

// f32 scratch of the root's levels: T / 32 run totals, their T / 1024, ...
__host__ __device__ inline int root_scratch(int T) {
  int size = 0;
  for (int n = T; n > 1;) {
    n /= n < kRootRun ? n : kRootRun;
    size += n;
  }
  return size;
}

// The arrays of a stream's state, in the order of the fitting layout.
enum Array { kValues, kSlab, kF, kNt, kRow, kTop, kUp, kRoot, kArrays };

// Where each array lies: offsets in i32 words, in shared memory where
// smem[i], else in global memory (spill only).
struct Layout {
  int off[kArrays];
  bool smem[kArrays];
  bool spill;           // the state does not fit: doc rows read in place
  int smem_words;       // dynamic shared memory, i32 words
  int scratch_words;    // a stream's slice of the scratch buffer
};

__host__ __device__ inline bool row_copied(int doc_rows, bool sparse) {
  return doc_rows == 0 && !sparse;
}

// The fitting layout, each of the first three 16-byte aligned: the values
// table (values_size); i32 slab[doc_rows * T] when paging; f32 F[2T]; i32
// n_t[T]; i32 n_td row[T] in dense r-mode unpaged; i32 topics[padded(cap +
// 1)] (a dump slot at cap); f32 upper scan levels of cap; f32 root
// scratch.  Where that exceeds kSmemLimit, the spilled one: no slab and no
// row; the scan and root scratch, then the F+tree, the values and topics
// tables and n_t in shared memory while they fit (the two tables before
// the F+tree in sparse r-mode, which copies them whole each token), each
// rounded up to 16 bytes; the tables that do not fit in the stream's scratch slice, the
// F+tree in the output row F[b], n_t in its own row n_t[b].  smem_words
// is over kSmemLimit / 4 only where even the scan and root scratch do not
// fit (never for T <= kMaxTopics).  The wrapper reads it through
// fused_sweep_smem_bytes, fused_sweep_scratch_bytes and
// fused_sweep_placement (below).
__host__ __device__ inline Layout layout(int T, int cap, int doc_rows,
                                         bool sparse) {
  long long size[kArrays] = {};
  size[kValues] = values_size(cap, sparse);
  size[kSlab] = static_cast<long long>(doc_rows) * T;
  size[kF] = 2LL * T;
  size[kNt] = T;
  size[kRow] = row_copied(doc_rows, sparse) ? T : 0;
  size[kTop] = padded(cap + 1);
  size[kUp] = scan_levels(cap).size;
  size[kRoot] = root_scratch(T);
  Layout l{};
  long long at = 0;
  for (int i = 0; i < kArrays; ++i) {
    l.off[i] = static_cast<int>(at);
    l.smem[i] = true;
    at += size[i];
  }
  if (4 * at <= kSmemLimit) {
    l.smem_words = static_cast<int>(at);
    return l;
  }
  l.spill = true;
  long long sm = 0, scr = 0;
  // Dense r-mode reads T leaves a token, sparse copies both tables.
  const int dense_order[] = {kUp, kRoot, kF, kValues, kTop, kNt};
  const int sparse_order[] = {kUp, kRoot, kValues, kTop, kF, kNt};
  for (int i : sparse ? sparse_order : dense_order) {
    const long long n = (size[i] + 3) & ~3LL;
    l.smem[i] = i == kUp || i == kRoot || 4 * (sm + n) <= kSmemLimit;
    if (l.smem[i]) {
      l.off[i] = static_cast<int>(sm);
      sm += n;
    } else if (i == kValues || i == kTop) {
      l.off[i] = static_cast<int>(scr);
      scr += n;
    } else {
      l.off[i] = 0;
    }
  }
  l.off[kSlab] = l.off[kRow] = 0;
  l.smem[kSlab] = l.smem[kRow] = false;
  l.smem_words = static_cast<int>(sm);
  l.scratch_words = static_cast<int>(scr);
  return l;
}

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
  int* scratch;         // (W, scratch_words) when the layout spills, else null
  int C, S, n_tiles, tile, tile_start, num_tiles, r, k, I_max, J_max, T, cap;
  int dtile, n_dt, doc_rows;
  float alpha, beta, beta_bar;
  Layout lay;
};

// Asynchronous 16-byte copy from global to shared memory (through L2
// only), and the wait for all of this thread's copies.
__device__ __forceinline__ void copy16_async(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Rebuilds the F+tree from the n_wt row `wt` and n_t: leaves, the pair
// sums of each level, and the root in XLA CPU's order.  Called by the
// whole CTA; returns synchronised.
__device__ void rebuild(float* s_F, float* s_root, const int* wt,
                        const int* s_nt, int T, float beta, float beta_bar) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = tid; t < T; t += blockDim.x)
    s_F[T + t] = q_of(wt[t], s_nt[t], beta, beta_bar);
  __syncthreads();
  for (int n = T >> 1; n >= 2; n >>= 1) {
    for (int i = n + tid; i < 2 * n; i += blockDim.x)
      s_F[i] = __fadd_rn(s_F[2 * i], s_F[2 * i + 1]);
    __syncthreads();
  }
  // The root: each run of 32 summed in order by one warp, lane 0 writing
  // its total, level after level.
  const float* src = s_F + T;
  float* dst = s_root;
  for (int n = T; n > 1;) {
    const int run = n < kRootRun ? n : kRootRun, runs = n / run;
    for (int i = warp; i < runs; i += nwarps) {
      const float v = lane < run ? src[i * run + lane] : 0.f;
      float acc = __shfl_sync(kFull, v, 0);
      for (int j = 1; j < run; ++j)
        acc = __fadd_rn(acc, __shfl_sync(kFull, v, j));
      if (lane == 0) dst[i] = acc;
    }
    __syncthreads();
    src = dst;
    dst += runs;
    n = runs;
  }
  if (tid == 0) s_F[1] = src[0];
  __syncthreads();
}

// The token metadata of one lane's position: every warp reads 32
// positions, one a lane.  slab is the slab to switch to there, or -1.
struct Meta {
  int valid, bound, wrow, slab, doc, z;
  float u;
};

template <bool kPaged>
__device__ __forceinline__ Meta load_meta(const SweepArgs& a, int p, int lo,
                                          int hi, std::size_t stream,
                                          std::size_t blk0) {
  Meta m{0, 0, 0, -1, 0, 0, 0.f};
  if (p >= hi) return m;
  const std::size_t q = stream * a.S + p;
  m.valid = a.tok_valid[q] != 0;
  m.bound = a.tok_bound[q] != 0;
  if (m.valid || m.bound)
    m.wrow = static_cast<int>(
        (blk0 + a.cot[stream * a.n_tiles + p / a.tile]) * a.J_max +
        a.tok_wrd[q]);
  if (m.valid) {
    m.doc = a.tok_doc[q];
    m.z = a.z[q];
    m.u = a.u[static_cast<std::size_t>(blockIdx.x) * a.S + p];
  }
  if (kPaged && (p == lo || p % a.dtile == 0)) {
    const int* dto = a.dto + stream * a.n_dt;
    const int g = dto[p / a.dtile];
    if (p == lo || g != dto[p / a.dtile - 1]) m.slab = g;
  }
  return m;
}

// n_wt[t] and n_t[t] += delta (lane 0 writes, every lane reads), then
// set_leaf(t, q): the delta of the leaf added to each node of its path,
// lane l adding it to the node l levels up.  Called by warp 0.
__device__ __forceinline__ void move_topic(float* s_F, int* wt, int* s_nt,
                                           int T, int depth, int t,
                                           int delta, float beta,
                                           float beta_bar) {
  const int lane = threadIdx.x & 31;
  const int nw = wt[t] + delta, nt = s_nt[t] + delta;
  const float leaf = s_F[T + t];
  __syncwarp();
  if (lane == 0) {
    wt[t] = nw;
    s_nt[t] = nt;
  }
  const float dl = __fsub_rn(q_of(nw, nt, beta, beta_bar), leaf);
  if (lane <= depth) {
    const int node = (T + t) >> lane;
    s_F[node] = __fadd_rn(s_F[node], dl);
  }
  __syncwarp();
}

// Entry j of the sparse table after rbucket.decrement, read from the table
// as it was loaded (unpadded): entry rm removed (rm = cap when nothing
// was), (0, 0) shifted in at the end.
__device__ __forceinline__ void d_entry(const int* s_top, const int* s_cnt,
                                        int cap, int rm, int j, int& t,
                                        int& c) {
  const int pj = j + (j >= rm);
  t = pj < cap ? s_top[pj] : 0;
  c = pj < cap ? s_cnt[pj] : 0;
}

// Product i of the sparse r-cumsum: the count times the topic's leaf,
// rounded, from the table after the decrement.
__device__ __forceinline__ float sparse_product(const int* s_top,
                                                const int* s_cnt,
                                                const float* s_F, int T,
                                                int cap, int rm, int i) {
  int t, c;
  d_entry(s_top, s_cnt, cap, rm, i, t, c);
  return __fmul_rn(__int2float_rn(c), s_F[T + t]);
}

// The sixteen products of a 16-byte aligned block, in four reads.
__device__ __forceinline__ void load_block(const float* block,
                                           float (&v)[kBlock]) {
  const float4* q = reinterpret_cast<const float4*>(block);
#pragma unroll
  for (int i = 0; i < kBlock / 4; ++i) {
    const float4 f = q[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// kPaged: the slab build (fitting layouts with a slab map); kSpill: the
// spilled layout (paged or not, the doc rows read in place).
template <bool kPaged, bool kSpill>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_sweep_kernel(SweepArgs a) {
  static_assert(!(kPaged && kSpill), "a spilled layout has no slab");
  extern __shared__ __align__(16) int smem[];
  PROBE_START
  const int T = a.T, cap = a.cap, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Levels lv = scan_levels(cap);
  const int nb = lv.len[0];                     // level-0 scan blocks
  const int depth = 31 - __clz(T);
  const bool sparse = a.topics != nullptr;

  // Fitting, the arrays in the order layout() sums them (computed here,
  // so that their loads stay shared-memory loads); spilled, each array in
  // shared memory or in its global home as layout() places it.
  float* s_pr;                                  // dense: padded4(cap + 1)
  int* s_cnt;                                   // sparse: cap, unpadded
  int* s_slab;                                  // doc_rows * T when paged
  float* s_F;
  int* s_nt;
  int* s_row;                                   // T when copied
  int* s_top;                                   // dense padded, sparse not
  float* s_up;
  float* s_root;
  const int b = blockIdx.x;
  int* nt_g = a.n_t + static_cast<std::size_t>(b) * T;
  if constexpr (!kSpill) {
    s_pr = reinterpret_cast<float*>(smem);
    s_cnt = smem;
    s_slab = smem + values_size(cap, sparse);
    s_F = reinterpret_cast<float*>(s_slab + (kPaged ? a.doc_rows * T : 0));
    s_nt = reinterpret_cast<int*>(s_F + 2 * T);
    s_row = s_nt + T;
    s_top = s_row + (row_copied(a.doc_rows, sparse) ? T : 0);
    s_up = reinterpret_cast<float*>(s_top + padded(cap + 1));
    s_root = s_up + lv.size;
  } else {
    const Layout& ly = a.lay;
    int* scr = a.scratch + static_cast<std::size_t>(b) * ly.scratch_words;
    auto at = [&](int i, int* home) -> int* {
      return ly.smem[i] ? smem + ly.off[i] : home + ly.off[i];
    };
    s_pr = reinterpret_cast<float*>(at(kValues, scr));
    s_cnt = at(kValues, scr);
    s_slab = s_row = nullptr;
    s_F = reinterpret_cast<float*>(
        at(kF, reinterpret_cast<int*>(a.F + static_cast<std::size_t>(b) *
                                                  2 * T)));
    s_nt = at(kNt, nt_g);
    s_top = at(kTop, scr);
    s_up = reinterpret_cast<float*>(smem + ly.off[kUp]);
    s_root = reinterpret_cast<float*>(smem + ly.off[kRoot]);
  }

  const int c = (b + a.r) % a.C;
  const std::size_t stream = static_cast<std::size_t>(b) * a.C + c;
  int* zs = a.z + stream * a.S;
  const std::size_t doc0 = static_cast<std::size_t>(b) * a.I_max;
  int* shard = a.n_td + doc0 * T;
  const std::size_t blk0 = static_cast<std::size_t>(c) * a.k;
  // Rows move 16 bytes a lane where they are aligned to it; topic t's
  // entry then belongs to lane (t / 4) % 32, else to lane t % 32.
  const bool vec = T >= kVecTopics &&
                   (reinterpret_cast<std::uintptr_t>(a.n_td) & 15) == 0;
  const int own_shift = vec ? 2 : 0;
  int g_cur = -1;                               // the slab held, if any

  if (!kSpill || a.lay.smem[kNt])
    for (int t = tid; t < T; t += blockDim.x) s_nt[t] = nt_g[t];
  for (int i = tid; i < 2 * T; i += blockDim.x) s_F[i] = 0.f;
  __syncthreads();

  const int lo = a.tile_start * a.tile;
  const int hi = lo + a.num_tiles * a.tile;
  Meta cur = load_meta<kPaged>(a, lo + lane, lo, hi, stream, blk0);
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const Meta nxt = load_meta<kPaged>(a, p0 + 32 + lane, lo, hi, stream,
                                       blk0);
    const unsigned vm = __ballot_sync(kFull, cur.valid);
    const unsigned bm = __ballot_sync(kFull, cur.bound);
    const unsigned sm = kPaged ? __ballot_sync(kFull, cur.slab >= 0) : 0u;
    for (unsigned ev = vm | bm | sm; ev; ev &= ev - 1) {
      const int j = __ffs(ev) - 1;
      if (kPaged && (sm >> j & 1)) {            // uniform across the CTA
        const int g = __shfl_sync(kFull, cur.slab, j);
        __syncthreads();
        if (g_cur >= 0)
          slab_copy(shard, s_slab, g_cur, a.doc_rows, a.I_max, T, false);
        slab_copy(shard, s_slab, g, a.doc_rows, a.I_max, T, true);
        g_cur = g;
      }
      const bool valid = vm >> j & 1, bound = bm >> j & 1;
      if (!valid && !bound) continue;
      const int wr = __shfl_sync(kFull, cur.wrow, j);
      int* wt = a.n_wt + static_cast<std::size_t>(wr) * T;  // the word's row
      if (bound) {                              // uniform across the CTA
        __syncthreads();
        rebuild(s_F, s_root, wt, s_nt, T, a.beta, a.beta_bar);
        PHASE(0) PROBE_COUNT(kProbeRebuilds)
      }
      if (!valid || warp != 0) continue;
      PHASE(7) PROBE_COUNT(kProbeValid)

      // The step, by warp 0 alone.
      const int p = p0 + j;
      const int d = __shfl_sync(kFull, cur.doc, j);
      const int t_old = __shfl_sync(kFull, cur.z, j);
      const float u01 = __shfl_sync(kFull, cur.u, j);
      int* ntd = kPaged ? s_slab + (d - g_cur * a.doc_rows) * T
                        : shard + static_cast<std::size_t>(d) * T;
      int m;                                    // active entries
      int rm = cap;                             // sparse: entry removed
      bool compact = true;                      // sparse: entries >= m (0, 0)
      int* top_g = nullptr;
      int* cnt_g = nullptr;
      if (!sparse) {
        // The doc's n_td row, from its slab or copied into s_row (its
        // latency overlapping the decrement), or spilled, where it lies;
        // the decrement applied.
        constexpr bool kCopy = !kPaged && !kSpill;
        int* row = kCopy ? s_row : ntd;
        if (kCopy) {
          if (vec) {
            for (int q = lane; q < T / 4; q += 32)
              copy16_async(row + 4 * q, ntd + 4 * q);
          } else {
            for (int t = lane; t < T; t += 32) row[t] = ntd[t];
          }
        }
        move_topic(s_F, wt, s_nt, T, depth, t_old, -1, a.beta, a.beta_bar);
        if (kCopy && vec) copy_wait();
        __syncwarp();
        if (lane == ((t_old >> own_shift) & 31)) {
          const int x = row[t_old] - 1;
          row[t_old] = x;
          if (kCopy) ntd[t_old] = x;
        }
        __syncwarp();
        PHASE(1)
        // Compaction: ranks by ballot, in ascending topic order; lane l
        // takes topics 4 l .. 4 l + 3 of each 128 (16 bytes, 4 bytes at a
        // time from a spilled row not aligned to 16), or l of each 32
        // below T = 128.
        int total = 0;
        if (T >= kVecTopics) {
          // Rounds of kRound 128-topic groups: the reads, ballots and
          // counts of a round are independent of each other, so they
          // overlap; only the running total is carried.
          const bool row_vec = !kSpill || vec;
          const int4* row4 = reinterpret_cast<const int4*>(row);
          auto four = [&](int q) {
            return row_vec ? row4[q]
                           : make_int4(row[4 * q], row[4 * q + 1],
                                       row[4 * q + 2], row[4 * q + 3]);
          };
          for (int g0 = 0; g0 < T / 128; g0 += kRound) {
            int x[kRound][4];
            unsigned bal[kRound][4];
#pragma unroll
            for (int r = 0; r < kRound; ++r) {
              const int4 v = g0 + r < T / 128 ? four(32 * (g0 + r) + lane)
                                               : make_int4(0, 0, 0, 0);
              x[r][0] = v.x;
              x[r][1] = v.y;
              x[r][2] = v.z;
              x[r][3] = v.w;
            }
#pragma unroll
            for (int r = 0; r < kRound; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                bal[r][e] = __ballot_sync(kFull, x[r][e] > 0);
            int start[kRound];                  // the round's first ranks
#pragma unroll
            for (int r = 0; r < kRound; ++r) {
              int before = 0, all = 0;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                before += __popc(bal[r][e] & ((1u << lane) - 1u));
                all += __popc(bal[r][e]);
              }
              start[r] = total + before;
              total += all;
            }
            // Every lane stores every entry, the inactive ones (and those
            // past cap) into the dump slot cap, so that no lane branches.
#pragma unroll
            for (int r = 0; r < kRound; ++r) {
              int rank = start[r];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int t = 4 * (32 * (g0 + r) + lane) + e;
                const bool act = x[r][e] > 0;
                const int at = act && rank < cap ? rank : cap;
                s_top[pad(at)] = t;
                s_pr[pad4(at)] =
                    __fmul_rn(__int2float_rn(x[r][e]), s_F[T + t]);
                rank += act;
              }
            }
          }
        } else {
          for (int t0 = 0; t0 < T; t0 += 32) {
            const int t = min(t0 + lane, T - 1);
            const int x = t0 + lane < T ? row[t] : 0;
            const unsigned bal = __ballot_sync(kFull, x > 0);
            const int rank = total + __popc(bal & ((1u << lane) - 1u));
            const int at = x > 0 && rank < cap ? rank : cap;
            s_top[pad(at)] = t;
            s_pr[pad4(at)] = __fmul_rn(__int2float_rn(x), s_F[T + t]);
            total += __popc(bal);
          }
        }
        m = min(total, cap);
        if constexpr (kSpill) __syncwarp();     // the tables may be global
        PHASE(2)
      } else {
        // The side table as loaded (its latency overlapping the
        // decrement), with the place of t_old in it.  Counting is per lane,
        // then one reduction.  A compacted table (active entries first,
        // then (0, 0)), as build_side_table makes and both updates keep,
        // has only +0 products past its active entries.
        top_g = a.topics + (doc0 + d) * cap;
        cnt_g = a.counts + (doc0 + d) * cap;
        const bool tvec =
            cap % 4 == 0 &&
            (!kSpill || (a.lay.smem[kTop] && a.lay.smem[kValues])) &&
            ((reinterpret_cast<std::uintptr_t>(top_g) |
              reinterpret_cast<std::uintptr_t>(cnt_g)) & 15) == 0;
        if (tvec) {
          for (int q = lane; q < cap / 4; q += 32) {
            copy16_async(s_top + 4 * q, top_g + 4 * q);
            copy16_async(s_cnt + 4 * q, cnt_g + 4 * q);
          }
        } else {
#pragma unroll 8
          for (int i = lane; i < cap; i += 32) {
            s_top[i] = top_g[i];
            s_cnt[i] = cnt_g[i];
          }
        }
        if (lane == ((t_old >> own_shift) & 31)) atomicAdd(ntd + t_old, -1);
        move_topic(s_F, wt, s_nt, T, depth, t_old, -1, a.beta, a.beta_bar);
        if (tvec) copy_wait();
        __syncwarp();
        int pos = 0, active = 0, nonzero = 0, last = -1;
        for (int i = lane; i < cap; i += 32) {
          const int ti = s_top[i], ci = s_cnt[i];
          pos += ci > 0 && ti < t_old;
          active += ci > 0;
          nonzero += ci != 0 || ti != 0;
          last = ci > 0 ? i : last;
        }
        pos = __reduce_add_sync(kFull, pos);
        active = __reduce_add_sync(kFull, active);
        nonzero = __reduce_add_sync(kFull, nonzero);
        last = __reduce_max_sync(kFull, last);
        compact = nonzero == active && last + 1 == active;
        const int newc = s_cnt[min(pos, cap - 1)] - 1;   // decrement
        __syncwarp();
        if (newc == 0 && pos < cap) {
          rm = pos;
          --active;
        } else if (pos < cap) {
          if (lane == 0) s_cnt[pos] = newc;
          compact = compact && newc > 0;        // not a (0, -1) past them
        }
        __syncwarp();
        m = active;
        PHASE(2)
      }

      // r-cumsum: level 0 over the lane's blocks, the upper levels by the
      // warp.  Dense entries past m are +0 products: a block's local sums
      // stop changing at its last active entry, so only active entries
      // are read, a block's sixteen at once.
      float last = 0.f;                         // the last block's total
      for (int g = 0; g < nb; g += 32) {        // the same trips in all lanes
        const int blk = g + lane;
        const int b0 = blk * kBlock;
        float acc = 0.f;
        if (!sparse) {
          const int n = blk < nb ? m - b0 : 0;  // active entries, if > 0
          if (__any_sync(kFull, n > 0)) {       // else every block is +0
            float v[kBlock];
            load_block(s_pr + min(blk, nb - 1) * (kBlock + 4), v);
            acc = n > 0 ? v[0] : 0.f;
#pragma unroll
            for (int e = 1; e < kBlock; ++e)
              acc = e < n ? __fadd_rn(acc, v[e]) : acc;
          }
        } else {
          const int b1 = compact ? min(b0 + kBlock, m) : min(b0 + kBlock, cap);
          for (int i = b0; i < b1; ++i) {
            const float pr = sparse_product(s_top, s_cnt, s_F, T, cap, rm, i);
            acc = i == b0 ? pr : __fadd_rn(acc, pr);
          }
        }
        if (blk < nb) {
          s_up[blk] = acc;
          last = acc;
        }
      }
      last = __shfl_sync(kFull, last, (nb - 1) & 31);
      __syncwarp();
      scan_upper(s_up, lv, Warp{});
      PHASE(3)
      const float r_mass = nb > 1 ? __fadd_rn(last, s_up[nb - 2]) : last;
      const float q_total = s_F[1];
      const float u_val = __fmul_rn(u01, __fmaf_rn(a.alpha, q_total, r_mass));
      int le = 0;                               // entries with cdf <= u_val
      for (int g = 0; g < nb; g += 32) {
        const int blk = g + lane;
        const int b0 = blk * kBlock, b1 = max(min(b0 + kBlock, cap), b0);
        const float pre = blk > 0 && blk < nb ? s_up[blk - 1] : 0.f;
        float acc = 0.f;
        if (!sparse) {
          const int n = blk < nb ? m - b0 : 0;
          if (__any_sync(kFull, n > 0)) {
            float v[kBlock];
            load_block(s_pr + min(blk, nb - 1) * (kBlock + 4), v);
#pragma unroll
            for (int e = 0; e < kBlock; ++e) {
              acc = e >= n ? acc : e == 0 ? v[0] : __fadd_rn(acc, v[e]);
              le += e < n && (blk > 0 ? __fadd_rn(acc, pre) : acc) <= u_val;
            }
          }
          const int zeros = b1 - b0 - max(min(n, kBlock), 0);
          if (zeros > 0)                        // the +0 entries after them
            le += zeros * ((blk > 0 ? __fadd_rn(acc, pre) : acc) <= u_val);
        } else {
          const int read = compact ? min(b1, max(m, b0)) : b1;
          for (int i = b0; i < read; ++i) {
            const float pr = sparse_product(s_top, s_cnt, s_F, T, cap, rm, i);
            acc = i == b0 ? pr : __fadd_rn(acc, pr);
            le += (blk > 0 ? __fadd_rn(acc, pre) : acc) <= u_val;
          }
          if (read < b1)                        // +0 products after them
            le += (b1 - read) * ((blk > 0 ? __fadd_rn(acc, pre) : acc) <= u_val);
        }
      }
      le = __reduce_add_sync(kFull, le);
      PHASE(4)

      // The draw, by every lane alike.
      int t_new;
      if (u_val < r_mass) {
        const int at = min(le, max(m - 1, 0));
        if (!sparse) {
          t_new = m > 0 ? s_top[pad(at)] : 0;
        } else {
          int ci;
          d_entry(s_top, s_cnt, cap, rm, at, t_new, ci);
        }
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
      PHASE(5)

      // Increment.
      if (lane == ((t_new >> own_shift) & 31)) {
        if (sparse)
          atomicAdd(ntd + t_new, 1);
        else if (!kPaged && !kSpill)
          ntd[t_new] = s_row[t_new] + 1;
        else
          ntd[t_new] += 1;
      }
      move_topic(s_F, wt, s_nt, T, depth, t_new, 1, a.beta, a.beta_bar);
      if (lane == 0) zs[p] = t_new;
      PHASE(6)
      if (sparse) {                             // rbucket.increment
        int pos = 0;
        for (int i = lane; i < cap; i += 32) {
          int ti, ci;
          d_entry(s_top, s_cnt, cap, rm, i, ti, ci);
          pos += ci > 0 && ti < t_new;
        }
        pos = __reduce_add_sync(kFull, pos);
        int ta, ca;
        d_entry(s_top, s_cnt, cap, rm, min(pos, cap - 1), ta, ca);
        const bool present = ca > 0 && ta == t_new;
        // A compacted table changes in [0, m + 1) only: (0, 0) after it.
        const int end = compact ? min(m + 1, cap) : cap;
        for (int i = lane; i < end; i += 32) {
          int ti, ci;
          if (present || i < pos) {
            d_entry(s_top, s_cnt, cap, rm, i, ti, ci);
            if (present && i == pos) ci += 1;
          } else if (i == pos) {
            ti = t_new;
            ci = 1;
          } else {
            d_entry(s_top, s_cnt, cap, rm, i - 1, ti, ci);
          }
          top_g[i] = ti;
          cnt_g[i] = ci;
        }
        __syncwarp();
      }
    }
    cur = nxt;
  }
  __syncthreads();
  if (kPaged && g_cur >= 0)                     // the flush
    slab_copy(shard, s_slab, g_cur, a.doc_rows, a.I_max, T, false);
  if (!kSpill || a.lay.smem[kNt])
    for (int t = tid; t < T; t += blockDim.x) nt_g[t] = s_nt[t];
  PROBE_END(kProbeTotal)
  float* F_g = a.F + static_cast<std::size_t>(b) * 2 * T;
  if (!kSpill || a.lay.smem[kF])
    for (int i = tid; i < 2 * T; i += blockDim.x) F_g[i] = s_F[i];
}

}  // namespace

// Launches W CTAs on `stream`; returns the cudaError_t of the launch (0 on
// success).  Pointers are device pointers to contiguous arrays with the
// shapes of SweepArgs; topics and counts are both null in dense r-mode,
// dto is null unless n_td is paged (then dtile, n_dt, doc_rows >= 1);
// scratch holds W * fused_sweep_scratch_bytes bytes (null where that is
// 0).  Refuses T past kMaxTopics and a layout whose shared memory exceeds
// kSmemLimit.
extern "C" int fused_sweep_launch(
    const void* tok_doc, const void* tok_wrd, const void* tok_valid,
    const void* tok_bound, void* z, const void* u, const void* cot,
    const void* dto, void* n_td, void* n_wt, void* n_t, void* F,
    void* topics, void* counts, void* scratch, int W, int C, int S,
    int n_tiles, int tile, int tile_start, int num_tiles, int r, int k,
    int I_max, int J_max, int T, int cap, int dtile, int n_dt, int doc_rows,
    float alpha, float beta, float beta_bar, void* stream) {
  const int threads = T < 32 ? 32 : (T > kMaxThreads ? kMaxThreads : T);
  const bool paged = dto != nullptr;
  if (!paged) dtile = n_dt = doc_rows = 0;
  if (W < 1 || C < 1 || T < 1 || T > kMaxTopics || (T & (T - 1)) ||
      cap < 1 || cap > T || tile < 1 || tile_start < 0 || num_tiles < 0 ||
      (tile_start + num_tiles) > n_tiles || n_tiles * tile > S ||
      (topics == nullptr) != (counts == nullptr) ||
      (paged && (dtile < 1 || doc_rows < 1 ||
                 static_cast<long long>(n_dt) * dtile <
                     static_cast<long long>(tile_start + num_tiles) * tile)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout ly = layout(T, cap, doc_rows, topics != nullptr);
  if (4LL * ly.smem_words > kSmemLimit ||
      (ly.scratch_words > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * ly.smem_words;
  void (*kernel)(SweepArgs) =
      ly.spill ? fused_sweep_kernel<false, true>
      : paged  ? fused_sweep_kernel<true, false>
               : fused_sweep_kernel<false, false>;
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
              static_cast<int*>(scratch),
              C, S, n_tiles, tile, tile_start, num_tiles, r, k, I_max, J_max,
              T, cap, dtile, n_dt, doc_rows, alpha, beta, beta_bar, ly};
  kernel<<<W, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one CTA takes for (T, cap, doc_rows) in sparse (nonzero)
// or dense r-mode, in bytes, as layout() places the state, capped at
// INT_MAX; the wrapper refuses what is over the kSmemLimit a block may
// use.
extern "C" int fused_sweep_smem_bytes(int T, int cap, int doc_rows,
                                      int sparse) {
  const long long n = 4LL * layout(T, cap, doc_rows, sparse != 0).smem_words;
  return n > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(n);
}

// Bytes of the scratch slice each stream needs (0 unless the layout
// spills a table out of shared memory).
extern "C" int fused_sweep_scratch_bytes(int T, int cap, int doc_rows,
                                         int sparse) {
  return 4 * layout(T, cap, doc_rows, sparse != 0).scratch_words;
}

// The placement as a bit mask: bit i set where array i (enum Array:
// values, slab, F, n_t, row, topics, scan, root) lies in shared memory,
// bit kArrays where the layout spills.
extern "C" int fused_sweep_placement(int T, int cap, int doc_rows,
                                     int sparse) {
  const Layout ly = layout(T, cap, doc_rows, sparse != 0);
  int mask = ly.spill ? 1 << kArrays : 0;
  for (int i = 0; i < kArrays; ++i) mask |= ly.smem[i] ? 1 << i : 0;
  return mask;
}
