// Fold-in kernel of the serving path, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/fold_in/fold_in.py:
// fold_in_pallas (body _kernel).  For each document row of a padded (D, L)
// batch it runs the phi-frozen multi-sweep Gibbs fold-in on precomputed
// draws (z0: initial topics, u: one uniform per sweep and position) and
// writes the row's (T,) topic counts.  Per valid token, in chain order:
// decrement n_td[z], prob = (n_td + alpha) * phi[w], cdf = cumsum(prob),
// guarded LSearch t = min(#(cdf <= u * cdf[T-1]), #(cdf < cdf[T-1])),
// reassign, increment.  Padded positions (valid <= 0) are skipped: in the
// reference they decrement and increment the same topic by 0 and keep it.
//
// Layout.  One CTA per document; the chain is serial and the step's
// latency bounds the kernel.  Thread i owns line i of the row: topics 32i
// .. 32i + 31, two scan blocks.  For T <= 1024 the CTA is one warp and the
// step has no CTA barrier; above, it has a warp for each 1024-topic chunk
// (measured faster than one warp taking several lines a lane: PERF.md),
// which meet at two barriers a step.  Above 16,384 topics (kDeep, up to
// kMaxTopics) the CTA keeps its 16 warps and thread i owns lines i + 512 j,
// a 1024-topic chunk a warp and pass j; n_td (4T bytes: 256 KiB at T =
// 65,536) lives in the document's row of a global scratch buffer the
// wrapper allocates, swizzled as below, and each thread reads its own
// lines of the step's phi row where they lie, the next step's prefetched
// into L2.  A step forms each line's products twice (their level-1 values
// are kept, their 32 products would not fit the registers of 4 lines):
// once for the group totals, once for the counts; three barriers a step,
// the group totals' prefixes formed by one warp between the first two
// (blocked_scan.cuh:group_prefixes, at most 256 groups).  Above 65,536
// topics (kHuge, up to kMaxTopics = 1,048,574, the largest T the
// reference's fold_in_vmem_bytes admits) a thread owns up to 64 lines,
// whose level-1 values would not fit its registers: pass 2 forms them
// again from the line's two block totals (shuffles only, the same values
// as pass 1's), and the at most 4,096 group totals take a fifth scan level
// (blocked_scan.cuh:supergroup_prefixes, the whole CTA).  Deep, shared
// memory holds only the L-arrays and the warps' exchange (huge: group
// totals and prefixes, supergroup totals and prefixes; 67,720 B at T =
// 1,048,574 and L = 2,048).  At T <= 16,384 shared memory holds n_td (T
// counts), a ring of phi rows, the document's valid positions in chain
// order with their topic, phi row and weight (L i32 each), and room for
// the warps' exchange.  n_td and the ring store each line's eight 16-byte
// units in the order unit ^ (line & 7), so that the eight lanes of a
// quarter warp reading unit j of their own lines hit eight different bank
// groups.  Per step:
//   * the ring: the row of the step `slots - 1` ahead is fetched into the
//     slot the last step read.  Where T is a multiple of 256 and phi is
//     16-byte aligned, by one TMA copy (its 128-byte swizzle is the order
//     above), completing on the slot's mbarrier, which the step waits on.
//     Else each thread copies its own line by cp.async (16 bytes at a
//     time where rows are 16-byte aligned, else 4) and waits for its own
//     copies: a thread reads no line but its own;
//   * the step's uniform comes by shuffle from a register: each lane loads
//     the uniform of one step of a 32-step window when it starts, from L2,
//     where a prefetch put it one window earlier;
//   * level 0: each thread forms prob for its line from its n_td and phi
//     units and scans its two blocks in registers;
//   * the upper levels, by shuffles (blocked_scan.cuh): level 1 within
//     each group of 16 blocks (8 lanes); then, in one warp, the at most 4
//     group totals; wide, the group totals cross warps through shared
//     memory and each warp scans all of them (at most 64) by shuffles;
//   * the counts: #(cdf <= u * total) by each thread, summed by
//     __reduce_add_sync (and wide, across warps); #(cdf < total) only when
//     u * total >= total, the only case where it can be the smaller;
//   * the update: the thread that owns t_new increments it, the one that
//     owns the next token's topic decrements that one.
// n_td is kept as floats (exact integers) unless the document's weights
// sum to 2^24 or more, which spares the step T int-to-float conversions
// (measured 2 % faster at T = 1024 and 7 % at T = 4096 than ints at every
// weight: PERF.md).
// The launcher sizes shared memory itself (smem_bytes, exported as
// fold_in_smem_bytes).
//
// Long documents (kLong).  Where the L-arrays would take the block past
// kSmemLimit (at T = 1024 a bucket of L > 13,999), they live in the
// document's row of the global scratch buffer (after its n_td row when
// deep), and shared memory is laid out as for L = 0: n_td (T <= 16,384),
// the ring with its slots back, the scan levels and the warps' exchange,
// so every (L, T, sweeps) the reference's guard takes runs, in all four
// builds.  The chain reads them through the same pointers, as plain
// global loads: the topic array is written by the chain (thread 0 at each
// step) and read by every thread, so it never goes through the read-only
// path; the barriers that order it in shared memory (barrier 1, or the
// warp's __syncwarp at the end of a step) order it there too.  A wide or
// deep step reads them in place, its latency long enough to hide theirs;
// the one-warp step (T <= 1024) takes them a 32-step window at a time by
// shuffle from registers (run_chain, kStage), as it takes its uniforms.
// A separate instantiation, so the builds whose arrays fit keep their
// code.
//
// Exactness.  Counts must equal the reference's bit for bit, so every
// float op is rounded where the reference rounds it:
//   * the cumsum is XLA CPU's blocked-16 order (repro_torch/numerics.py):
//     sequential within 16-element blocks, the block totals scanned by the
//     same rule, each block's exclusive prefix added to its elements;
//   * cdf[T-1] is the last block's local total plus its exclusive prefix,
//     as that scan forms it, not a separate reduction;
//   * no FMA contraction.  The reference rounds (n_td + alpha) * phi[w]
//     before the scan adds it, and nvcc would contract `acc + a * b` into
//     one fma by default.  Every float add and multiply in this file is
//     written with __fadd_rn / __fmul_rn, which nvcc never contracts; the
//     build relies on no flag such as -fmad=false.
//   * the two LSearch counts are integer reductions, exact in any order.
//
// Bound.  Each token step reads one phi row (4*T bytes) and is a dependent
// link of a chain of sweeps * (valid tokens) steps per document: the
// prob products, two 16-long dependent add chains, the upper scan, the
// counts and a warp reduction.  The chain's latency, not bandwidth, bounds
// the kernel: a full 64 x 512 x 20 batch at T = 1024 reads 2.7 GB of phi
// rows, but each CTA must take its 10,240 steps one after another.
// PERF.md keeps the measured time beside the bound and the chain's
// computed floor; tools/time_fold_scores.py --probes times the phases.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "../../csrc/blocked_scan.cuh"
#include "../../csrc/step_probes.cuh"

namespace {

using blocked_scan::kBlock;
using blocked_scan::scan_levels;
using blocked_scan::scan_line;
using blocked_scan::scan_line_groups;
using blocked_scan::scan_line_upper;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLine = 2 * kBlock;    // topics of a lane's line
constexpr int kChunk = 32 * kLine;   // topics of a chunk: a line a lane
constexpr int kUnits = kLine / 4;    // its 16-byte units
constexpr int kRingMax = 8;          // phi row slots, at most
constexpr int kBoxLines = 256;       // lines of a TMA box, at most
constexpr int kMaxWarps = 16;        // a CTA's warps
constexpr int kWideTopics = kMaxWarps * kChunk;   // 16,384: a line a thread
constexpr int kDeepTopics = 65536;   // deep: kMaxChunks lines a thread
constexpr int kMaxChunks = kDeepTopics / kWideTopics;
constexpr int kMaxTopics = 1048574;  // huge above kDeepTopics
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use
// Step probe counters: phases 0 .. 4 (ring wait, level 0, upper levels,
// counts, update), then steps and the total.
constexpr int kProbeSteps = 8, kProbeTotal = 10;

// phi[w] as jnp indexes it: a negative id wraps once, then it is clamped.
__device__ __forceinline__ int phi_row(int w, int J) {
  if (w < 0) w += J;
  return min(max(w, 0), J - 1);
}

// Words of a T-row in shared memory: whole lines.
__host__ __device__ inline int row_words(int T) {
  return (T + kLine - 1) / kLine * kLine;
}

// Shared index of topic t in a row: line t / 32, its 16-byte units in the
// order unit ^ (line & 7).
__device__ __forceinline__ int swz(int t) {
  return (t & ~31) | ((((t >> 2) & 7) ^ ((t >> 5) & 7)) << 2) | (t & 3);
}

// Whether phi rows can arrive by TMA: each row a whole number of 1024-byte
// swizzle spans, and whole boxes of at most 256 lines.  A TMA copy (two for
// T = 16,384) stores unit j of line o at unit j ^ (o & 7), as swz does.
__host__ __device__ inline bool tma_layout(int T) {
  constexpr int kBox = kBoxLines * kLine;
  return T % 256 == 0 && (T <= kBox || T % kBox == 0);
}

__host__ __device__ inline long long fixed_words(int L, int T) {
  return row_words(T) + 4LL * L + scan_levels(T).size;
}

__host__ __device__ inline bool deep(int T) { return T > kWideTopics; }
__host__ __device__ inline bool huge(int T) { return T > kDeepTopics; }

// f32 words of a huge CTA's exchange: group totals and their prefixes
// (ceil(T / 256) each), the last block's total and the value before it,
// the warps' two counts, supergroup totals and their prefixes
// (ceil(T / 4096) each).
__host__ __device__ inline long long huge_words(int T) {
  const long long ng = (T + kBlock * kBlock - 1) / (kBlock * kBlock);
  return 2 * ng + 2 + 2 * kMaxWarps + 2 * ((ng + kBlock - 1) / kBlock);
}

// Ring slots: 2 .. kRingMax as fit (with the alignment's 1024 bytes and 2
// words of mbarrier each), else 1, its row copied at its own step; none
// when deep.
__host__ __device__ inline int ring_slots(int L, int T) {
  if (deep(T)) return 0;
  const long long r = (kSmemLimit / 4 - 256 - fixed_words(L, T)) /
                      (row_words(T) + 2);
  return static_cast<int>(r < 2 ? 1 : (r > kRingMax ? kRingMax : r));
}

// Shared memory: with two slots or more, 1024 bytes of alignment, f32
// ring[slots][T], i32 n_td[T], the slots' mbarriers; else i32
// n_td[row_words(T)], f32 ring[row_words(T)].  Then i32 topic, phi row,
// weight and position [L] each, f32 upper scan levels; rows swizzled.
// The least of it, one slot, is fold_in.py:least_smem_bytes.
// Deep, the L-arrays and the scan levels' room only; huge, the L-arrays
// and the exchange.
__host__ __device__ inline long long smem_bytes(int L, int T) {
  if (huge(T)) return 4LL * (4LL * L + huge_words(T));
  if (deep(T)) return 4LL * (4LL * L + scan_levels(T).size);
  const int r = ring_slots(L, T);
  return 4LL * (fixed_words(L, T) + static_cast<long long>(r) *
                                        row_words(T)) +
         (r > 1 ? 1024 + 8LL * r : 0);
}

// Whether (L, T) takes the long placement: the L-arrays in device memory,
// where beside the state they would pass kSmemLimit.
__host__ __device__ inline bool long_rows(int L, int T) {
  return smem_bytes(L, T) > kSmemLimit;
}

// The L-arrays' length in shared memory: L, or 0 in the long placement.
__host__ __device__ inline int shared_len(int L, int T) {
  return long_rows(L, T) ? 0 : L;
}

// i32 words of global scratch a document takes: its n_td row when deep,
// then its four L-arrays in the long placement.
__host__ __device__ inline long long scratch_words(int L, int T) {
  return (deep(T) ? row_words(T) : 0) + (long_rows(L, T) ? 4LL * L : 0);
}

// The most chain steps (sweeps * L) a launch takes: step indices, with the
// windows' look-ahead, stay inside int32.
constexpr long long kMaxSteps = 0x7fffffffLL - 64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(std::uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits for the phase of parity `parity` of `bar` to complete.
__device__ __forceinline__ void mbar_wait(std::uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// By one lane: starts the TMA copies of row w (T / 32 lines of the map's
// (J * T / 32, 32) view of phi) into `slot`, completing on `bar`, after
// ordering the slot's last reads and writes before them.
__device__ __forceinline__ void tma_row(float* slot, const CUtensorMap* map,
                                        int w, int T, std::uint64_t* bar) {
  const int lines = T / kLine, box = min(lines, kBoxLines);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(4 * T)
      : "memory");
  for (int b = 0; b < lines; b += box)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_addr(slot + b * kLine)),
        "l"(map), "r"(0), "r"(w * lines + b), "r"(smem_addr(bar))
        : "memory");
}

// Waits until at most N of the thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// By each thread: cp.async copies of its own line of the phi row `src`
// into `slot`, swizzled, its entries below n (T, or 0 for an empty group),
// committed as one group; then waits until at most `pending` (0 ..
// kRingMax - 1) of its groups are pending.  `vec`: rows 16-byte aligned (T
// a multiple of 4, phi aligned), 16-byte copies.  Not inlined: it stays
// out of the instruction stream of the TMA steps.
__device__ __noinline__ void async_line(float* slot,
                                        const float* __restrict__ src,
                                        int n, bool vec, int pending) {
  const int lo = threadIdx.x * kLine;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kUnits; ++j)
      if (lo + 4 * j < n)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(slot + swz(lo + 4 * j))),
                     "l"(src + lo + 4 * j)
                     : "memory");
  } else {
    for (int e = 0; e < kLine && lo + e < n; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(slot + swz(lo + e))),
                   "l"(src + lo + e)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  switch (pending) {
    case 0: wait_groups<0>(); break;
    case 1: wait_groups<1>(); break;
    case 2: wait_groups<2>(); break;
    case 3: wait_groups<3>(); break;
    case 4: wait_groups<4>(); break;
    case 5: wait_groups<5>(); break;
    case 6: wait_groups<6>(); break;
    default: wait_groups<7>(); break;
  }
}
static_assert(kRingMax <= 8, "async_line waits for at most 7 groups");

// Four counts of a line as floats: stored as floats (exact integers), or
// as ints and converted.
__device__ __forceinline__ float4 counts4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 counts4(const int* p) {
  const int4 m = *reinterpret_cast<const int4*>(p);
  return make_float4(__int2float_rn(m.x), __int2float_rn(m.y),
                     __int2float_rn(m.z), __int2float_rn(m.w));
}

// Level 0 of the line from topic `lo`: prob = (n_td + alpha) * phi for its
// entries (both rows swizzled in shared memory), then each of its two
// blocks scanned in place; t0, t1 the blocks' local totals.  `n` entries
// of the line lie below T (kLine unless kMasked).
template <bool kMasked, typename Count>
__device__ __forceinline__ void line_cdf(float (&c)[kLine],
                                         const Count* s_ntd, const float* ph,
                                         int lo, int n, float alpha,
                                         float& t0, float& t1) {
  const int sw = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int off = lo + ((j ^ sw) << 2);
    const float4 m = counts4(s_ntd + off);
    const float4 f = *reinterpret_cast<const float4*>(ph + off);
    c[4 * j] = __fmul_rn(__fadd_rn(m.x, alpha), f.x);
    c[4 * j + 1] = __fmul_rn(__fadd_rn(m.y, alpha), f.y);
    c[4 * j + 2] = __fmul_rn(__fadd_rn(m.z, alpha), f.z);
    c[4 * j + 3] = __fmul_rn(__fadd_rn(m.w, alpha), f.w);
  }
  scan_line<kMasked>(c, n, t0, t1);
}

// The entries of one line (level-0 cdf c, its two blocks' exclusive
// prefixes p0 and p1) that are <= bound, or < bound with kStrict; the first
// `n` only with kMasked.  The first block's prefix is +0, and c + 0
// compares as c does.
template <bool kMasked, bool kStrict>
__device__ __forceinline__ int line_count(const float (&c)[kLine], int n,
                                          float p0, float p1, float bound) {
  int k[4] = {0, 0, 0, 0};               // four chains of adds, not one
#pragma unroll
  for (int j = 0; j < kLine; ++j) {
    if (!kMasked || j < n) {
      const float cdf = __fadd_rn(c[j], j < kBlock ? p0 : p1);
      k[j & 3] += kStrict ? cdf < bound : cdf <= bound;
    }
  }
  return (k[0] + k[1]) + (k[2] + k[3]);
}

// A line's le = #(cdf <= uval) and, with `strict`, lt = #(cdf < total).
template <bool kMasked>
__device__ __forceinline__ void line_counts(const float (&c)[kLine], int n,
                                            float p0, float p1, float uval,
                                            float total, bool strict,
                                            int& le, int& lt) {
  le += line_count<kMasked, false>(c, n, p0, p1, uval);
  if (strict) lt += line_count<kMasked, true>(c, n, p0, p1, total);
}

// One document's chain, as the kernel lays it out in shared memory (the
// L-arrays in device memory in the long placement).
struct Chain {
  const float* phi;       // (J, T)
  const CUtensorMap* map; // phi's TMA view, or null: rows by cp.async
  const float* u;         // the document's (sweeps, L) uniforms
  float* ring;            // slots of row_words(T)
  std::uint64_t* bars;    // the slots' mbarriers
  int* z;                 // topic, phi row, weight and position of the
  const int* w;           // valid tokens, in chain order
  const int* v;
  const int* pos;
  float* x;               // wide: the warps' exchange
  float alpha;
  int L, T, slots, nv, steps;
  bool vec;               // cp.async: rows 16-byte aligned
};

// The chain's steps, the counts n_td stored as Count (swizzled).  Thread
// i owns line i: topics 32i .. 32i + 31, two scan blocks.  kWide: T >
// 1024, a warp a 1024-topic chunk, else one warp; kMasked: T not a
// multiple of 32 (the loop of a multiple of 32 carries no masked code);
// kStage: one warp (not kWide) whose L-arrays lie in device memory
// (the long placement), read a window at a time (below).
template <typename Count, bool kWide, bool kMasked, bool kStage>
__device__ void run_chain(const Chain& a, Count* s_ntd) {
  static_assert(!(kWide && kStage), "a wide chain reads its arrays in place");
  PROBE_START
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, nv = a.nv, steps = a.steps, rw = row_words(T);
  const int nb = (T + kBlock - 1) / kBlock;    // level-0 scan blocks
  const int ring = a.slots;
  const int lo = tid * kLine, n = min(T - lo, kLine);
  // Wide: the exchange between warps, group totals and partial counts.
  const int ng = (nb + kBlock - 1) / kBlock, nw = blockDim.x >> 5;
  float* x_g = a.x;                             // [ng] group totals
  float* x_last = x_g + ng;                     // X[nb-1], Ylocal[nb-2]
  int* x_le = reinterpret_cast<int*>(x_last + 2);   // [nw] each
  int* x_lt = x_le + nw;

  // Step s's uniform, u[k][pos] for sweep k = s / nv.  Lane i holds the
  // one of step s0 + i of the window of 32 steps from s0, loaded when the
  // window starts, from L2, where a prefetch put it a window earlier.
  auto u_of = [&](int s) {
    const int k = s / nv;
    return a.u + static_cast<std::size_t>(k) * a.L + a.pos[s - k * nv];
  };
  auto u_window = [&](int s0) {
    if (s0 + 32 + lane < steps)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(u_of(s0 + 32 + lane)));
    return s0 + lane < steps ? __ldg(u_of(s0 + lane)) : 0.f;
  };
  float u_cur = u_window(0);
  // kStage: what the step reads of the L-arrays, in device memory, comes
  // by shuffle, as the uniform does, from registers each lane loads for
  // one step of a 32-step window: the phi row each step fetches (step s +
  // ring - 1's), the next token's weight, and the position of the
  // uniform, a window ahead (they are not written after compaction; the
  // next window's uniforms are prefetched at the end of the window's first
  // step, when its positions have come).  The next token's topic is
  // written by the chain: where nv > 32 it is loaded when its window
  // starts (after the last step's __syncwarp, which orders thread 0's
  // write) and shuffled at the update; else lane i keeps topic i, set at
  // each update, since a window would hold topics the chain rewrites
  // within it.  Only the one-warp step is short enough to gain: a wide
  // one reads its arrays in place as fast as from shared memory, and the
  // registers cost its 512 threads more than that (measured: PERF.md).
  int w_win = 0, v_win = 0, z_win = 0;          // this window's
  int w_ahead = 0, v_ahead = 0, pos_ahead = 0;  // the next window's
  auto l_load = [&](int s0) {
    w_ahead = a.w[(s0 + ring - 1 + lane) % nv];
    v_ahead = a.v[(s0 + 1 + lane) % nv];
    pos_ahead = a.pos[(s0 + lane) % nv];
  };
  if constexpr (kStage) {
    l_load(0);
    if (nv <= 32) z_win = lane < nv ? a.z[lane] : 0;
  }
  // Fetches the row (phi row w) of step s_f into slot_f: by thread 0's TMA
  // copy, or by each thread's cp.async group, empty past the chain (so
  // that the groups a thread has pending count steps), after which the
  // thread waits until at most `pending` of its groups are (cp.async
  // only).
  int qf = 0, slot_f = 0;                       // the next row to fetch
  auto fetch = [&](int s_f, int w, int pending) {
    float* dst = a.ring + slot_f * rw;
    if (a.map) {
      if (tid == 0 && s_f < steps)
        tma_row(dst, a.map, w, T, a.bars + slot_f);
    } else {
      async_line(dst, a.phi + static_cast<std::size_t>(w) * T,
                 s_f < steps ? T : 0, a.vec, pending);
    }
    qf = qf + 1 == nv ? 0 : qf + 1;
    slot_f = slot_f + 1 == ring ? 0 : slot_f + 1;
  };
  if (a.map && tid == 0)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(a.map) : "memory");
  for (int k = 0; k + 1 < ring; ++k) fetch(k, a.w[qf], kRingMax - 1);
  int q = 0, slot = 0, parity = 0, vi = a.v[0];
  {
    const int t = a.z[0];
    if (t >= 0 && t < T && tid == t >> 5)
      s_ntd[swz(t)] -= static_cast<Count>(vi);
  }

  for (int s = 0; s < steps; ++s) {
    const int qn = q + 1 == nv ? 0 : q + 1;
    // Wide, the next token's topic is read after barrier 1, which orders
    // thread 0's write of it at the last step (a document of two tokens).
    int z_next, v_next, w_f;
    if constexpr (kStage) {
      if ((s & 31) == 0) {
        w_win = w_ahead;
        v_win = v_ahead;
        if (s > 0)                              // window 0's: u_window(0)
          u_cur = s + lane < steps
                      ? __ldg(a.u + static_cast<std::size_t>(
                                        (s + lane) / nv) * a.L + pos_ahead)
                      : 0.f;
        l_load(s + 32);
        if (nv > 32) z_win = a.z[(s + 1 + lane) % nv];
      }
      w_f = __shfl_sync(kFull, w_win, s & 31);
    } else {
      z_next = kWide ? 0 : a.z[qn];
      v_next = a.v[qn];
      w_f = a.w[qf];
      if ((s & 31) == 0 && s > 0) u_cur = u_window(s);
    }
    const float us = __shfl_sync(kFull, u_cur, s & 31);
    if (a.map) {
      mbar_wait(a.bars + slot, parity);
    } else {                                    // the slot the last step
      fetch(s + ring - 1, w_f, ring - 1);       // read; this step's own
    }                                           // copies done
    PHASE(0)

    // Level 0, in registers.
    const float* ph = a.ring + slot * rw;
    float c[kLine], t0 = 0.f, t1 = 0.f;
    if (n > 0) line_cdf<kMasked>(c, s_ntd, ph, lo, n, a.alpha, t0, t1);
    PHASE(1)

    // The upper levels: by shuffles in one warp; wide, level 1 by each
    // warp, the group totals (and the last block's total and the local
    // value of the block before it) through shared memory, each warp
    // then scanning all group totals by shuffles.
    float p0, p1, total;
    if constexpr (!kWide) {
      scan_line_upper(t0, t1, nb, p0, p1, total);
    } else {
      float ya, yb;
      scan_line_groups(t0, t1, ya, yb);
      if ((lane & 7) == 7 && lo < T) x_g[tid >> 3] = yb;
      if (tid == (nb - 1) >> 1) x_last[0] = ((nb - 1) & 1) ? t1 : t0;
      if (tid == (nb - 2) >> 1) x_last[1] = ((nb - 2) & 1) ? yb : ya;
      __syncthreads();
      z_next = a.z[qn];
      if (a.map) fetch(s + ring - 1, w_f, 0);   // every warp is past the
      float z0, z1, unused;                     // last step's slot
      scan_line_upper(2 * lane < ng ? x_g[2 * lane] : 0.f,
                      2 * lane + 1 < ng ? x_g[2 * lane + 1] : 0.f, ng, z0,
                      z1, unused);
      // The exclusive prefix of group g, held by lane g / 2.
      auto group_pre = [&](int g) {
        const float e = __shfl_sync(kFull, z0, (g >> 1) & 31);
        const float o = __shfl_sync(kFull, z1, (g >> 1) & 31);
        return (g & 1) ? o : e;
      };
      const int g = tid >> 3;
      const float pre = group_pre(g);
      if (g > 0) {
        ya = __fadd_rn(ya, pre);
        yb = __fadd_rn(yb, pre);
      }
      p1 = ya;
      p0 = __shfl_up_sync(kFull, yb, 1);
      const float pre_last = group_pre(4 * warp - 1);
      if (lane == 0)                            // the last block before
        p0 = warp == 0 ? 0.f                    // this warp's chunk
                       : __fadd_rn(x_g[4 * warp - 1], pre_last);
      const int g2 = (nb - 2) >> 4;
      const float pre2 = group_pre(g2);
      const float y2 = g2 > 0 ? __fadd_rn(x_last[1], pre2) : x_last[1];
      total = __fadd_rn(x_last[0], y2);
    }
    PHASE(2)

    // The counts and the guarded LSearch, min(le, lt): with uval < total
    // every entry <= uval is < total, so le <= lt and lt is not needed.
    const float uval = __fmul_rn(us, total);
    const bool strict = !(uval < total);
    int le = 0, lt = 0;
    if (n > 0)
      line_counts<kMasked>(c, n, p0, p1, uval, total, strict, le, lt);
    int t_new = __reduce_add_sync(kFull, le);
    if (strict) lt = __reduce_add_sync(kFull, lt);
    if constexpr (kWide) {
      if (lane == 0) {
        x_le[warp] = t_new;
        x_lt[warp] = lt;
      }
      __syncthreads();
      t_new = 0;
      lt = 0;
      for (int k = 0; k < nw; ++k) {
        t_new += x_le[k];
        lt += x_lt[k];
      }
    } else if (a.map) {
      fetch(s + ring - 1, w_f, 0);              // while the sum travels
    }
    if (strict) t_new = min(t_new, lt);
    PHASE(3)

    // The update: this token's increment and the next one's decrement,
    // each by the thread that owns the topic.
    if constexpr (kStage) {
      v_next = __shfl_sync(kFull, v_win, s & 31);
      z_next = __shfl_sync(kFull, z_win, nv > 32 ? s & 31 : qn);
      if (nv <= 32 && lane == q) z_win = t_new;
      if ((s & 31) == 0 && s + 32 + lane < steps)  // the next window's
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(  // uniforms
            a.u + static_cast<std::size_t>((s + 32 + lane) / nv) * a.L +
            pos_ahead));
    }
    if (tid == 0) a.z[q] = t_new;
    const int own_new = t_new >> 5;
    const int t_next = qn == q ? t_new : z_next;
    const bool dec = s + 1 < steps && t_next >= 0 && t_next < T;
    if (dec && t_next == t_new) {
      if (tid == own_new)
        s_ntd[swz(t_new)] += static_cast<Count>(vi - v_next);
    } else {
      if (tid == own_new) s_ntd[swz(t_new)] += static_cast<Count>(vi);
      if (dec && tid == t_next >> 5)
        s_ntd[swz(t_next)] -= static_cast<Count>(v_next);
    }
    __syncwarp();
    PHASE(4) PROBE_COUNT(kProbeSteps)
    q = qn;
    vi = v_next;
    if (++slot == ring) {
      slot = 0;
      parity ^= 1;
    }
  }
  PROBE_END(kProbeTotal)
}

// Level 0 of a deep line from topic `lo` (kDeep): as line_cdf, its
// counts from the swizzled global n_td row, its phi entries from the row
// `ph` where it lies (16 bytes at a time where `vec`), the first `n` only.
template <typename Count>
__device__ __forceinline__ void line_cdf_deep(float (&c)[kLine],
                                              const Count* ntd,
                                              const float* __restrict__ ph,
                                              int lo, int n, bool vec,
                                              float alpha, float& t0,
                                              float& t1) {
  const int sw = (lo >> 5) & 7;
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const float4 m = counts4(ntd + lo + ((j ^ sw) << 2));
    const float* p = ph + lo + 4 * j;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec) {
      if (4 * j < n) f = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      if (4 * j < n) f.x = __ldg(p);
      if (4 * j + 1 < n) f.y = __ldg(p + 1);
      if (4 * j + 2 < n) f.z = __ldg(p + 2);
      if (4 * j + 3 < n) f.w = __ldg(p + 3);
    }
    c[4 * j] = __fmul_rn(__fadd_rn(m.x, alpha), f.x);
    c[4 * j + 1] = __fmul_rn(__fadd_rn(m.y, alpha), f.y);
    c[4 * j + 2] = __fmul_rn(__fadd_rn(m.z, alpha), f.z);
    c[4 * j + 3] = __fmul_rn(__fadd_rn(m.w, alpha), f.w);
  }
  scan_line<true>(c, n, t0, t1);
}

// The chain's steps above 16,384 topics (kDeep): n_td in the document's
// global scratch row `ntd` (swizzled, stored as Count), phi rows read where
// they lie; thread i owns lines i + 512 j for j < chunks.  The scan's
// order is run_chain's wide one: level 1 by each warp's lanes, the group
// totals (at most 256) through shared memory, their exclusive prefixes by
// warp 0 (group_prefixes).  kHuge (T > 65,536): up to 64 lines a thread,
// their level-1 values formed again in pass 2 rather than kept, and up to
// 4,096 group totals (supergroup_prefixes).
template <typename Count, bool kHuge>
__device__ void run_chain_deep(const Chain& a, Count* ntd) {
  PROBE_START
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int T = a.T, nv = a.nv, steps = a.steps;
  const int nb = (T + kBlock - 1) / kBlock;     // level-0 scan blocks
  const int ng = (nb + kBlock - 1) / kBlock;    // their groups of 16
  const int chunks = ((T + kLine - 1) / kLine + nt - 1) / nt;
  float* x_g = a.x;                             // [ng] group totals
  float* x_pre = x_g + ng;                      // [ng] their prefixes
  float* x_last = x_pre + ng;                   // X[nb-1], Ylocal[nb-2]
  int* x_le = reinterpret_cast<int*>(x_last + 2);   // [nw] each
  int* x_lt = x_le + nw;
  // kHuge: [ns] supergroup totals, then [ns] their prefixes.
  float* x_sg = reinterpret_cast<float*>(x_lt + nw);
  float* x_spre = x_sg + (ng + kBlock - 1) / kBlock;
  auto owner = [&](int t) { return (t >> 5) & (nt - 1); };

  auto u_of = [&](int s) {
    const int k = s / nv;
    return a.u + static_cast<std::size_t>(k) * a.L + a.pos[s - k * nv];
  };
  auto u_window = [&](int s0) {
    if (s0 + 32 + lane < steps)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(u_of(s0 + 32 + lane)));
    return s0 + lane < steps ? __ldg(u_of(s0 + lane)) : 0.f;
  };
  // The lines of phi row w this thread owns, into L2.
  auto prefetch_row = [&](int w) {
    const float* row = a.phi + static_cast<std::size_t>(w) * T;
    for (int j = 0; j < chunks; ++j) {
      const int lo = (tid + nt * j) * kLine;
      if (lo < T) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + lo));
    }
  };
  float u_cur = u_window(0);
  int q = 0, vi = a.v[0];
  {
    const int t = a.z[0];
    if (t >= 0 && t < T && tid == owner(t))
      ntd[swz(t)] -= static_cast<Count>(vi);
  }
  prefetch_row(a.w[0]);

  for (int s = 0; s < steps; ++s) {
    const int qn = q + 1 == nv ? 0 : q + 1;
    const int v_next = a.v[qn];
    if ((s & 31) == 0 && s > 0) u_cur = u_window(s);
    const float us = __shfl_sync(kFull, u_cur, s & 31);
    const float* ph = a.phi + static_cast<std::size_t>(a.w[q]) * T;
    if (s + 1 < steps) prefetch_row(a.w[qn]);
    PHASE(0)

    // Pass 1: each line's level 0 and level 1; the group totals, the
    // last block's total and the local value of the block before it.
    // Huge, each line's own level-1 values are not kept.
    float ya[kMaxChunks], yb[kMaxChunks];
    auto level1 = [&](int j, float& pa, float& pb) {
      const int line = tid + nt * j, lo = line * kLine;
      const int n = min(T - lo, kLine);
      float c[kLine], t0 = 0.f, t1 = 0.f;
      if (n > 0) line_cdf_deep(c, ntd, ph, lo, n, a.vec, a.alpha, t0, t1);
      scan_line_groups(t0, t1, pa, pb);
      if ((lane & 7) == 7 && lo < T) x_g[line >> 3] = pb;
      if (line == (nb - 1) >> 1) x_last[0] = ((nb - 1) & 1) ? t1 : t0;
      if (line == (nb - 2) >> 1) x_last[1] = ((nb - 2) & 1) ? pb : pa;
    };
    if constexpr (kHuge) {
#pragma unroll 1
      for (int j = 0; j < chunks; ++j) {
        float pa, pb;
        level1(j, pa, pb);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        if (j >= chunks) break;                 // uniform across the CTA
        level1(j, ya[j], yb[j]);
      }
    }
    PHASE(1)
    __syncthreads();
    // Barrier 1 also orders thread 0's write of the next token's topic
    // at the last step (a document of two tokens).
    const int z_next = a.z[qn];
    if constexpr (kHuge) {
      blocked_scan::supergroup_prefixes(x_g, ng, x_pre, x_sg, x_spre);
    } else {
      if (warp == 0) blocked_scan::group_prefixes(x_g, ng, x_pre);
      __syncthreads();
    }
    const int g2 = (nb - 2) >> 4;
    const float y2 = g2 > 0 ? __fadd_rn(x_last[1], x_pre[g2]) : x_last[1];
    const float total = __fadd_rn(x_last[0], y2);
    PHASE(2)

    // Pass 2: the same products again, each block's prefix, the counts.
    const float uval = __fmul_rn(us, total);
    const bool strict = !(uval < total);
    int le = 0, lt = 0;
    auto count = [&](int j, const float (&c)[kLine], int n, float pa,
                     float pb) {
      const int line = tid + nt * j, g = line >> 3;
      if (g > 0) {
        pa = __fadd_rn(pa, x_pre[g]);
        pb = __fadd_rn(pb, x_pre[g]);
      }
      float p0 = __shfl_up_sync(kFull, pb, 1);
      if (lane == 0)                            // the last block before
        p0 = line == 0 ? 0.f                    // this warp's lines
                       : __fadd_rn(x_g[g - 1], x_pre[g - 1]);
      if (n > 0) line_counts<true>(c, n, p0, pa, uval, total, strict, le, lt);
    };
    if constexpr (kHuge) {
#pragma unroll 1
      for (int j = 0; j < chunks; ++j) {
        const int lo = (tid + nt * j) * kLine, n = min(T - lo, kLine);
        float c[kLine], t0 = 0.f, t1 = 0.f, pa, pb;
        if (n > 0) line_cdf_deep(c, ntd, ph, lo, n, a.vec, a.alpha, t0, t1);
        scan_line_groups(t0, t1, pa, pb);     // pass 1's values again
        count(j, c, n, pa, pb);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        if (j >= chunks) break;
        const int lo = (tid + nt * j) * kLine, n = min(T - lo, kLine);
        float c[kLine], t0, t1;
        if (n > 0) line_cdf_deep(c, ntd, ph, lo, n, a.vec, a.alpha, t0, t1);
        count(j, c, n, ya[j], yb[j]);
      }
    }
    int t_new = __reduce_add_sync(kFull, le);
    if (strict) lt = __reduce_add_sync(kFull, lt);
    if (lane == 0) {
      x_le[warp] = t_new;
      x_lt[warp] = lt;
    }
    __syncthreads();
    t_new = 0;
    lt = 0;
    for (int k = 0; k < nw; ++k) {
      t_new += x_le[k];
      lt += x_lt[k];
    }
    if (strict) t_new = min(t_new, lt);
    PHASE(3)

    // The update, each count by the thread that owns its line.
    if (tid == 0) a.z[q] = t_new;
    const int t_next = qn == q ? t_new : z_next;
    const bool dec = s + 1 < steps && t_next >= 0 && t_next < T;
    if (dec && t_next == t_new) {
      if (tid == owner(t_new))
        ntd[swz(t_new)] += static_cast<Count>(vi - v_next);
    } else {
      if (tid == owner(t_new)) ntd[swz(t_new)] += static_cast<Count>(vi);
      if (dec && tid == owner(t_next))
        ntd[swz(t_next)] -= static_cast<Count>(v_next);
    }
    PHASE(4) PROBE_COUNT(kProbeSteps)
    q = qn;
    vi = v_next;
  }
  PROBE_END(kProbeTotal)
}

// One CTA per document: one warp for T <= 1024, else a warp for each
// 1024-topic chunk (kWide), up to 16; kDeep past 16,384 topics, 16 warps,
// n_td in the document's row of `scratch`; kHuge past 65,536; kLong, the
// L-arrays in the document's row of `scratch` (long_rows).
template <bool kWide, bool kDeep, bool kHuge, bool kLong>
__global__ void __launch_bounds__(kWide ? kMaxWarps * 32 : 32)
    fold_in_kernel(const __grid_constant__ CUtensorMap map,
                   const int* __restrict__ words,
                   const int* __restrict__ valid, const int* __restrict__ z0,
                   const float* __restrict__ u,
                   const float* __restrict__ phi, int* __restrict__ out,
                   int* __restrict__ scratch, float alpha, int L, int T,
                   int J, int sweeps, int slots, bool tma, bool vec) {
  static_assert(kWide || !kDeep, "a deep CTA has 16 warps");
  static_assert(kDeep || !kHuge, "a huge CTA is deep");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rw = row_words(T);
  float* s_ring = nullptr;
  int* s_ntd;
  std::uint64_t* s_bars = nullptr;
  int* s_z;                                     // chain order: topic,
  // A document's scratch row: n_td (deep), then the L-arrays (kLong).
  const std::size_t row_words_ntd = kDeep ? rw : 0;
  const std::size_t scratch_row =
      row_words_ntd + (kLong ? 4 * static_cast<std::size_t>(L) : 0);
  if constexpr (kDeep) {
    s_ntd = scratch + static_cast<std::size_t>(blockIdx.x) * scratch_row;
    s_z = reinterpret_cast<int*>(smem_raw);
  } else if (slots > 1) {
    const unsigned pad = (1024u - smem_addr(smem_raw) % 1024u) % 1024u;
    s_ring = reinterpret_cast<float*>(smem_raw + pad);
    s_ntd = reinterpret_cast<int*>(s_ring + slots * rw);
    s_bars = reinterpret_cast<std::uint64_t*>(s_ntd + rw);
    s_z = reinterpret_cast<int*>(s_bars + slots);
  } else {
    s_ntd = reinterpret_cast<int*>(smem_raw);
    s_ring = reinterpret_cast<float*>(s_ntd + rw);
    s_z = reinterpret_cast<int*>(s_ring + rw);
  }
  float* s_up;                                  // scan levels' room
  if constexpr (kLong) {        // where the L-arrays would be; they go to
    s_up = reinterpret_cast<float*>(s_z);       // the scratch row
    s_z = scratch + static_cast<std::size_t>(blockIdx.x) * scratch_row +
          row_words_ntd;
  }
  int* s_w = s_z + L;                           // phi row,
  int* s_v = s_w + L;                           // weight,
  int* s_p = s_v + L;                           // position
  if constexpr (!kLong) s_up = reinterpret_cast<float*>(s_p + L);
  const int tid = threadIdx.x, lane = tid & 31;
  const std::size_t row = static_cast<std::size_t>(blockIdx.x) * L;
  if (s_bars && tid == 0) {
    for (int k = 0; k < slots; ++k) mbar_init(s_bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < rw; i += blockDim.x) s_ntd[i] = 0;
  __syncthreads();
  int nv = 0;                                   // valid positions
  unsigned long long mass = 0;                  // sum of |valid|
  if (tid < 32) {                               // the first warp compacts
    for (int base = 0; base < L; base += 32) {
      const int p = base + lane;
      int v = 0, t = -1, w = 0;
      if (p < L) {
        v = valid[row + p];
        t = z0[row + p];
        w = words[row + p];
      }
      mass += v < 0 ? -static_cast<long long>(v) : v;
      if (t >= 0 && t < T) atomicAdd(&s_ntd[swz(t)], v);  // jnp drops
      const unsigned m = __ballot_sync(kFull, v > 0);      // out-of-range
      if (v > 0) {                                         // adds
        const int q = nv + __popc(m & ((1u << lane) - 1u));
        s_z[q] = t;
        s_w[q] = phi_row(w, J);
        s_v[q] = v;
        s_p[q] = p;
      }
      nv += __popc(m);
    }
    for (int d = 16; d > 0; d >>= 1) mass += __shfl_xor_sync(kFull, mass, d);
  }
  if constexpr (kWide) {                        // to the other warps
    unsigned long long* s_meta = reinterpret_cast<unsigned long long*>(s_up);
    if (tid == 0) {
      s_meta[0] = nv;
      s_meta[1] = mass;
    }
    __syncthreads();
    nv = static_cast<int>(s_meta[0]);
    mass = s_meta[1];
  }
  __syncthreads();                              // s_up is the chain's now
  // Every count the chain forms sums weights of this document, so below
  // 2^24 they are exact integers as floats, which spares each step the
  // conversion.
  const bool exact = mass < (1ull << 24);
  if (sweeps * nv > 0) {
    const Chain a{phi, tma ? &map : nullptr, u + row * sweeps, s_ring,
                  s_bars, s_z, s_w, s_v, s_p, s_up, alpha, L, T, slots, nv,
                  sweeps * nv, vec};
    if (exact) {
      float* s_f = reinterpret_cast<float*>(s_ntd);
      for (int i = tid; i < rw; i += blockDim.x)
        s_f[i] = __int2float_rn(s_ntd[i]);
      __syncthreads();
      if constexpr (kDeep)
        run_chain_deep<float, kHuge>(a, s_f);
      else if constexpr (kWide)
        run_chain<float, true, true, false>(a, s_f);
      else if (T % kLine)
        run_chain<float, false, true, kLong>(a, s_f);
      else
        run_chain<float, false, false, kLong>(a, s_f);
      __syncthreads();
      for (int i = tid; i < rw; i += blockDim.x)
        s_ntd[i] = __float2int_rn(s_f[i]);
    } else if constexpr (kDeep) {
      run_chain_deep<int, kHuge>(a, s_ntd);
    } else {
      run_chain<int, kWide, true, kLong && !kWide>(a, s_ntd);
    }
    __syncthreads();
  }
  for (int t = tid; t < T; t += blockDim.x)
    out[static_cast<std::size_t>(blockIdx.x) * T + t] = s_ntd[swz(t)];
}

// cuTensorMapEncodeTiled, looked up in libcuda, which the CUDA runtime
// has already loaded (the build links only the runtime).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// phi's TMA view: (J * T / 32) lines of 32 f32, a box of T / 32 lines (at
// most kBoxLines), 128-byte swizzle.  False where it cannot be made (the
// launch then fails rather than run without it).
bool phi_map(CUtensorMap* map, const void* phi, int J, int T) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (!lib) return false;
    encode = reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
    if (!encode) return false;
  }
  const cuuint64_t dims[2] = {kLine, static_cast<cuuint64_t>(J) * T / kLine};
  const cuuint64_t strides[1] = {4 * kLine};
  const cuuint32_t box[2] = {kLine,
                             static_cast<cuuint32_t>(min(T / kLine,
                                                         kBoxLines))};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(phi), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Shared memory of one CTA for (L, T), in bytes: smem_bytes of the
// placement the launcher picks (the L-arrays' length 0 when long_rows).
extern "C" int fold_in_smem_bytes(int L, int T) {
  if (L < 1 || T < 1) return 0;
  const long long n = smem_bytes(shared_len(L, T), T);
  return n > 0x7fffffff ? 0x7fffffff : static_cast<int>(n);
}

// Bytes of global scratch a document takes (scratch_words): its n_td row
// when deep, its L-arrays when long_rows, else none; 0x7fffffff past int32.
extern "C" int fold_in_scratch_bytes(int L, int T) {
  if (L < 1 || T < 1 || T > kMaxTopics) return 0;
  const long long n = 4 * scratch_words(L, T);
  return n > 0x7fffffff ? 0x7fffffff : static_cast<int>(n);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Pointers are device pointers to contiguous arrays:
// words, valid, z0 (D, L) i32; u (D, sweeps * L) f32; phi (J, T) f32;
// out (D, T) i32; scratch D * fold_in_scratch_bytes(L, T) bytes (null
// where that is 0).  Refuses T past kMaxTopics, sweeps * L past kMaxSteps
// and a document's scratch past int32 bytes.
extern "C" int fold_in_launch(const void* words, const void* valid,
                              const void* z0, const void* u, const void* phi,
                              void* out, void* scratch, float alpha, int D,
                              int L, int T, int J, int sweeps,
                              void* stream) {
  if (D < 1 || L < 1 || T < 1 || T > kMaxTopics || J < 1 || sweeps < 1 ||
      static_cast<long long>(sweeps) * L > kMaxSteps ||
      4 * scratch_words(L, T) > 0x7fffffff ||
      (scratch_words(L, T) > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool lng = long_rows(L, T);
  const int smem = static_cast<int>(smem_bytes(shared_len(L, T), T));
  const int slots = ring_slots(shared_len(L, T), T);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // One warp for T <= 1024, else a warp a 1024-topic chunk, 16 at most.
  const bool wide = T > kChunk;
  const int threads = deep(T) ? 32 * kMaxWarps
                              : 32 * ((T + kChunk - 1) / kChunk);
  const auto kernel =
      lng ? (huge(T)   ? fold_in_kernel<true, true, true, true>
             : deep(T) ? fold_in_kernel<true, true, false, true>
             : wide    ? fold_in_kernel<true, false, false, true>
                       : fold_in_kernel<false, false, false, true>)
          : (huge(T)   ? fold_in_kernel<true, true, true, false>
             : deep(T) ? fold_in_kernel<true, true, false, false>
             : wide    ? fold_in_kernel<true, false, false, false>
                       : fold_in_kernel<false, false, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA copies where rows fit its layout, the ring has two slots or more
  // and phi is 16-byte aligned; else each thread's cp.async.
  CUtensorMap map{};
  const bool aligned = reinterpret_cast<std::uintptr_t>(phi) % 16 == 0;
  const bool tma = tma_layout(T) && slots > 1 && aligned;
  if (tma && !phi_map(&map, phi, J, T))
    return static_cast<int>(cudaErrorNotSupported);
  kernel<<<D, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int*>(words), static_cast<const int*>(valid),
      static_cast<const int*>(z0), static_cast<const float*>(u),
      static_cast<const float*>(phi), static_cast<int*>(out),
      static_cast<int*>(scratch), alpha, L, T, J, sweeps, slots, tma,
      aligned && T % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}
