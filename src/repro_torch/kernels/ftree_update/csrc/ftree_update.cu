// Batched F+tree update kernel, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ftree_update/ftree_update.py:
// ftree_update_pallas (body _kernel).  K updates p[ts[k]] += deltas[k] to
// one F+tree F (2T f32, heap layout, T a power of two), written to a new
// tree: each delta is added to its leaf T + ts[k] and to every ancestor
// (T + ts[k]) >> l.  Duplicate leaves and shared ancestors accumulate.
//
// Order.  Every node lies on exactly one level, and the reference adds the
// deltas that reach a node in the order of k: the Pallas kernel scatters
// level by level, and ftree.update_batch scatters the flattened paths, both
// one update after another.  This kernel keeps that order, so its tree
// equals the plain version's bit for bit for any deltas, where f32
// atomicAdd would add them in an order that changes from run to run.
//
// Layout.  One CTA per level l (log2 T + 1 of them), the level's T >> l
// nodes in its shared memory (4 T bytes at the leaves), for the levels of
// at most kRange nodes.  A level with more (T > 32,768, toward the leaves)
// is split by node range over (T >> l) / kRange CTAs, kRange nodes each:
// every CTA reads all K updates in k order and keeps those whose node falls
// in its range, so every node still lives in exactly one CTA and adds its
// deltas in k order.  The first log2 T + 1 CTAs of the grid take one
// level each (its first range), the root's among them, so that the
// longest chains of adds start first; the further ranges come after.  The
// CTA takes the
// updates kChunk at a time, in k order, the next chunk read into registers
// while this one is worked on.  It sorts the chunk by node with a stable
// radix sort written here (two bits of the node a pass: a block-wide scan
// of the four digits' counts ranks each update), so that the deltas of
// each node lie together and still in k order.  Then one thread
// a node present in the chunk adds that node's deltas, in order, to the
// node's value, all nodes of the level at once.  Updates with ts outside
// [0, T) or outside the CTA's range sort after every node and are skipped
// (the plain version raises on updates outside the tree).
//
// Exactness.  One __fadd_rn per delta and node, in the reference's order;
// nothing to contract.
//
// Bound.  Bytes: ts and deltas read once (8 K bytes) and the tree read and
// written once (16 T bytes), about 0.16 us for K = 65,536 at 3.35 TB/s.
// A split level reads the K updates once a CTA (from L2 after the first).
// Order: the root adds all K deltas one after another, so no kernel that
// keeps the reference's bits can take less than K dependent f32 adds; the
// root's CTA feeds them from shared memory, sixteen loads ahead of the adds,
// and the other levels' CTAs finish before it.  PERF.md keeps the
// measured time beside both.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // updates a thread holds
constexpr int kChunk = kThreads * kItems;     // updates sorted at once
constexpr int kUnroll = 16;                   // loads ahead of the adds
constexpr int kRange = 32768;                 // nodes a CTA, at most

using u64 = unsigned long long;

// Exclusive sum over the CTA of one u64 per thread, in thread order, and
// the total: four 16-bit counters side by side, none of which carries
// into the next (a chunk holds fewer than 2**16 items).  `s_warp` holds
// kWarps u64; returns synchronised.
__device__ __forceinline__ u64 block_exclusive_sum(u64 v, u64* s_warp,
                                                   u64& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    u64 w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const u64 excl = incl - v + (warp > 0 ? s_warp[warp - 1] : 0);
  total = s_warp[kWarps - 1];
  __syncthreads();
  return excl;
}

// Inclusive max over the CTA of one int per thread, in thread order.
// `s_warp` holds kWarps ints; returns synchronised.
__device__ __forceinline__ int block_inclusive_max(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, y);
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = -1;
  for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
  __syncthreads();
  return max(v, before);
}

// acc + val[j] + val[j + 1] + ... + val[end - 1], one add after another,
// the next kUnroll loads in flight while the adds of these run.
__device__ __forceinline__ float walk(const float* val, int j, int end,
                                      float acc) {
  float x[kUnroll];
  if (j + kUnroll <= end) {
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) x[e] = val[j + e];
    j += kUnroll;
    while (j + kUnroll <= end) {
      float y[kUnroll];
#pragma unroll
      for (int e = 0; e < kUnroll; ++e) y[e] = val[j + e];
#pragma unroll
      for (int e = 0; e < kUnroll; ++e) acc = __fadd_rn(acc, x[e]);
#pragma unroll
      for (int e = 0; e < kUnroll; ++e) x[e] = y[e];
      j += kUnroll;
    }
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) acc = __fadd_rn(acc, x[e]);
  }
#pragma unroll 1
  for (; j < end; ++j) acc = __fadd_rn(acc, val[j]);
  return acc;
}

// Chunk items i = e * kThreads + threadIdx.x of the chunk at `base`, read
// coalesced: key = node - from, the node's place in the CTA's range of
// `nodes` from node `from`, or `nodes` for an update outside the tree or
// (kSplit) the range (and past K), and the delta.  Without kSplit the
// range is the whole level, and every update in the tree falls in it.
template <bool kSplit>
__device__ __forceinline__ void fetch(int (&rk)[kItems], float (&rv)[kItems],
                                      const int* ts, const float* deltas,
                                      int base, int K, int T, int level,
                                      int from, int nodes) {
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int k = base + e * kThreads + threadIdx.x;
    const int t = k < K ? ts[k] : -1;
    int key = nodes;
    if (t >= 0 && t < T) {
      const int at = ((t + T) >> level) - from;
      if (!kSplit || (at >= 0 && at < nodes)) key = at;
    }
    rk[e] = key;
    rv[e] = k < K ? deltas[k] : 0.f;
  }
}

// The level and the node range of this CTA: blocks 0 .. depth take level
// blockIdx.x, its first kRange nodes (all of them for a whole level); the
// blocks after take the further ranges of the split levels, leaves first.
template <bool kSplit>
__device__ __forceinline__ void my_range(int T, int depth, int& level,
                                         int& lo) {
  if (!kSplit || static_cast<int>(blockIdx.x) <= depth) {
    level = blockIdx.x;
    lo = 0;
    return;
  }
  int j = blockIdx.x - depth - 1;
  for (level = 0;; ++level) {
    const int extra = (T >> level) / kRange - 1;   // ranges past the first
    if (j < extra) break;
    j -= extra;
  }
  lo = (j + 1) * kRange;
}

// kSplit: T > kRange, some levels split over several CTAs.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    ftree_update_kernel(const float* __restrict__ F,
                        const int* __restrict__ ts,
                        const float* __restrict__ deltas,
                        float* __restrict__ out, int K, int T,
                        int depth) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  int level, lo;
  my_range<kSplit>(T, depth, level, lo);
  const int first = T >> level;      // the level's nodes: [first, 2 first)
  // This CTA's: [from, from + nodes).
  const int nodes = kSplit ? min(first, kRange) : first;
  const int from = first + lo;
  int bits = 0;                      // log2 of the CTA's node count
  while ((1 << bits) < nodes) ++bits;
  // The two key and value buffers of the sort: buffer w's keys at
  // smem + w kChunk, its values at smem + (2 + w) kChunk.
  int* const s_keys = reinterpret_cast<int*>(smem);
  float* const s_vals = smem + 2 * kChunk;
  u64* s_warp = reinterpret_cast<u64*>(smem + 4 * kChunk);   // kWarps
  float* s_node = smem + 4 * kChunk + 2 * kWarps;  // `nodes` f32
  for (int i = tid; i < nodes; i += kThreads) s_node[i] = F[from + i];
  if (first == 1 && tid == 0) out[0] = F[0];  // the unused slot

  int rk[kItems];
  float rv[kItems];
  fetch<kSplit>(rk, rv, ts, deltas, 0, K, T, level, from, nodes);
  for (int base = 0; base < K; base += kChunk) {
    __syncthreads();                 // the last chunk is walked
    bool outside = false;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      s_keys[e * kThreads + tid] = rk[e];
      s_vals[e * kThreads + tid] = rv[e];
      outside |= rk[e] == nodes;
    }
    if (base + kChunk < K)
      fetch<kSplit>(rk, rv, ts, deltas, base + kChunk, K, T, level, from,
                    nodes);
    // The stable sort by key, two bits of it a pass (a radix-4 digit),
    // thread tid holding items [tid * kItems, (tid + 1) * kItems), read
    // as 16-byte vectors; the digit counts of all threads scanned at once.
    const int passes =
        (bits + (__syncthreads_or(outside) ? 1 : 0) + 1) / 2;
    int cur = 0;
    for (int pass = 0; pass < passes; ++pass) {
      int k[kItems];
      float v[kItems];
      const int4* kq =
          reinterpret_cast<const int4*>(s_keys + cur * kChunk) + 2 * tid;
      const float4* vq =
          reinterpret_cast<const float4*>(s_vals + cur * kChunk) + 2 * tid;
      const int4 k0 = kq[0], k1 = kq[1];
      const float4 v0 = vq[0], v1 = vq[1];
      k[0] = k0.x; k[1] = k0.y; k[2] = k0.z; k[3] = k0.w;
      k[4] = k1.x; k[5] = k1.y; k[6] = k1.z; k[7] = k1.w;
      v[0] = v0.x; v[1] = v0.y; v[2] = v0.z; v[3] = v0.w;
      v[4] = v1.x; v[5] = v1.y; v[6] = v1.z; v[7] = v1.w;
      const int shift = 2 * pass;
      u64 mine = 0;
#pragma unroll
      for (int e = 0; e < kItems; ++e)
        mine += 1ull << (16 * ((k[e] >> shift) & 3));
      u64 total;
      u64 at = block_exclusive_sum(mine, s_warp, total);
      // The first slot of each digit's items: the totals of the digits
      // below it, added into each 16-bit field.
      at += (total << 16) + (total << 32) + (total << 48);
#pragma unroll
      for (int e = 0; e < kItems; ++e) {
        const int digit = (k[e] >> shift) & 3;
        const int dst = static_cast<int>((at >> (16 * digit)) & 0xffffull);
        at += 1ull << (16 * digit);
        s_keys[(cur ^ 1) * kChunk + dst] = k[e];
        s_vals[(cur ^ 1) * kChunk + dst] = v[e];
      }
      cur ^= 1;
      __syncthreads();
    }
    // Runs of equal keys: the head of the run each thread's items start
    // in (an inclusive max scan of the head positions, read one thread
    // back), and each head's end, written at the head's position in the
    // spare key buffer by the run's last item.
    const int* key = s_keys + cur * kChunk;
    int* end_at = s_keys + (cur ^ 1) * kChunk;
    int* s_head = reinterpret_cast<int*>(s_vals + (cur ^ 1) * kChunk);
    int head = -1;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = tid * kItems + e;
      if (i == 0 || key[i] != key[i - 1]) head = i;
    }
    s_head[tid] = block_inclusive_max(head, reinterpret_cast<int*>(s_warp));
    __syncthreads();
    int h = tid > 0 ? s_head[tid - 1] : -1;   // the run going on at my items
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = tid * kItems + e;
      if (i == 0 || key[i] != key[i - 1]) h = i;
      if (i == kChunk - 1 || key[i] != key[i + 1]) end_at[h] = i + 1;
    }
    __syncthreads();
#pragma unroll 1
    for (int e = 0; e < kItems; ++e) {
      const int i = tid * kItems + e;
      const int node = key[i];
      if ((i == 0 || node != key[i - 1]) && node < nodes)
        s_node[node] = walk(s_vals + cur * kChunk, i, end_at[i],
                            s_node[node]);
    }
  }
  __syncthreads();
  for (int i = tid; i < nodes; i += kThreads) out[from + i] = s_node[i];
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  F and out (2T,) f32 (distinct), ts (K,) i32, deltas
// (K,) f32: contiguous device arrays; T a power of two up to 2**30, whose
// heap indices fit an int (ftree_update.py:MAX_TOPICS).
extern "C" int ftree_update_launch(const void* F, const void* ts,
                                   const void* deltas, void* out, int K,
                                   int T, void* stream) {
  if (K < 0 || T < 1 || T > (1 << 30) || (T & (T - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int depth = 0, blocks = 0;
  while ((1 << depth) < T) ++depth;
  for (int level = 0; level <= depth; ++level)
    blocks += (T >> level) > kRange ? (T >> level) / kRange : 1;
  const int smem = 4 * (T < kRange ? T : kRange) + 16 * kChunk + 8 * kWarps;
  const auto kernel = T > kRange ? ftree_update_kernel<true>
                                 : ftree_update_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<const int*>(ts),
      static_cast<const float*>(deltas), static_cast<float*>(out), K, T,
      depth);
  return static_cast<int>(cudaGetLastError());
}
