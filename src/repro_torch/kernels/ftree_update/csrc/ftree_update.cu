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
// nodes in its shared memory (4 T bytes at the leaves).  The CTA's threads
// stage the updates in batches of kBatch in shared memory (coalesced), then
// warp 0 walks the batch 32 updates at a time in k order: each lane maps
// its update to its node at this level and, from the node's value, adds
// the deltas of every lane on that node in lane order (which is k order),
// fetched by shuffle; the lowest lane of each node (__match_any_sync)
// writes the node back.  Different groups hold different nodes, so the
// writes do not race; the next 32 updates see them after __syncwarp.
// Updates with ts outside [0, T) are skipped (the plain version raises on
// them).
//
// Exactness.  One __fadd_rn per delta and node, in the reference's order;
// nothing to contract.
//
// Bound.  Bytes: ts and deltas read once (8 K bytes) and the tree read and
// written once (16 T bytes), about 0.16 us for K = 65,536 at 3.35 TB/s.
// The kernel runs far above it: each level is one warp's serial walk of K
// updates.  PERF.md keeps the measured time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBatch = 4096;     // updates staged in shared memory at once

__global__ void __launch_bounds__(kThreads)
    ftree_update_kernel(const float* __restrict__ F,
                        const int* __restrict__ ts,
                        const float* __restrict__ deltas,
                        float* __restrict__ out, int K, int T) {
  extern __shared__ float smem[];
  const int level = blockIdx.x;
  const int first = T >> level;      // the level's nodes: [first, 2 first)
  const int count = first;
  float* s_node = smem;                              // count f32
  int* s_ts = reinterpret_cast<int*>(s_node + count);  // kBatch i32
  float* s_d = reinterpret_cast<float*>(s_ts + kBatch);  // kBatch f32
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    s_node[i] = F[first + i];
  if (first == 1 && threadIdx.x == 0) out[0] = F[0];  // the unused slot
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < K; base += kBatch) {
    const int n = min(kBatch, K - base);
    __syncthreads();                 // the last batch is walked
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_ts[i] = ts[base + i];
      s_d[i] = deltas[base + i];
    }
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    for (int c = 0; c < n; c += 32) {
      const int i = c + lane;
      const int t = i < n ? s_ts[i] : -1;
      const bool live = t >= 0 && t < T;
      // a distinct key for each dead lane, so it shares no node
      const int node = live ? (t + T) >> level : -1 - lane;
      const float d = live ? s_d[i] : 0.f;
      float acc = live ? s_node[node - first] : 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {   // the lanes on my node, in k order
        const int nj = __shfl_sync(kFull, node, j);
        const float dj = __shfl_sync(kFull, d, j);
        if (nj == node) acc = __fadd_rn(acc, dj);
      }
      const unsigned group = __match_any_sync(kFull, node);
      if (live && (__ffs(group) - 1) == lane) s_node[node - first] = acc;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    out[first + i] = s_node[i];
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  F and out (2T,) f32 (distinct), ts (K,) i32, deltas
// (K,) f32: contiguous device arrays; T a power of two with 4 T + 8 kBatch
// bytes of shared memory allowed a block (T <= 49,984 on sm_90, so up to
// T = 32768).
extern "C" int ftree_update_launch(const void* F, const void* ts,
                                   const void* deltas, void* out, int K,
                                   int T, void* stream) {
  if (K < 0 || T < 1 || (T & (T - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int depth = 0;
  while ((1 << depth) < T) ++depth;
  const int smem = 4 * T + 8 * kBatch;
  cudaError_t err = cudaFuncSetAttribute(
      ftree_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ftree_update_kernel<<<depth + 1, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<const int*>(ts),
      static_cast<const float*>(deltas), static_cast<float*>(out), K, T);
  return static_cast<int>(cudaGetLastError());
}
