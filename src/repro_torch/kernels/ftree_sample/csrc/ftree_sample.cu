// Batched F+tree sampling kernel, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ftree_sample/ftree_sample.py:
// ftree_sample_pallas (body _kernel).  N draws against one F+tree F (2T f32,
// heap layout: F[1] the root, node i's children 2i and 2i+1, leaf t at
// F[T + t]; T a power of two): u = u01 * F[1], then log2 T steps down from
// the root, going right when u >= F[2i] and the right subtree has mass
// (F[2i + 1] > 0), and then u -= F[2i]; the draw is the leaf's index.
// The guard keeps a uniform that rounds up to F[1] off a zero-mass padded
// leaf (repro/core/ftree.py:sample_batch).
//
// One split a node.  The walk needs, at node i, F[2i] and whether
// F[2i + 1] > 0.  Each CTA first turns the pairs (F[2i], F[2i + 1]) into
// one float a node, split[i] = F[2i + 1] > 0 ? F[2i] : NaN, in shared
// memory.  No u is >= NaN, so `u >= split[i]` is the reference's whole
// test (a NaN F[2i] or F[2i + 1] goes left in both), and where it holds
// split[i] is F[2i] bit for bit.  A level is then one 4-byte shared-memory
// read, where the pair took two: the top six levels' nodes (1 .. 63) sit in
// distinct banks (one wavefront a warp), a random level below costs the
// balls-in-bins maximum of 32 reads over 32 banks.
//
// Layout.  A persistent grid of 1024-thread CTAs, one an SM, so that each
// SM fills one tree.  A CTA fills the splits of nodes 1 .. S - 1,
// S = min(T, 2^15) (at most 128 KiB), from 16-byte loads of F, so
// occupancy no longer falls with T and any T runs: levels at nodes >= S
// (T > 32768) read their pair through the read-only path (the tree sits in
// L2).  A thread owns groups of 4 consecutive draws: one 16-byte load of
// their uniforms, asked for two groups ahead (the first two before the
// fill, or right after the fill's loads where the fill takes one pass, so
// that the tree's first nodes arrive first), four interleaved walks that
// hide each other's latency, one 16-byte store of the draws.  The head of
// u01 up to its first 16-byte boundary and the tail past the last whole
// group go one draw a thread; where z is not aligned as u01 is, the draws
// go by 4-byte stores.  Two CTAs an SM, 8 draws a thread, one group ahead
// and the top three levels in registers each measured slower on the H100.
//
// Exactness.  The two float ops, u01 * F[1] and u - F[2i], are written as
// __fmul_rn and __fsub_rn, which nvcc never contracts (there is no product
// that is added).  The comparisons are exact and ordered (false on NaN).
// So every draw equals the plain version's (ftree.sample_batch) bit for bit.
//
// Bound.  Bytes: u01 read and z written, 8 N bytes, plus the tree: 2.5 us at
// N = 2**20 and 3.35 TB/s.  Besides the bytes, the walks' shared-memory
// wavefronts (1 a level at the top, ~3.5 a random level at the bottom, one
// an SM a cycle) and, at small N, each CTA's fill (8 S bytes from L2) set
// the time.  PERF.md keeps the measured time.
//
// FTREE_ABLATE (tools/time_ftree_sample.py --ablate builds it; unset in the
// library): 1 skips the walk, 2 the fill, 3 the uniforms' loads.  Their
// draws are not the plain version's.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#ifndef FTREE_ABLATE
#define FTREE_ABLATE 0
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kDraws = 4;               // consecutive draws: one float4
constexpr int kSmemDepth = 15;          // splits of nodes < 2^15 fit a CTA
constexpr int kMaxDepth = 30;           // heap indices 2T - 1 fit an int32
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float split(float left, float right) {
  return right > 0.f ? left : __int_as_float(0x7fc00000);
}

// One level of K interleaved walks, each at node i[k] with split s[k].
template <int K>
__device__ __forceinline__ void step(const float (&s)[K], float (&u)[K],
                                     int (&i)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool right = u[k] >= s[k];
    i[k] = 2 * i[k] + (right ? 1 : 0);
    if (right) u[k] = __fsub_rn(u[k], s[k]);
  }
}

// K walks from the root: u[k] already scaled by F[1]; i[k] ends at the leaf.
template <int K>
__device__ __forceinline__ void walk(const float* __restrict__ splits,
                                     const float* __restrict__ F,
                                     int smem_depth, int depth, float (&u)[K],
                                     int (&i)[K]) {
#if FTREE_ABLATE == 1
  (void)splits;
  (void)F;
  (void)smem_depth;
#pragma unroll
  for (int k = 0; k < K; ++k)
    i[k] = (1 << depth) + (__float_as_int(u[k]) & ((1 << depth) - 1));
#else
#pragma unroll
  for (int k = 0; k < K; ++k) i[k] = 1;
  float s[K];
  for (int d = 0; d < smem_depth; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = splits[i[k]];
    step(s, u, i);
  }
  for (int d = smem_depth; d < depth; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[k] = split(__ldg(F + 2 * i[k]), __ldg(F + 2 * i[k] + 1));
    step(s, u, i);
  }
#endif
}

// Group g's uniforms (zeros past the last group): one 16-byte load,
// streamed past L1.
__device__ __forceinline__ float4 uniforms(const float4* __restrict__ u4,
                                           int64_t g, int64_t G) {
  if (g >= G) return make_float4(0.f, 0.f, 0.f, 0.f);
#if FTREE_ABLATE == 3
  (void)u4;
  const float a =
      static_cast<float>((static_cast<unsigned>(g) * 2654435761u) >> 8) *
      0x1p-24f;
  return make_float4(a, 1.f - a, 0.5f * a, 0.25f + 0.5f * a);
#else
  return __ldcs(u4 + g);
#endif
}

__global__ void __launch_bounds__(kThreads)
    ftree_sample_kernel(const float* __restrict__ F,
                        const float* __restrict__ u01, int* __restrict__ z,
                        int64_t N, int T, int depth, int smem_depth) {
  extern __shared__ float splits[];  // splits[i], node 1 <= i < S
  const int S = 1 << smem_depth;
  // Draws [0, head) lie before u01's first 16-byte boundary, then G whole
  // groups of kDraws, then `tail` draws.
  int64_t head = ((16 - (reinterpret_cast<std::uintptr_t>(u01) & 15)) & 15)
                 >> 2;
  if (head > N) head = N;
  const int64_t G = (N - head) / kDraws;
  const int64_t tail = N - head - kDraws * G;
  const float4* u4 = reinterpret_cast<const float4*>(u01 + head);
  const bool z_aligned =
      (reinterpret_cast<std::uintptr_t>(z + head) & 15) == 0;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  // The fill, and the first two groups' uniforms in flight over it.  They
  // go out before the fill, except where the fill is one pass of 16-byte
  // loads: that pass goes first, so that the tree's nodes arrive first
  // (and as written here: merging the three branches' uniform loads into
  // one place measured slower).
  float4 next, after;
  const bool F_aligned = (reinterpret_cast<std::uintptr_t>(F) & 15) == 0;
#if FTREE_ABLATE == 2
  next = uniforms(u4, first, G);
  after = uniforms(u4, first + stride, G);
#else
  if (F_aligned && S / 2 <= kThreads) {        // one pass: the tree first
    const int j = threadIdx.x;
    const float4 q = j < S / 2 ? __ldg(reinterpret_cast<const float4*>(F) + j)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    next = uniforms(u4, first, G);
    after = uniforms(u4, first + stride, G);
    if (j < S / 2)
      reinterpret_cast<float2*>(splits)[j] =
          make_float2(split(q.x, q.y), split(q.z, q.w));
  } else if (F_aligned) {
    next = uniforms(u4, first, G);
    after = uniforms(u4, first + stride, G);
    const float4* F4 = reinterpret_cast<const float4*>(F);
    float2* pairs = reinterpret_cast<float2*>(splits);
#pragma unroll 4
    for (int j = threadIdx.x; j < S / 2; j += kThreads) {
      const float4 q = __ldg(F4 + j);            // nodes 2j and 2j + 1
      pairs[j] = make_float2(split(q.x, q.y), split(q.z, q.w));
    }
  } else {
    next = uniforms(u4, first, G);
    after = uniforms(u4, first + stride, G);
#pragma unroll 4
    for (int j = threadIdx.x; j < S; j += kThreads)
      splits[j] = split(__ldg(F + 2 * j), __ldg(F + 2 * j + 1));
  }
#endif
  __syncthreads();
  const float root = __ldg(F + 1);

  // The head and the tail, one draw a thread.
  const int64_t edge = first < head                ? first
                       : first - head < tail       ? N - tail + (first - head)
                                                   : -1;
  if (edge >= 0) {
    float u[1] = {__fmul_rn(u01[edge], root)};
    int i[1];
    walk(splits, F, smem_depth, depth, u, i);
    z[edge] = i[0] - T;
  }

  for (int64_t g = first; g < G; g += stride) {
    const float4 v = next;
    next = after;
    after = uniforms(u4, g + 2 * stride, G);
    float u[kDraws] = {__fmul_rn(v.x, root), __fmul_rn(v.y, root),
                       __fmul_rn(v.z, root), __fmul_rn(v.w, root)};
    int i[kDraws];
    walk(splits, F, smem_depth, depth, u, i);
    int* out = z + head + kDraws * g;
    if (z_aligned) {
      __stcs(reinterpret_cast<int4*>(out),
             make_int4(i[0] - T, i[1] - T, i[2] - T, i[3] - T));
    } else {
#pragma unroll
      for (int k = 0; k < kDraws; ++k) out[k] = i[k] - T;
    }
  }
}

// The SM count of each device, asked once (with the shared-memory
// attribute set then); static storage, so 0 until then.
std::atomic<int> sm_count[kMaxDevices];

cudaError_t sms_of_current_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sm_count[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(
           ftree_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           4 << kSmemDepth)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  sm_count[dev].store(*sms, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  F (2T,) f32 and u01 (N,) f32, z (N,) i32: contiguous
// device arrays (4-byte aligned will do); T a power of two up to 2^30.
extern "C" int ftree_sample_launch(const void* F, const void* u01, void* z,
                                   int64_t N, int T, void* stream) {
  if (N < 1 || T < 1 || (T & (T - 1)) || T > (1 << kMaxDepth))
    return static_cast<int>(cudaErrorInvalidValue);
  int depth = 0;
  while ((1 << depth) < T) ++depth;
  const int smem_depth = depth < kSmemDepth ? depth : kSmemDepth;
  int sms = 0;
  cudaError_t err = sms_of_current_device(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One CTA an SM (more would each fill a tree of their own): a thread a
  // group of kDraws, one each for the head and tail draws (at most
  // 3 + kDraws - 1), on at most `sms` CTAs.
  const int64_t threads = N / kDraws + 3 + kDraws;
  const int64_t need = (threads + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < sms ? need : sms);
  ftree_sample_kernel<<<blocks, kThreads, 4 << smem_depth,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<const float*>(u01),
      static_cast<int*>(z), N, T, depth, smem_depth);
  return static_cast<int>(cudaGetLastError());
}
