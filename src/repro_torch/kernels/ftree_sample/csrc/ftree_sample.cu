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
// Layout.  A persistent grid: as many CTAs as fit on the SMs at once, each
// copies the whole tree into its shared memory (8 T bytes: 8 KiB at
// T = 1024, 128 KiB at T = 16384, which leaves room for one CTA an SM), then
// each thread walks draws n, n + stride, ... one after another.  The TPU
// kernel walks a tile of 1024 draws in lock step with vector gathers; here
// each thread's walk is its own dependent chain of log2 T shared-memory
// reads, and the SM hides their latency with its other warps.
//
// Exactness.  The two float ops, u01 * F[1] and u - F[2i], are written as
// __fmul_rn and __fsub_rn, which nvcc never contracts (there is no product
// that is added).  The comparisons are exact.  So every draw equals the
// plain version's (ftree.sample_batch) bit for bit.
//
// Bound.  Bytes: u01 read and z written, 8 N bytes, plus the tree once a
// CTA from L2; or the log2 T dependent shared-memory reads of one walk,
// whichever is longer.  At N = 2**20 the bytes take about 2.5 us at
// 3.35 TB/s, so the kernel sits on its walks' latency and on how many
// walks the SMs keep in flight.  PERF.md keeps the measured time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    ftree_sample_kernel(const float* __restrict__ F,
                        const float* __restrict__ u01, int* __restrict__ z,
                        int64_t N, int T, int depth) {
  extern __shared__ float tree[];
  for (int i = threadIdx.x; i < 2 * T; i += blockDim.x) tree[i] = F[i];
  __syncthreads();
  const float root = tree[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       n < N; n += stride) {
    float u = __fmul_rn(u01[n], root);
    int i = 1;
    for (int d = 0; d < depth; ++d) {
      const float left = tree[2 * i];
      const bool right = u >= left && tree[2 * i + 1] > 0.f;
      i = 2 * i + (right ? 1 : 0);
      if (right) u = __fsub_rn(u, left);
    }
    z[n] = i - T;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  F (2T,) f32, u01 (N,) f32, z (N,) i32: contiguous
// device arrays; T a power of two with 8 T bytes of shared memory allowed
// a block (T <= 16384 on sm_90).
extern "C" int ftree_sample_launch(const void* F, const void* u01, void* z,
                                   int64_t N, int T, void* stream) {
  if (N < 1 || T < 1 || (T & (T - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 8 * T;
  cudaError_t err = cudaFuncSetAttribute(
      ftree_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ftree_sample_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t need = (N + kThreads - 1) / kThreads;
  const int64_t fit = static_cast<int64_t>(sms) * per_sm;
  const int blocks = static_cast<int>(need < fit ? need : fit);
  int depth = 0;
  while ((1 << depth) < T) ++depth;
  ftree_sample_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<const float*>(u01),
      static_cast<int*>(z), N, T, depth);
  return static_cast<int>(cudaGetLastError());
}
