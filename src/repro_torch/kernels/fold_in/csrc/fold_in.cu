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
// Layout.  One CTA per document.  Shared memory holds n_td (T i32), the
// current token's phi row (T f32), the row's z, word ids, mask and the
// list of its valid positions (L i32 each), and the upper levels of the
// scan (about T/15 f32).  n_td and the phi row are stored with one pad
// word after every 16 entries, so that thread b, which owns scan block b
// (entries 16b .. 16b+15), reads them without bank conflicts.  Thread b
// forms prob for its block and scans it in registers, so level 0 of the
// cdf never touches shared memory.  The next token's phi row is read from
// global memory, coalesced (thread i reads entries i, i + blockDim, ...),
// while the current one scans, and is stored at the end of the step.
//
// Exactness.  Counts must equal the reference's bit for bit, so every
// float op is rounded where the reference rounds it:
//   * the cumsum is XLA CPU's blocked-16 order (repro_torch/numerics.py):
//     sequential within 16-element blocks, the block totals scanned by the
//     same rule, each block's exclusive prefix added to its elements;
//   * no FMA contraction.  The reference rounds (n_td + alpha) * phi[w]
//     before the scan adds it, and nvcc would contract `acc + a * b` into
//     one fma by default.  Every float add and multiply in this file is
//     written with __fadd_rn / __fmul_rn, which nvcc never contracts; the
//     build relies on no flag such as -fmad=false.
//   * the two LSearch counts are integer reductions, exact in any order.
//
// Bound.  Each token step reads one phi row (4*T bytes) and is a dependent
// link of a chain of sweeps * (valid tokens) steps per CTA: a 16-long
// serial add chain per level, ~7 __syncthreads and two block reductions.
// The chain's latency, not bandwidth, bounds the kernel: a full
// 64 x 512 x 20 batch at T = 1024 reads 2.7 GB of phi rows, but each CTA
// must take its 10,240 steps one after another, and only 64 SMs hold a
// CTA.  PERF.md keeps the measured time beside the bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/blocked_scan.cuh"

namespace {

using blocked_scan::kBlock;
using blocked_scan::Levels;
using blocked_scan::scan_levels;
using blocked_scan::scan_upper;

// phi[w] as jnp indexes it: a negative id wraps once, then it is clamped.
__device__ __forceinline__ int phi_row(int w, int J) {
  if (w < 0) w += J;
  return min(max(w, 0), J - 1);
}

// Shared index of entry t of a padded T-array: one pad word per 16.
__device__ __forceinline__ int pad(int t) { return t + t / kBlock; }

// Thread i's entries i, i + blockDim, ... of a phi row (at most 16, since
// blockDim >= T / 16), read coalesced.
__device__ __forceinline__ void load_row(float (&r)[kBlock],
                                         const float* __restrict__ row,
                                         int T) {
#pragma unroll
  for (int k = 0; k < kBlock; ++k) {
    const int t = threadIdx.x + k * blockDim.x;
    r[k] = t < T ? __ldg(row + t) : 0.f;
  }
}

__device__ __forceinline__ void store_row(float* s_phi,
                                          const float (&r)[kBlock], int T) {
#pragma unroll
  for (int k = 0; k < kBlock; ++k) {
    const int t = threadIdx.x + k * blockDim.x;
    if (t < T) s_phi[pad(t)] = r[k];
  }
}

// Shared memory: ints n_td[pad(T)], z[L], w[L], v[L], pos[L], red[66];
// then f32 phi_row[pad(T)] and the upper scan levels.
// fold_in.py:fold_in_smem_bytes mirrors it.
__host__ __device__ inline int smem_bytes(int L, int T) {
  const int padded = T + (T + kBlock - 1) / kBlock;
  return 4 * (2 * padded + 4 * L + 66 + scan_levels(T).size);
}

__global__ void fold_in_kernel(const int* __restrict__ words,
                               const int* __restrict__ valid,
                               const int* __restrict__ z0,
                               const float* __restrict__ u,
                               const float* __restrict__ phi,
                               int* __restrict__ out, float alpha, int L,
                               int T, int J, int sweeps) {
  extern __shared__ int smem[];
  const Levels lv = scan_levels(T);
  const int nb = lv.len[0];                  // level-0 scan blocks
  int* s_ntd = smem;                         // padded
  int* s_z = s_ntd + T + nb;
  int* s_w = s_z + L;
  int* s_v = s_w + L;
  int* s_pos = s_v + L;          // valid positions, in chain order
  int* s_red = s_pos + L;        // [0,32) [32,64): per-warp counts;
                                 // 64: valid count; 65: last block total
  float* s_phi = reinterpret_cast<float*>(s_red + 66);  // padded
  float* s_up = s_phi + T + nb;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const std::size_t row = static_cast<std::size_t>(blockIdx.x) * L;

  for (int t = tid; t < T; t += nthr) s_ntd[pad(t)] = 0;
  for (int p = tid; p < L; p += nthr) {
    s_z[p] = z0[row + p];
    s_w[p] = phi_row(words[row + p], J);
    s_v[p] = valid[row + p];
  }
  __syncthreads();
  for (int p = tid; p < L; p += nthr) {  // jnp drops out-of-range adds
    const int t = s_z[p];
    if (t >= 0 && t < T) atomicAdd(&s_ntd[pad(t)], s_v[p]);
  }
  if (tid == 0) {
    int n = 0;
    for (int p = 0; p < L; ++p)
      if (s_v[p] > 0) s_pos[n++] = p;
    s_red[64] = n;
  }
  __syncthreads();

  const int nv = s_red[64];
  const int steps = sweeps * nv;
  const int lo = tid * kBlock;
  const bool owner = tid < nb;
  const float* ud = u + row * sweeps;
  float nxt[kBlock];
  if (steps > 0) {
    load_row(nxt, phi + static_cast<std::size_t>(s_w[s_pos[0]]) * T, T);
    store_row(s_phi, nxt, T);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int k = s / nv, q = s - k * nv;
    const int p = s_pos[q];
    const int vi = s_v[p];
    const int t_old = s_z[p];
    const bool more = s + 1 < steps;
    if (more) {
      const int pn = s_pos[q + 1 == nv ? 0 : q + 1];
      load_row(nxt, phi + static_cast<std::size_t>(s_w[pn]) * T, T);
    }

    // prob and the sequential scan of this thread's block, in registers.
    float c[kBlock];
    if (owner) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        const int t = lo + j;
        if (t < T) {
          const int n = s_ntd[pad(t)] - (t == t_old ? vi : 0);
          const float pr = __fmul_rn(__fadd_rn(__int2float_rn(n), alpha),
                                     s_phi[pad(t)]);
          acc = (j == 0) ? pr : __fadd_rn(acc, pr);
          c[j] = acc;
        }
      }
      s_up[tid] = acc;
      if (tid == nb - 1) s_red[65] = __float_as_int(acc);
    }
    __syncthreads();
    scan_upper(s_up, lv);

    // cdf[T-1] as the blocked scan forms it: the last block's local total
    // plus the exclusive prefix of that block.
    const float last = __int_as_float(s_red[65]);
    const float total = nb > 1 ? __fadd_rn(last, s_up[nb - 2]) : last;
    const float uval = __fmul_rn(ud[k * L + p], total);
    int le = 0, lt = 0;
    if (owner) {
      const float pre = tid > 0 ? s_up[tid - 1] : 0.f;
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        if (lo + j < T) {
          const float cdf = tid > 0 ? __fadd_rn(c[j], pre) : c[j];
          le += cdf <= uval;
          lt += cdf < total;
        }
      }
    }
    le = __reduce_add_sync(0xffffffffu, le);
    lt = __reduce_add_sync(0xffffffffu, lt);
    if (lane == 0) {
      s_red[warp] = le;
      s_red[32 + warp] = lt;
    }
    __syncthreads();
    if (tid == 0) {
      int n_le = 0, n_lt = 0;
      for (int w = 0; w < nwarps; ++w) {
        n_le += s_red[w];
        n_lt += s_red[32 + w];
      }
      const int t_new = min(n_le, n_lt);
      if (t_old >= 0 && t_old < T) s_ntd[pad(t_old)] -= vi;
      s_ntd[pad(t_new)] += vi;
      s_z[p] = t_new;
    }
    if (more) store_row(s_phi, nxt, T);    // read after the next barrier
    __syncthreads();
  }
  for (int t = tid; t < T; t += nthr)
    out[static_cast<std::size_t>(blockIdx.x) * T + t] = s_ntd[pad(t)];
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Pointers are device pointers to contiguous arrays:
// words, valid, z0 (D, L) i32; u (D, sweeps * L) f32; phi (J, T) f32;
// out (D, T) i32.  `smem` must be what fold_in_smem_bytes gives.
extern "C" int fold_in_launch(const void* words, const void* valid,
                              const void* z0, const void* u, const void* phi,
                              void* out, float alpha, int D, int L, int T,
                              int J, int sweeps, int smem, void* stream) {
  const int nb = (T + kBlock - 1) / kBlock;
  const int threads = (nb + 31) / 32 * 32;
  if (D < 1 || L < 1 || T < 1 || J < 1 || sweeps < 1 || threads > 1024 ||
      smem != smem_bytes(L, T))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fold_in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_in_kernel<<<D, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), static_cast<const int*>(valid),
      static_cast<const int*>(z0), static_cast<const float*>(u),
      static_cast<const float*>(phi), static_cast<int*>(out), alpha, L, T, J,
      sweeps);
  return static_cast<int>(cudaGetLastError());
}
