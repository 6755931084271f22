// Step probes of the port's serial-chain kernels (fused_sweep.cu,
// fold_in.cu), for tools/step_phases.py and tools/time_fold_scores.py.
//
// Built with -DSTEP_PROBES, thread 0 of CTA g_probe_cta adds the clock64
// cycles since the last probe to counter k of PHASE(k), adds one to
// counter k at PROBE_COUNT(k), and at PROBE_END(total) stores the
// counters, with the kernel's total cycles in counter `total`, in
// g_probe.  Without the define the probes compile to nothing.  A probed
// build compiles one kernel source on its own (step_probe is defined
// once per source).
#pragma once

#include <cuda_runtime.h>

#ifdef STEP_PROBES
__device__ unsigned long long g_probe[16];
__device__ int g_probe_cta = -1;
#define PROBE_ON (blockIdx.x == g_probe_cta && threadIdx.x == 0)
#define PROBE_START                             \
  long long last_ = clock64(), t0_ = last_;      \
  unsigned long long acc_[16] = {0};
#define PHASE(k)                                \
  if (PROBE_ON) {                               \
    const long long n_ = clock64();             \
    acc_[k] += n_ - last_;                      \
    last_ = n_;                                 \
  }
#define PROBE_COUNT(k) \
  if (PROBE_ON) acc_[k] += 1;
#define PROBE_END(total)                                    \
  if (PROBE_ON) {                                           \
    acc_[total] = clock64() - t0_;                          \
    for (int i_ = 0; i_ < 16; ++i_) g_probe[i_] = acc_[i_]; \
  }

// Sets the probed CTA and zeroes the counters (host null), or copies the
// counters to host[16]; returns the cudaError_t.
extern "C" int step_probe(int cta, unsigned long long* host) {
  if (host)
    return static_cast<int>(
        cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe)));
  unsigned long long zero[16] = {0};
  cudaError_t err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(g_probe_cta, &cta, sizeof(int)));
}
#else
#define PROBE_START
#define PHASE(k)
#define PROBE_COUNT(k)
#define PROBE_END(total)
#endif
