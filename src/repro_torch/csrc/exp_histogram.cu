// Signed exponent histograms, Hopper (sm_90a).
//
// Replaces src/repro/kernels/exp_histogram/exp_histogram.py:
//   exp_histogram_kernel (#11): hist[g, e] = sum_i sign[g, i] *
//   [vals[g, i] == e], LamaAccel's signed exponent counters (paper
//   §V-C), behind term T1 of Eq. 1.
// The TPU kernel compares a chunk of values against an iota of bin ids
// and contracts the one-hot with the signs on the MXU, carrying the
// histogram in VMEM along a sequential chunk axis, in bg x bm blocks
// that must divide G and M.  Here one block owns one row: each of its 8
// warps keeps a private histogram of num_bins float32 counters in shared
// memory (at most 512 bins: 16 KiB), adds each sign to its counter with
// a shared-memory atomic (one increment per element, no one-hot), then
// the block sums the 8 copies and writes the row once.  Any G and M.  A
// value outside [0, num_bins) counts nowhere, as its one-hot row is
// zero.  Bound on an H100: bytes -- vals and signs read once (8 B per
// element), the histograms written once.  Signs of +-1 sum exactly in
// float32 below 2^24 per bin, so the result equals the plain version bit
// for bit whatever order the atomics take.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BINS = 512;

__device__ __forceinline__ void count(float* h, int v, float s, int bins) {
  if ((unsigned)v < (unsigned)bins) atomicAdd(h + v, s);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
exp_histogram_kernel(const int* __restrict__ vals,
                     const float* __restrict__ signs, float* __restrict__ out,
                     int M, int bins) {
  extern __shared__ float s_h[];   // [WARPS][bins]
  for (int i = threadIdx.x; i < WARPS * bins; i += THREADS) s_h[i] = 0.0f;
  __syncthreads();
  float* h = s_h + (threadIdx.x / 32) * bins;
  const size_t row0 = (size_t)blockIdx.x * M;
  if constexpr (VEC) {
    const int4* v4 = reinterpret_cast<const int4*>(vals + row0);
    const float4* s4 = reinterpret_cast<const float4*>(signs + row0);
    for (int i = threadIdx.x; i < M / 4; i += THREADS) {
      const int4 v = v4[i];
      const float4 s = s4[i];
      count(h, v.x, s.x, bins);
      count(h, v.y, s.y, bins);
      count(h, v.z, s.z, bins);
      count(h, v.w, s.w, bins);
    }
  } else {
    for (int i = threadIdx.x; i < M; i += THREADS)
      count(h, vals[row0 + i], signs[row0 + i], bins);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < bins; e += THREADS) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += s_h[w * bins + e];
    out[(size_t)blockIdx.x * bins + e] = t;
  }
}

}  // namespace

// vals int32 [G, M]; signs float32 [G, M]; out float32 [G, bins].
// vec = 1 takes 16-byte loads (M a multiple of 4, both 16-byte aligned).
extern "C" int exp_histogram_launch(const void* vals, const void* signs,
                                    void* out, int G, int M, int bins,
                                    int vec, void* stream) {
  if (G < 1 || M < 0 || bins < 1 || bins > MAX_BINS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * bins * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* v = static_cast<const int*>(vals);
  const float* s = static_cast<const float*>(signs);
  float* o = static_cast<float*>(out);
  if (vec)
    exp_histogram_kernel<true><<<G, THREADS, smem, st>>>(v, s, o, M, bins);
  else
    exp_histogram_kernel<false><<<G, THREADS, smem, st>>>(v, s, o, M, bins);
  return (int)cudaGetLastError();
}
