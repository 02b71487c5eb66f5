// DNA-TEQ encode for kernel epilogues: a float32 value to its uint8 code
// `sign<<7 | (e - e_min)` under packed params qmeta = (alpha, beta, base,
// bits) -- the same float32 steps as exponential_quant.encode_meta:
//   arg = max((|x| - beta) / alpha, 1e-30)
//   e   = round_half_even(log(arg) / log(base)), clipped to [e_min, e_max]
// rintf rounds half to even (roundf would round half away from zero), and
// the build keeps -use_fast_math out, so '/' and logf are the accurate
// ones.  A one-ulp difference between this logf and the host library's
// can still move a value across a rounding boundary: such codes differ
// by one exponent step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dnateq {

__device__ __forceinline__ uint8_t encode(float x, const float* qm) {
  const float alpha = qm[0], beta = qm[1], base = qm[2], bits = qm[3];
  const float e_min = -exp2f(bits - 1.0f);
  const float e_max = exp2f(bits - 1.0f) - 1.0f;
  const float arg = fmaxf((fabsf(x) - beta) / alpha, 1e-30f);
  float e = rintf(logf(arg) / logf(base));
  e = fminf(fmaxf(e, e_min), e_max);
  const unsigned biased = (unsigned)(e - e_min);
  return (uint8_t)((x < 0.0f ? 0x80u : 0u) | biased);
}

}  // namespace dnateq
