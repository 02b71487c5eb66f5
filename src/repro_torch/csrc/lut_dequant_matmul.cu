// Fused LUT-dequantize + matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels
//   src/repro/kernels/lut_dequant_matmul/lut_dequant_matmul.py:
//     lut_dequant_matmul_kernel        (#1)  y = act(x @ dec(codes) + bias)
//     lut_dequant_matmul_gated_kernel  (#2)  y = act(x @ dec(cg)) * (x @ dec(cu))
//     lut_dequant_matmul_dual_kernel   (#3)  y = act(dec_a(xc) @ dec(codes) + bias)
//     lut_dequant_matmul_dual_gated_kernel (#4)
//                                            y = act(dec_a(xc) @ dec(cg)) * (dec_a(xc) @ dec(cu))
//
// dec() maps uint8 DNA-TEQ codes through a 256-entry table.  The table is
// loaded into shared memory once per block ("gather" mode) or computed
// there from the packed (alpha, beta, base, bits) by the closed form
// sign*(alpha*exp(e*log(base))+beta) ("alu" mode) -- the same values the
// reference's per-element ALU decode gives for each code.  Codes cross
// device memory as 1 byte per weight; the decoded weight tile exists
// only in shared memory.  Accumulation is float32 FMA (no TF32, no
// tensor cores), so the result is a float32 matmul up to summation order.
//
// What bounds it on an H100: at decode (M <= 8) the code bytes -- about
// 1.72 GB per qwen3-1.7b decode step -- so the "skinny" path streams
// codes with every SM busy (split-K over a deterministic second pass
// when the N tiles alone cannot fill the card).  At prefill (M = 64 ...
// 2048) float32 FMA throughput (67 TFLOP/s peak outside the tensor
// cores), so the "tiled" path keeps a 128x128 output tile in registers
// (8x8 per thread) and reuses every decoded tile across 128 rows.
// Layouts: codes [K, N], or [N, K] (transposed: the tied unembedding),
// where the transpose happens while a decoded tile is stored to shared
// memory, never on the table in device memory.
//
// Dual variants (#3, #4; XT = uint8_t): x arrives as uint8 activation
// codes and decodes through its own table in shared memory (gather or
// ALU form) while the x tile is staged, so activations cross device
// memory at 1 B/element too.  The ragged K edge stores 0.0 *after*
// decode: code 0 is a live code (it decodes to +-(alpha*base^e_min +
// beta)), so a past-K element must never be "load code 0".  With an out
// qmeta the epilogue is bias, activation (gated: act(g)*u), then the
// DNA-TEQ encode (dnateq.cuh), writing uint8; under split-K it runs only
// in the reduce pass, after the partials are summed, never per split.
// At decode the dual GEMMs are bound by the weight-code bytes like #1/#2
// (the activation codes are a quarter of the float32 x bytes); at
// prefill by the float32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dnateq.cuh"

namespace {

constexpr int ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3;

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == ACT_GELU) {  // tanh approximation, as jax.nn.gelu's default
    const float c = 0.7978845608028654f;
    return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
  }
  if (act == ACT_SILU) return x * (1.0f / (1.0f + expf(-x)));
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One 256-entry decode table into shared memory (gather or closed form).
__device__ __forceinline__ void fill_table(float* s_lut, const float* lut,
                                           const float* qmeta, int alu) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    float v;
    if (alu) {
      const float alpha = qmeta[0], beta = qmeta[1], base = qmeta[2];
      const float e_min = -exp2f(qmeta[3] - 1.0f);
      const float sign = 1.0f - 2.0f * (float)(c >> 7);
      const float e = (float)(c & 0x7F) + e_min;
      v = sign * (alpha * expf(e * logf(base)) + beta);
    } else {
      v = lut[c];
    }
    s_lut[c] = v;
  }
}

struct Args {
  const void* x;        // [M, K] float32, bfloat16 or uint8 codes
  const uint8_t* c0;
  const uint8_t* c1;
  const float* lut0;
  const float* lut1;
  const float* qm0;
  const float* qm1;
  const float* lutx;    // activation-code table and params (uint8 x only)
  const float* qmx;
  const float* qmo;     // out params: encode to uint8 when set
  const float* bias;
  void* out;            // [M, N] float32, or uint8 when qmo is set
  float* ws;  // [NW, splits, M, N] partial sums when splits > 1
  int M, K, N, k_per_split, alu, act;
};

// One element of x as float32: a float operand converted, or an
// activation code decoded through the shared-memory table.
template <typename XT>
__device__ __forceinline__ float load_x(const XT* x, size_t i,
                                        const float* s_xlut) {
  if constexpr (std::is_same<XT, uint8_t>::value) {
    return s_xlut[x[i]];
  } else {
    return to_f32(x[i]);
  }
}

// The epilogue of one output element: bias and activation (gated:
// act(g) * u), then either a float32 store or the DNA-TEQ encode.
template <bool GATED>
__device__ __forceinline__ void finish(const Args& a, size_t i, int n,
                                       float v0, float v1) {
  float v;
  if (GATED) {
    v = act_fn(v0, a.act) * v1;
  } else {
    v = v0;
    if (a.bias) v += a.bias[n];
    v = act_fn(v, a.act);
  }
  if (a.qmo) {
    static_cast<uint8_t*>(a.out)[i] = dnateq::encode(v, a.qmo);
  } else {
    static_cast<float*>(a.out)[i] = v;
  }
}

// Flush one output element, or park its partial sum for the reduce pass.
template <bool GATED>
__device__ __forceinline__ void emit(const Args& a, int m, int n, float v0,
                                     float v1) {
  const int splits = gridDim.z;
  if (splits == 1) {
    finish<GATED>(a, (size_t)m * a.N + n, n, v0, v1);
  } else {
    const size_t mn = (size_t)a.M * a.N;
    a.ws[(size_t)blockIdx.z * mn + (size_t)m * a.N + n] = v0;
    if (GATED) a.ws[(size_t)(splits + blockIdx.z) * mn + (size_t)m * a.N + n] = v1;
  }
}

// ------------------------------------------------------------- tiled --
// 128x128 output tile, K step 16, 256 threads, 8x8 outputs per thread
// (rows {tr*4+i, 64+tr*4+i}, cols {tc*4+j, 64+tc*4+j}: float4 reads of
// the shared tiles without bank conflicts).
constexpr int TM = 128, TN = 128, TK = 16;

template <typename XT, bool TRANS, bool GATED>
__global__ void __launch_bounds__(256) lut_mm_tiled(Args a) {
  constexpr int NW = GATED ? 2 : 1;
  constexpr bool XC = std::is_same<XT, uint8_t>::value;
  __shared__ float s_lut[NW][256];
  __shared__ float s_xlut[XC ? 256 : 1];
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[NW][TK][TN + 4];

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  fill_table(s_lut[0], a.lut0, a.qm0, a.alu);
  if (GATED) fill_table(s_lut[1], a.lut1, a.qm1, a.alu);
  if constexpr (XC) fill_table(s_xlut, a.lutx, a.qmx, a.alu);
  const int tr = tid >> 4, tc = tid & 15;

  float acc[NW][8][8];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[w][i][j] = 0.0f;

  for (int k0 = kb; k0 < ke; k0 += TK) {
    __syncthreads();  // tables ready / previous tiles consumed
    {  // x tile, stored k-major: thread -> row tid/2, 8 consecutive k
      const int r = tid >> 1, kk = (tid & 1) * 8, gm = m0 + r;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gk = k0 + kk + i;
        As[kk + i][r] = (gm < a.M && gk < ke)
                            ? load_x(x, (size_t)gm * a.K + gk, s_xlut) : 0.0f;
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint8_t* c = w ? a.c1 : a.c0;
      if (!TRANS) {  // codes [K, N]: thread -> k row tid/16, 8 columns
        const int kk = tid >> 4, cc = (tid & 15) * 8, gk = k0 + kk;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gn = n0 + cc + j;
          Bs[w][kk][cc + j] = (gk < ke && gn < a.N)
                                  ? s_lut[w][c[(size_t)gk * a.N + gn]] : 0.0f;
        }
      } else {  // codes [N, K]: thread -> column tid/2, 8 consecutive k
        const int cc = tid >> 1, kk = (tid & 1) * 8, gn = n0 + cc;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int gk = k0 + kk + i;
          Bs[w][kk + i][cc] = (gk < ke && gn < a.N)
                                  ? s_lut[w][c[(size_t)gn * a.K + gk]] : 0.0f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[8], bv[NW][8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tr * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[w][kk][tc * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[w][kk][64 + tc * 4]);
        bv[w][0] = b0.x; bv[w][1] = b0.y; bv[w][2] = b0.z; bv[w][3] = b0.w;
        bv[w][4] = b1.x; bv[w][5] = b1.y; bv[w][6] = b1.z; bv[w][7] = b1.w;
      }
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[w][i][j] += av[i] * bv[w][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? tr * 4 + i : 64 + tr * 4 + i - 4);
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tc * 4 + j : 64 + tc * 4 + j - 4);
      if (n >= a.N) continue;
      emit<GATED>(a, m, n, acc[0][i][j], acc[NW - 1][i][j]);
    }
  }
}

// ------------------------------------------------------------ skinny --
// M <= 8 (a decode step).  Codes [K, N]: a block owns 64 columns; each
// thread owns 4 of them and one of 16 k-lanes (2 per warp), so a warp
// reads two 64-byte code rows per step.  x is staged in shared memory
// in K chunks; the 16 k-lanes are summed through shuffles and shared
// memory at the end.
constexpr int SM = 8, SN = 64, SKC = 256;

template <typename XT, bool GATED>
__global__ void __launch_bounds__(256) lut_mm_skinny(Args a) {
  constexpr int NW = GATED ? 2 : 1;
  constexpr bool XC = std::is_same<XT, uint8_t>::value;
  __shared__ float s_lut[NW][256];
  __shared__ float s_xlut[XC ? 256 : 1];
  __shared__ float s_x[SM][SKC];
  __shared__ float s_red[NW][8][SM][SN];

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 15, kl = warp * 2 + (lane >> 4);
  const int n0 = blockIdx.x * SN, ncol = n0 + cg * 4;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  fill_table(s_lut[0], a.lut0, a.qm0, a.alu);
  if (GATED) fill_table(s_lut[1], a.lut1, a.qm1, a.alu);
  if constexpr (XC) fill_table(s_xlut, a.lutx, a.qmx, a.alu);

  float acc[NW][SM][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < SM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[w][m][j] = 0.0f;

  for (int k0 = kb; k0 < ke; k0 += SKC) {
    const int kc = min(SKC, ke - k0);
    __syncthreads();
    for (int i = tid; i < SM * SKC; i += 256) {
      const int m = i / SKC, kk = i % SKC;
      s_x[m][kk] = (m < a.M && kk < kc)
                       ? load_x(x, (size_t)m * a.K + k0 + kk, s_xlut) : 0.0f;
    }
    __syncthreads();
    for (int kk = kl; kk < kc; kk += 16) {
      const size_t row = (size_t)(k0 + kk) * a.N;
      float wv[NW][4];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint8_t* c = w ? a.c1 : a.c0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[w][j] = (ncol + j < a.N) ? s_lut[w][c[row + ncol + j]] : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < SM; ++m) {
        const float xv = s_x[m][kk];
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[w][m][j] += xv * wv[w][j];
      }
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < SM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[w][m][j] += __shfl_xor_sync(0xffffffffu, acc[w][m][j], 16);
  if (lane < 16) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int m = 0; m < SM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) s_red[w][warp][m][cg * 4 + j] = acc[w][m][j];
  }
  __syncthreads();
  for (int p = tid; p < SM * SN; p += 256) {
    const int m = p / SN, cc = p % SN, n = n0 + cc;
    if (m >= a.M || n >= a.N) continue;
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) s += s_red[w][q][m][cc];
      v[w] = s;
    }
    emit<GATED>(a, m, n, v[0], v[NW - 1]);
  }
}

// M <= 8 with codes [N, K] (the tied unembedding): each warp owns 4
// columns and reads their code rows 128 contiguous bytes at a time.
constexpr int TCPW = 4;

template <typename XT>
__global__ void __launch_bounds__(256) lut_mm_skinny_t(Args a) {
  __shared__ float s_lut[256];
  __shared__ __align__(16) float s_x[SM][SKC];

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = blockIdx.x * (8 * TCPW) + warp * TCPW;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  fill_table(s_lut, a.lut0, a.qm0, a.alu);

  float acc[SM][TCPW];
#pragma unroll
  for (int m = 0; m < SM; ++m)
#pragma unroll
    for (int c = 0; c < TCPW; ++c) acc[m][c] = 0.0f;

  for (int k0 = kb; k0 < ke; k0 += SKC) {
    const int kc = min(SKC, ke - k0);
    __syncthreads();
    for (int i = tid; i < SM * SKC; i += 256) {
      const int m = i / SKC, kk = i % SKC;
      s_x[m][kk] = (m < a.M && kk < kc) ? to_f32(x[(size_t)m * a.K + k0 + kk])
                                        : 0.0f;
    }
    __syncthreads();
    for (int kk = lane * 4; kk < kc; kk += 128) {
      float xv[SM][4];
#pragma unroll
      for (int m = 0; m < SM; ++m) {
        const float4 t = *reinterpret_cast<const float4*>(&s_x[m][kk]);
        xv[m][0] = t.x; xv[m][1] = t.y; xv[m][2] = t.z; xv[m][3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < TCPW; ++c) {
        const int n = nb + c;
        if (n >= a.N) continue;
        const uint8_t* cp = a.c0 + (size_t)n * a.K + k0 + kk;
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = (kk + i < kc) ? s_lut[cp[i]] : 0.0f;
#pragma unroll
        for (int m = 0; m < SM; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][c] += xv[m][i] * wv[i];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SM; ++m)
#pragma unroll
    for (int c = 0; c < TCPW; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < SM; ++m)
#pragma unroll
      for (int c = 0; c < TCPW; ++c)
        if (m < a.M && nb + c < a.N) emit<false>(a, m, nb + c, acc[m][c], 0.0f);
  }
}

// ------------------------------------------------------------ reduce --
// Sums the split-K partials in split order (deterministic) and applies
// the epilogue.
template <bool GATED>
__global__ void lut_mm_reduce(Args a, int splits) {
  const size_t mn = (size_t)a.M * a.N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s0 = 0.0f, s1 = 0.0f;
  for (int z = 0; z < splits; ++z) s0 += a.ws[(size_t)z * mn + i];
  if (GATED)
    for (int z = 0; z < splits; ++z) s1 += a.ws[(size_t)(splits + z) * mn + i];
  finish<GATED>(a, i, (int)(i % a.N), s0, s1);
}

template <typename XT, bool TRANS, bool GATED>
void launch(const Args& a, int splits, cudaStream_t st) {
  if (a.M <= SM) {
    if constexpr (TRANS) {
      dim3 grid((a.N + 8 * TCPW - 1) / (8 * TCPW), 1, splits);
      lut_mm_skinny_t<XT><<<grid, 256, 0, st>>>(a);
    } else {
      dim3 grid((a.N + SN - 1) / SN, 1, splits);
      lut_mm_skinny<XT, GATED><<<grid, 256, 0, st>>>(a);
    }
  } else {
    dim3 grid((a.N + TN - 1) / TN, (a.M + TM - 1) / TM, splits);
    lut_mm_tiled<XT, TRANS, GATED><<<grid, 256, 0, st>>>(a);
  }
  if (splits > 1) {
    const size_t mn = (size_t)a.M * a.N;
    lut_mm_reduce<GATED><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(a, splits);
  }
}

// Every field of Args; the operands a variant does not use are null.
Args make_args(const void* x, const void* c0, const void* c1,
               const void* lut0, const void* lut1, const void* qm0,
               const void* qm1, const void* lutx, const void* qmx,
               const void* qmo, const void* bias, void* out, void* ws, int M,
               int K, int N, int k_per_split, int alu, int act) {
  Args a;
  a.x = x;
  a.c0 = static_cast<const uint8_t*>(c0);
  a.c1 = static_cast<const uint8_t*>(c1);
  a.lut0 = static_cast<const float*>(lut0);
  a.lut1 = static_cast<const float*>(lut1);
  a.qm0 = static_cast<const float*>(qm0);
  a.qm1 = static_cast<const float*>(qm1);
  a.lutx = static_cast<const float*>(lutx);
  a.qmx = static_cast<const float*>(qmx);
  a.qmo = static_cast<const float*>(qmo);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.M = M;
  a.K = K;
  a.N = N;
  a.k_per_split = k_per_split;
  a.alu = alu;
  a.act = act;
  return a;
}

}  // namespace

extern "C" {

// y[M, N] = act(x[M, K] @ dec(codes) + bias), codes [K, N] or, with
// transposed=1, [N, K].  x is float32 (x_bf16=0) or bfloat16; lut [256]
// and qmeta [4] float32; bias [N] float32 or null; out [M, N] float32;
// ws holds splits*M*N floats when splits > 1.  Returns cudaGetLastError().
int lut_dequant_matmul_launch(const void* x, int x_bf16, const void* codes,
                              const void* lut, const void* qmeta,
                              const void* bias, void* out, void* ws, int M,
                              int K, int N, int transposed, int alu, int act,
                              int splits, int k_per_split, void* stream) {
  const Args a = make_args(x, codes, nullptr, lut, nullptr, qmeta, nullptr,
                           nullptr, nullptr, nullptr, bias, out, ws, M, K, N,
                           k_per_split, alu, act);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (transposed) launch<__nv_bfloat16, true, false>(a, splits, st);
    else launch<__nv_bfloat16, false, false>(a, splits, st);
  } else {
    if (transposed) launch<float, true, false>(a, splits, st);
    else launch<float, false, false>(a, splits, st);
  }
  return (int)cudaGetLastError();
}

// y[M, N] = act(x @ dec_g(codes_g)) * (x @ dec_u(codes_u)), codes [K, N];
// ws holds 2*splits*M*N floats when splits > 1.
int lut_dequant_matmul_gated_launch(const void* x, int x_bf16,
                                    const void* codes_g, const void* codes_u,
                                    const void* lut_g, const void* lut_u,
                                    const void* qmeta_g, const void* qmeta_u,
                                    void* out, void* ws, int M, int K, int N,
                                    int alu, int act, int splits,
                                    int k_per_split, void* stream) {
  const Args a = make_args(x, codes_g, codes_u, lut_g, lut_u, qmeta_g,
                           qmeta_u, nullptr, nullptr, nullptr, nullptr, out,
                           ws, M, K, N, k_per_split, alu, act);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch<__nv_bfloat16, false, true>(a, splits, st);
  else launch<float, false, true>(a, splits, st);
  return (int)cudaGetLastError();
}

// y[M, N] = act(dec_x(x_codes) @ dec_w(codes) + bias): x_codes [M, K] and
// codes [K, N] uint8, each with its table (lut_x/lut_w [256]) and params
// (qmeta_x/qmeta_w [4]).  With qmeta_out set, out is uint8 [M, N] codes
// encoded under it; otherwise float32.  ws as for the single variant.
int lut_dequant_matmul_dual_launch(const void* x_codes, const void* codes,
                                   const void* lut_x, const void* lut_w,
                                   const void* qmeta_x, const void* qmeta_w,
                                   const void* qmeta_out, const void* bias,
                                   void* out, void* ws, int M, int K, int N,
                                   int alu, int act, int splits,
                                   int k_per_split, void* stream) {
  const Args a = make_args(x_codes, codes, nullptr, lut_w, nullptr, qmeta_w,
                           nullptr, lut_x, qmeta_x, qmeta_out, bias, out, ws,
                           M, K, N, k_per_split, alu, act);
  launch<uint8_t, false, false>(a, splits, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// y[M, N] = act(dec_x(x_codes) @ dec_g(codes_g)) * (dec_x(x_codes) @
// dec_u(codes_u)), one shared activation decode; qmeta_out and out as
// for the dual variant; ws holds 2*splits*M*N floats when splits > 1.
int lut_dequant_matmul_dual_gated_launch(
    const void* x_codes, const void* codes_g, const void* codes_u,
    const void* lut_x, const void* lut_g, const void* lut_u,
    const void* qmeta_x, const void* qmeta_g, const void* qmeta_u,
    const void* qmeta_out, void* out, void* ws, int M, int K, int N, int alu,
    int act, int splits, int k_per_split, void* stream) {
  const Args a = make_args(x_codes, codes_g, codes_u, lut_g, lut_u, qmeta_g,
                           qmeta_u, lut_x, qmeta_x, qmeta_out, nullptr, out,
                           ws, M, K, N, k_per_split, alu, act);
  launch<uint8_t, false, true>(a, splits, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // extern "C"
