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
// only in shared memory or registers.
// Layouts: codes [K, N], or [N, K] (transposed: the tied unembedding, #1
// only), where the transpose happens while a decoded tile is stored to
// shared memory, never on the table in device memory.
//
// Dual variants (#3, #4; XT = uint8_t): x arrives as uint8 activation
// codes and decodes through its own table in shared memory (gather or
// ALU form), so activations cross device memory at 1 B/element too.  The
// ragged K edge is 0.0 *after* decode: code 0 is a live code (it decodes
// to +-(alpha*base^e_min + beta)), so a past-K element must never be
// "load code 0".  With an out qmeta the epilogue is bias, activation
// (gated: act(g)*u), then the DNA-TEQ encode (dnateq.cuh), writing
// uint8, once per element after the whole K sum, never per split.
//
// #1 and #3 (lut_mm_skinny, lut_mm_skinny_t, lut_mm_tiled): float32 FMA
// on the CUDA cores.  At decode (M <= 8) the code bytes bound them, and
// the skinny bodies stream codes with every SM busy (split-K over a
// deterministic second pass when the N tiles alone cannot fill the
// card); at prefill a 128x128 output tile in registers (8x8 a thread)
// reuses each decoded tile across 128 rows.
//
// #2 and #4, the gated GEMMs (gated_skinny, gated_tiled; templates over
// the number of weights NW, instantiated for NW = 2):
// - Decode (M <= 8), gated_skinny: bound by the 2*K*N code bytes (25 MB,
//   0.0075 ms at 3.35 TB/s, at d_model 2048 x d_ff 6144).  A block owns
//   128 columns of both weights and a range of K.  Codes and the same k
//   rows of x reach shared memory by 16-byte cp.async copies into an
//   8-stage ring of 32 k rows (48 KB of codes in flight a block before
//   any is used); the thread that computes 4 columns reads them from the
//   ring, not from device memory, and x is converted to float32 (decoded,
//   for #4) one stage ahead of its use.  When the column slabs alone give
//   fewer than two blocks an SM, the blocks of a slab split K as one
//   thread-block cluster (at most 8 blocks): each sums its rows, then
//   rank 0 adds the partials of ranks 0, 1, ... from their shared memory
//   (distributed shared memory, fixed order: deterministic, one launch,
//   no workspace) and runs the epilogue.  Float32 FMA: a tensor-core body
//   of the same ring (rows 8-15 of A carrying x_lo) measured barely
//   faster, since the ring's stream, not the arithmetic, sets the pace.
// - Prefill (M > 8), gated_tiled: bound by 4*M*K*N multiply-adds.  They
//   run on the tensor cores as mma.sync.m16n8k8 TF32 in split form
//   (v = hi + lo, hi = v cut to TF32, lo = v - hi; one TF32 pass misses
//   the 1e-4 gate): x_hi.W_hi + x_hi.W_lo, plus x_lo.W_hi unless x is
//   bfloat16 (exact in TF32).  A decoded weight is split as it is looked
//   up (one 4-byte table read and two ALU operations: measured faster
//   than a table of (hi, lo) pairs, whose 8-byte reads cost twice the
//   shared-memory wavefronts).  A block owns 128 x 128 outputs of both
//   weights (8 warps of 64 x 32, 128 accumulators a thread); x and both
//   code tiles of 32 k rows arrive by 16-byte cp.async in a 3-stage ring.
//   A lane reads a 4-byte word of codes (4 columns) from k rows 2t and
//   2t+1 and uses its bytes as the B fragments of 4 n8 tiles, the columns
//   of tile j being 4g + j: so the fragment k order is (2t, 2t+1) for both
//   operands, and the x fragment is one 8-byte (float32) or 4-byte (bf16)
//   load per row.  #4's activation codes are decoded once a tile into a
//   float32 tile that all warps read.  Gate and up take the same x
//   fragments.  Split-K (a workspace and the reduce pass) only when the
//   tiles fill under half the SMs.
// Rows whose stride is not a multiple of 16 bytes (ragged K or N) are
// staged byte by byte instead of by cp.async.

#include <cooperative_groups.h>
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

// The epilogue's value of one output element (the gated kernels' store8;
// the same arithmetic as finish).
template <bool GATED>
__device__ __forceinline__ float epilogue(const Args& a, int n, float v0,
                                          float v1) {
  if (GATED) return act_fn(v0, a.act) * v1;
  if (a.bias) v0 += a.bias[n];
  return act_fn(v0, a.act);
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

// ============================================ gated kernels (#2, #4) ==

// 16 bytes global -> shared by cp.async.cg; the bytes past src_bytes are
// zero-filled (src_bytes 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One 16-byte chunk of a row into shared memory, its first ``nbytes``
// from src and zeros after: by cp.async when the rows are 16-byte
// aligned in device memory (``vec``), else byte by byte (ragged K or N).
__device__ __forceinline__ void copy16(void* dst, const void* src, int nbytes,
                                       bool vec) {
  if (vec) {
    cp_async16(dst, src, nbytes);
    return;
  }
  const uint8_t* p = static_cast<const uint8_t*>(src);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * i + b < nbytes) v |= (uint32_t)p[4 * i + b] << (8 * b);
    w[i] = v;
  }
  *static_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Whether x's rows (XT elements) and the codes' rows start on 16-byte
// boundaries in device memory, so that cp.async can copy them.  Worked
// out in the kernel: a field for it in Args, read by every kernel of
// this file, slowed the #1/#3 split-K tiles by a quarter.
template <typename XT>
__device__ __forceinline__ void rows_aligned(const Args& a, bool& xvec,
                                             bool& cvec) {
  xvec = (uintptr_t)a.x % 16 == 0 && ((size_t)a.K * sizeof(XT)) % 16 == 0;
  cvec = (uintptr_t)a.c0 % 16 == 0 && (uintptr_t)a.c1 % 16 == 0 &&
         a.N % 16 == 0;
}

// Raise a kernel's dynamic shared-memory limit, once per device: the
// attribute is a property of the function, and setting it on every call
// costs host time.  ``done`` is the calling instantiation's own flags.
template <typename Kern>
cudaError_t smem_limit(Kern kern, int bytes, bool (&done)[16]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 16) done[dev] = true;
  return e;
}

// --------------------------------------------------- gated: decode --
// M <= 8.  A block (8 warps) owns GS_N = 128 columns of each weight and
// the rows [kb, ke) of K; lane l of warp w owns columns 4l .. 4l + 3 and
// k-lane w, i.e. rows kb + w + 8 i, so a warp's code read and each
// 16-byte copy of a row fill whole 128-byte lines.  A ring stage
// holds GS_K rows of both weights' codes and the same rows of x as
// they are in device memory; x is converted to float32 [k][m] one stage
// ahead of its use, into one of two small buffers.
constexpr int GS_N = 128;      // columns of a block: 4 a lane
constexpr int GS_K = 32;       // k rows of a ring stage
constexpr int GS_STAGES = 8;   // ring depth

template <int NW>
struct SkinnySmem {
  float lut[NW][256];
  float xlut[256];
  float part[NW][SM][GS_N];    // the block's sums, read by rank 0
  float xf[2][GS_K][SM];       // x of two stages as float32, [k][m]
  union {
    struct {
      uint8_t codes[NW][GS_K][GS_N];
      uint8_t x[SM][GS_K * 4];   // x rows [m][k] as stored: float, bf16 or u8
    } ring[GS_STAGES];
    float red[NW][8][SM][GS_N];  // per-warp sums, once the ring is done
  } u;
};

template <typename XT, int NW>
__global__ void __launch_bounds__(256, 2) gated_skinny(Args a) {
  namespace cg = cooperative_groups;
  constexpr int CPR = GS_N / 16;                  // chunks a code row
  constexpr int EPC = 16 / (int)sizeof(XT);       // x elements a chunk
  constexpr int XCH = GS_K / EPC;                 // chunks an x row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SkinnySmem<NW>& sm = *reinterpret_cast<SkinnySmem<NW>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * GS_N;
  // blockIdx.z is the block's rank in its cluster: cluster dims (1, 1, z)
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  const int n_st = ke > kb ? (ke - kb + GS_K - 1) / GS_K : 0;
  bool xvec, cvec;
  rows_aligned<XT>(a, xvec, cvec);

  auto load = [&](int s) {
    if (s < n_st) {
      const int k0 = kb + s * GS_K;
      auto& st = sm.u.ring[s % GS_STAGES];
      for (int c = tid; c < NW * GS_K * CPR; c += 256) {
        const int w = c / (GS_K * CPR), r = (c / CPR) % GS_K, ch = c % CPR;
        const int gk = k0 + r, gn = n0 + ch * 16;
        const uint8_t* cw = w ? a.c1 : a.c0;
        const int nb = gk < ke ? max(0, min(16, a.N - gn)) : 0;
        copy16(&st.codes[w][r][ch * 16], nb ? cw + (size_t)gk * a.N + gn : cw,
               nb, cvec);
      }
      if (tid < SM * XCH) {
        const int m = tid / XCH, ch = tid % XCH, gk = k0 + ch * EPC;
        const int ne = m < a.M ? max(0, min(EPC, ke - gk)) : 0;
        copy16(&st.x[m][ch * 16], ne ? x + (size_t)m * a.K + gk : x,
               ne * (int)sizeof(XT), xvec);
      }
    }
    cp_async_commit();
  };
  // x of stage s as float32 into xf[s & 1]: one element a thread, zeros
  // past ke and past M (a zero-filled code would decode to a live value)
  auto convert = [&](int s) {
    const int m = tid / GS_K, r = tid % GS_K, k0 = kb + s * GS_K;
    const XT* row = reinterpret_cast<const XT*>(sm.u.ring[s % GS_STAGES].x[m]);
    sm.xf[s & 1][r][m] =
        (m < a.M && k0 + r < ke) ? load_x(row, r, sm.xlut) : 0.0f;
  };
  static_assert(SM * GS_K == 256 && GS_N == 128, "the thread layout above");

#pragma unroll
  for (int s = 0; s < GS_STAGES - 1; ++s) load(s);
  fill_table(sm.lut[0], a.lut0, a.qm0, a.alu);
  if (NW == 2) fill_table(sm.lut[NW - 1], a.lut1, a.qm1, a.alu);
  if constexpr (std::is_same<XT, uint8_t>::value)
    fill_table(sm.xlut, a.lutx, a.qmx, a.alu);
  cp_async_wait<GS_STAGES - 2>();
  __syncthreads();     // the tables and stage 0 are in
  if (n_st > 0) convert(0);

  float acc[NW][SM][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < SM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[w][m][j] = 0.0f;

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<GS_STAGES - 3>();
    __syncthreads();   // stages s, s + 1 landed, x of s converted; s - 1 done
    load(s + GS_STAGES - 1);
    if (s + 1 < n_st) convert(s + 1);
    const int rows = min(GS_K, ke - kb - s * GS_K);
    const auto& st = sm.u.ring[s % GS_STAGES];
#pragma unroll
    for (int i = 0; i < GS_K / 8; ++i) {
      const int r = warp + 8 * i;
      if (r >= rows) break;
      uint32_t cw[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        cw[w] = *reinterpret_cast<const uint32_t*>(&st.codes[w][r][lane * 4]);
      const float4 x0 = *reinterpret_cast<const float4*>(&sm.xf[s & 1][r][0]);
      const float4 x1 = *reinterpret_cast<const float4*>(&sm.xf[s & 1][r][4]);
      const float xv[SM] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float wv[NW][4];
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[w][j] = sm.lut[w][(cw[w] >> (8 * j)) & 255u];
#pragma unroll
      for (int m = 0; m < SM; ++m)
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[w][m][j] = fmaf(xv[m], wv[w][j], acc[w][m][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is dead: red takes its place

  // the 8 warps' (k-lanes') sums, added in order
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < SM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.u.red[w][warp][m][lane * 4 + j] = acc[w][m][j];
  __syncthreads();
  for (int p = tid; p < NW * SM * GS_N; p += 256) {
    const int w = p / (SM * GS_N), mc = p % (SM * GS_N);
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += (&sm.u.red[w][q][0][0])[mc];
    (&sm.part[w][0][0])[mc] = v;
  }

  // the cluster's partials in rank order, finished once, by rank 0
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int ranks = (int)cluster.num_blocks();
    for (int p = tid; p < SM * GS_N; p += 256) {
      const int m = p / GS_N, n = n0 + p % GS_N;
      if (m >= a.M || n >= a.N) continue;
      float v[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float t = 0.0f;
        for (int r = 0; r < ranks; ++r)
          t += cluster.map_shared_rank(&sm.part[w][0][0], r)[p];
        v[w] = t;
      }
      finish<NW == 2>(a, (size_t)m * a.N + n, n, v[0], v[NW - 1]);
    }
  }
  cluster.sync();      // no block leaves while rank 0 reads its partials
}

template <typename XT, int NW>
cudaError_t launch_gated_skinny(const Args& a, int splits, cudaStream_t st) {
  constexpr int smem = (int)sizeof(SkinnySmem<NW>);
  static bool done[16] = {};
  auto kern = gated_skinny<XT, NW>;
  cudaError_t e = smem_limit(kern, smem, done);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + GS_N - 1) / GS_N, 1, splits);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

// -------------------------------------------------- gated: prefill --
// M > 8.  A block (8 warps, 2 along M x 4 along N) owns GT_M x GT_N
// outputs of each weight; warp (wm, wn) owns rows 64 wm .. +63 (4 m16
// tiles) and columns 32 wn .. +31 (4 n8 tiles) of each weight.  Lane
// (g = lane / 4, t = lane % 4) holds, for n8 tile j, the columns
// 32 wn + 4 g + j as the tile's column g (B) and 32 wn + 8 t + j,
// 32 wn + 8 t + 4 + j as its columns 2t, 2t + 1 (C).
constexpr int GT_M = 128, GT_N = 128, GT_K = 32, GT_STAGES = 3;
constexpr int GT_CS = GT_N + 16;     // staged code row, bytes
constexpr int GT_FS = GT_K + 8;      // float32 x row, floats

// Staged x row, bytes: padded so each warp's fragment loads hit
// distinct banks (row stride = 8, 20 or 12 words mod 32).
template <typename XT>
__host__ __device__ constexpr int gt_xs() {
  return GT_K * (int)sizeof(XT) + (sizeof(XT) == 4 ? 32 : 16);
}
template <typename XT, int NW>
__host__ __device__ constexpr int gt_stage() {
  return GT_M * gt_xs<XT>() + NW * GT_K * GT_CS;
}
// tables, the ring, and for codes x the decoded float32 x tile
template <typename XT, int NW>
__host__ __device__ constexpr int gt_smem() {
  return (NW + 1) * 256 * 4 + GT_STAGES * gt_stage<XT, NW>() +
         (sizeof(XT) == 1 ? GT_M * GT_FS * 4 : 0);
}

// v = hi + lo: hi = v cut to TF32 (its upper 19 bits), lo = v - hi,
// exact in float32, of which the tensor core reads the upper 19 bits.
__device__ __forceinline__ float2 tf32_split(float v) {
  const float hi = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
  return make_float2(hi, v - hi);
}

// c += a . b on one m16n8k8 TF32 tile, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x at (row, k) and (row, k + 1) of a staged float32 or bfloat16 row as
// TF32 hi (and lo): float32 split here, bfloat16 exact (no lo).
__device__ __forceinline__ void load_a(const float* row, int k, uint32_t& h0,
                                       uint32_t& h1, uint32_t& l0,
                                       uint32_t& l1) {
  const float2 v = *reinterpret_cast<const float2*>(row + k);
  const float2 s0 = tf32_split(v.x), s1 = tf32_split(v.y);
  h0 = __float_as_uint(s0.x); l0 = __float_as_uint(s0.y);
  h1 = __float_as_uint(s1.x); l1 = __float_as_uint(s1.y);
}
__device__ __forceinline__ void load_a(const __nv_bfloat16* row, int k,
                                       uint32_t& h0, uint32_t& h1, uint32_t&,
                                       uint32_t&) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(row + k);
  h0 = raw << 16;
  h1 = raw & 0xffff0000u;
}

// Eight consecutive outputs n .. n + 7 of row m: parked for the reduce
// pass under split-K, else finished and stored, 16 (float32) or 4 (u8)
// bytes at a time where the row allows it.
template <int NW>
__device__ __forceinline__ void store8(const Args& a, int m, int n,
                                       const float (&v0)[8],
                                       const float (&v1)[8]) {
  constexpr bool GATED = NW == 2;
  if (gridDim.z > 1) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (n + q < a.N) emit<GATED>(a, m, n + q, v0[q], v1[q]);
    return;
  }
  float y[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) y[q] = epilogue<GATED>(a, min(n + q, a.N - 1), v0[q], v1[q]);
  const size_t i = (size_t)m * a.N + n;
  const bool whole = n + 8 <= a.N && a.N % 4 == 0;
  if (a.qmo) {
    uint8_t* o = static_cast<uint8_t*>(a.out) + i;
    uint8_t c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) c[q] = dnateq::encode(y[q], a.qmo);
    if (whole) {
      reinterpret_cast<uchar4*>(o)[0] = make_uchar4(c[0], c[1], c[2], c[3]);
      reinterpret_cast<uchar4*>(o)[1] = make_uchar4(c[4], c[5], c[6], c[7]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (n + q < a.N) o[q] = c[q];
    }
  } else {
    float* o = static_cast<float*>(a.out) + i;
    if (whole) {
      reinterpret_cast<float4*>(o)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (n + q < a.N) o[q] = y[q];
    }
  }
}

template <typename XT, int NW>
__global__ void __launch_bounds__(256, 1) gated_tiled(Args a) {
  constexpr bool XC = std::is_same<XT, uint8_t>::value;
  constexpr bool X_EXACT = std::is_same<XT, __nv_bfloat16>::value;
  // the element type of the x tile the fragments read, and its stride
  using FT = std::conditional_t<XC, float, XT>;
  constexpr int XS = gt_xs<XT>();
  constexpr int FS = XC ? GT_FS : XS / (int)sizeof(XT);
  constexpr int EPC = 16 / (int)sizeof(XT);     // x elements a chunk
  constexpr int CPR = GT_K / EPC;               // x chunks a row
  constexpr int STAGE = gt_stage<XT, NW>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_wt = reinterpret_cast<float*>(smem_raw);     // [NW][256]
  float* s_xt = s_wt + NW * 256;                        // [256] codes x
  unsigned char* ring = reinterpret_cast<unsigned char*>(s_xt + 256);
  float* s_xf = reinterpret_cast<float*>(ring + GT_STAGES * STAGE);  // codes x

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, lt = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * GT_M, n0 = blockIdx.x * GT_N;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  const int n_t = ke > kb ? (ke - kb + GT_K - 1) / GT_K : 0;
  bool xvec, cvec;
  rows_aligned<XT>(a, xvec, cvec);

  auto x_tile = [&](int t) { return ring + (t % GT_STAGES) * STAGE; };
  auto c_tile = [&](int t, int w) {
    return x_tile(t) + GT_M * XS + w * GT_K * GT_CS;
  };
  auto load = [&](int t) {
    if (t < n_t) {
      const int k0 = kb + t * GT_K;
      unsigned char* xs = x_tile(t);
      for (int c = tid; c < GT_M * CPR; c += 256) {
        const int r = c / CPR, gm = m0 + r, gk = k0 + (c % CPR) * EPC;
        const int ne = gm < a.M ? max(0, min(EPC, ke - gk)) : 0;
        copy16(xs + r * XS + (c % CPR) * 16,
               ne ? x + (size_t)gm * a.K + gk : x, ne * (int)sizeof(XT), xvec);
      }
      for (int c = tid; c < NW * GT_K * (GT_N / 16); c += 256) {
        const int w = c / (GT_K * GT_N / 16), r = (c / (GT_N / 16)) % GT_K;
        const int ch = c % (GT_N / 16), gk = k0 + r, gn = n0 + ch * 16;
        const uint8_t* cw = w ? a.c1 : a.c0;
        const int nb = gk < ke ? max(0, min(16, a.N - gn)) : 0;
        copy16(c_tile(t, w) + r * GT_CS + ch * 16,
               nb ? cw + (size_t)gk * a.N + gn : cw, nb, cvec);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < GT_STAGES - 1; ++s) load(s);
  fill_table(s_wt, a.lut0, a.qm0, a.alu);
  if (NW == 2) fill_table(s_wt + 256, a.lut1, a.qm1, a.alu);
  if constexpr (XC) fill_table(s_xt, a.lutx, a.qmx, a.alu);

  float acc[NW][4][4][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.0f;

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<GT_STAGES - 2>();
    __syncthreads();   // tile t landed; every warp is done with t - 1
    load(t + GT_STAGES - 1);
    const FT* xs;
    if constexpr (XC) {
      // the tile's activation codes decoded once, for all warps, into
      // the float32 tile the fragments read (past-K x codes decode to a
      // live value; B is zeroed there)
      const uint8_t* xc = x_tile(t);
#pragma unroll
      for (int i = 0; i < GT_M * GT_K / 4 / 256; ++i) {
        const int q = tid + i * 256, r = q / (GT_K / 4), k = 4 * (q % (GT_K / 4));
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(xc + r * XS + k);
        *reinterpret_cast<float4*>(s_xf + r * GT_FS + k) =
            make_float4(s_xt[raw & 255u], s_xt[(raw >> 8) & 255u],
                        s_xt[(raw >> 16) & 255u], s_xt[raw >> 24]);
      }
      __syncthreads();
      xs = s_xf;
    } else {
      xs = reinterpret_cast<const FT*>(x_tile(t));
    }
    // rows of the tile inside [kb, ke): past them the staged codes are
    // zeros, which decode to a live value, so B is zeroed there
    const int kvalid = ke - kb - t * GT_K;
#pragma unroll
    for (int ks = 0; ks < GT_K / 8; ++ks) {
      const int kk = ks * 8 + 2 * lt;   // this lane's k rows: kk, kk + 1
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + lg;
        load_a(xs + r * FS, kk, ah[i][0], ah[i][2], al[i][0], al[i][2]);
        load_a(xs + (r + 8) * FS, kk, ah[i][1], ah[i][3], al[i][1], al[i][3]);
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const unsigned char* cs = c_tile(t, w) + wn * 32 + 4 * lg;
        const uint32_t c0 = *reinterpret_cast<const uint32_t*>(cs + kk * GT_CS);
        const uint32_t c1 =
            *reinterpret_cast<const uint32_t*>(cs + (kk + 1) * GT_CS);
        const bool v0 = kk < kvalid, v1 = kk + 1 < kvalid;
        const float* tab = s_wt + w * 256;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b0 = tf32_split(v0 ? tab[(c0 >> (8 * j)) & 255u] : 0.0f);
          const float2 b1 = tf32_split(v1 ? tab[(c1 >> (8 * j)) & 255u] : 0.0f);
          const uint32_t bh0 = __float_as_uint(b0.x), bl0 = __float_as_uint(b0.y);
          const uint32_t bh1 = __float_as_uint(b1.x), bl1 = __float_as_uint(b1.y);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_tf32(acc[w][i][j], ah[i], bh0, bh1);
            mma_tf32(acc[w][i][j], ah[i], bl0, bl1);
            if constexpr (!X_EXACT) mma_tf32(acc[w][i][j], al[i], bh0, bh1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[w][i][j][e]: row 16 i + lg (+8 for e >= 2), column 8 lt + j
  // (+4 for odd e) of the warp's tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + lg + 8 * h;
      if (m >= a.M) continue;
      float v[NW][8];
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int q = 0; q < 8; ++q) v[w][q] = acc[w][i][q & 3][2 * h + (q >> 2)];
      store8<NW>(a, m, n0 + wn * 32 + 8 * lt, v[0], v[NW - 1]);
    }
}

template <typename XT, int NW>
cudaError_t launch_gated_tiled(const Args& a, int splits, cudaStream_t st) {
  constexpr int smem = gt_smem<XT, NW>();
  static bool done[16] = {};
  auto kern = gated_tiled<XT, NW>;
  cudaError_t e = smem_limit(kern, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + GT_N - 1) / GT_N, (a.M + GT_M - 1) / GT_M, splits);
  kern<<<grid, 256, smem, st>>>(a);
  if (splits > 1) {
    const size_t mn = (size_t)a.M * a.N;
    lut_mm_reduce<NW == 2><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(a, splits);
  }
  return cudaGetLastError();
}

// The gated GEMM on either path.
template <typename XT>
int launch_gated(const Args& a, int splits, cudaStream_t st) {
  if (splits < 1 || (a.M <= SM && splits > 8)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = a.M <= SM ? launch_gated_skinny<XT, 2>(a, splits, st)
                                  : launch_gated_tiled<XT, 2>(a, splits, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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

// y[M, N] = act(x @ dec_g(codes_g)) * (x @ dec_u(codes_u)), codes [K, N].
// M <= 8: splits is the cluster size (1..8) and ws is unused; M > 8: ws
// holds 2*splits*M*N floats when splits > 1.
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
  return x_bf16 ? launch_gated<__nv_bfloat16>(a, splits, st)
                : launch_gated<float>(a, splits, st);
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
// for the dual variant; splits and ws as for the gated variant.
int lut_dequant_matmul_dual_gated_launch(
    const void* x_codes, const void* codes_g, const void* codes_u,
    const void* lut_x, const void* lut_g, const void* lut_u,
    const void* qmeta_x, const void* qmeta_g, const void* qmeta_u,
    const void* qmeta_out, void* out, void* ws, int M, int K, int N, int alu,
    int act, int splits, int k_per_split, void* stream) {
  const Args a = make_args(x_codes, codes_g, codes_u, lut_g, lut_u, qmeta_g,
                           qmeta_u, lut_x, qmeta_x, qmeta_out, nullptr, out,
                           ws, M, K, N, k_per_split, alu, act);
  return launch_gated<uint8_t>(a, splits, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block of the gated kernels (NW = 2):
// tiled = 0 the decode path, else the prefill path for x_kind 0 float32,
// 1 bfloat16, 2 uint8 codes.
int lut_dequant_matmul_gated_smem_bytes(int tiled, int x_kind) {
  if (!tiled) return (int)sizeof(SkinnySmem<2>);
  if (x_kind == 1) return gt_smem<__nv_bfloat16, 2>();
  if (x_kind == 2) return gt_smem<uint8_t, 2>();
  return gt_smem<float, 2>();
}

}  // extern "C"
