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
// Codes [K, N]: one pair of bodies, templates over the number of weights
// NW (1: #1 and #3, bias and activation in the epilogue; 2: #2 and #4,
// act(g) * u), so every variant runs the same decode and prefill paths
// (what was measured, below, on one NVIDIA H100 80GB HBM3 at a 700 W
// power limit: PERF.md):
// - Decode (M <= 8), mm_skinny: bound by the NW*K*N code bytes (25 MB,
//   0.0075 ms at the H100's 3.35 TB/s, for #2 at d_model 2048 x d_ff
//   6144).  A block owns 128 columns of each weight and a range of K.
//   Codes and the same k rows of x reach shared memory by 16-byte
//   cp.async copies into an 8-stage ring of 32 k rows (NW * 24 KB of
//   codes in flight a block before any is used); the thread that
//   computes 4 columns reads them
//   from the ring, not from device memory, and x is converted to float32
//   (decoded, for codes x) one stage ahead of its use.  When the column
//   slabs alone give fewer than two blocks an SM, the blocks of a slab
//   split K as one thread-block cluster (at most 8 blocks): each sums its
//   rows, then each rank adds, for its slice of the columns, the partials
//   of ranks 0, 1, ... from their shared memory (distributed shared
//   memory, fixed order: deterministic, one launch, no workspace) and
//   runs the epilogue.  Float32 FMA: a tensor-core body of the same ring
//   (rows 8-15 of A carrying x_lo) measured barely faster, since the
//   ring's stream, not the arithmetic, sets the pace.
// - Prefill (M > 8), mm_tiled: bound by 2*NW*M*K*N operations.  They run
//   on the tensor cores in split form, since one pass of TF32 or bf16
//   misses the 1e-4 gate.  Float32 or bfloat16 x: mma.sync.m16n8k8 TF32
//   (v = hi + lo, hi = v cut to TF32, lo = v - hi): x_hi.W_hi + x_hi.W_lo,
//   plus x_lo.W_hi unless x is bfloat16 (exact in TF32).  A decoded weight
//   is split as it is looked up (one 4-byte table read and two ALU
//   operations: measured faster than a table of TF32 (hi, lo) pairs, whose
//   8-byte reads cost twice the shared-memory wavefronts).  Codes x: both
//   decoded operands split into bfloat16 hi + lo (v = hi + lo + O(2^-16 v))
//   and hi.hi + hi.lo + lo.hi on mma.sync.m16n8k16 bf16, float32
//   accumulate: three passes at half the issue of a TF32 pass each
//   (measured 1.6x faster than three TF32 passes for #4).  Its tables
//   hold each code's (hi, lo) as one 4-byte bf16 pair, so a lookup
//   costs what a float32 lookup costs, and a byte permute gathers two
//   entries' hi (or lo) halves into one operand register.  A block owns
//   128 x 128 outputs of each weight (8 warps of 64 x 32, NW * 64
//   accumulators a thread); x and the code tiles of 32 k rows arrive by
//   16-byte cp.async in a 3-stage ring.  A lane reads a 4-byte word of
//   codes (4 columns) a k row and uses its bytes as the B fragments of 4
//   n8 tiles, the columns of tile j being 4g + j.  Activation codes are
//   decoded once a tile into a tile of bf16 pairs that all warps read.
//   Split-K (a workspace and the reduce pass) only when the tiles fill
//   under half the SMs, up to the blocks the SMs hold (two a SM at
//   NW = 1, one at 2).
//
// Codes [N, K] (the tied unembedding, #1 only):
// - Decode (M <= 8), mm_stream_t: bound by the K*N code bytes (311 MB,
//   0.093 ms at the H100's 3.35 TB/s, at vocabulary 151936 x d_model
//   2048).  Each
//   code row is K contiguous bytes, so the product runs transposed on the
//   tensor cores: a warp owns 16 columns (the 16 rows of an m16n8k16 A
//   tile, its codes decoded to bf16 hi + lo pairs) and the 8 rows of x are
//   the tile's 8 columns (B, from shared memory, where x is staged once a
//   K chunk as bf16: hi, and lo for float32 x).  A lane reads 16 code
//   bytes of each of its two columns a 64-k step, four steps in flight, by
//   16-byte loads that bypass L1; the sum across lanes is the mma's own.
// - Prefill (M > 8), mm_tiled with TRANS: the codes-[K, N] prefill body
//   (TF32 passes), its code tile staged as [128 columns][32 k] from the
//   code rows, tile j's column g being 8j + g (conflict-free 2-byte
//   reads).  Only the full-sequence forward reaches it.
// Rows whose stride is not a multiple of 16 bytes (ragged K or N) are
// staged byte by byte instead of by cp.async or 16-byte loads.

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

// The decoded value of code c (gather or closed form).
__device__ __forceinline__ float table_value(int c, const float* lut,
                                             const float* qmeta, int alu) {
  if (!alu) return lut[c];
  const float alpha = qmeta[0], beta = qmeta[1], base = qmeta[2];
  const float e_min = -exp2f(qmeta[3] - 1.0f);
  const float sign = 1.0f - 2.0f * (float)(c >> 7);
  const float e = (float)(c & 0x7F) + e_min;
  return sign * (alpha * expf(e * logf(base)) + beta);
}

// One 256-entry decode table into shared memory.
__device__ __forceinline__ void fill_table(float* s_lut, const float* lut,
                                           const float* qmeta, int alu) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x)
    s_lut[c] = table_value(c, lut, qmeta, alu);
}

// v as a bf16 pair: hi = v rounded to bf16 (low half), lo = v - hi rounded
// to bf16 (high half); v - hi - lo is within 2^-16 of v.
__device__ __forceinline__ uint32_t bf16_pair(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
  return (uint32_t)__bfloat16_as_ushort(hi) |
         ((uint32_t)__bfloat16_as_ushort(lo) << 16);
}

// One decode table of bf16 pairs into shared memory.
__device__ __forceinline__ void fill_pairs(uint32_t* s_tab, const float* lut,
                                           const float* qmeta, int alu) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x)
    s_tab[c] = bf16_pair(table_value(c, lut, qmeta, alu));
}

// The hi (or lo) halves of two pair entries as one bf16x2 operand, the
// first entry's in the low half.
__device__ __forceinline__ uint32_t his(uint32_t e0, uint32_t e1) {
  return __byte_perm(e0, e1, 0x5410);
}
__device__ __forceinline__ uint32_t los(uint32_t e0, uint32_t e1) {
  return __byte_perm(e0, e1, 0x7632);
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

// The epilogue's value of one output element: bias and activation
// (gated: act(g) * u).
template <bool GATED>
__device__ __forceinline__ float epilogue(const Args& a, int n, float v0,
                                          float v1) {
  if (GATED) return act_fn(v0, a.act) * v1;
  if (a.bias) v0 += a.bias[n];
  return act_fn(v0, a.act);
}

// The epilogue of one output element, then either a float32 store or the
// DNA-TEQ encode.
template <bool GATED>
__device__ __forceinline__ void finish(const Args& a, size_t i, int n,
                                       float v0, float v1) {
  const float v = epilogue<GATED>(a, n, v0, v1);
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

cudaError_t launch_reduce(const Args& a, int nw, int splits, cudaStream_t st) {
  const size_t mn = (size_t)a.M * a.N;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  if (nw == 2) lut_mm_reduce<true><<<blocks, 256, 0, st>>>(a, splits);
  else lut_mm_reduce<false><<<blocks, 256, 0, st>>>(a, splits);
  return cudaGetLastError();
}

// ------------------------------------------------------------ copies --

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

// The first ``nbytes`` (<= 16) bytes at p, zeros after, one byte at a
// time (for rows off 16-byte boundaries).
__device__ __forceinline__ uint4 bytes16(const uint8_t* p, int nbytes) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * i + b < nbytes) v |= (uint32_t)p[4 * i + b] << (8 * b);
    w[i] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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
  *static_cast<uint4*>(dst) = bytes16(static_cast<const uint8_t*>(src), nbytes);
}

// Whether x's rows (XT elements) and the codes' rows start on 16-byte
// boundaries in device memory, so that cp.async can copy them.  Worked
// out in the kernel: a field for it in Args, read by every kernel of
// this file, slowed the split-K tiles by a quarter.
template <typename XT, bool TRANS = false>
__device__ __forceinline__ void rows_aligned(const Args& a, bool& xvec,
                                             bool& cvec) {
  xvec = (uintptr_t)a.x % 16 == 0 && ((size_t)a.K * sizeof(XT)) % 16 == 0;
  cvec = (uintptr_t)a.c0 % 16 == 0 && (uintptr_t)a.c1 % 16 == 0 &&
         (TRANS ? a.K : a.N) % 16 == 0;
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

// ------------------------------------------------- codes [K, N]: decode --
// M <= 8.  A block (8 warps) owns GS_N = 128 columns of each weight and
// the rows [kb, ke) of K; lane l of warp w owns columns 4l .. 4l + 3 and
// k-lane w, i.e. rows kb + w + 8 i, so a warp's code read and each
// 16-byte copy of a row fill whole 128-byte lines.  A ring stage
// holds GS_K rows of the weights' codes and the same rows of x as they
// are in device memory; x is converted to float32 [k][m] one stage ahead
// of its use, into one of two small buffers.
constexpr int SM = 8;          // rows of x at most on the decode paths
constexpr int GS_N = 128;      // columns of a block: 4 a lane
constexpr int GS_K = 32;       // k rows of a ring stage
constexpr int GS_STAGES = 8;   // ring depth

template <int NW>
struct SkinnySmem {
  float lut[NW][256];
  float xlut[256];
  float part[NW][SM][GS_N];    // the block's sums, read by every rank
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
__global__ void __launch_bounds__(256, 2) mm_skinny(Args a) {
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
    // every row of the stage: past ke its codes are zeros (a live value)
    // and its x is 0.0, so it adds exact zeros, and the warp's four rows
    // load at once
    const auto& st = sm.u.ring[s % GS_STAGES];
#pragma unroll
    for (int i = 0; i < GS_K / 8; ++i) {
      const int r = warp + 8 * i;
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

  // the cluster's partials in rank order, finished once: rank q sums
  // and finishes the q-th slice of the slab's columns
  cluster.sync();
  {
    const int ranks = (int)cluster.num_blocks();
    const int cw = (GS_N + ranks - 1) / ranks;
    const int c0 = (int)cluster.block_rank() * cw;
    for (int q = tid; q < SM * cw; q += 256) {
      const int m = q / cw, c = c0 + q % cw, n = n0 + c;
      if (m >= a.M || c >= GS_N || n >= a.N) continue;
      float v[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float t = 0.0f;
        for (int r = 0; r < ranks; ++r)
          t += cluster.map_shared_rank(&sm.part[w][0][0], r)[m * GS_N + c];
        v[w] = t;
      }
      finish<NW == 2>(a, (size_t)m * a.N + n, n, v[0], v[NW - 1]);
    }
  }
  cluster.sync();      // no block leaves while another reads its partials
}

template <typename XT, int NW>
cudaError_t launch_skinny(const Args& a, int splits, cudaStream_t st) {
  constexpr int smem = (int)sizeof(SkinnySmem<NW>);
  static bool done[16] = {};
  auto kern = mm_skinny<XT, NW>;
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

// ------------------------------------------------ codes [K, N]: prefill --
// M > 8.  A block (8 warps, 2 along M x 4 along N) owns GT_M x GT_N
// outputs of each weight; warp (wm, wn) owns rows 64 wm .. +63 (4 m16
// tiles) and columns 32 wn .. +31 (4 n8 tiles) of each weight.  Lane
// (g = lane / 4, t = lane % 4) holds, for n8 tile j, the columns
// 32 wn + 4 g + j as the tile's column g (B) and 32 wn + 8 t + j,
// 32 wn + 8 t + 4 + j as its columns 2t, 2t + 1 (C).  TF32 k steps of 8:
// the lane's k rows 2t, 2t + 1 stand for the fragment's k t, t + 4 (the
// same order for both operands); bf16 k steps of 16: rows 2t, 2t + 1,
// 2t + 8, 2t + 9 as the fragment has them.
constexpr int GT_M = 128, GT_N = 128, GT_K = 32, GT_STAGES = 3;
constexpr int GT_CS = GT_N + 16;     // staged code row, bytes
constexpr int GT_TS = GT_K + 16;     // staged code column (codes [N, K]),
                                     // bytes: 12 words, so 8 consecutive
                                     // columns hit distinct banks
constexpr int GT_FS = GT_K + 8;      // decoded x row (codes x), 4-byte words

// Staged x row, bytes: padded so each warp's fragment loads hit
// distinct banks (row stride = 8, 20 or 12 words mod 32).
template <typename XT>
__host__ __device__ constexpr int gt_xs() {
  return GT_K * (int)sizeof(XT) + (sizeof(XT) == 4 ? 32 : 16);
}
template <typename XT, int NW, bool TRANS>
__host__ __device__ constexpr int gt_stage() {
  return GT_M * gt_xs<XT>() + NW * (TRANS ? GT_N * GT_TS : GT_K * GT_CS);
}
// tables, the ring, and for codes x the decoded tile of bf16 pairs
template <typename XT, int NW, bool TRANS = false>
__host__ __device__ constexpr int gt_smem() {
  return (NW + 1) * 256 * 4 + GT_STAGES * gt_stage<XT, NW, TRANS>() +
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

// c += a . b on one m16n8k16 bf16 tile, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

template <typename XT, int NW, bool TRANS>
__global__ void __launch_bounds__(256, NW == 1 ? 2 : 1) mm_tiled(Args a) {
  constexpr bool XC = std::is_same<XT, uint8_t>::value;
  static_assert(!TRANS || (NW == 1 && !XC), "codes [N, K]: #1 only");
  constexpr bool X_EXACT = std::is_same<XT, __nv_bfloat16>::value;
  constexpr int XS = gt_xs<XT>();
  constexpr int EPC = 16 / (int)sizeof(XT);     // x elements a chunk
  constexpr int CPR = GT_K / EPC;               // x chunks a row
  constexpr int STAGE = gt_stage<XT, NW, TRANS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [NW][256] weight tables (float32; bf16 pairs for codes x), then the
  // activation-code table (bf16 pairs), the ring and the decoded x tile
  float* s_wt = reinterpret_cast<float*>(smem_raw);
  uint32_t* s_wp = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* s_xt = s_wp + NW * 256;
  unsigned char* ring = reinterpret_cast<unsigned char*>(s_xt + 256);
  uint32_t* s_xp = reinterpret_cast<uint32_t*>(ring + GT_STAGES * STAGE);

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, lt = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * GT_M, n0 = blockIdx.x * GT_N;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  const int n_t = ke > kb ? (ke - kb + GT_K - 1) / GT_K : 0;
  bool xvec, cvec;
  rows_aligned<XT, TRANS>(a, xvec, cvec);

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
      if constexpr (TRANS) {   // column r: its k0 .. k0 + 31, 2 chunks
        for (int c = tid; c < GT_N * (GT_K / 16); c += 256) {
          const int r = c / (GT_K / 16), gn = n0 + r;
          const int gk = k0 + (c % (GT_K / 16)) * 16;
          const int nb = gn < a.N ? max(0, min(16, ke - gk)) : 0;
          copy16(c_tile(t, 0) + r * GT_TS + (c % (GT_K / 16)) * 16,
                 nb ? a.c0 + (size_t)gn * a.K + gk : a.c0, nb, cvec);
        }
      } else {
        for (int c = tid; c < NW * GT_K * (GT_N / 16); c += 256) {
          const int w = c / (GT_K * GT_N / 16), r = (c / (GT_N / 16)) % GT_K;
          const int ch = c % (GT_N / 16), gk = k0 + r, gn = n0 + ch * 16;
          const uint8_t* cw = w ? a.c1 : a.c0;
          const int nb = gk < ke ? max(0, min(16, a.N - gn)) : 0;
          copy16(c_tile(t, w) + r * GT_CS + ch * 16,
                 nb ? cw + (size_t)gk * a.N + gn : cw, nb, cvec);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < GT_STAGES - 1; ++s) load(s);
  if constexpr (XC) {
    fill_pairs(s_wp, a.lut0, a.qm0, a.alu);
    if (NW == 2) fill_pairs(s_wp + 256, a.lut1, a.qm1, a.alu);
    fill_pairs(s_xt, a.lutx, a.qmx, a.alu);
  } else {
    fill_table(s_wt, a.lut0, a.qm0, a.alu);
    if (NW == 2) fill_table(s_wt + 256, a.lut1, a.qm1, a.alu);
  }

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
    // rows of the tile inside [kb, ke): past them the staged codes are
    // zeros, which decode to a live value, so B is zeroed there
    const int kvalid = ke - kb - t * GT_K;
    if constexpr (XC) {
      // the tile's activation codes decoded once, for all warps, into
      // bf16 pairs (past-K x codes decode to a live value; B is zeroed
      // there)
      const uint8_t* xc = x_tile(t);
#pragma unroll
      for (int i = 0; i < GT_M * GT_K / 4 / 256; ++i) {
        const int q = tid + i * 256, r = q / (GT_K / 4), k = 4 * (q % (GT_K / 4));
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(xc + r * XS + k);
        *reinterpret_cast<uint4*>(s_xp + r * GT_FS + k) =
            make_uint4(s_xt[raw & 255u], s_xt[(raw >> 8) & 255u],
                       s_xt[(raw >> 16) & 255u], s_xt[raw >> 24]);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < GT_K / 16; ++ks) {
        const int kk = ks * 16 + 2 * lt;   // this lane's k rows: kk, +1, +8, +9
        // B of every weight and n8 tile: rows kk, kk + 1 (b0) and kk + 8,
        // kk + 9 (b1) of column 4 lg + j, as hi and lo halves
        uint32_t bh[NW][4][2], bl[NW][4][2];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const unsigned char* cs = c_tile(t, w) + wn * 32 + 4 * lg;
          const uint32_t* tab = s_wp + w * 256;
          uint32_t cw[4];
          bool ok[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = kk + (r & 1) + 8 * (r >> 1);
            cw[r] = *reinterpret_cast<const uint32_t*>(cs + row * GT_CS);
            ok[r] = row < kvalid;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t e[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) e[r] = ok[r] ? tab[(cw[r] >> (8 * j)) & 255u] : 0u;
            bh[w][j][0] = his(e[0], e[1]); bh[w][j][1] = his(e[2], e[3]);
            bl[w][j][0] = los(e[0], e[1]); bl[w][j][1] = los(e[2], e[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm * 64 + i * 16 + lg;
          const uint2 p0 = *reinterpret_cast<const uint2*>(s_xp + r * GT_FS + kk);
          const uint2 p1 = *reinterpret_cast<const uint2*>(s_xp + (r + 8) * GT_FS + kk);
          const uint2 p2 = *reinterpret_cast<const uint2*>(s_xp + r * GT_FS + kk + 8);
          const uint2 p3 = *reinterpret_cast<const uint2*>(s_xp + (r + 8) * GT_FS + kk + 8);
          const uint32_t ah[4] = {his(p0.x, p0.y), his(p1.x, p1.y),
                                  his(p2.x, p2.y), his(p3.x, p3.y)};
          const uint32_t al[4] = {los(p0.x, p0.y), los(p1.x, p1.y),
                                  los(p2.x, p2.y), los(p3.x, p3.y)};
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma_bf16(acc[w][i][j], ah, bh[w][j][0], bh[w][j][1]);
              mma_bf16(acc[w][i][j], ah, bl[w][j][0], bl[w][j][1]);
              mma_bf16(acc[w][i][j], al, bh[w][j][0], bh[w][j][1]);
            }
        }
      }
    } else {
      const XT* xs = reinterpret_cast<const XT*>(x_tile(t));
      constexpr int FS = XS / (int)sizeof(XT);
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
          // codes of rows kk, kk + 1: byte j of c0, c1 (column 4 lg + j of
          // the warp's 32), or, codes [N, K], bytes 0, 1 of cp[j] (column
          // 8 j + lg)
          uint32_t c0 = 0, c1 = 0, cp[4] = {0, 0, 0, 0};
          if constexpr (TRANS) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cp[j] = *reinterpret_cast<const uint16_t*>(
                  c_tile(t, 0) + (wn * 32 + 8 * j + lg) * GT_TS + kk);
          } else {
            const unsigned char* cs = c_tile(t, w) + wn * 32 + 4 * lg;
            c0 = *reinterpret_cast<const uint32_t*>(cs + kk * GT_CS);
            c1 = *reinterpret_cast<const uint32_t*>(cs + (kk + 1) * GT_CS);
          }
          const bool v0 = kk < kvalid, v1 = kk + 1 < kvalid;
          const float* tab = s_wt + w * 256;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t k0c = TRANS ? cp[j] & 255u : (c0 >> (8 * j)) & 255u;
            const uint32_t k1c = TRANS ? cp[j] >> 8 : (c1 >> (8 * j)) & 255u;
            const float2 b0 = tf32_split(v0 ? tab[k0c] : 0.0f);
            const float2 b1 = tf32_split(v1 ? tab[k1c] : 0.0f);
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
  }
  cp_async_wait<0>();

  // acc[w][i][j][e]: row 16 i + lg (+8 for e >= 2), column 8 lt + j
  // (+4 for odd e) of the warp's tile; codes [N, K]: column 8 j + 2 lt
  // (+1 for odd e)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + lg + 8 * h;
      if (m >= a.M) continue;
      if constexpr (TRANS) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + wn * 32 + 8 * (e >> 1) + 2 * lt + (e & 1);
          if (n < a.N) emit<false>(a, m, n, acc[0][i][e >> 1][2 * h + (e & 1)], 0.0f);
        }
        continue;
      }
      float v[NW][8];
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int q = 0; q < 8; ++q) v[w][q] = acc[w][i][q & 3][2 * h + (q >> 2)];
      store8<NW>(a, m, n0 + wn * 32 + 8 * lt, v[0], v[NW - 1]);
    }
}

template <typename XT, int NW, bool TRANS = false>
cudaError_t launch_tiled(const Args& a, int splits, cudaStream_t st) {
  constexpr int smem = gt_smem<XT, NW, TRANS>();
  static bool done[16] = {};
  auto kern = mm_tiled<XT, NW, TRANS>;
  cudaError_t e = smem_limit(kern, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + GT_N - 1) / GT_N, (a.M + GT_M - 1) / GT_M, splits);
  kern<<<grid, 256, smem, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess && splits > 1) e = launch_reduce(a, NW, splits, st);
  return e;
}

// --------------------------------------------- codes [N, K]: decode --
// M <= 8, the tied unembedding.  out^T [N, M] = dec(codes) [N, K] . x^T:
// warp w of a block owns the ST_COLS = 16 columns n0 .. n0 + 15 as the
// rows of m16n8k16 A tiles and x's 8 rows as the tile's columns.  Lane
// (g, t) reads code bytes k0 + 16 t .. + 15 of columns n0 + g and
// n0 + g + 8 a 64-k step; in the step's k16 slice s its bytes 4 s ..
// 4 s + 3 stand for the fragment's k 2t, 2t + 1, 2t + 8, 2t + 9, and B
// takes x at the same k (x row g, 4 bf16 from shared memory).
constexpr int ST_COLS = 16;            // columns a warp
constexpr int ST_N = 8 * ST_COLS;      // columns a block
constexpr int ST_KC = 2048;            // k of x staged at once
constexpr int ST_XS = ST_KC + 8;       // staged x row, bf16: rows 16 bytes
                                       // apart mod 128 (conflict-free reads)
constexpr int ST_U = 4;                // 64-k steps in flight a lane

template <typename XT>
__host__ __device__ constexpr int st_smem() {
  return (std::is_same<XT, float>::value ? 2 : 1) * SM * ST_XS * 2;
}

// 16 bytes of a code row by one load that bypasses L1 (the codes are
// read once), or byte by byte for a row off 16-byte boundaries or its
// ragged end; zeros past ``nbytes``.
__device__ __forceinline__ uint4 codes16(const uint8_t* p, int nbytes,
                                         bool vec) {
  if (nbytes <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && nbytes >= 16) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
  return bytes16(p, nbytes);
}

template <typename XT>
__global__ void __launch_bounds__(256, 2) mm_stream_t(Args a) {
  constexpr bool XF = std::is_same<XT, float>::value;   // x split hi + lo
  __shared__ uint32_t s_tab[256];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_xh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_xl = s_xh + SM * ST_XS;               // float32 x only

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, lt = lane & 3;
  const int n0 = blockIdx.x * ST_N + warp * ST_COLS;
  const bool cvec = (uintptr_t)a.c0 % 16 == 0 && a.K % 16 == 0;
  const bool xvec = (uintptr_t)a.x % 16 == 0 && a.K % 4 == 0;
  // columns past N read the last row and are never stored
  const uint8_t* row0 = a.c0 + (size_t)min(n0 + lg, a.N - 1) * a.K;
  const uint8_t* row1 = a.c0 + (size_t)min(n0 + lg + 8, a.N - 1) * a.K;
  fill_pairs(s_tab, a.lut0, a.qm0, a.alu);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kc = 0; kc < a.K; kc += ST_KC) {
    const int kn = min(ST_KC, a.K - kc);
    __syncthreads();   // the previous chunk's x is consumed
    // x [8, kn] as bf16 hi (and lo), zeros past M and kn: 4 k a thread
    for (int q = tid; q < SM * ST_KC / 4; q += 256) {
      const int m = q / (ST_KC / 4), k = 4 * (q % (ST_KC / 4));
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (m < a.M) {
        const XT* src = x + (size_t)m * a.K + kc + k;
        if (xvec && k + 4 <= kn) {
          if constexpr (XF) {
            const float4 f = *reinterpret_cast<const float4*>(src);
            v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
          } else {
            const uint2 b = *reinterpret_cast<const uint2*>(src);
            v[0] = __uint_as_float(b.x << 16); v[1] = __uint_as_float(b.x & 0xffff0000u);
            v[2] = __uint_as_float(b.y << 16); v[3] = __uint_as_float(b.y & 0xffff0000u);
          }
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (k + r < kn) v[r] = to_f32(src[r]);
        }
      }
      uint32_t h[2], l[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t e0 = bf16_pair(v[2 * p]), e1 = bf16_pair(v[2 * p + 1]);
        h[p] = his(e0, e1);
        l[p] = los(e0, e1);
      }
      *reinterpret_cast<uint2*>(s_xh + m * ST_XS + k) = make_uint2(h[0], h[1]);
      if constexpr (XF)
        *reinterpret_cast<uint2*>(s_xl + m * ST_XS + k) = make_uint2(l[0], l[1]);
    }
    __syncthreads();   // x (and, the first time, the table) in

    for (int k0 = 0; k0 < kn; k0 += 64 * ST_U) {
      uint4 c0[ST_U], c1[ST_U];
#pragma unroll
      for (int u = 0; u < ST_U; ++u) {
        const int kk = k0 + 64 * u + 16 * lt;
        c0[u] = codes16(row0 + kc + kk, kn - kk, cvec);
        c1[u] = codes16(row1 + kc + kk, kn - kk, cvec);
      }
#pragma unroll
      for (int u = 0; u < ST_U; ++u) {
        if (k0 + 64 * u >= kn) break;
        const int kk = k0 + 64 * u + 16 * lt;
        const uint4 xa = *reinterpret_cast<const uint4*>(s_xh + lg * ST_XS + kk);
        const uint4 xb = *reinterpret_cast<const uint4*>(s_xh + lg * ST_XS + kk + 8);
        const uint32_t xh[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        uint32_t xl[8];
        if constexpr (XF) {
          const uint4 la = *reinterpret_cast<const uint4*>(s_xl + lg * ST_XS + kk);
          const uint4 lb = *reinterpret_cast<const uint4*>(s_xl + lg * ST_XS + kk + 8);
          xl[0] = la.x; xl[1] = la.y; xl[2] = la.z; xl[3] = la.w;
          xl[4] = lb.x; xl[5] = lb.y; xl[6] = lb.z; xl[7] = lb.w;
        }
        const uint32_t w0[4] = {c0[u].x, c0[u].y, c0[u].z, c0[u].w};
        const uint32_t w1[4] = {c1[u].x, c1[u].y, c1[u].z, c1[u].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t e[4], f[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            e[r] = s_tab[(w0[s] >> (8 * r)) & 255u];
            f[r] = s_tab[(w1[s] >> (8 * r)) & 255u];
          }
          const uint32_t ah[4] = {his(e[0], e[1]), his(f[0], f[1]),
                                  his(e[2], e[3]), his(f[2], f[3])};
          const uint32_t al[4] = {los(e[0], e[1]), los(f[0], f[1]),
                                  los(e[2], e[3]), los(f[2], f[3])};
          mma_bf16(acc, ah, xh[2 * s], xh[2 * s + 1]);
          mma_bf16(acc, al, xh[2 * s], xh[2 * s + 1]);
          if constexpr (XF) mma_bf16(acc, ah, xl[2 * s], xl[2 * s + 1]);
        }
      }
    }
  }
  // acc: (column n0 + lg, row 2 lt), (n0 + lg, 2 lt + 1), (n0 + lg + 8,
  // 2 lt), (n0 + lg + 8, 2 lt + 1)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = n0 + lg + 8 * (e >> 1), m = 2 * lt + (e & 1);
    if (m < a.M && n < a.N) finish<false>(a, (size_t)m * a.N + n, n, acc[e], 0.0f);
  }
}

template <typename XT>
cudaError_t launch_stream_t(const Args& a, cudaStream_t st) {
  constexpr int smem = st_smem<XT>();
  static bool done[16] = {};
  auto kern = mm_stream_t<XT>;
  cudaError_t e = smem_limit(kern, smem, done);
  if (e != cudaSuccess) return e;
  kern<<<(a.N + ST_N - 1) / ST_N, 256, smem, st>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launch --

// NW weights of codes [K, N] on the decode or the prefill path; M <= 8:
// splits is the cluster size (1..8), M > 8: the K splits of the tiles.
template <typename XT, int NW>
int launch_kn(const Args& a, int splits, cudaStream_t st) {
  if (splits < 1 || (a.M <= SM && splits > 8)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = a.M <= SM ? launch_skinny<XT, NW>(a, splits, st)
                                  : launch_tiled<XT, NW>(a, splits, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// One weight of codes [N, K]: no split on the decode path.
template <typename XT>
int launch_nk(const Args& a, int splits, cudaStream_t st) {
  if (splits < 1 || (a.M <= SM && splits != 1)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = a.M <= SM ? launch_stream_t<XT>(a, st)
                                  : launch_tiled<XT, 1, true>(a, splits, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
// and qmeta [4] float32; bias [N] float32 or null; out [M, N] float32.
// Codes [K, N]: M <= 8: splits is the cluster size (1..8) and ws is
// unused; M > 8: ws holds splits*M*N floats when splits > 1.  Codes
// [N, K]: splits 1 at M <= 8, else as for [K, N].  Returns the launch's
// cudaError_t.
int lut_dequant_matmul_launch(const void* x, int x_bf16, const void* codes,
                              const void* lut, const void* qmeta,
                              const void* bias, void* out, void* ws, int M,
                              int K, int N, int transposed, int alu, int act,
                              int splits, int k_per_split, void* stream) {
  const Args a = make_args(x, codes, nullptr, lut, nullptr, qmeta, nullptr,
                           nullptr, nullptr, nullptr, bias, out, ws, M, K, N,
                           k_per_split, alu, act);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return transposed ? launch_nk<__nv_bfloat16>(a, splits, st)
                      : launch_kn<__nv_bfloat16, 1>(a, splits, st);
  return transposed ? launch_nk<float>(a, splits, st)
                    : launch_kn<float, 1>(a, splits, st);
}

// y[M, N] = act(x @ dec_g(codes_g)) * (x @ dec_u(codes_u)), codes [K, N].
// splits and ws as for the plain variant's codes [K, N] (ws 2*splits*M*N
// floats).
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
  return x_bf16 ? launch_kn<__nv_bfloat16, 2>(a, splits, st)
                : launch_kn<float, 2>(a, splits, st);
}

// y[M, N] = act(dec_x(x_codes) @ dec_w(codes) + bias): x_codes [M, K] and
// codes [K, N] uint8, each with its table (lut_x/lut_w [256]) and params
// (qmeta_x/qmeta_w [4]).  With qmeta_out set, out is uint8 [M, N] codes
// encoded under it; otherwise float32.  splits and ws as for the plain
// variant's codes [K, N].
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
  return launch_kn<uint8_t, 1>(a, splits, static_cast<cudaStream_t>(stream));
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
  return launch_kn<uint8_t, 2>(a, splits, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block: path 0 mm_skinny, 1 mm_tiled (NW
// weights), 2 mm_stream_t, 3 mm_tiled on codes [N, K], for x_kind 0
// float32, 1 bfloat16, 2 uint8 codes; -1 for a combination no kernel
// takes.
int lut_dequant_matmul_smem_bytes(int path, int x_kind, int nw) {
  if (nw != 1 && nw != 2) return -1;
  if (path == 0) return nw == 1 ? (int)sizeof(SkinnySmem<1>) : (int)sizeof(SkinnySmem<2>);
  if (path == 1) {
    if (x_kind == 1) return nw == 1 ? gt_smem<__nv_bfloat16, 1>() : gt_smem<__nv_bfloat16, 2>();
    if (x_kind == 2) return nw == 1 ? gt_smem<uint8_t, 1>() : gt_smem<uint8_t, 2>();
    return nw == 1 ? gt_smem<float, 1>() : gt_smem<float, 2>();
  }
  if (path == 2 && nw == 1 && x_kind != 2)
    return x_kind == 1 ? st_smem<__nv_bfloat16>() : st_smem<float>();
  if (path == 3 && nw == 1 && x_kind != 2)
    return x_kind == 1 ? gt_smem<__nv_bfloat16, 1, true>() : gt_smem<float, 1, true>();
  return -1;
}

}  // extern "C"
