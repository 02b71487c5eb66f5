// Chunked flash prefill over a paged KV cache on Hopper's tensor cores
// (sm_90a).
//
// Replaces src/repro/kernels/flash_prefill/flash_prefill.py:
//   flash_prefill_paged_kernel (:211, #5): float32 or bfloat16 q;
//     float32, bfloat16 or float8_e4m3fn pages, upcast to float32 after
//     the load as the TPU kernel upcasts; float32 out;
//   flash_prefill_paged_codes_kernel (:145, #6): uint8 DNA-TEQ codes for
//     q and pages, decoded through the q table and this KV head's K and V
//     tables (3 x 256 floats in shared memory), the context encoded to
//     uint8 under out_qmeta at the flush (dnateq.cuh).
// A chunk of S queries per row, row 0 at absolute position q_start[b],
// attends the pages named by block_tables with validity
// kv_pos <= q_start+i and kv_pos < kv_lens[b]; masked logits are -1e30,
// the scale 1/sqrt(hd); online softmax with the reference's recurrence
//   m' = max(m, max_t logit); p = exp(logit - m'); corr = exp(m - m');
//   l' = l*corr + sum_t p;    acc' = acc*corr + sum_t p*v,
// applied per KV tile, and at the flush acc / max(l, 1e-30), or zeros
// for a row whose m never rose above -5e29.  The TPU's sequential page
// grid axis becomes the tile loop inside a block; its scalar-prefetched
// table becomes each copy reading its own block_tables entry.
//
// What bounds it on an H100: the two products, QK^T and PV.  At the
// serving chunk they are ~6 GFLOP of float32 arithmetic against a few
// tens of MB of pages, far above the byte line; float32 FMA outside the
// tensor cores runs 67 TFLOP/s, TF32 on them 495.  Plain TF32 keeps 10
// mantissa bits and misses the 1e-4 gate of the float kernel
// (tests/test_torch_prefill_tf32.py), so the products are split TF32.
// Measured (PERF.md), the tensor pipe is not the limit either: the
// instructions around each mma (fragment loads, the splits, the softmax)
// and their latency are, at 8 warps per SM.
//
// Design:
// - Split TF32: x = hi + lo, hi = x cut to TF32, lo = x - hi (exact);
//   a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi on
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  A pass whose lo part
//   is zero by construction is left out: bfloat16 and e4m3 values are
//   exact in TF32, so bf16 q needs no q_lo pass and bf16 or e4m3 pages
//   no K_lo/V_lo pass
//   (serving: bf16 q, float32 pages -> 2 QK passes, 3 PV passes; P is
//   never exact, so PV always has its P_lo pass).
// - Geometry: a block is (row b, KV head h, 64 query rows = qpb =
//   floor(64/g) positions x the g query heads of h), 4 warps; warp w owns
//   rows 16w..16w+15 (one m16 fragment) and keeps its S tile [16 x 32]
//   and its O [16 x HD] in registers.  Where g does not divide 64 (g 3,
//   5, 6, 7) rows qpb*g..63 are padding: their q is zeros, every logit
//   of theirs is masked, and they are never stored.  The last query
//   tiles of a chunk see the most positions, so they are launched first
//   (blockIdx.z counts down).  A block whose row has nothing to do writes
//   its zeros at once.
// - Head layouts: HD 64, 128 or 256 (a template parameter: the O
//   fragment [16 x HD], the staged row strides and the shared memory
//   follow it; at HD 256 O is 128 floats a thread), g from 1 to 16 (4
//   positions x 16 heads at the most).
// - Staging: KV tiles of 32 positions in a ring of 2 stages (K and V of
//   a tile in one cp.async group: tile j+1 loads while tile j computes),
//   filled by cp.async.cg 16-byte copies.  Each copy finds its page as
//   block_tables[b, t / bs]: lane j of a warp looks position t0 + j up
//   once per tile (t / bs as a multiply-high, not a division; exact while
//   t * bs < 2^32) and the
//   copies take it by shuffle, so any bs works and a tile may span pages
//   or end mid-page.  Positions past the last one a row of the block may
//   see are zero-filled (src-size 0) and masked; tiles wholly past it are
//   not loaded.  q is loaded once, converted (or decoded) to float32.
//   cp.async rather than TMA: a TMA box needs a host-built tensor map,
//   and pages of 16 positions are small, scattered boxes.
// - Bank conflicts: rows are padded (HD + 4 words for float32 tiles,
//   HD + 8 halves for bfloat16; 4 banks on from one row to the next at
//   either HD) so each fragment load of a warp hits 32 distinct banks.
// - P feeds PV with no re-layout (no shuffles, no shared-memory tile).
//   S's accumulator holds columns 2t, 2t+1 of a row where PV's A
//   fragment wants k = t, t+4; PV sums over its k in any order, so it
//   takes k = t as tile position 2t and k = t+4 as 2t+1, and the V
//   fragment is read at those same positions.  The registers of S, after
//   the softmax, are P's A fragment as they stand.
// - QK keeps even and odd k-steps in two accumulators (twice the
//   independent mma chains); PV has 16 already (one per 8 dims).
// - Softmax in registers: a row's max by quad shuffles, expf (not
//   __expf; the build has no fast math), per-thread partial sums of l
//   reduced over the quad at the flush.
// - Codes: the uint8 tile is staged by cp.async at 1 B per element and
//   decoded through the tables once per tile into a float32 tile that
//   all four warps then read; q is decoded at its load.  Decoded values
//   are not exact in TF32: 3 passes for each product.
// - e4m3 pages: staged at 1 B per element as codes are, and converted
//   into the same float32 tiles (two values at a time through half2:
//   exact, NaN stays NaN); exact in TF32, so K and V take one pass.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "dnateq.cuh"

namespace prefill {

constexpr int ROWS = 64;       // query rows per block: 64/g positions x g
constexpr int THREADS = 128;   // 4 warps of 16 rows
constexpr int KT = 32;         // KV positions per tile
constexpr int STAGES = 2;      // ring depth: tiles of K and V in flight
constexpr unsigned FULL = 0xffffffffu;
constexpr int PAD = INT_MIN;   // the last visible position of a padding row

struct Codes {
  const float* q_lut;
  const float* k_lut;
  const float* v_lut;
  const float* out_qmeta;
};

using f8 = __nv_fp8_e4m3;

template <typename T>
constexpr bool is_codes = std::is_same_v<T, uint8_t>;
// pages staged at 1 B an element and converted into float32 tiles
template <typename T>
constexpr bool is_narrow = is_codes<T> || std::is_same_v<T, f8>;
template <typename T>
constexpr bool exact_tf32 =
    std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, f8>;

// float32 row stride (words) of the q tile and the decoded tiles.
template <int HD>
__host__ __device__ constexpr int fstride() { return HD + 4; }

// Staged row stride, in elements of the page type.
template <int HD, typename PT>
__host__ __device__ constexpr int stride() {
  if constexpr (std::is_same_v<PT, float>) return HD + 4;
  else if constexpr (std::is_same_v<PT, __nv_bfloat16>) return HD + 8;
  else return HD + 16;
}

template <int HD, typename PT>
constexpr size_t smem_bytes() {
  return sizeof(float) * ROWS * fstride<HD>() +
         (size_t)STAGES * 2 * KT * stride<HD, PT>() * sizeof(PT) +
         (is_narrow<PT> ? sizeof(float) * 2 * KT * fstride<HD>() : 0) +
         (is_codes<PT> ? sizeof(float) * 3 * 256 : 0);
}

// x = hi + lo for a TF32 operand; lo is left unset when x is exact in
// TF32.  hi is x cut to its upper 19 bits (one op: cvt.rna.tf32.f32 is
// a longer sequence in SASS); lo = x - hi is exact in float32 and goes
// to the tensor core as it is, which reads a TF32 operand's upper 19
// bits.  So hi + lo is x within 2^-20 of it, and a split product within
// ~2^-20 of the float32 one.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// c += a . b on one m16n8k8 TF32 tile, float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive q elements as float32: converted, or decoded.
__device__ __forceinline__ float4 load4(const float* p, const float*) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p,
                                        const float*) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 load4(const uint8_t* p, const float* lut) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  return make_float4(lut[raw & 255u], lut[(raw >> 8) & 255u],
                     lut[(raw >> 16) & 255u], lut[raw >> 24]);
}
__device__ __forceinline__ float2 f8x2(uint32_t w) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}
__device__ __forceinline__ float4 load4(const f8* p, const float*) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  const float2 a = f8x2(raw), c = f8x2(raw >> 16);
  return make_float4(a.x, a.y, c.x, c.y);
}

// Start the copies of KV positions t0..t0+KT-1 into one ring stage (K and
// V tiles [KT][stride]); positions at or past n_pos are zero-filled.
// Lane j of every warp looks up position t0 + j once: its pool row
// page * bs + t % bs, with t / bs as a multiply-high by the block's
// reciprocal ``inv_bs`` (exact while t * bs <= 2^32; the launch checks
// it), and each copy takes its position's row by shuffle.
template <int HD, typename PT>
__device__ __forceinline__ void load_tile(PT* sk, PT* sv,
                                          const PT* __restrict__ kp,
                                          const PT* __restrict__ vp,
                                          const int* __restrict__ bt_row,
                                          int t0, int n_pos, int bs,
                                          unsigned inv_bs, int n_kv, int h,
                                          int tid) {
  constexpr int EPC = 16 / sizeof(PT);     // elements per 16-byte chunk
  constexpr int CH = HD / EPC;             // chunks per position
  constexpr int ST = stride<HD, PT>();
  static_assert(KT == 32, "one lane per position of a tile");
  static_assert(KT * CH % THREADS == 0, "whole copies a thread");
  const int t = t0 + (tid & 31);
  int row = 0;
  if (t < n_pos) {
    const int blk = bs == 1 ? t : (int)__umulhi((unsigned)t, inv_bs);
    row = __ldg(bt_row + blk) * bs + (t - blk * bs);
  }
#pragma unroll
  for (int k = 0; k < KT * CH / THREADS; ++k) {
    const int c = tid + k * THREADS;
    const int i = c / CH, e = (c % CH) * EPC;
    const int r = __shfl_sync(FULL, row, i);
    const size_t off = ((size_t)r * n_kv + h) * HD + e;
    const int nbytes = t0 + i < n_pos ? 16 : 0;
    cp_async16(sk + i * ST + e, kp + off, nbytes);
    cp_async16(sv + i * ST + e, vp + off, nbytes);
  }
}

// A staged uint8 tile decoded through a table, or an e4m3 tile
// converted, into a float32 tile.
template <int HD, typename PT>
__device__ __forceinline__ void decode_rows(float* dst, const PT* src,
                                            const float* lut, int tid) {
  constexpr int ST = stride<HD, PT>();
#pragma unroll
  for (int k = 0; k < KT * HD / 4 / THREADS; ++k) {
    const int c = tid + k * THREADS;
    const int i = c / (HD / 4), d = (c % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(dst + i * fstride<HD>() + d) =
        load4(src + i * ST + d, lut);
  }
}

// q [B, S, n_kv, g, HD] (QT float, bf16, or uint8 codes); pages
// [N, bs, n_kv, HD] (PT float, bf16, e4m3, or uint8 codes); block_tables
// [B, max_blk]; out [B, S, n_kv, g, HD] float32, or uint8 for codes.
template <int HD, typename QT, typename PT>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pages,
               const PT* __restrict__ v_pages,
               const int* __restrict__ block_tables,
               const int* __restrict__ q_start,
               const int* __restrict__ kv_lens, void* __restrict__ out, int S,
               int n_kv, int g, int bs, int max_blk, float scale,
               Codes codes) {
  constexpr bool CODES = is_codes<PT>;
  constexpr bool NARROW = is_narrow<PT>;
  constexpr bool Q_EXACT = exact_tf32<QT>;
  constexpr bool KV_EXACT = exact_tf32<PT>;
  // the element type of the tiles the fragments read, and its stride
  using FT = std::conditional_t<NARROW, float, PT>;
  constexpr int FS = fstride<HD>();
  constexpr int SK = NARROW ? FS : stride<HD, PT>();
  constexpr int ST = stride<HD, PT>();

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);                 // [ROWS][FS]
  PT* ring = reinterpret_cast<PT*>(s_q + ROWS * FS);  // [STAGES][K, V][KT][ST]
  float* s_kf = reinterpret_cast<float*>(ring + STAGES * 2 * KT * ST);  // narrow
  float* s_vf = s_kf + KT * FS;                               // [KT][FS] narrow
  float* s_ql = s_vf + KT * FS;                                // [256] codes
  float* s_kl = s_ql + 256;                                    // [256] codes
  float* s_vl = s_kl + 256;                                    // [256] codes
  const int b = blockIdx.x, h = blockIdx.y;
  const int qpb = ROWS / g;
  const int live_rows = qpb * g;   // rows past it are padding
  // the last query tiles see the most positions: they go first
  const int qi0 = (gridDim.z - 1 - blockIdx.z) * qpb;
  if (qi0 >= S) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lg = lane >> 2, lt = lane & 3;   // fragment row group, column
  const int r0 = warp * 16 + lg, r1 = r0 + 8;
  const int qs = q_start[b];
  const int kvl = min(kv_lens[b], max_blk * bs);
  // a row's last visible position; PAD (nothing, and never stored) for a
  // padding row, so that no flag has to stay live through the tile loop
  const int qp0 = r0 < live_rows ? qs + qi0 + r0 / g : PAD;
  const int qp1 = r1 < live_rows ? qs + qi0 + r1 / g : PAD;
  // positions any row of this block may see
  const int q_last = min(S - 1, qi0 + qpb - 1);
  const int n_pos = kvl > 0 ? min(kvl, qs + q_last + 1) : 0;
  const int n_tiles = (n_pos + KT - 1) / KT;

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.0f, l1 = 0.0f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  if (n_tiles > 0) {
    const int* bt_row = block_tables + (size_t)b * max_blk;
    const unsigned inv_bs = 0xffffffffu / (unsigned)bs + 1u;   // 0 for bs 1
    auto stage = [&](int jt, int kv) {
      return ring + ((jt % STAGES) * 2 + kv) * KT * ST;
    };
    auto load = [&](int jt) {
      if (jt < n_tiles)
        load_tile<HD>(stage(jt, 0), stage(jt, 1), k_pages, v_pages, bt_row,
                      jt * KT, n_pos, bs, inv_bs, n_kv, h, tid);
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) load(s);
    if constexpr (CODES) {
      for (int c = tid; c < 256; c += THREADS) {
        s_ql[c] = codes.q_lut[c];
        s_kl[c] = codes.k_lut[(size_t)h * 256 + c];
        s_vl[c] = codes.v_lut[(size_t)h * 256 + c];
      }
      __syncthreads();
    }
    // the q tile, once: rows past S and padding rows are zeros
#pragma unroll 4
    for (int c = tid; c < ROWS * HD / 4; c += THREADS) {
      const int r = c / (HD / 4), d = (c % (HD / 4)) * 4;
      const int qi = qi0 + r / g, gi = r % g;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (qi < S && r < live_rows)
        v = load4(q + ((((size_t)b * S + qi) * n_kv + h) * g + gi) * HD + d,
                  s_ql);
      *reinterpret_cast<float4*>(s_q + r * FS + d) = v;
    }

    for (int jt = 0; jt < n_tiles; ++jt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // tile jt landed; every warp is done with jt - 1
      load(jt + STAGES - 1);
      const FT* sk;
      const FT* sv;
      if constexpr (NARROW) {
        decode_rows<HD>(s_kf, stage(jt, 0), s_kl, tid);
        decode_rows<HD>(s_vf, stage(jt, 1), s_vl, tid);
        __syncthreads();
        sk = s_kf;
        sv = s_vf;
      } else {
        sk = stage(jt, 0);
        sv = stage(jt, 1);
      }

      // S = q k^T over the tile, [16 x KT] per warp; even and odd
      // k-steps in two accumulators, so twice as many mma chains are in
      // flight
      float sc[KT / 8][4], sd[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
        sd[n][0] = sd[n][1] = sd[n][2] = sd[n][3] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        const float* qa = s_q + r0 * FS + ks * 8 + lt;
        uint32_t ah[4], al[4];
        split<Q_EXACT>(qa[0], ah[0], al[0]);
        split<Q_EXACT>(qa[8 * FS], ah[1], al[1]);
        split<Q_EXACT>(qa[4], ah[2], al[2]);
        split<Q_EXACT>(qa[8 * FS + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
          const FT* kb = sk + (n * 8 + lg) * SK + ks * 8 + lt;
          uint32_t bh0, bl0, bh1, bl1;
          split<KV_EXACT>(to_f32(kb[0]), bh0, bl0);
          split<KV_EXACT>(to_f32(kb[4]), bh1, bl1);
          float(&acc)[4] = (ks & 1) ? sd[n] : sc[n];
          if constexpr (!Q_EXACT) mma(acc, al, bh0, bh1);
          if constexpr (!KV_EXACT) mma(acc, ah, bl0, bl1);
          mma(acc, ah, bh0, bh1);
        }
      }

      // mask, scale and the online softmax; sc[n][e] is row r0 (e < 2)
      // or r1 at tile position 8n + 2*lt + (e & 1)
      const int t0 = jt * KT;
      float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += sd[n][e];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + n * 8 + 2 * lt + e;
          const bool live = t < kvl;
          sc[n][e] = live && t <= qp0 ? sc[n][e] * scale : -1e30f;
          sc[n][2 + e] = live && t <= qp1 ? sc[n][2 + e] * scale : -1e30f;
          mx0 = fmaxf(mx0, sc[n][e]);
          mx1 = fmaxf(mx1, sc[n][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = expf(sc[n][e] - mn0);
          sc[n][2 + e] = expf(sc[n][2 + e] - mn1);
          ps0 += sc[n][e];
          ps1 += sc[n][2 + e];
        }
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }

      // O += P V, k = lt <-> tile position 8ks + 2lt, k = lt + 4 <-> +1
#pragma unroll
      for (int ks = 0; ks < KT / 8; ++ks) {
        uint32_t ah[4], al[4];
        split<false>(sc[ks][0], ah[0], al[0]);
        split<false>(sc[ks][2], ah[1], al[1]);
        split<false>(sc[ks][1], ah[2], al[2]);
        split<false>(sc[ks][3], ah[3], al[3]);
        const FT* vb = sv + (ks * 8 + 2 * lt) * SK + lg;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split<KV_EXACT>(to_f32(vb[n * 8]), bh0, bl0);
          split<KV_EXACT>(to_f32(vb[SK + n * 8]), bh1, bl1);
          mma(o[n], al, bh0, bh1);
          if constexpr (!KV_EXACT) mma(o[n], ah, bl0, bl1);
          mma(o[n], ah, bh0, bh1);
        }
      }
    }
    cp_async_wait<0>();
  }

  // flush: o[n][e] is row r0 (e < 2) or r1 at dim 8n + 2*lt + (e & 1)
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const int qi = qi0 + r / g, gi = r % g;
    if (qi >= S || (half ? qp1 : qp0) == PAD) continue;
    const bool seen = (half ? m1 : m0) > -5e29f;
    const float den = fmaxf(half ? l1 : l0, 1e-30f);
    const size_t base =
        ((((size_t)b * S + qi) * n_kv + h) * g + gi) * HD + 2 * lt;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float x0 = seen ? o[n][2 * half] / den : 0.0f;
      const float x1 = seen ? o[n][2 * half + 1] / den : 0.0f;
      if constexpr (CODES) {
        *reinterpret_cast<uchar2*>(static_cast<uint8_t*>(out) + base + n * 8) =
            make_uchar2(dnateq::encode(x0, codes.out_qmeta),
                        dnateq::encode(x1, codes.out_qmeta));
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + base + n * 8) =
            make_float2(x0, x1);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit, once per device: the
// attribute is a property of the function, setting it on every call costs
// host time, and a launch inside a CUDA graph capture then makes no API
// call but the launch.  ``done`` is the calling instantiation's own flags.
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

template <int HD, typename QT, typename PT>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const void* bt, const void* qs, const void* kl,
                      void* out, int B, int S, int n_kv, int g, int bs,
                      int max_blk, float scale, void* stream, Codes codes) {
  constexpr size_t smem = smem_bytes<HD, PT>();
  static bool done[16] = {};
  auto kern = prefill_kernel<HD, QT, PT>;
  cudaError_t e = smem_limit(kern, (int)smem, done);
  if (e != cudaSuccess) return e;
  const int qpb = ROWS / g;
  dim3 grid(B, n_kv, (S + qpb - 1) / qpb);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(qs), static_cast<const int*>(kl), out, S, n_kv,
      g, bs, max_blk, scale, codes);
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* qs, const void* kl, void* out,
                   int B, int S, int n_kv, int g, int hd, int bs, int max_blk,
                   float scale, void* stream, Codes codes) {
  if (hd == 64)
    return launch_hd<64, QT, PT>(q, k, v, bt, qs, kl, out, B, S, n_kv, g, bs,
                                 max_blk, scale, stream, codes);
  if (hd == 256)
    return launch_hd<256, QT, PT>(q, k, v, bt, qs, kl, out, B, S, n_kv, g,
                                  bs, max_blk, scale, stream, codes);
  return launch_hd<128, QT, PT>(q, k, v, bt, qs, kl, out, B, S, n_kv, g, bs,
                                max_blk, scale, stream, codes);
}

// the positions' division by bs in load_tile is exact while t * bs <= 2^32
inline bool valid_shape(int g, int hd, int bs, int max_blk) {
  const long long n = (long long)max_blk * bs;
  return (hd == 64 || hd == 128 || hd == 256) && g >= 1 && g <= 16 &&
         bs >= 1 && n < (1ll << 26) && n * bs <= (1ll << 32);
}

// The float launches' page type: 0 float32, 1 bfloat16, 2 e4m3.
template <typename QT>
cudaError_t launch_float(int kv_kind, const void* q, const void* k,
                         const void* v, const void* bt, const void* qs,
                         const void* kl, void* out, int B, int S, int n_kv,
                         int g, int hd, int bs, int max_blk, float scale,
                         void* stream) {
  const Codes none{nullptr, nullptr, nullptr, nullptr};
  if (kv_kind == 1)
    return launch<QT, __nv_bfloat16>(q, k, v, bt, qs, kl, out, B, S, n_kv, g,
                                     hd, bs, max_blk, scale, stream, none);
  if (kv_kind == 2)
    return launch<QT, f8>(q, k, v, bt, qs, kl, out, B, S, n_kv, g, hd, bs,
                          max_blk, scale, stream, none);
  if (kv_kind == 0)
    return launch<QT, float>(q, k, v, bt, qs, kl, out, B, S, n_kv, g, hd, bs,
                             max_blk, scale, stream, none);
  return cudaErrorInvalidValue;
}

}  // namespace prefill

// q [B, S, n_kv, g, hd] float32/bfloat16; pages [N, bs, n_kv, hd]
// float32, bfloat16 or float8_e4m3fn (kv_kind 0, 1, 2; hd 64, 128 or
// 256, g 1..16, any bs with max_blk * bs^2 <= 2^32); out float32 of q's
// shape.
extern "C" int flash_prefill_paged_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    int kv_kind, const void* block_tables, const void* q_start,
    const void* kv_lens, void* out, int B, int S, int n_kv, int g, int hd,
    int bs, int max_blk, float scale, void* stream) {
  if (!prefill::valid_shape(g, hd, bs, max_blk))
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return (int)prefill::launch_float<__nv_bfloat16>(
        kv_kind, q, k_pages, v_pages, block_tables, q_start, kv_lens, out, B,
        S, n_kv, g, hd, bs, max_blk, scale, stream);
  return (int)prefill::launch_float<float>(
      kv_kind, q, k_pages, v_pages, block_tables, q_start, kv_lens, out, B, S,
      n_kv, g, hd, bs, max_blk, scale, stream);
}

// Codes mode: q_codes [B, S, n_kv, g, hd] and pages uint8; q_lut [256],
// k_lut/v_lut [n_kv, 256] and out_qmeta [4] float32; out uint8 of q's
// shape.
extern "C" int flash_prefill_paged_codes_launch(
    const void* q_codes, const void* k_pages, const void* v_pages,
    const void* q_lut, const void* k_lut, const void* v_lut,
    const void* out_qmeta, const void* block_tables, const void* q_start,
    const void* kv_lens, void* out, int B, int S, int n_kv, int g, int hd,
    int bs, int max_blk, float scale, void* stream) {
  if (!prefill::valid_shape(g, hd, bs, max_blk))
    return (int)cudaErrorInvalidValue;
  const prefill::Codes codes{static_cast<const float*>(q_lut),
                             static_cast<const float*>(k_lut),
                             static_cast<const float*>(v_lut),
                             static_cast<const float*>(out_qmeta)};
  return (int)prefill::launch<uint8_t, uint8_t>(
      q_codes, k_pages, v_pages, block_tables, q_start, kv_lens, out, B, S,
      n_kv, g, hd, bs, max_blk, scale, stream, codes);
}

// Dynamic shared memory of one block for a page dtype (0 float32,
// 1 bfloat16, 2 e4m3, 3 uint8 codes) at head_dim hd (64, 128 or 256).
template <int HD>
static int smem_of(int page_kind) {
  using namespace prefill;
  if (page_kind == 1) return (int)smem_bytes<HD, __nv_bfloat16>();
  if (page_kind == 2) return (int)smem_bytes<HD, f8>();
  if (page_kind == 3) return (int)smem_bytes<HD, uint8_t>();
  return (int)smem_bytes<HD, float>();
}

extern "C" int flash_prefill_smem_bytes(int page_kind, int hd) {
  return hd == 64    ? smem_of<64>(page_kind)
         : hd == 256 ? smem_of<256>(page_kind)
                     : smem_of<128>(page_kind);
}
