// Flash decode over a paged or a contiguous KV cache, Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_gqa/decode_gqa.py:
//   decode_gqa_paged_kernel (#7) (body _paged_kernel -> _kernel): float32
//     or bfloat16 q; float32, bfloat16 or float8_e4m3fn pages, upcast to
//     float32 right after the load as the TPU kernel upcasts; float32
//     out;
//   decode_gqa_paged_codes_kernel (#8) (_paged_codes_kernel): the Codes
//     instantiation below;
//   decode_gqa_kernel (#9): the contiguous [B, S, n_kv, hd] cache of the
//     legacy serving path (float32, bfloat16 or float8_e4m3fn), on the
//     same split-KV body (Contiguous
//     instantiation below).  The TPU kernel's block_s=512 grid axis and
//     its padding of S are TPU tiling: the partitions cover the row and
//     mask its tail, so any S runs as it is.
//
// One query per row, masked by lengths[b]: logit = (q . k) / sqrt(hd),
// -1e30 where kv_pos >= lengths[b]; the online softmax
//   m' = max(m, max_t logit); p = exp(logit - m'); corr = exp(m - m');
//   l' = l*corr + sum_t p;    acc' = acc*corr + sum_t p*v;
// out = acc / max(l, 1e-30), or zeros where m <= -5e29 (length 0).
//
// Split-KV body (#7, #8, #9): flash-decoding.
// Bounds on an H100: the KV bytes up to lengths[b] (one read per KV
// head; the arithmetic is ~1 FLOP a byte for float32 pages).  At the
// serving shapes that is a few MB, microseconds at 3.35 TB/s, so the
// kernel's task is to keep enough loads in flight, on enough SMs:
// - Grid (B, n_kv * row groups, n_split).  A block owns one (row b, KV
//   head h), the g query heads of h (each position is read once per KV
//   head and row group; one group up to g = 8) and one
//   partition of `part` positions: [z*part, (z+1)*part).  The wrapper
//   chooses part and n_split from static shapes only (decode_gqa.py
//   split_plan); lengths never reach the host, so a step can be captured
//   in a CUDA graph.  A block whose partition starts at or past
//   lengths[b] returns at once and writes nothing: the merge folds only
//   the partitions that start before the length, which it reads on the
//   device too.  Both kernels clamp the lengths to [0, cap] (cap: the
//   positions a row holds); the wrappers launch no clamp.
// - Loads: a warp takes BATCH positions at a time (BATCH_WIDE at HD 256,
//   whose lanes hold twice the dims), positions w*BATCH +
//   k*WARPS*BATCH of its partition; lane u < BATCH finds position u's
//   pool row once (a position past the length is clamped to the last
//   live one, in bounds, and masked), and the warp's lanes take it by
//   shuffle.  Paged: the row is block_tables[b, t / bs] * bs + t % bs
//   (any bs).  Lane i holds dims V*i..V*i+V-1 of every
//   position (V = HD/32): at HD 128 one 16-byte load a lane for float32
//   (8 bytes bfloat16, 4 bytes codes and e4m3), at HD 64 one 8-byte load
//   (4, 2), at HD 256 two 16-byte loads (16, 8);
//   a whole warp per position either way, and all 2*BATCH loads of a
//   batch are issued before the first is used.  No shared memory and no
//   barrier in the loop.  (At HD 64 a half-warp per position would keep
//   16-byte loads, but then each half holds other positions' scores and
//   its own partial acc, one more exchange a batch and a fold of the
//   halves; the warp's 256 contiguous bytes are one coalesced load
//   either way.)
// - Arithmetic: every lane is busy.  Each lane holds its V dims of the g
//   query rows; a dot is V FMAs and a 5-step __shfl_xor_sync butterfly,
//   which leaves the same sum in every lane, so each lane runs the
//   online softmax of the warp's rows in registers (the same values in
//   every lane) and scales its V dims of acc.  float32 FMA: at g <= 8
//   queries a KV head the products are too thin for tensor cores.
// - Head layouts: HD 64, 128 or 256, and any g from 1 to 16: up to 8
//   rows a block on the instantiation G = the next power of two (1, 2,
//   4, 8), g 9..16 as two row groups (launch_layout).  Rows past the
//   block's own load no q, fold nothing and store nothing (a branch
//   uniform over the block); q, out and the workspace are strided by g.
// - e4m3 pages (#7, #9): 1 B an element across device memory, two
//   values converted at a time by __nv_cvt_fp8x2_to_halfraw2 and half2
//   -> float2 (exact: every e4m3 value is a half; NaN stays NaN).
// - The 4 warps of a block merge once, at the end, in shared memory:
//   M = max_w m_w, l = sum_w l_w*exp(m_w - M), acc likewise.
// - Merge pass: a second kernel, grid (B, n_kv), folds a row's live
//   partials from the workspace [B, n_kv, n_split, g, HD + 2] (acc, m,
//   l) with the same rule and flushes.  A second launch rather than a
//   last-arriving block under a counter: no counter state has to survive
//   between calls (or be reset inside a captured graph), and the order of
//   the sums is fixed, so the result does not depend on which block ends
//   last.  With n_split = 1 the split kernel flushes itself and the merge
//   is not launched.
// Contiguous instantiation (#9): block_tables is null.  A [B, S, n_kv,
// HD] cache is a pool of B*S rows whose row b, position t is pool row
// b*S + t, so a lane finds its row with no table; cap = S, and split_plan
// cuts the row into virtual pages of 64 positions.  Everything else (the
// batches, the register softmax, the merge) is the paged body's, and the
// same instantiations serve both.
// Past the length (F4): the reference's oracles and TPU kernels weigh
// every position of the block-table columns passed (of the cache, for
// #9) at or past lengths[b] by 0, and 0 x NaN (or 0 x inf) is NaN.  So an
// output lane d of a row with a live position is NaN exactly when V[., h,
// d] is not finite at one of those positions; every other element keeps
// its value bit for bit.  Each partition scans V over its positions at
// or past the length after its own loop (tail_bits: V only, NB loads a
// warp in flight, a column skipped when its page is the previous whole
// column's, as the engine's trash columns all are), and leaves one bit a
// dim in the workspace's flag words; the merge ORs the flags of the
// partitions from the length on and flushes such a lane as NaN.  With
// one partition the block scans and flushes itself.  The lengths stay on
// the device, so a call can still be captured.
// Codes instantiation (#8; uint8 q and pages): the block copies the q
// table and its KV head's K and V tables (3 x 256 floats) into shared
// memory once, and decodes q, K and V through them right after each
// load (the per-head gather of the reference's kernels/_codes.
// decode_heads).  Partials stay float32; the context is encoded under
// out_qmeta (dnateq.cuh) only at the flush, after the merge, never per
// partition.  Pages cross device memory at 1 B per element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dnateq.cuh"

namespace split {

using f8 = __nv_fp8_e4m3;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 8;         // positions a warp loads at once
constexpr int BATCH_WIDE = 4;    // the same at HD 256 (8 dims a lane)
constexpr int MAX_G = 8;         // query rows a block holds, at most
constexpr unsigned FULL = 0xffffffffu;

struct Codes {
  const float* q_lut;
  const float* k_lut;
  const float* v_lut;
  const float* out_qmeta;
};

// A lane's V consecutive elements of a row (float32, bfloat16, e4m3 or
// uint8 codes; V = HD / 32 = 2, 4 or 8) as one load of 2 to 16 bytes,
// or two 16-byte loads (float32 at HD 256).
template <int BYTES>
struct Vec;
template <>
struct Vec<32> { uint4 a, b; };
template <>
struct Vec<16> { uint4 a; };
template <>
struct Vec<8> { uint2 a; };
template <>
struct Vec<4> { unsigned a; };
template <>
struct Vec<2> { unsigned short a; };
template <typename T, int V>
using Raw = Vec<V * (int)sizeof(T)>;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* p) {
  Raw<T, V> r;
  if constexpr (sizeof(r) == 32) {
    const uint4* s = reinterpret_cast<const uint4*>(p);
    r.a = __ldg(s);
    r.b = __ldg(s + 1);
  } else {
    r.a = __ldg(reinterpret_cast<const decltype(r.a)*>(p));
  }
  return r;
}

// 32-bit word i of a load (i is a constant once the loops unroll).
__device__ __forceinline__ unsigned word4(const uint4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
__device__ __forceinline__ unsigned word(const Vec<32>& r, int i) {
  return i < 4 ? word4(r.a, i) : word4(r.b, i - 4);
}
__device__ __forceinline__ unsigned word(const Vec<16>& r, int i) {
  return word4(r.a, i);
}
__device__ __forceinline__ unsigned word(const Vec<8>& r, int i) {
  return i == 0 ? r.a.x : r.a.y;
}
__device__ __forceinline__ unsigned word(const Vec<4>& r, int) { return r.a; }
__device__ __forceinline__ unsigned word(const Vec<2>& r, int) { return r.a; }

__device__ __forceinline__ float2 bf2(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
// two e4m3 values (the low 16 bits) as float32: exact through half, and
// a NaN stays NaN
__device__ __forceinline__ float2 f8x2(unsigned w) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// ... as float32: as they are, converted, or decoded through a table.
template <typename T, int V, int N>
__device__ __forceinline__ void unpack(const Vec<N>& r, float (&o)[V],
                                       const float* lut) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __uint_as_float(word(r, i));
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = bf2(word(r, i));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else if constexpr (std::is_same_v<T, f8>) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = f8x2(word(r, i / 2) >> (16 * (i % 2)));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = lut[(word(r, i / 4) >> (8 * (i % 4))) & 255u];
  }
}

// One output element from its merged (m, l, acc): the reference's flush,
// then the encode for codes.
template <bool CODES>
__device__ __forceinline__ void flush(void* out, size_t i, float m, float l,
                                      float acc, bool tail_nan,
                                      const float* out_qmeta) {
  const float o = m > -5e29f ? (tail_nan ? __int_as_float(0x7fc00000)
                                         : acc / fmaxf(l, 1e-30f))
                             : 0.0f;
  if constexpr (CODES) {
    static_cast<uint8_t*>(out)[i] = dnateq::encode(o, out_qmeta);
  } else {
    static_cast<float*>(out)[i] = o;
  }
}

// F4: bit i of the result is set when dim V*lane + i of V is not finite
// at one of positions [lo, hi) of row b, KV head h (paged through bt_row,
// or contiguous when it is null).  A warp takes NB positions at a time,
// their loads all issued before the first check, as the main loop does
// (twice the main loop's batch: only V is loaded, and the loop's K and V
// registers are free by now).
// A position whose column and the column before it both lie whole in
// [lo, hi) and name the same page is not loaded again.
template <int HD, typename PT>
__device__ unsigned tail_bits(const PT* __restrict__ v_pages,
                              const int* __restrict__ bt_row, int b, int h,
                              int n_kv, int bs, int cap, int lo, int hi,
                              int warp, int lane, const float* s_vl) {
  constexpr int V = HD / 32;
  constexpr int NB = 2 * (HD > 128 ? BATCH_WIDE : BATCH);
  static_assert(NB <= 32, "one lane a position of a batch");
  unsigned bad = 0;
  for (int t0 = lo + warp * NB; t0 < hi; t0 += WARPS * NB) {
    int row = -1;
    const int t = t0 + lane;
    if (lane < NB && t < hi) {
      if (bt_row) {
        const int c = t / bs;
        const int pg = __ldg(bt_row + c);
        if (!(c > 0 && (c - 1) * bs >= lo && __ldg(bt_row + c - 1) == pg))
          row = pg * bs + (t - c * bs);
      } else {
        row = b * cap + t;
      }
    }
    Raw<PT, V> vr[NB];
    int rows[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      rows[u] = __shfl_sync(FULL, row, u);
      if (rows[u] >= 0)
        vr[u] = load<PT, V>(v_pages + ((size_t)rows[u] * n_kv + h) * HD +
                            V * lane);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (rows[u] < 0) continue;
      float vf[V];
      unpack<PT>(vr[u], vf, s_vl);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (!isfinite(vf[i])) bad |= 1u << i;
    }
  }
  return bad;
}

// q [B, n_kv, g, HD]; pages [N, bs, n_kv, HD] with block_tables
// [B, cap / bs], or (block_tables null) a contiguous cache [B, cap, n_kv,
// HD]; lengths [B]; work [B, n_kv, n_split, g, HD + 2] (unused when
// n_split = 1) and after it flags [B, n_kv, n_split, 32] (tail_bits of
// each lane); out [B, n_kv, g, HD] float32, or uint8 for codes.
// Grid (B, n_kv * row groups, n_split): block y holds rows gs * (y % row
// groups) .. + gs - 1 of KV head y / row groups (fewer in the last
// group).
template <int HD, int G, typename QT, typename PT>
__global__ void __launch_bounds__(THREADS)
split_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pages,
             const PT* __restrict__ v_pages,
             const int* __restrict__ block_tables,
             const int* __restrict__ lengths, float* __restrict__ work,
             unsigned* __restrict__ flags, void* __restrict__ out, int n_kv,
             int g, int gs, int bs, int cap, int part, float scale,
             Codes codes) {
  constexpr bool CODES = std::is_same_v<PT, uint8_t>;
  constexpr int V = HD / 32;        // dims a lane holds
  constexpr int NB = HD > 128 ? BATCH_WIDE : BATCH;
  constexpr int WS = HD + 2;        // workspace row: acc[HD], m, l
  __shared__ float s_lut[CODES ? 3 * 256 : 1];     // q, K, V tables
  __shared__ float s_m[WARPS][G], s_l[WARPS][G];
  __shared__ __align__(16) float s_acc[WARPS][G][HD];
  __shared__ unsigned s_tail[32];   // the block's tail_bits, a lane each

  const int b = blockIdx.x, z = blockIdx.z;
  const int n_rg = gridDim.y / n_kv, n_split = gridDim.z;
  const int h = blockIdx.y / n_rg, r0 = (blockIdx.y % n_rg) * gs;
  const int gr = min(gs, g - r0);   // this block's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the lengths' one clamp, here and in the merge: the wrapper has none
  const int kvl = max(0, min(lengths[b], cap));
  const int t_begin = z * part;
  const int t_end = min(t_begin + part, kvl);
  // F4: this partition's positions at or past the length, scanned when
  // the row has a live position (a zero-length row flushes zeros); with
  // more than one partition only row group 0 scans, for every group
  const int tail_lo = max(t_begin, kvl), tail_hi = min(t_begin + part, cap);
  const bool scan = kvl > 0 && tail_lo < tail_hi &&
                    (n_split == 1 || blockIdx.y % n_rg == 0);
  const bool live = t_begin < kvl;
  if (n_split > 1 && !live && !scan) return;   // the merge skips it
  if (tid < 32) s_tail[tid] = 0u;

  const float* s_ql = s_lut;
  const float* s_kl = s_lut + (CODES ? 256 : 0);
  const float* s_vl = s_lut + (CODES ? 512 : 0);
  if constexpr (CODES) {
    for (int c = tid; c < 256; c += THREADS) {
      s_lut[c] = codes.q_lut[c];
      s_lut[256 + c] = codes.k_lut[(size_t)h * 256 + c];
      s_lut[512 + c] = codes.v_lut[(size_t)h * 256 + c];
    }
    __syncthreads();
  }

  float qv[G][V], acc[G][V], m[G], l[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int i = 0; i < V; ++i) qv[r][i] = acc[r][i] = 0.0f;
    m[r] = -1e30f;
    l[r] = 0.0f;
    if (r < gr && live)
      unpack<QT>(load<QT, V>(q + (((size_t)b * n_kv + h) * g + r0 + r) * HD +
                             V * lane),
                 qv[r], s_ql);
  }

  const int* bt_row =
      block_tables ? block_tables + (size_t)b * (cap / bs) : nullptr;
  for (int t0 = t_begin + warp * NB; t0 < t_end; t0 += WARPS * NB) {
    int row = 0;
    if (lane < NB) {
      const int t = min(t0 + lane, t_end - 1);
      if (bt_row) {
        const int pg = t / bs;
        row = __ldg(bt_row + pg) * bs + (t - pg * bs);
      } else {
        row = b * cap + t;
      }
    }
    Raw<PT, V> kr[NB], vr[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int rw = __shfl_sync(FULL, row, u);
      const size_t off = ((size_t)rw * n_kv + h) * HD + V * lane;
      kr[u] = load<PT, V>(k_pages + off);
      vr[u] = load<PT, V>(v_pages + off);
    }
    float kf[NB][V], vf[NB][V];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      unpack<PT>(kr[u], kf[u], s_kl);
      unpack<PT>(vr[u], vf[u], s_vl);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= gr) continue;
      float s[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        s[u] = qv[r][0] * kf[u][0];
#pragma unroll
        for (int i = 1; i < V; ++i) s[u] += qv[r][i] * kf[u][i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < NB; ++u) s[u] += __shfl_xor_sync(FULL, s[u], o);
      }
      float mx = -1e30f;
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        s[u] = t0 + u < t_end ? s[u] * scale : -1e30f;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float ps = 0.0f, pv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) pv[i] = 0.0f;
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const float p = expf(s[u] - m_new);
        ps += p;
#pragma unroll
        for (int i = 0; i < V; ++i) pv[i] += p * vf[u][i];
      }
      l[r] = l[r] * corr + ps;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[r][i] = acc[r][i] * corr + pv[i];
      m[r] = m_new;
    }
  }

  if (scan) {
    const unsigned bad = tail_bits<HD>(v_pages, bt_row, b, h, n_kv, bs, cap,
                                       tail_lo, tail_hi, warp, lane, s_vl);
    __syncthreads();   // s_tail zeroed
    atomicOr(&s_tail[lane], bad);
    __syncthreads();
    if (n_split > 1 && warp == 0)
      flags[(((size_t)b * n_kv + h) * n_split + z) * 32 + lane] = s_tail[lane];
  }
  // a partition wholly past the length leaves flags only (one partition
  // still flushes its zeros)
  if (n_split > 1 && !live) return;

  // the block's warps, merged once; thread tid then owns element tid
  // (row, dim) of each THREADS-wide slice of [g, HD]
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= gr) continue;
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) s_acc[warp][r][V * lane + i] = acc[r][i];
  }
  __syncthreads();
#pragma unroll
  for (int e = tid; e < G * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    if (r >= gr) continue;
    float mb = s_m[0][r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mb = fmaxf(mb, s_m[w][r]);
    float lb = 0.0f, ab = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(s_m[w][r] - mb);
      lb += s_l[w][r] * c;
      ab += s_acc[w][r][d] * c;
    }
    if (n_split == 1) {
      flush<CODES>(out, (((size_t)b * n_kv + h) * g + r0 + r) * HD + d, mb,
                   lb, ab, (s_tail[d / V] >> (d % V)) & 1u, codes.out_qmeta);
    } else {
      float* wr =
          work + ((((size_t)b * n_kv + h) * n_split + z) * g + r0 + r) * WS;
      wr[d] = ab;
      if (d == 0) {
        wr[HD] = mb;
        wr[HD + 1] = lb;
      }
    }
  }
}

// The merge pass: grid (B, n_kv); thread tid folds element tid (row,
// dim) of each THREADS-wide slice of [g, HD] over the partitions that
// start before lengths[b], ORs the tail flags of the partitions from the
// length on (F4), then flushes.
template <int HD, bool CODES>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ work,
             const unsigned* __restrict__ flags,
             const int* __restrict__ lengths, void* __restrict__ out, int g,
             int cap, int part, int n_split,
             const float* __restrict__ out_qmeta) {
  constexpr int WS = HD + 2;
  constexpr int V = HD / 32;
  __shared__ unsigned s_tail[32];
  const int b = blockIdx.x, h = blockIdx.y, n_kv = gridDim.y;
  const int kvl = max(0, min(lengths[b], cap));
  const int n_live = min((kvl + part - 1) / part, n_split);
  if (threadIdx.x < 32) {
    unsigned bad = 0u;
    if (kvl > 0 && kvl < cap)
      for (int z = kvl / part; z < n_split; ++z)
        bad |= flags[(((size_t)b * n_kv + h) * n_split + z) * 32 + threadIdx.x];
    s_tail[threadIdx.x] = bad;
  }
  __syncthreads();
  const float* w0 = work + ((size_t)b * n_kv + h) * n_split * g * WS;
  for (int e = threadIdx.x; e < g * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const float* wr = w0 + r * WS;
    float mm = -1e30f;
    for (int i = 0; i < n_live; ++i) mm = fmaxf(mm, wr[(size_t)i * g * WS + HD]);
    float ll = 0.0f, aa = 0.0f;
    for (int i = 0; i < n_live; ++i) {
      const float* wi = wr + (size_t)i * g * WS;
      const float c = expf(wi[HD] - mm);
      ll += wi[HD + 1] * c;
      aa += wi[d] * c;
    }
    flush<CODES>(out, (((size_t)b * n_kv + h) * g + r) * HD + d, mm, ll, aa,
                 (s_tail[d / V] >> (d % V)) & 1u, out_qmeta);
  }
}

// The shapes of one call: B rows, n_kv KV heads of g query heads, head_dim
// hd; paged (bt non-null, bs positions a page) or contiguous; cap
// positions a row; partitions of `part` positions.
struct Shape {
  int B, n_kv, g, hd, bs, cap, part;
};

template <int HD, int G, typename QT, typename PT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* lengths, void* work, void* out,
                   const Shape& s, int n_rg, int gs, float scale,
                   cudaStream_t st, Codes codes) {
  constexpr bool CODES = std::is_same_v<PT, uint8_t>;
  const int n_split = (s.cap + s.part - 1) / s.part;
  const int* ln = static_cast<const int*>(lengths);
  float* wk = static_cast<float*>(work);
  // the flag words follow the partials
  unsigned* fl = n_split == 1 ? nullptr
                              : reinterpret_cast<unsigned*>(
                                    wk + (size_t)s.B * s.n_kv * n_split * s.g *
                                             (HD + 2));
  split_kernel<HD, G, QT, PT>
      <<<dim3(s.B, s.n_kv * n_rg, n_split), THREADS, 0, st>>>(
          static_cast<const QT*>(q), static_cast<const PT*>(k),
          static_cast<const PT*>(v), static_cast<const int*>(bt), ln, wk, fl,
          out, s.n_kv, s.g, gs, s.bs, s.cap, s.part, scale, codes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  merge_kernel<HD, CODES><<<dim3(s.B, s.n_kv), THREADS, 0, st>>>(
      wk, fl, ln, out, s.g, s.cap, s.part, n_split, codes.out_qmeta);
  return cudaGetLastError();
}

// The instantiation of a head layout: HD as it is; the g rows of a KV
// head in ceil(g / MAX_G) row groups of gs = ceil(g / groups) rows, one
// block each, on the instantiation G = the next power of two at or above
// gs.  (g 9..16 is two groups: each block reads its KV head once more,
// where one block of 16 rows would hold 2 x 16 x V accumulators and q
// values a lane, past the register file at HD 256.)
template <typename QT, typename PT>
cudaError_t launch_layout(const void* q, const void* k, const void* v,
                          const void* bt, const void* lengths, void* work,
                          void* out, const Shape& s, float scale,
                          cudaStream_t st, Codes codes) {
  const int n_rg = (s.g + MAX_G - 1) / MAX_G;
  const int gs = (s.g + n_rg - 1) / n_rg;
  const int G = gs <= 1 ? 1 : gs <= 2 ? 2 : gs <= 4 ? 4 : 8;
#define REPRO_SPLIT_CASE(HDV, GV)                                            \
  if (s.hd == HDV && G == GV)                                                \
    return launch<HDV, GV, QT, PT>(q, k, v, bt, lengths, work, out, s, n_rg, \
                                   gs, scale, st, codes);
  REPRO_SPLIT_CASE(64, 1)
  REPRO_SPLIT_CASE(64, 2)
  REPRO_SPLIT_CASE(64, 4)
  REPRO_SPLIT_CASE(64, 8)
  REPRO_SPLIT_CASE(128, 1)
  REPRO_SPLIT_CASE(128, 2)
  REPRO_SPLIT_CASE(128, 4)
  REPRO_SPLIT_CASE(128, 8)
  REPRO_SPLIT_CASE(256, 1)
  REPRO_SPLIT_CASE(256, 2)
  REPRO_SPLIT_CASE(256, 4)
  REPRO_SPLIT_CASE(256, 8)
#undef REPRO_SPLIT_CASE
  return cudaErrorInvalidValue;
}

inline bool valid_shape(const Shape& s) {
  return (s.hd == 64 || s.hd == 128 || s.hd == 256) && s.g >= 1 &&
         s.g <= 2 * MAX_G && s.bs >= 1 && s.cap >= 1 && s.part >= 1;
}

// The float launches' KV element type: 0 float32, 1 bfloat16, 2 e4m3.
template <typename QT>
cudaError_t launch_float(int kv_kind, const void* q, const void* k,
                         const void* v, const void* bt, const void* lengths,
                         void* work, void* out, const Shape& s, float scale,
                         cudaStream_t st) {
  const Codes none{nullptr, nullptr, nullptr, nullptr};
  if (kv_kind == 1)
    return launch_layout<QT, __nv_bfloat16>(q, k, v, bt, lengths, work, out,
                                            s, scale, st, none);
  if (kv_kind == 2)
    return launch_layout<QT, f8>(q, k, v, bt, lengths, work, out, s, scale,
                                 st, none);
  if (kv_kind == 0)
    return launch_layout<QT, float>(q, k, v, bt, lengths, work, out, s, scale,
                                    st, none);
  return cudaErrorInvalidValue;
}

}  // namespace split

// q [B, n_kv, g, hd] float32/bfloat16; pages [N, bs, n_kv, hd] float32,
// bfloat16 or float8_e4m3fn (kv_kind 0, 1, 2; hd 64, 128 or 256, g
// 1..16, any bs); block_tables [B, max_blk] and lengths [B] int32 (any
// values: the kernels clamp them to [0, max_blk * bs]); work float32
// [B, n_kv, n_split, g, hd + 2] with n_split = ceil(max_blk / part_pages)
// followed by [B, n_kv, n_split, 32] flag words (may be null when
// n_split is 1); out float32 of q's shape.  Zero-length rows get zeros.
extern "C" int decode_gqa_paged_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    int kv_kind, const void* block_tables, const void* lengths, void* work,
    void* out, int B, int n_kv, int g, int hd, int bs, int max_blk,
    int part_pages, float scale, void* stream) {
  const split::Shape s{B, n_kv, g, hd, bs, max_blk * bs, part_pages * bs};
  if (!split::valid_shape(s) || max_blk < 1 ||
      (long long)max_blk * bs >= (1ll << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return (int)split::launch_float<__nv_bfloat16>(
        kv_kind, q, k_pages, v_pages, block_tables, lengths, work, out, s,
        scale, st);
  return (int)split::launch_float<float>(kv_kind, q, k_pages, v_pages,
                                         block_tables, lengths, work, out, s,
                                         scale, st);
}

// Codes mode: q_codes [B, n_kv, g, hd] and pages uint8; q_lut [256],
// k_lut/v_lut [n_kv, 256], out_qmeta [4] float32; work as above; out
// uint8 of q's shape.
extern "C" int decode_gqa_paged_codes_launch(
    const void* q_codes, const void* k_pages, const void* v_pages,
    const void* q_lut, const void* k_lut, const void* v_lut,
    const void* out_qmeta, const void* block_tables, const void* lengths,
    void* work, void* out, int B, int n_kv, int g, int hd, int bs,
    int max_blk, int part_pages, float scale, void* stream) {
  const split::Shape s{B, n_kv, g, hd, bs, max_blk * bs, part_pages * bs};
  if (!split::valid_shape(s) || max_blk < 1 ||
      (long long)max_blk * bs >= (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const split::Codes codes{static_cast<const float*>(q_lut),
                           static_cast<const float*>(k_lut),
                           static_cast<const float*>(v_lut),
                           static_cast<const float*>(out_qmeta)};
  return (int)split::launch_layout<uint8_t, uint8_t>(
      q_codes, k_pages, v_pages, block_tables, lengths, work, out, s, scale,
      static_cast<cudaStream_t>(stream), codes);
}

// Contiguous caches: q [B, n_kv, g, hd] float32/bfloat16; k_cache and
// v_cache [B, S, n_kv, hd] float32, bfloat16 or float8_e4m3fn (kv_kind
// as above); lengths [B] int32 (any values: the kernels clamp them to
// [0, S]); partitions of `part` positions; work float32
// [B, n_kv, ceil(S / part), g, hd + 2] and the flag words, as above (may
// be null when that is 1); out float32 of q's shape.  Zero-length rows
// get zeros.
extern "C" int decode_gqa_launch(
    const void* q, int q_bf16, const void* k_cache, const void* v_cache,
    int kv_kind, const void* lengths, void* work, void* out, int B, int S,
    int n_kv, int g, int hd, int part, float scale, void* stream) {
  const split::Shape s{B, n_kv, g, hd, 1, S, part};
  // a lane's pool row b*S + t is an int
  if (!split::valid_shape(s) || (long long)B * S >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return (int)split::launch_float<__nv_bfloat16>(
        kv_kind, q, k_cache, v_cache, nullptr, lengths, work, out, s, scale,
        st);
  return (int)split::launch_float<float>(kv_kind, q, k_cache, v_cache,
                                         nullptr, lengths, work, out, s,
                                         scale, st);
}
