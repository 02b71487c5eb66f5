// Paged online-softmax attention body of the decode kernels (the
// reference shares one body the same way: decode_gqa.py's _paged_kernel
// -> _kernel).  Chunked prefill has its own tensor-core kernel,
// flash_prefill.cu.
//
// One block = one (row b, KV head h, query tile).  It holds R query rows
// of that KV head -- R/g query positions times the g query heads that
// share the head -- in shared memory, reads its own block_tables row and
// walks the row's pages in order.  Each K/V page is loaded once per block
// (shared by all R rows, so the g query heads of a KV head share every
// page load), upcast to float32 after the load, and folded into the
// running (m, l, acc) with the reference's exact recurrence:
//   logit = (q . k) * scale, masked to -1e30 unless
//           kv_pos <= q_pos and kv_pos < kv_len,
//   m' = max(m, max_t logit); p = exp(logit - m'); corr = exp(m - m');
//   l' = l*corr + sum_t p;    acc' = acc*corr + sum_t p*v,
// and at the flush out = acc / max(l, 1e-30), or zeros for a row whose m
// never rose above -5e29.  Pages past the last position any row of the
// tile may see are skipped: every row has seen position 0 by then (its
// m is finite), so such a page would only add exp(-1e30 - m) = 0.
//
// Thread d (of HD = 128) owns output dimension d for all R rows.
// Bounds on an H100: KV bytes (one page read per block); the paged walk
// still waits on one load per position (the CONTIG branch batches them).
//
// Contiguous instantiation (CONTIG = true): the cache is [B, cache_s,
// n_kv, HD] per row, with no block table.  A "page" is then a tile of
// bs consecutive positions, read at ((b*cache_s + t)*n_kv + h)*HD, 16
// positions' loads in flight at once; positions at or past kv_len (the
// last tile's tail, or a row shorter than the cache) are stored as 0.0
// and masked to -1e30 like any other, so the cache needs no padding to
// a multiple of the tile.
//
// Codes instantiation (CODES = true; q and pages uint8 DNA-TEQ codes):
// the block copies the q table and its own KV head's K and V tables
// (3 x 256 floats) into shared memory first, decodes q, K and V through
// them right after each load -- the per-head gather of the reference's
// kernels/_codes.decode_heads -- and runs the same recurrence, then
// encodes the context under out_qmeta at the flush (dnateq.cuh), so the
// output leaves as uint8 codes.  Pages cross device memory at 1 B per
// element, a quarter of float32 pages.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dnateq.cuh"

namespace paged {

constexpr int HD = 128;
constexpr int THREADS = 128;
constexpr int CONTIG_BATCH = 16;   // contiguous positions loaded at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The codes mode's tables: q [256], K and V [n_kv, 256], and the
// context's out params [4].  All null for float operands.
struct Codes {
  const float* q_lut;
  const float* k_lut;
  const float* v_lut;
  const float* out_qmeta;
};

inline size_t smem_bytes(int R, int bs, bool codes) {
  return sizeof(float) *
         ((size_t)R * HD + (size_t)bs * (HD + 1) + (size_t)bs * HD +
          (size_t)R * bs + 3 * (size_t)R + (codes ? 3 * 256 : 0));
}

// An operand element as float32: converted, or decoded through a table.
template <bool CODES, typename T>
__device__ __forceinline__ float operand(T v, const float* lut) {
  if constexpr (CODES) {
    return lut[v];
  } else {
    return to_f32(v);
  }
}

// q [B, S, n_kv, g, HD]; pages [N, bs, n_kv, HD]; block_tables
// [B, max_blk]; out [B, S, n_kv, g, HD] float32 (uint8 codes when
// CODES).  decode=1 reads kv_lens as the decode lengths and puts the
// single query at position len-1 (validity then reduces to kv_pos < len).
// CONTIG: k_pages/v_pages are the [B, cache_s, n_kv, HD] caches,
// block_tables is unused, and max_blk = ceil(cache_s / bs) tiles.
template <int R, typename QT, typename KT, bool CODES, bool CONTIG>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                 const KT* __restrict__ v_pages,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ q_start,
                 const int* __restrict__ kv_lens, void* __restrict__ out,
                 int S, int n_kv, int g, int bs, int max_blk, float scale,
                 int decode, Codes codes, int cache_s) {
  extern __shared__ float smem[];
  float* s_q = smem;                    // [R][HD]
  float* s_k = s_q + R * HD;            // [bs][HD + 1]
  float* s_v = s_k + bs * (HD + 1);     // [bs][HD]
  float* s_p = s_v + bs * HD;           // [R][bs]
  float* s_m = s_p + R * bs;            // [R]
  float* s_l = s_m + R;                 // [R]
  float* s_c = s_l + R;                 // [R]
  float* s_ql = s_c + R;                // [256] (codes only)
  float* s_kl = s_ql + 256;             // [256] this KV head's K table
  float* s_vl = s_kl + 256;             // [256] this KV head's V table

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int qpb = R / g;
  const int qi0 = blockIdx.z * qpb;
  const int kvl = CONTIG ? min(kv_lens[b], cache_s) : kv_lens[b];
  const int qs = decode ? kvl - 1 : q_start[b];

  if constexpr (CODES) {
    for (int c = tid; c < 256; c += THREADS) {
      s_ql[c] = codes.q_lut[c];
      s_kl[c] = codes.k_lut[(size_t)h * 256 + c];
      s_vl[c] = codes.v_lut[(size_t)h * 256 + c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = qi0 + r / g, gi = r % g;
    s_q[r * HD + tid] =
        qi < S ? operand<CODES>(
                     q[((((size_t)b * S + qi) * n_kv + h) * g + gi) * HD + tid], s_ql)
               : 0.0f;
  }
  if (tid < R) {
    s_m[tid] = -1e30f;
    s_l[tid] = 0.0f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  int n_pages = 0;
  if (kvl > 0) {
    const int q_last = min(S - 1, qi0 + qpb - 1);
    n_pages = min(min((kvl + bs - 1) / bs, (qs + q_last) / bs + 1), max_blk);
  }
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    if constexpr (CONTIG) {
      // CONTIG_BATCH positions at a time: every load of a batch is
      // issued before the first is used (a dead position loads the
      // row's last live one, in bounds, and is then zeroed), so a
      // batch costs one memory latency, not one per position
      for (int t0 = 0; t0 < bs; t0 += CONTIG_BATCH) {
        float kr[CONTIG_BATCH], vr[CONTIG_BATCH];
#pragma unroll
        for (int u = 0; u < CONTIG_BATCH; ++u) {
          const int pos = min(j * bs + t0 + u, kvl - 1);
          const size_t off = (((size_t)b * cache_s + pos) * n_kv + h) * HD + tid;
          kr[u] = operand<CODES>(k_pages[off], s_kl);
          vr[u] = operand<CODES>(v_pages[off], s_vl);
        }
#pragma unroll
        for (int u = 0; u < CONTIG_BATCH; ++u) {
          const int t = t0 + u;
          if (t < bs) {
            const bool live = j * bs + t < kvl;
            s_k[t * (HD + 1) + tid] = live ? kr[u] : 0.0f;
            s_v[t * HD + tid] = live ? vr[u] : 0.0f;
          }
        }
      }
    } else {
      const size_t page = (size_t)block_tables[(size_t)b * max_blk + j];
      for (int t = 0; t < bs; ++t) {
        const size_t off = ((page * bs + t) * n_kv + h) * HD + tid;
        s_k[t * (HD + 1) + tid] = operand<CODES>(k_pages[off], s_kl);
        s_v[t * HD + tid] = operand<CODES>(v_pages[off], s_vl);
      }
    }
    __syncthreads();
    for (int p = tid; p < R * bs; p += THREADS) {
      const int r = p / bs, t = p % bs;
      const float* qr = s_q + r * HD;
      const float* kt = s_k + t * (HD + 1);
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += qr[d] * kt[d];
      const int kv_pos = j * bs + t;
      const int q_pos = qs + qi0 + r / g;
      const bool valid = kv_pos <= q_pos && kv_pos < kvl;
      s_p[r * bs + t] = valid ? dot * scale : -1e30f;
    }
    __syncthreads();
    if (tid < R) {
      float* pr = s_p + tid * bs;
      const float m_prev = s_m[tid];
      float mx = pr[0];
      for (int t = 1; t < bs; ++t) mx = fmaxf(mx, pr[t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = 0; t < bs; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      s_l[tid] = s_l[tid] * corr + sum;
      s_m[tid] = m_new;
      s_c[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* pr = s_p + r * bs;
      float pv = 0.0f;
      for (int t = 0; t < bs; ++t) pv += pr[t] * s_v[t * HD + tid];
      acc[r] = acc[r] * s_c[r] + pv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = qi0 + r / g, gi = r % g;
    if (qi >= S) continue;
    const float o = s_m[r] > -5e29f ? acc[r] / fmaxf(s_l[r], 1e-30f) : 0.0f;
    const size_t i = ((((size_t)b * S + qi) * n_kv + h) * g + gi) * HD + tid;
    if constexpr (CODES) {
      static_cast<uint8_t*>(out)[i] = dnateq::encode(o, codes.out_qmeta);
    } else {
      static_cast<float*>(out)[i] = o;
    }
  }
}

// Launch one instantiation with dynamic shared memory sized for bs.
template <int R, typename QT, typename KT, bool CODES = false,
          bool CONTIG = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* bt, const int* qs, const int* kl, void* out,
                   int B, int S, int n_kv, int g, int bs, int max_blk,
                   float scale, int decode, int tiles, cudaStream_t st,
                   Codes codes = Codes{nullptr, nullptr, nullptr, nullptr},
                   int cache_s = 0) {
  const size_t smem = smem_bytes(R, bs, CODES);
  auto kern = attention_kernel<R, QT, KT, CODES, CONTIG>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, n_kv, tiles);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), bt, qs, kl, out, S, n_kv, g, bs, max_blk,
      scale, decode, codes, cache_s);
  return cudaGetLastError();
}

// The codes instantiation: uint8 q and pages, uint8 out.
template <int R>
cudaError_t launch_codes(const void* q, const void* k, const void* v,
                         const int* bt, const int* qs, const int* kl,
                         void* out, int B, int S, int n_kv, int g, int bs,
                         int max_blk, float scale, int decode, int tiles,
                         cudaStream_t st, Codes codes) {
  return launch<R, uint8_t, uint8_t, true>(q, k, v, bt, qs, kl, out, B, S,
                                           n_kv, g, bs, max_blk, scale,
                                           decode, tiles, st, codes);
}

// Dispatch on the q and page dtypes (float32 or bfloat16); CONTIG with
// the caches' length cache_s for the contiguous instantiation.
template <int R, bool CONTIG = false>
cudaError_t launch_typed(const void* q, int q_bf16, const void* k,
                         const void* v, int kv_bf16, const int* bt,
                         const int* qs, const int* kl, void* out, int B,
                         int S, int n_kv, int g, int bs, int max_blk,
                         float scale, int decode, int tiles, cudaStream_t st,
                         int cache_s = 0) {
  const Codes none{nullptr, nullptr, nullptr, nullptr};
  if (q_bf16 && kv_bf16)
    return launch<R, __nv_bfloat16, __nv_bfloat16, false, CONTIG>(
        q, k, v, bt, qs, kl, out, B, S, n_kv, g, bs, max_blk, scale, decode,
        tiles, st, none, cache_s);
  if (q_bf16)
    return launch<R, __nv_bfloat16, float, false, CONTIG>(
        q, k, v, bt, qs, kl, out, B, S, n_kv, g, bs, max_blk, scale, decode,
        tiles, st, none, cache_s);
  if (kv_bf16)
    return launch<R, float, __nv_bfloat16, false, CONTIG>(
        q, k, v, bt, qs, kl, out, B, S, n_kv, g, bs, max_blk, scale, decode,
        tiles, st, none, cache_s);
  return launch<R, float, float, false, CONTIG>(
      q, k, v, bt, qs, kl, out, B, S, n_kv, g, bs, max_blk, scale, decode,
      tiles, st, none, cache_s);
}

}  // namespace paged
