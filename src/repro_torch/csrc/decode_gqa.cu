// Flash decode over a paged or a contiguous KV cache, Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_gqa/decode_gqa.py:
//   decode_gqa_paged_kernel (#7) (body _paged_kernel -> _kernel): float32
//     or bfloat16 q and pages, float32 out;
//   decode_gqa_paged_codes_kernel (#8) (_paged_codes_kernel): the Codes
//     instantiation below;
//   decode_gqa_kernel (#9): the contiguous [B, S, n_kv, 128] cache of the
//     legacy serving path, decode_contig.cuh's body (tiles of 64
//     positions).  The TPU kernel's block_s=512 grid axis and its padding
//     of S are TPU tiling: the block walks its row's tiles in a loop and
//     masks the tail, so any S runs as it is.
//
// One query per row, masked by lengths[b]: logit = (q . k) / sqrt(128),
// -1e30 where kv_pos >= lengths[b]; the online softmax
//   m' = max(m, max_t logit); p = exp(logit - m'); corr = exp(m - m');
//   l' = l*corr + sum_t p;    acc' = acc*corr + sum_t p*v;
// out = acc / max(l, 1e-30), or zeros where m <= -5e29 (length 0).
//
// Paged split-KV body (#7, #8): flash-decoding over pages.
// Bounds on an H100: the page bytes up to lengths[b] (one read per KV
// head; the arithmetic is ~1 FLOP a byte for float32 pages).  At the
// serving shapes that is a few MB, microseconds at 3.35 TB/s, so the
// kernel's task is to keep enough loads in flight, on enough SMs:
// - Grid (B, n_kv, n_split).  A block owns one (row b, KV head h), the G
//   query heads of h (each page is read once per KV head) and one
//   partition of part_pages pages: positions [z*P, (z+1)*P), P =
//   part_pages*bs.  The wrapper chooses part_pages and n_split from
//   static shapes only (decode_gqa.py split_plan); lengths never reach
//   the host, so a step can be captured in a CUDA graph.  A block whose
//   partition starts at or past lengths[b] returns at once and writes
//   nothing: the merge folds only the partitions that start before the
//   length, which it reads on the device too.
// - Loads: a warp takes BATCH positions at a time, positions w*BATCH +
//   k*WARPS*BATCH of its partition; lane u < BATCH looks position u's
//   page up in block_tables once (any bs from 1 to 64; a position past
//   the length is clamped to the last live one, in bounds, and masked),
//   and the warp's lanes take its pool row by shuffle.  Lane i holds
//   dims 4i..4i+3 of every position: one 16-byte load a lane for
//   float32 (8 bytes bfloat16, 4 bytes codes), a whole warp per
//   position, and all 2*BATCH loads of a batch are issued before the
//   first is used.  No shared memory and no barrier in the loop.
// - Arithmetic: every lane is busy.  Each lane holds its 4 dims of the G
//   query rows; a dot is 4 FMAs and a 5-step __shfl_xor_sync butterfly,
//   which leaves the same sum in every lane, so each lane runs the
//   online softmax of the warp's rows in registers (the same values in
//   every lane) and scales its 4 dims of acc.  float32 FMA: at G <= 8
//   queries a KV head the products are too thin for tensor cores.
// - The 4 warps of a block merge once, at the end, in shared memory:
//   M = max_w m_w, l = sum_w l_w*exp(m_w - M), acc likewise.
// - Merge pass: a second kernel, grid (B, n_kv), folds a row's live
//   partials from the workspace [B, n_kv, n_split, G, 128 + 2] (acc, m,
//   l) with the same rule and flushes.  A second launch rather than a
//   last-arriving block under a counter: no counter state has to survive
//   between calls (or be reset inside a captured graph), and the order of
//   the sums is fixed, so the result does not depend on which block ends
//   last.  With n_split = 1 the split kernel flushes itself and the merge
//   is not launched.
// Codes instantiation (#8; uint8 q and pages): the block copies the q
// table and its KV head's K and V tables (3 x 256 floats) into shared
// memory once, and decodes q, K and V through them right after each
// load (the per-head gather of the reference's kernels/_codes.
// decode_heads).  Partials stay float32; the context is encoded under
// out_qmeta (dnateq.cuh) only at the flush, after the merge, never per
// partition.  Pages cross device memory at 1 B per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dnateq.cuh"
#include "decode_contig.cuh"

namespace split {

constexpr int HD = 128;
constexpr int THREADS = 128;     // == HD: the merges give thread d dim d
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 8;         // positions a warp loads at once
constexpr int WS = HD + 2;       // workspace row: acc[HD], m, l
constexpr unsigned FULL = 0xffffffffu;

struct Codes {
  const float* q_lut;
  const float* k_lut;
  const float* v_lut;
  const float* out_qmeta;
};

// A lane's 4 consecutive elements as they are loaded: 16 bytes of
// float32, 8 of bfloat16, 4 of uint8 codes.
template <typename T>
struct Raw;
template <>
struct Raw<float> { using type = float4; };
template <>
struct Raw<__nv_bfloat16> { using type = uint2; };
template <>
struct Raw<uint8_t> { using type = uint32_t; };

template <typename T>
__device__ __forceinline__ typename Raw<T>::type load4(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T>::type*>(p));
}

// ... as float32: as they are, converted, or decoded through a table.
__device__ __forceinline__ float4 to_f4(float4 v, const float*) { return v; }
__device__ __forceinline__ float4 to_f4(uint2 raw, const float*) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 to_f4(uint32_t raw, const float* lut) {
  return make_float4(lut[raw & 255u], lut[(raw >> 8) & 255u],
                     lut[(raw >> 16) & 255u], lut[raw >> 24]);
}

// One output element from its merged (m, l, acc): the reference's flush,
// then the encode for codes.
template <bool CODES>
__device__ __forceinline__ void flush(void* out, size_t i, float m, float l,
                                      float acc, const float* out_qmeta) {
  const float o = m > -5e29f ? acc / fmaxf(l, 1e-30f) : 0.0f;
  if constexpr (CODES) {
    static_cast<uint8_t*>(out)[i] = dnateq::encode(o, out_qmeta);
  } else {
    static_cast<float*>(out)[i] = o;
  }
}

// q [B, n_kv, G, HD]; pages [N, bs, n_kv, HD]; block_tables [B, max_blk];
// lengths [B]; work [B, n_kv, n_split, G, WS] (unused when n_split = 1);
// out [B, n_kv, G, HD] float32, or uint8 for codes.
template <int G, typename QT, typename PT>
__global__ void __launch_bounds__(THREADS)
split_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pages,
             const PT* __restrict__ v_pages,
             const int* __restrict__ block_tables,
             const int* __restrict__ lengths, float* __restrict__ work,
             void* __restrict__ out, int bs, int max_blk, int part_pages,
             float scale, Codes codes) {
  constexpr bool CODES = std::is_same_v<PT, uint8_t>;
  __shared__ float s_lut[CODES ? 3 * 256 : 1];     // q, K, V tables
  __shared__ float s_m[WARPS][G], s_l[WARPS][G];
  __shared__ __align__(16) float s_acc[WARPS][G][HD];

  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int n_kv = gridDim.y, n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the lengths' one clamp, here and in the merge: the wrapper has none
  const int kvl = max(0, min(lengths[b], max_blk * bs));
  const int t_begin = z * part_pages * bs;
  if (n_split > 1 && t_begin >= kvl) return;   // the merge skips it
  const int t_end = min(t_begin + part_pages * bs, kvl);

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

  float4 qv[G], acc[G];
  float m[G], l[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    qv[r] = to_f4(load4(q + (((size_t)b * n_kv + h) * G + r) * HD + 4 * lane),
                  s_ql);
    acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    m[r] = -1e30f;
    l[r] = 0.0f;
  }

  const int* bt_row = block_tables + (size_t)b * max_blk;
  for (int t0 = t_begin + warp * BATCH; t0 < t_end; t0 += WARPS * BATCH) {
    int row = 0;
    if (lane < BATCH) {
      const int t = min(t0 + lane, t_end - 1);
      const int pg = t / bs;
      row = __ldg(bt_row + pg) * bs + (t - pg * bs);
    }
    typename Raw<PT>::type kr[BATCH], vr[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int rw = __shfl_sync(FULL, row, u);
      const size_t off = ((size_t)rw * n_kv + h) * HD + 4 * lane;
      kr[u] = load4(k_pages + off);
      vr[u] = load4(v_pages + off);
    }
    float4 kf[BATCH], vf[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      kf[u] = to_f4(kr[u], s_kl);
      vf[u] = to_f4(vr[u], s_vl);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float s[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        s[u] = qv[r].x * kf[u].x + qv[r].y * kf[u].y + qv[r].z * kf[u].z +
               qv[r].w * kf[u].w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < BATCH; ++u) s[u] += __shfl_xor_sync(FULL, s[u], o);
      }
      float mx = -1e30f;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        s[u] = t0 + u < t_end ? s[u] * scale : -1e30f;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float ps = 0.0f;
      float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const float p = expf(s[u] - m_new);
        ps += p;
        pv.x += p * vf[u].x;
        pv.y += p * vf[u].y;
        pv.z += p * vf[u].z;
        pv.w += p * vf[u].w;
      }
      l[r] = l[r] * corr + ps;
      acc[r].x = acc[r].x * corr + pv.x;
      acc[r].y = acc[r].y * corr + pv.y;
      acc[r].z = acc[r].z * corr + pv.z;
      acc[r].w = acc[r].w * corr + pv.w;
      m[r] = m_new;
    }
  }

  // the block's warps, merged once; thread tid then owns dim tid
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
    *reinterpret_cast<float4*>(&s_acc[warp][r][4 * lane]) = acc[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float mb = s_m[0][r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mb = fmaxf(mb, s_m[w][r]);
    float lb = 0.0f, ab = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(s_m[w][r] - mb);
      lb += s_l[w][r] * c;
      ab += s_acc[w][r][tid] * c;
    }
    if (n_split == 1) {
      flush<CODES>(out, (((size_t)b * n_kv + h) * G + r) * HD + tid, mb, lb,
                   ab, codes.out_qmeta);
    } else {
      float* wr = work + ((((size_t)b * n_kv + h) * n_split + z) * G + r) * WS;
      wr[tid] = ab;
      if (tid == 0) {
        wr[HD] = mb;
        wr[HD + 1] = lb;
      }
    }
  }
}

// The merge pass: grid (B, n_kv); thread d folds dim d of each of the G
// rows over the partitions that start before lengths[b], then flushes.
template <int G, bool CODES>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ work, const int* __restrict__ lengths,
             void* __restrict__ out, int bs, int max_blk, int part_pages,
             int n_split, const float* __restrict__ out_qmeta) {
  const int b = blockIdx.x, h = blockIdx.y, n_kv = gridDim.y;
  const int tid = threadIdx.x;
  const int part = part_pages * bs;
  const int kvl = max(0, min(lengths[b], max_blk * bs));
  const int n_live = min((kvl + part - 1) / part, n_split);
  const float* w0 = work + ((size_t)b * n_kv + h) * n_split * G * WS;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const float* wr = w0 + r * WS;
    float mm = -1e30f;
    for (int i = 0; i < n_live; ++i) mm = fmaxf(mm, wr[(size_t)i * G * WS + HD]);
    float ll = 0.0f, aa = 0.0f;
    for (int i = 0; i < n_live; ++i) {
      const float* wi = wr + (size_t)i * G * WS;
      const float c = expf(wi[HD] - mm);
      ll += wi[HD + 1] * c;
      aa += wi[tid] * c;
    }
    flush<CODES>(out, (((size_t)b * n_kv + h) * G + r) * HD + tid, mm, ll, aa,
                 out_qmeta);
  }
}

template <int G, typename QT, typename PT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* lengths, void* work, void* out,
                   int B, int n_kv, int bs, int max_blk, int part_pages,
                   float scale, cudaStream_t st, Codes codes) {
  constexpr bool CODES = std::is_same_v<PT, uint8_t>;
  const int n_split = (max_blk + part_pages - 1) / part_pages;
  const int* ln = static_cast<const int*>(lengths);
  split_kernel<G, QT, PT><<<dim3(B, n_kv, n_split), THREADS, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const int*>(bt), ln,
      static_cast<float*>(work), out, bs, max_blk, part_pages, scale, codes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  merge_kernel<G, CODES><<<dim3(B, n_kv), THREADS, 0, st>>>(
      static_cast<const float*>(work), ln, out, bs, max_blk, part_pages,
      n_split, codes.out_qmeta);
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v,
                     const void* bt, const void* lengths, void* work,
                     void* out, int B, int n_kv, int bs, int max_blk,
                     int part_pages, float scale, cudaStream_t st,
                     Codes codes) {
  switch (g) {
#define REPRO_SPLIT_CASE(G)                                                 \
  case G:                                                                   \
    return launch<G, QT, PT>(q, k, v, bt, lengths, work, out, B, n_kv, bs,  \
                             max_blk, part_pages, scale, st, codes);
    REPRO_SPLIT_CASE(1)
    REPRO_SPLIT_CASE(2)
    REPRO_SPLIT_CASE(4)
    REPRO_SPLIT_CASE(8)
#undef REPRO_SPLIT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool valid_shape(int hd, int bs, int max_blk, int part_pages) {
  return hd == HD && bs >= 1 && bs <= 64 && max_blk >= 1 && part_pages >= 1 &&
         (long long)max_blk * bs < (1ll << 30);
}

}  // namespace split

// q [B, n_kv, g, 128] float32/bfloat16; pages [N, bs, n_kv, 128]
// float32/bfloat16; block_tables [B, max_blk] and lengths [B] int32
// (any values: the kernels clamp them to [0, max_blk * bs]);
// work float32 [B, n_kv, n_split, g, 130] with n_split =
// ceil(max_blk / part_pages) (may be null when that is 1); out float32
// of q's shape.  Zero-length rows get zeros.
extern "C" int decode_gqa_paged_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    int kv_bf16, const void* block_tables, const void* lengths, void* work,
    void* out, int B, int n_kv, int g, int hd, int bs, int max_blk,
    int part_pages, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!split::valid_shape(hd, bs, max_blk, part_pages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const split::Codes none{nullptr, nullptr, nullptr, nullptr};
#define REPRO_PAGED(QT, PT)                                                   \
  return (int)split::launch_g<QT, PT>(g, q, k_pages, v_pages, block_tables,   \
                                      lengths, work, out, B, n_kv, bs,        \
                                      max_blk, part_pages, scale, st, none)
  if (q_bf16 && kv_bf16) REPRO_PAGED(bf16, bf16);
  if (q_bf16) REPRO_PAGED(bf16, float);
  if (kv_bf16) REPRO_PAGED(float, bf16);
  REPRO_PAGED(float, float);
#undef REPRO_PAGED
}

// Codes mode: q_codes [B, n_kv, g, 128] and pages uint8; q_lut [256],
// k_lut/v_lut [n_kv, 256], out_qmeta [4] float32; work as above; out
// uint8 of q's shape.
extern "C" int decode_gqa_paged_codes_launch(
    const void* q_codes, const void* k_pages, const void* v_pages,
    const void* q_lut, const void* k_lut, const void* v_lut,
    const void* out_qmeta, const void* block_tables, const void* lengths,
    void* work, void* out, int B, int n_kv, int g, int hd, int bs,
    int max_blk, int part_pages, float scale, void* stream) {
  if (!split::valid_shape(hd, bs, max_blk, part_pages))
    return (int)cudaErrorInvalidValue;
  const split::Codes codes{static_cast<const float*>(q_lut),
                           static_cast<const float*>(k_lut),
                           static_cast<const float*>(v_lut),
                           static_cast<const float*>(out_qmeta)};
  return (int)split::launch_g<uint8_t, uint8_t>(
      g, q_codes, k_pages, v_pages, block_tables, lengths, work, out, B, n_kv,
      bs, max_blk, part_pages, scale, static_cast<cudaStream_t>(stream),
      codes);
}

// Contiguous caches: q [B, n_kv, g, 128] float32/bfloat16; k_cache and
// v_cache [B, S, n_kv, 128] float32/bfloat16; lengths [B] in [0, S];
// out float32 of q's shape.  Zero-length rows get zeros.
extern "C" int decode_gqa_launch(
    const void* q, int q_bf16, const void* k_cache, const void* v_cache,
    int kv_bf16, const void* lengths, void* out, int B, int S, int n_kv,
    int g, int hd, float scale, void* stream) {
  constexpr int tile = 64;   // cache positions per shared-memory tile
  if (hd != contig::HD || S < 1) return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONTIG_CASE(G)                                                  \
  case G:                                                                     \
    return (int)contig::launch_typed<G>(q, q_bf16, k_cache, v_cache, kv_bf16, \
                                        ln, o, B, n_kv, tile, S, scale, st);
  switch (g) {
    REPRO_CONTIG_CASE(1)
    REPRO_CONTIG_CASE(2)
    REPRO_CONTIG_CASE(4)
    REPRO_CONTIG_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CONTIG_CASE
}
