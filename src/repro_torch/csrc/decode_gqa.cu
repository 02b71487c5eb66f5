// Flash decode over a paged or a contiguous KV cache, Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_gqa/decode_gqa.py:
//   decode_gqa_paged_kernel (#7) (body _paged_kernel -> _kernel),
//   decode_gqa_paged_codes_kernel (#8): uint8 q and pages decoded through
//   per-KV-head tables in shared memory, the context encoded to uint8 at
//   the flush.  Bound by the page bytes, which are 1 B per element there;
//   and decode_gqa_kernel (#9): the contiguous [B, S, n_kv, 128] cache
//   of the legacy serving path (paged_attention.cuh's CONTIG
//   instantiation, tiles of 64 positions).  The TPU kernel's block_s=512
//   grid axis and its padding of S to a multiple of it are TPU tiling:
//   here a block walks its row's tiles in a loop and masks the tail, so
//   any S runs as it is.  Bound by the KV bytes up to lengths[b].
// One query per row, masked by lengths[b]: the shared body of
// paged_attention.cuh with S = 1 and the query at position len-1.  A
// block owns one (row, KV head) and its g query heads (R = g), so every
// K/V page is read once per KV head.  Bound by KV bytes; with only
// B*n_kv blocks in flight a split over pages (flash-decoding) is the
// next step for long caches.

#include "paged_attention.cuh"

extern "C" int decode_gqa_paged_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    int kv_bf16, const void* block_tables, const void* lengths, void* out,
    int B, int n_kv, int g, int hd, int bs, int max_blk, float scale,
    void* stream) {
  if (hd != paged::HD || bs < 1 || bs > 64) return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(G)                                                  \
  case G:                                                                     \
    return (int)paged::launch_typed<G>(q, q_bf16, k_pages, v_pages, kv_bf16,  \
                                       bt, nullptr, ln, out, B, 1, n_kv, g,   \
                                       bs, max_blk, scale, 1, 1, st);
  switch (g) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(4)
    REPRO_DECODE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

// Codes mode: q_codes [B, n_kv, g, 128] and pages uint8; q_lut [256],
// k_lut/v_lut [n_kv, 256], out_qmeta [4] float32; out uint8 of q's shape.
extern "C" int decode_gqa_paged_codes_launch(
    const void* q_codes, const void* k_pages, const void* v_pages,
    const void* q_lut, const void* k_lut, const void* v_lut,
    const void* out_qmeta, const void* block_tables, const void* lengths,
    void* out, int B, int n_kv, int g, int hd, int bs, int max_blk,
    float scale, void* stream) {
  if (hd != paged::HD || bs < 1 || bs > 64) return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const paged::Codes codes{static_cast<const float*>(q_lut),
                           static_cast<const float*>(k_lut),
                           static_cast<const float*>(v_lut),
                           static_cast<const float*>(out_qmeta)};
#define REPRO_DECODE_CODES_CASE(G)                                       \
  case G:                                                                \
    return (int)paged::launch_codes<G>(q_codes, k_pages, v_pages, bt,    \
                                       nullptr, ln, out, B, 1, n_kv, g,  \
                                       bs, max_blk, scale, 1, 1, st,     \
                                       codes);
  switch (g) {
    REPRO_DECODE_CODES_CASE(1)
    REPRO_DECODE_CODES_CASE(2)
    REPRO_DECODE_CODES_CASE(4)
    REPRO_DECODE_CODES_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CODES_CASE
}

// Contiguous caches: q [B, n_kv, g, 128] float32/bfloat16; k_cache and
// v_cache [B, S, n_kv, 128] float32/bfloat16; lengths [B] in [0, S];
// out float32 of q's shape.  Zero-length rows get zeros.
extern "C" int decode_gqa_launch(
    const void* q, int q_bf16, const void* k_cache, const void* v_cache,
    int kv_bf16, const void* lengths, void* out, int B, int S, int n_kv,
    int g, int hd, float scale, void* stream) {
  constexpr int tile = 64;   // cache positions per shared-memory tile
  if (hd != paged::HD || S < 1) return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lengths);
  const int tiles = (S + tile - 1) / tile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONTIG_CASE(G)                                                \
  case G:                                                                   \
    return (int)paged::launch_typed<G, true>(q, q_bf16, k_cache, v_cache,   \
                                             kv_bf16, nullptr, nullptr, ln, \
                                             out, B, 1, n_kv, g, tile,      \
                                             tiles, scale, 1, 1, st, S);
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
