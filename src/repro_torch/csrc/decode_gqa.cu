// Flash decode over a paged KV cache, Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_gqa/decode_gqa.py:
//   decode_gqa_paged_kernel (#7) (body _paged_kernel -> _kernel).
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
