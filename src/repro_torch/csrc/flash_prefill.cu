// Chunked flash prefill over a paged KV cache, Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_prefill/flash_prefill.py:
//   flash_prefill_paged_kernel (#5), and
//   flash_prefill_paged_codes_kernel (#6): the same body over uint8
//   q/K/V codes with per-KV-head tables and a uint8 context out
//   (paged_attention.cuh's codes instantiation).
// A chunk of S queries per row, row 0 at absolute position q_start[b],
// attends the pages named by block_tables with validity
// kv_pos <= q_start+i and kv_pos < kv_lens[b].  The body is
// paged_attention.cuh; a block holds 32 query rows (32/g positions of
// the g query heads of one KV head), so each page load serves 32 rows.
// The TPU's sequential page grid axis becomes the loop inside a block;
// the scalar-prefetched table becomes the block reading its own row.
// Bound on an H100 at the serving shapes: the float32 dot products
// (operations), which run as scalar FMAs on shared-memory tiles here;
// sharing each page across 32 rows keeps the KV bytes read per
// operation low.  Tensor-core tiles are the next step.

#include "paged_attention.cuh"

extern "C" int flash_prefill_paged_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    int kv_bf16, const void* block_tables, const void* q_start,
    const void* kv_lens, void* out, int B, int S, int n_kv, int g, int hd,
    int bs, int max_blk, float scale, void* stream) {
  constexpr int R = 32;
  if (hd != paged::HD || g < 1 || R % g != 0 || bs < 1 || bs > 64)
    return (int)cudaErrorInvalidValue;
  const int qpb = R / g;
  const int tiles = (S + qpb - 1) / qpb;
  return (int)paged::launch_typed<R>(
      q, q_bf16, k_pages, v_pages, kv_bf16,
      static_cast<const int*>(block_tables), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_lens), out, B, S, n_kv, g, bs, max_blk, scale,
      /*decode=*/0, tiles, static_cast<cudaStream_t>(stream));
}

// Codes mode: q_codes [B, S, n_kv, g, 128] and pages uint8; q_lut [256],
// k_lut/v_lut [n_kv, 256] and out_qmeta [4] float32; out uint8 of q's
// shape.  Bound as the float kernel (the scalar dot products at a
// serving chunk); its pages are a quarter of the float32 bytes.
extern "C" int flash_prefill_paged_codes_launch(
    const void* q_codes, const void* k_pages, const void* v_pages,
    const void* q_lut, const void* k_lut, const void* v_lut,
    const void* out_qmeta, const void* block_tables, const void* q_start,
    const void* kv_lens, void* out, int B, int S, int n_kv, int g, int hd,
    int bs, int max_blk, float scale, void* stream) {
  constexpr int R = 32;
  if (hd != paged::HD || g < 1 || R % g != 0 || bs < 1 || bs > 64)
    return (int)cudaErrorInvalidValue;
  const int qpb = R / g;
  const int tiles = (S + qpb - 1) / qpb;
  const paged::Codes codes{static_cast<const float*>(q_lut),
                           static_cast<const float*>(k_lut),
                           static_cast<const float*>(v_lut),
                           static_cast<const float*>(out_qmeta)};
  return (int)paged::launch_codes<R>(
      q_codes, k_pages, v_pages, static_cast<const int*>(block_tables),
      static_cast<const int*>(q_start), static_cast<const int*>(kv_lens), out,
      B, S, n_kv, g, bs, max_blk, scale, /*decode=*/0, tiles,
      static_cast<cudaStream_t>(stream), codes);
}
