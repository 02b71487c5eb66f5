// Lama bulk LUT operation, Hopper (sm_90a).
//
// Replaces src/repro/kernels/lama_bulk_op/lama_bulk_op.py:
//   lama_bulk_op_kernel (#10): out[g, i] = table[a[g], b[g, i]], the
//   paper's case study 1 (bulk LUT multiplication, Fig. 2): a scalar
//   operand per batch picks one table row, the vector operand's codes
//   pick columns within it.
// The TPU kernel scalar-prefetches a and lets the table BlockSpec's
// index map DMA row a[g] into VMEM (the "LUT activation").  Here a block
// stages that row in shared memory itself (an 8-bit row is 256 int32,
// 1 KiB; at most 8192 columns, 32 KiB), then every thread gathers its
// columns from it.  Grid: (batch g, spans of 4096 columns of b).  b is
// read in its own dtype (uint8 or int32), four codes per thread and
// load, and out is written with one 16-byte store per four elements, so
// a warp reads and writes 128 consecutive elements (coalesced both
// ways); scalar when the rows are not so aligned.  Codes outside the table are not clipped (the TPU kernel's
// take clips silently): they set a flag the wrapper raises on, and their
// elements are written as 0.  Bound on an H100: bytes -- b read once,
// out written once; a table row is read once per block, from L2 (the
// whole 8-bit table is 256 KiB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// four codes in one load
template <typename BT>
struct Vec4;
template <>
struct Vec4<uint8_t> {
  using T = uchar4;
};
template <>
struct Vec4<int> {
  using T = int4;
};

constexpr int THREADS = 256;
constexpr int SPAN = 4096;       // columns of b per block
constexpr int MAX_COLS = 8192;

// bad: bit 0 = a row code out of range, bit 1 = a column code.
template <typename BT, bool VEC>
__global__ void __launch_bounds__(THREADS)
lama_bulk_kernel(const int* __restrict__ a, const BT* __restrict__ b,
                 const int* __restrict__ table, int* __restrict__ out,
                 int* __restrict__ bad, int m, int rows, int cols) {
  extern __shared__ int s_row[];   // [cols]: the activated table row
  const int g = blockIdx.x;
  const int ag = a[g];
  const bool row_ok = ag >= 0 && ag < rows;
  for (int c = threadIdx.x; c < cols; c += THREADS)
    s_row[c] = row_ok ? table[(size_t)ag * cols + c] : 0;
  if (!row_ok && threadIdx.x == 0) atomicOr(bad, 1);
  __syncthreads();

  const size_t row0 = (size_t)g * m;
  const int i0 = blockIdx.y * SPAN;
  const int i1 = min(m, i0 + SPAN);
  bool oob = false;
  if constexpr (VEC) {
    // m, SPAN and i0 are multiples of 4, so a vector never crosses i1
#pragma unroll 4
    for (int i = i0 + threadIdx.x * 4; i < i1; i += THREADS * 4) {
      const auto v = *reinterpret_cast<const typename Vec4<BT>::T*>(b + row0 + i);
      const int c[4] = {static_cast<int>(v.x), static_cast<int>(v.y),
                        static_cast<int>(v.z), static_cast<int>(v.w)};
      int o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = c[j] >= 0 && c[j] < cols;
        oob |= !ok;
        o[j] = ok ? s_row[c[j]] : 0;
      }
      *reinterpret_cast<int4*>(out + row0 + i) = make_int4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int i = i0 + threadIdx.x; i < i1; i += THREADS) {
      const int c = static_cast<int>(b[row0 + i]);
      const bool ok = c >= 0 && c < cols;
      oob |= !ok;
      out[row0 + i] = ok ? s_row[c] : 0;
    }
  }
  if (oob) atomicOr(bad, 2);
}

template <typename BT, bool VEC>
cudaError_t launch(const void* a, const void* b, const void* table, void* out,
                   void* bad, int G, int m, int rows, int cols,
                   cudaStream_t st) {
  dim3 grid(G, (m + SPAN - 1) / SPAN);
  lama_bulk_kernel<BT, VEC><<<grid, THREADS, cols * sizeof(int), st>>>(
      static_cast<const int*>(a), static_cast<const BT*>(b),
      static_cast<const int*>(table), static_cast<int*>(out),
      static_cast<int*>(bad), m, rows, cols);
  return cudaGetLastError();
}

}  // namespace

// a int32 [G]; b uint8 (b_int32 = 0) or int32 [G, m]; table 4-byte
// elements [rows, cols]; out [G, m] of the table's element type; bad
// int32 [1], zeroed by the caller.  vec = 1 takes four codes per load
// and 16-byte stores (m a multiple of 4, b aligned to four codes, out to
// 16 bytes).
extern "C" int lama_bulk_op_launch(const void* a, const void* b,
                                   const void* table, void* out, void* bad,
                                   int G, int m, int rows, int cols,
                                   int b_int32, int vec, void* stream) {
  if (G < 1 || m < 1 || rows < 1 || cols < 1 || cols > MAX_COLS ||
      (m + SPAN - 1) / SPAN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_int32)
    return (int)(vec ? launch<int, true>(a, b, table, out, bad, G, m, rows, cols, st)
                     : launch<int, false>(a, b, table, out, bad, G, m, rows, cols, st));
  return (int)(vec ? launch<uint8_t, true>(a, b, table, out, bad, G, m, rows, cols, st)
                   : launch<uint8_t, false>(a, b, table, out, bad, G, m, rows, cols, st));
}
