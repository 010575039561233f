// Column-major gather of feature-major table columns:
// out[p, j] = table[p, cols[j]] for every sublane p < dp, into a new
// [dp, n] float32 array; a column outside [0, vc) (the sentinel
// (2**31-2) // fold that pads the unique ids) gives zeros.
//
// Replaces mindrec_tpu/ops/pallas/stream_gather.py:streamed_gather, which
// streamed every tile of the [Dp, Vc] table through VMEM, placed the
// columns with one-hot matmuls and read-modify-wrote the output chunks
// that adjacent tiles share (and left the chunks that no tile visits, the
// sentinel tail, unwritten).  Here only the named columns are read.  Both
// arrays are feature-major, so thread j of a warp reads table[p, cols[j]]
// (the step's columns are sorted, so the 32 reads of a warp fall on few
// 32-byte sectors, and equal columns on one) and the warp writes
// out[p, j0 .. j0 + 31] as one 128-byte line.  A thread keeps its column
// and issues kRows independent loads before the stores, so a warp has
// several loads in flight.  Bound: bytes - cols read once (4 B each), each
// distinct live column's dp values read once, dp * n float32 written.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // sublanes per thread (grid.y covers dp)

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const T* __restrict__ table, int64_t vc, int dp,
                   const int* __restrict__ cols, int64_t n,
                   float* __restrict__ out) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (j >= n) return;
  const int c = cols[j];
  const bool live = c >= 0 && c < vc;
  const int p0 = blockIdx.y * kRows;
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = p0 + r;
    v[r] = (live && p < dp)
               ? mr::to_f(table[static_cast<int64_t>(p) * vc + c])
               : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = p0 + r;
    if (p < dp) out[static_cast<int64_t>(p) * n + j] = v[r];
  }
}

}  // namespace

// table: [dp, vc] f32 or bf16 (table_bf16), feature-major; cols: [n] i32;
// out: [dp, n] f32.
extern "C" int mr_gather_cols(const void* table, int table_bf16, int64_t vc,
                              int dp, const int* cols, int64_t n, float* out,
                              void* stream) {
  if (dp <= 0 || dp > 65535 * kRows || n < 0 || vc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(mr::blocks_for(n, kThreads),
            static_cast<unsigned>((dp + kRows - 1) / kRows));
  if (table_bf16) {
    gather_cols_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), vc, dp, cols, n, out);
  } else {
    gather_cols_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(table), vc, dp, cols, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
