// Row-major gather of feature-major table columns into the unique-row
// buffer: buf[j, off + p] = table[p, cols[j]] for every sublane p < dp,
// in place; a slot whose column lies outside [0, vc) (the sentinel
// (2**31-2) // fold) keeps the buffer's content.
//
// Replaces mindrec_tpu/ops/pallas/stream_gather.py:streamed_gather_rows,
// which streamed every tile of the [Dp, Vc] table through VMEM and placed
// the columns with one-hot matmuls (a chunk schedule over sorted ids).
// Here only the touched columns are read.  The table is feature-major: a
// column's dp values lie 4*vc bytes apart, while the buffer is
// row-major.  So a block takes kSlots consecutive unique slots and, for
// each sublane p, its threads read table[p, cols[j]] across those slots
// (the columns are sorted, so neighbouring threads read nearby
// addresses), staging a [kSlots, dp] tile in shared memory; then each
// warp writes whole buffer rows as runs of consecutive lanes.  Duplicate
// columns (folded tables, the tiny group's arange(2048) // 8) only read.
// Bound: bytes - per slot its column (4 B), the dp values of each
// distinct touched column, and the dp written lanes of each valid slot.

#include "common.cuh"

namespace {

constexpr int kSlots = 32;    // unique slots per block
constexpr int kThreads = 256;
constexpr int kMaxDp = 256;   // sublanes staged per slot

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, int64_t vc, int dp,
                   const int* __restrict__ cols, int64_t n,
                   float* __restrict__ buf, int64_t width, int off) {
  __shared__ float tile[kSlots][kMaxDp + 1];
  __shared__ int scol[kSlots];
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kSlots;
  const int t = threadIdx.x;
  if (t < kSlots) {
    int c = j0 + t < n ? cols[j0 + t] : -1;
    scol[t] = (c >= 0 && c < vc) ? c : -1;
  }
  __syncthreads();
  // read: a warp covers the kSlots slots of one sublane
  const int s = t % kSlots;
  const int c = scol[s];
  if (c >= 0) {
    for (int p = t / kSlots; p < dp; p += kThreads / kSlots)
      tile[s][p] = mr::to_f(table[static_cast<int64_t>(p) * vc + c]);
  }
  __syncthreads();
  // write: a warp writes one slot's dp lanes at a time
  const int lane = t & 31;
  for (int r = t >> 5; r < kSlots; r += kThreads / 32) {
    if (scol[r] < 0) continue;
    float* row = buf + (j0 + r) * width + off;
    for (int p = lane; p < dp; p += 32) row[p] = tile[r][p];
  }
}

}  // namespace

// table: [dp, vc] f32 or bf16 (table_bf16), feature-major; cols: [n] i32;
// buf: [n, width] f32, row-major, written in lanes [off, off + dp).
extern "C" int mr_gather_rows(const void* table, int table_bf16, int64_t vc,
                              int dp, const int* cols, int64_t n, float* buf,
                              int64_t width, int off, void* stream) {
  if (dp <= 0 || dp > kMaxDp || off < 0 || off + dp > width || n < 0 ||
      vc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned blocks = static_cast<unsigned>((n + kSlots - 1) / kSlots);
  if (table_bf16) {
    gather_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), vc, dp, cols, n, buf, width,
        off);
  } else {
    gather_rows_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(table), vc, dp, cols, n, buf, width, off);
  }
  return static_cast<int>(cudaGetLastError());
}
