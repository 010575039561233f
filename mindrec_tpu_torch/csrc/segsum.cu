// Sorted segment-sum: out[d, u] = sum of g[n, d] over positions n with
// uidx_sorted[n] == u, summed in float32.
//
// Replaces mindrec_tpu/ops/pallas/stream_segsum.py:streamed_segsum
// (row_major=True), which built a one-hot [W, C] matrix per 256-row
// chunk and summed on the TPU's matrix unit to avoid scatters.  Here the
// sort already groups each segment into a contiguous run of rows, so no
// one-hot and no atomics are needed.  Three passes:
//   1. segment_bounds: one thread per position marks where each run
//      starts and ends (seg[0:n_out] / seg[n_out:2*n_out]);
//   2. chunk_sum: one warp per chunk of kChunk consecutive positions,
//      lanes across the D columns, walks its rows in order.  A segment
//      that lies wholly inside the chunk is written to column u of the
//      [D, n_out] output (the reference's layout); the part of a segment
//      that crosses a chunk edge goes to partial[chunk][slot] (slot 0 for
//      the chunk's first segment, 1 for its last);
//   3. span_sum: one warp per segment; a segment that crosses chunk
//      edges adds its partials in chunk order; an empty one writes 0.
// Every sum is taken in a fixed order, so the result is deterministic.
// Hot ids (thousands of positions after the sort) are split over many
// warps instead of one.  Bound: bytes - g is read once (N*D*2 bytes in
// bf16), uidx once, out written once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColsPerLane = 8;  // D <= 256
constexpr int kChunk = 64;          // positions per warp in chunk_sum

__global__ void segment_bounds(const int* __restrict__ uidx, int64_t n,
                               int n_out, int* __restrict__ seg_start,
                               int* __restrict__ seg_end) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int u = uidx[i];
  if (u < 0 || u >= n_out) return;
  if (i == 0 || uidx[i - 1] != u) seg_start[u] = static_cast<int>(i);
  if (i == n - 1 || uidx[i + 1] != u) seg_end[u] = static_cast<int>(i + 1);
}

// Write a finished run's sums: to out[:, u] when the whole segment lies
// in [a, b), else to the chunk's partial slot.
__device__ __forceinline__ void flush(const float* acc, int lane, int d,
                                      int u, int n_out, int a, int b,
                                      bool first, const int* seg_start,
                                      const int* seg_end, float* out,
                                      float* partial_row) {
  if (u < 0 || u >= n_out) return;
  bool whole = seg_start[u] >= a && seg_end[u] <= b;
  float* dst = whole ? nullptr : partial_row + (first ? 0 : d);
#pragma unroll
  for (int k = 0; k < kMaxColsPerLane; ++k) {
    int c = lane + 32 * k;
    if (c >= d) break;
    if (whole)
      out[static_cast<int64_t>(c) * n_out + u] = acc[k];
    else
      dst[c] = acc[k];
  }
}

template <typename T>
__global__ void chunk_sum(const T* __restrict__ g, const int* __restrict__ uidx,
                          int64_t n, int d, const int* __restrict__ seg_start,
                          const int* __restrict__ seg_end, int n_out,
                          float* __restrict__ out,
                          float* __restrict__ partial) {
  int64_t chunk =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  int64_t a = chunk * kChunk;
  if (a >= n) return;
  int64_t b = a + kChunk < n ? a + kChunk : n;
  float* prow = partial + chunk * 2 * d;
  float acc[kMaxColsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxColsPerLane; ++k) acc[k] = 0.f;
  int cur = uidx[a];
  bool first = true;
  for (int64_t i = a; i < b; ++i) {
    int u = uidx[i];
    if (u != cur) {
      flush(acc, lane, d, cur, n_out, static_cast<int>(a),
            static_cast<int>(b), first, seg_start, seg_end, out, prow);
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) acc[k] = 0.f;
      cur = u;
      first = false;
    }
    const T* row = g + i * d;
#pragma unroll
    for (int k = 0; k < kMaxColsPerLane; ++k) {
      int c = lane + 32 * k;
      if (c < d) acc[k] += mr::to_f(row[c]);
    }
  }
  flush(acc, lane, d, cur, n_out, static_cast<int>(a), static_cast<int>(b),
        first, seg_start, seg_end, out, prow);
}

__global__ void span_sum(const int* __restrict__ uidx, int d,
                         const int* __restrict__ seg_start,
                         const int* __restrict__ seg_end, int n_out,
                         const float* __restrict__ partial,
                         float* __restrict__ out) {
  int u = static_cast<int>(
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5);
  int lane = threadIdx.x & 31;
  if (u >= n_out) return;
  int s = seg_start[u], e = seg_end[u];
  int c0 = s / kChunk, c1 = (e - 1) / kChunk;
  if (e > s && c0 == c1) return;  // written whole by chunk_sum
  float acc[kMaxColsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxColsPerLane; ++k) acc[k] = 0.f;
  if (e > s) {
    for (int c = c0; c <= c1; ++c) {
      // slot 0 when u is the chunk's first segment, else slot 1
      int slot = uidx[static_cast<int64_t>(c) * kChunk] == u ? 0 : 1;
      const float* p = partial + (static_cast<int64_t>(c) * 2 + slot) * d;
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) {
        int col = lane + 32 * k;
        if (col < d) acc[k] += p[col];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxColsPerLane; ++k) {
    int col = lane + 32 * k;
    if (col < d) out[static_cast<int64_t>(col) * n_out + u] = acc[k];
  }
}

}  // namespace

// g: [n, d] bf16 (g_bf16 != 0) or f32, row-major; uidx: [n] i32,
// non-decreasing; seg: [2 * n_out] i32 scratch; partial:
// [ceil(n / kChunk), 2, d] f32 scratch; out: [d, n_out] f32.
extern "C" int mr_segsum_sorted(const void* g, int g_bf16, const int* uidx,
                                int64_t n, int d, int n_out, int* seg,
                                float* partial, float* out, void* stream) {
  if (d <= 0 || d > 32 * kMaxColsPerLane || n_out < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(seg, 0, sizeof(int) * 2 * static_cast<size_t>(n_out), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    segment_bounds<<<mr::blocks_for(n, kThreads), kThreads, 0, st>>>(
        uidx, n, n_out, seg, seg + n_out);
    int64_t chunks = (n + kChunk - 1) / kChunk;
    unsigned blocks = mr::blocks_for(chunks * 32, kThreads);
    if (g_bf16) {
      chunk_sum<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(g), uidx, n, d, seg, seg + n_out,
          n_out, out, partial);
    } else {
      chunk_sum<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(g), uidx, n, d, seg, seg + n_out, n_out,
          out, partial);
    }
  }
  span_sum<<<mr::blocks_for(static_cast<int64_t>(n_out) * 32, kThreads),
             kThreads, 0, st>>>(uidx, d, seg, seg + n_out, n_out, partial,
                                out);
  return static_cast<int>(cudaGetLastError());
}
