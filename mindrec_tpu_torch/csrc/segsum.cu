// Sorted segment-sum: out[u, c] = sum of g[n, c] over positions n with
// uidx_sorted[n] == u, summed in float32 and stored row-major [n_out, D]
// (the wrapper hands the callers its transpose, the reference's
// [D, n_out] layout, which they copy anyway).
//
// Replaces mindrec_tpu/ops/pallas/stream_segsum.py:streamed_segsum
// (row_major=True), which built a one-hot [W, C] matrix per 256-row
// chunk and summed on the TPU's matrix unit to avoid scatters.  Here the
// sort already groups each segment into a contiguous run of rows, so no
// one-hot and no atomics are needed.  Four passes:
//   1. segment_bounds: one thread per position marks where each run
//      starts and ends (seg[0:n_out] / seg[n_out:2*n_out]);
//   2. chunk_sum: one warp per chunk of kChunk consecutive positions,
//      lanes across the D columns, walks its rows in order.  The chunk's
//      segment ids sit in two registers per lane (read by shuffles) and
//      rows are loaded kRows at a time ahead of the sums, so a warp keeps
//      several loads in flight.  A segment that lies wholly inside the
//      chunk is written as row u of out (one coalesced row); the part of
//      a segment that crosses a chunk edge goes to partial[chunk][slot]
//      (slot 0 for the chunk's first segment, 1 for its last);
//   3. span_sum: one warp per chunk; the segment that starts in the chunk
//      and crosses its end adds its partials in chunk order;
//   4. fill_empty: zeroes the rows of the ids in [0, n_out) outside
//      [uidx[0], uidx[n-1]]; uidx is monotone with unit steps (the
//      contract), so no other row is empty.
// Every sum is taken in a fixed order, so the result is deterministic.
// Hot ids (thousands of positions after the sort) are split over many
// warps instead of one.  Bound: bytes - g is read once (N*D*2 bytes in
// bf16), uidx once, out written once.
//
// Column-major sorted segment-sum (mr_segsum_cols, below): the same sum
// for gradients that arrive as [D, N] and leave as [D, n_out], replacing
// stream_segsum.py:streamed_segsum with row_major=False (the one-hot
// matmul contracted over the position axis).  It exists so that the
// feature-major step has no transpose around its sum.  Lanes run along
// positions, so reads coalesce along N.  cols_chunk_sum: one warp per
// chunk of kCChunk positions and kCRows feature rows walks the chunk 32
// positions at a time; a segmented warp scan (__shfl_up_sync, joined where
// the segment id kCRows rows share is equal) gives each lane its run's
// prefix sum, the lane's run carries over from the 32 positions before,
// and the lane at a run's end writes out[d, u] (runs of length 1, the
// common case, make that a coalesced line).  A run that crosses a chunk
// edge goes to partial[chunk][slot][d] (slot 0 for the chunk's first
// segment, 1 for its last) and cols_span_sum adds the partials of a
// crossing segment in chunk order (one thread per chunk and row, from the
// chunk where the segment starts).  cols_fill_empty zeroes the columns
// outside [uidx[0], uidx[n-1]].  Fixed order, no atomics: deterministic.
// Bound: bytes - g read once, uidx once, out written once.
//
// Unsorted segment-sum (mr_segsum_unsorted, below): the same sum for
// segment ids in any order with n_out <= 2048, into [D, n_out],
// replacing stream_segsum.py:streamed_segsum_unsorted (one resident
// [D, n_out] VMEM block and a one-hot matmul per 1024-row chunk).  Its
// trouble is contention: at the Outbrain recipe 1.7M positions fall on
// 16 live ids, and [2048 x 128] f32 (1 MB) does not fit a block's shared
// memory.  So each block privatises a 16-column slice of the sum over a
// range of positions ([n_out, 16] f32 in shared memory), and a second
// pass adds the blocks' partials in block order.  Inside a block no
// atomics are used: half-warp o owns the segments s with s % 16 == o and
// adds its positions in position order (lanes are the 16 columns), so
// every sum is taken in a fixed order and the result is deterministic.
// A block stages the segment ids of kUChunk positions in shared memory,
// lists each owner's positions, then loads kUBatch rows at a time per
// owner to keep loads in flight.  Bound: bytes - g read once, seg once,
// out written once.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kChunk = 64;  // positions per warp in chunk_sum
constexpr int kRows = 8;    // rows loaded ahead per warp
constexpr int kSpans = 4;   // partials loaded ahead per warp in span_sum

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

// Write a finished run's sums: to row u of out when the whole segment
// lies in [a, b), else to the chunk's partial slot.
template <int CPL>
__device__ __forceinline__ void flush(const float (&acc)[CPL], int lane,
                                      int d, int u, int n_out, int64_t a,
                                      int64_t b, bool first,
                                      const int* seg_start, const int* seg_end,
                                      float* out, float* partial_row) {
  if (u < 0 || u >= n_out) return;
  bool whole = seg_start[u] >= a && seg_end[u] <= b;
  float* dst = whole ? out + static_cast<int64_t>(u) * d
                     : partial_row + (first ? 0 : d);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    int c = lane + 32 * k;
    if (c < d) dst[c] = acc[k];
  }
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
chunk_sum(const T* __restrict__ g, const int* __restrict__ uidx, int64_t n,
          int d, const int* __restrict__ seg_start,
          const int* __restrict__ seg_end, int n_out, float* __restrict__ out,
          float* __restrict__ partial) {
  const int64_t chunk =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t a = chunk * kChunk;
  if (a >= n) return;
  const int len = static_cast<int>(n - a < kChunk ? n - a : kChunk);
  const int u_lo = lane < len ? uidx[a + lane] : 0;
  const int u_hi = 32 + lane < len ? uidx[a + 32 + lane] : 0;
  float* prow = partial + chunk * 2 * d;
  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  int cur = __shfl_sync(kFull, u_lo, 0);
  bool first = true;
  for (int i0 = 0; i0 < len; i0 += kRows) {
    float v[kRows][CPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T* row = g + (a + i0 + r) * d;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        int c = lane + 32 * k;
        v[r][k] = (i0 + r < len && c < d) ? mr::to_f(row[c]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= len) break;  // the same for every lane
      const int u = __shfl_sync(kFull, i < 32 ? u_lo : u_hi, i & 31);
      if (u != cur) {
        flush<CPL>(acc, lane, d, cur, n_out, a, a + len, first, seg_start,
                   seg_end, out, prow);
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
        cur = u;
        first = false;
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc[k] += v[r][k];
    }
  }
  flush<CPL>(acc, lane, d, cur, n_out, a, a + len, first, seg_start, seg_end,
             out, prow);
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
span_sum(const int* __restrict__ uidx, int64_t n, int d,
         const int* __restrict__ seg_start, const int* __restrict__ seg_end,
         int n_out, const float* __restrict__ partial,
         float* __restrict__ out) {
  const int64_t chunk =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t a = chunk * kChunk;
  if (a >= n) return;
  const int64_t b = a + kChunk < n ? a + kChunk : n;
  const int u = uidx[b - 1];  // the chunk's last segment
  if (u < 0 || u >= n_out) return;
  const int64_t s = seg_start[u], e = seg_end[u];
  if (s < a || e <= b) return;  // another chunk's, or written whole
  const int64_t c1 = (e - 1) / kChunk;
  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  for (int64_t c0 = chunk; c0 <= c1; c0 += kSpans) {
    float v[kSpans][CPL];
#pragma unroll
    for (int j = 0; j < kSpans; ++j) {
      const int64_t cc = c0 + j;
      // slot 0 when u is chunk cc's first segment, else slot 1
      const float* p = nullptr;
      if (cc <= c1)
        p = partial + (cc * 2 + (uidx[cc * kChunk] == u ? 0 : 1)) * d;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        int c = lane + 32 * k;
        v[j][k] = (p != nullptr && c < d) ? p[c] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSpans; ++j) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc[k] += v[j][k];
    }
  }
  float* dst = out + static_cast<int64_t>(u) * d;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    int c = lane + 32 * k;
    if (c < d) dst[c] = acc[k];
  }
}

// Zero the rows of out for ids in [0, n_out) that no position holds:
// those below uidx[0] and above uidx[n-1].
__global__ void fill_empty(const int* __restrict__ uidx, int64_t n, int d,
                           int n_out, float* __restrict__ out) {
  int lo = n_out, hi = n_out - 1;  // no positions: every row is empty
  if (n > 0) {
    lo = uidx[0];
    hi = uidx[n - 1];
    lo = lo < 0 ? 0 : (lo > n_out ? n_out : lo);
    hi = hi < -1 ? -1 : (hi > n_out - 1 ? n_out - 1 : hi);
  }
  const int64_t head = static_cast<int64_t>(lo) * d;
  const int64_t total = head + static_cast<int64_t>(n_out - 1 - hi) * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       t < total; t += stride)
    out[t < head ? t : static_cast<int64_t>(hi + 1) * d + (t - head)] = 0.f;
}

template <typename T, int CPL>
void launch_sorted(const void* g, const int* uidx, int64_t n, int d,
                   int n_out, int* seg, float* partial, float* out,
                   cudaStream_t st) {
  int64_t chunks = (n + kChunk - 1) / kChunk;
  unsigned blocks = mr::blocks_for(chunks * 32, kThreads);
  chunk_sum<T, CPL><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(g), uidx, n, d, seg, seg + n_out, n_out, out,
      partial);
  span_sum<CPL><<<blocks, kThreads, 0, st>>>(uidx, n, d, seg, seg + n_out,
                                              n_out, partial, out);
}

template <typename T>
void launch_sorted_cols(const void* g, const int* uidx, int64_t n, int d,
                        int n_out, int* seg, float* partial, float* out,
                        cudaStream_t st) {
  if (d <= 32)
    launch_sorted<T, 1>(g, uidx, n, d, n_out, seg, partial, out, st);
  else if (d <= 64)
    launch_sorted<T, 2>(g, uidx, n, d, n_out, seg, partial, out, st);
  else if (d <= 128)
    launch_sorted<T, 4>(g, uidx, n, d, n_out, seg, partial, out, st);
  else
    launch_sorted<T, 8>(g, uidx, n, d, n_out, seg, partial, out, st);
}

constexpr int kUCols = 16;                 // columns per block
constexpr int kUWarps = 8;
constexpr int kUOwners = 2 * kUWarps;     // half-warps per block
constexpr int kUThreads = 32 * kUWarps;
constexpr int kUChunk = 1024;             // positions staged per round
constexpr int kUBatch = 16;               // rows loaded at once per owner
constexpr int kUStride = kUCols + 1;      // acc row stride (banks)

size_t unsorted_smem(int n_out) {
  return sizeof(float) * static_cast<size_t>(n_out) * kUStride +
         sizeof(int) * kUChunk + sizeof(uint16_t) * kUOwners * kUChunk;
}

// Block (x, y): positions [x * per_block, ...) and columns
// [16 y, 16 y + 16); writes its sums to partial[x][col][s].
template <typename T>
__global__ void __launch_bounds__(kUThreads)
unsorted_partial(const T* __restrict__ g, const int* __restrict__ seg,
                 int64_t n, int d, int n_out, int64_t per_block,
                 float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* acc = smem;                                       // [n_out][17]
  int* sseg = reinterpret_cast<int*>(acc + static_cast<size_t>(n_out) * kUStride);
  uint16_t* list = reinterpret_cast<uint16_t*>(sseg + kUChunk);  // [16][kUChunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hl = lane & 15;
  const int owner = 2 * warp + (lane >> 4);
  const int col = blockIdx.y * kUCols + hl;
  const bool col_ok = col < d;
  uint16_t* mylist = list + owner * kUChunk;
  for (int i = tid; i < n_out * kUStride; i += kUThreads) acc[i] = 0.f;
  const int64_t a = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t b = a + per_block < n ? a + per_block : n;
  for (int64_t c0 = a; c0 < b; c0 += kUChunk) {
    const int len = static_cast<int>(b - c0 < kUChunk ? b - c0 : kUChunk);
    __syncthreads();  // the previous round's lists are consumed
    for (int i = tid; i < kUChunk; i += kUThreads) {
      int s = i < len ? seg[c0 + i] : -1;
      sseg[i] = (s >= 0 && s < n_out) ? s : -1;
    }
    __syncthreads();
    // list the positions of both owners of this warp, in order
    int cnt0 = 0, cnt1 = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < len; base += 32) {
      int s = sseg[base + lane];
      int o = s >= 0 ? s % kUOwners : -1;
      unsigned m0 = __ballot_sync(0xffffffffu, o == 2 * warp);
      unsigned m1 = __ballot_sync(0xffffffffu, o == 2 * warp + 1);
      if (o == 2 * warp)
        list[(2 * warp) * kUChunk + cnt0 + __popc(m0 & below)] =
            static_cast<uint16_t>(base + lane);
      if (o == 2 * warp + 1)
        list[(2 * warp + 1) * kUChunk + cnt1 + __popc(m1 & below)] =
            static_cast<uint16_t>(base + lane);
      cnt0 += __popc(m0);
      cnt1 += __popc(m1);
    }
    __syncwarp();
    const int cnt = (lane >> 4) ? cnt1 : cnt0;
    for (int k0 = 0; k0 < cnt; k0 += kUBatch) {
      float v[kUBatch];
#pragma unroll
      for (int k = 0; k < kUBatch; ++k) {
        v[k] = 0.f;
        if (k0 + k < cnt && col_ok)
          v[k] = mr::to_f(g[(c0 + mylist[k0 + k]) * d + col]);
      }
#pragma unroll
      for (int k = 0; k < kUBatch; ++k) {
        if (k0 + k < cnt) {
          int s = sseg[mylist[k0 + k]];
          acc[s * kUStride + hl] += v[k];
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<int64_t>(blockIdx.x) * d * n_out;
  for (int i = tid; i < kUCols * n_out; i += kUThreads) {
    int c = i / n_out, s = i - c * n_out;
    int cc = blockIdx.y * kUCols + c;
    if (cc < d) out[static_cast<int64_t>(cc) * n_out + s] = acc[s * kUStride + c];
  }
}

// out[c][s] = sum over blocks x, in order, of partial[x][c][s]
__global__ void unsorted_reduce(const float* __restrict__ partial,
                                int n_part, int64_t cells,
                                float* __restrict__ out) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= cells) return;
  float s = 0.f;
  for (int x = 0; x < n_part; ++x) s += partial[x * cells + i];
  out[i] = s;
}

constexpr int kCChunk = 256;  // positions per warp in cols_chunk_sum
constexpr int kCRows = 4;     // feature rows per warp
constexpr int kNoRun = INT32_MIN;      // no run is open
constexpr int kPadId = INT32_MIN + 1;  // lane past the chunk's end

template <typename T>
__global__ void __launch_bounds__(kThreads)
cols_chunk_sum(const T* __restrict__ g, const int* __restrict__ uidx,
               int64_t n, int d, int n_out, float* __restrict__ out,
               float* __restrict__ partial) {
  const int64_t chunk =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t a = chunk * kCChunk;
  if (a >= n) return;
  const int64_t b = a + kCChunk < n ? a + kCChunk : n;
  const int d0 = blockIdx.y * kCRows;
  const int first_u = uidx[a];
  // the chunk's first segment began in an earlier chunk
  const bool before = a > 0 && uidx[a - 1] == first_u;
  float carry[kCRows];
#pragma unroll
  for (int r = 0; r < kCRows; ++r) carry[r] = 0.f;
  int carry_u = kNoRun;
  for (int64_t i = a; i < b; i += 32) {
    const int64_t pos = i + lane;
    const bool valid = pos < b;
    const int u = valid ? uidx[pos] : kPadId;
    const bool end = valid && (pos + 1 >= n || uidx[pos + 1] != u);
    bool join[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int up = __shfl_up_sync(kFull, u, 1 << s);
      join[s] = lane >= (1 << s) && up == u;
    }
    const bool cont = u == carry_u;
    float val[kCRows];
#pragma unroll
    for (int r = 0; r < kCRows; ++r) {
      const int dd = d0 + r;
      float v = (valid && dd < d)
                    ? mr::to_f(g[static_cast<int64_t>(dd) * n + pos])
                    : 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const float t = __shfl_up_sync(kFull, v, 1 << s);
        if (join[s]) v += t;
      }
      if (cont) v += carry[r];
      val[r] = v;
    }
    if (end && u >= 0 && u < n_out) {
      const bool whole = !(before && u == first_u);
#pragma unroll
      for (int r = 0; r < kCRows; ++r) {
        const int dd = d0 + r;
        if (dd >= d) continue;
        if (whole)
          out[static_cast<int64_t>(dd) * n_out + u] = val[r];
        else
          partial[chunk * 2 * d + dd] = val[r];
      }
    }
    const bool last_end = __shfl_sync(kFull, end ? 1 : 0, 31) != 0;
    const int last_u = __shfl_sync(kFull, u, 31);
#pragma unroll
    for (int r = 0; r < kCRows; ++r) {
      const float t = __shfl_sync(kFull, val[r], 31);
      carry[r] = last_end ? 0.f : t;
    }
    carry_u = last_end ? kNoRun : last_u;
  }
  if (carry_u >= 0 && carry_u < n_out) {  // the run open at the chunk's end
    const int slot = carry_u == first_u ? 0 : 1;
#pragma unroll
    for (int r = 0; r < kCRows; ++r) {
      if (lane == r && d0 + r < d)
        partial[(chunk * 2 + slot) * d + d0 + r] = carry[r];
    }
  }
}

// Thread (chunk, row): if a segment starts in this chunk and crosses its
// end, add its partials in chunk order and write its column.
__global__ void cols_span_sum(const int* __restrict__ uidx, int64_t n, int d,
                              int n_out, const float* __restrict__ partial,
                              float* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t chunk = t / d;
  const int dd = static_cast<int>(t - chunk * d);
  const int64_t a = chunk * kCChunk, b = a + kCChunk;
  if (b >= n) return;  // the last chunk's runs end inside it
  const int u = uidx[b - 1];
  if (uidx[b] != u || u < 0 || u >= n_out) return;  // ends in this chunk
  const bool is_first = uidx[a] == u;
  if (is_first && a > 0 && uidx[a - 1] == u) return;  // began earlier
  float s = partial[(chunk * 2 + (is_first ? 0 : 1)) * d + dd];
  for (int64_t cc = chunk + 1;; ++cc) {
    s += partial[cc * 2 * d + dd];
    const int64_t e = (cc + 1) * kCChunk;
    if (e >= n || uidx[e] != u) break;
  }
  out[static_cast<int64_t>(dd) * n_out + u] = s;
}

// Zero the columns of out [d, n_out] that no position holds: those below
// uidx[0] and above uidx[n-1].
__global__ void cols_fill_empty(const int* __restrict__ uidx, int64_t n, int d,
                                int n_out, float* __restrict__ out) {
  int lo = n_out, hi = n_out - 1;  // no positions: every column is empty
  if (n > 0) {
    lo = uidx[0];
    hi = uidx[n - 1];
    lo = lo < 0 ? 0 : (lo > n_out ? n_out : lo);
    hi = hi < -1 ? -1 : (hi > n_out - 1 ? n_out - 1 : hi);
  }
  const int64_t col = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (col >= n_out || (col >= lo && col <= hi)) return;
  for (int dd = 0; dd < d; ++dd) out[static_cast<int64_t>(dd) * n_out + col] = 0.f;
}

template <typename T>
void launch_cols(const void* g, const int* uidx, int64_t n, int d, int n_out,
                 float* partial, float* out, cudaStream_t st) {
  const int64_t chunks = (n + kCChunk - 1) / kCChunk;
  dim3 grid(mr::blocks_for(chunks * 32, kThreads),
            static_cast<unsigned>((d + kCRows - 1) / kCRows));
  cols_chunk_sum<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(g), uidx,
                                               n, d, n_out, out, partial);
  cols_span_sum<<<mr::blocks_for(chunks * d, kThreads), kThreads, 0, st>>>(
      uidx, n, d, n_out, partial, out);
}

}  // namespace

// Floats of mr_segsum_cols's partial scratch for n positions of d rows.
extern "C" int64_t mr_segsum_cols_partial_len(int64_t n, int d) {
  return (n + kCChunk - 1) / kCChunk * 2 * d;
}

// g: [d, n] bf16 (g_bf16 != 0) or f32, feature-major; uidx: [n] i32,
// non-decreasing with unit steps; partial: [ceil(n / kCChunk), 2, d] f32
// scratch (mr_segsum_cols_partial_len floats); out: [d, n_out] f32, every
// column written.
extern "C" int mr_segsum_cols(const void* g, int g_bf16, const int* uidx,
                              int64_t n, int d, int n_out, float* partial,
                              float* out, void* stream) {
  if (d <= 0 || d > 65535 * kCRows || n_out < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (g_bf16)
      launch_cols<__nv_bfloat16>(g, uidx, n, d, n_out, partial, out, st);
    else
      launch_cols<float>(g, uidx, n, d, n_out, partial, out, st);
  }
  cols_fill_empty<<<mr::blocks_for(n_out, kThreads), kThreads, 0, st>>>(
      uidx, n, d, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// g: [n, d] bf16 (g_bf16 != 0) or f32; seg: [n] i32, any order; ids
// outside [0, n_out) add nothing; n_part: position ranges (blocks along
// x); partial: [n_part, d, n_out] f32 scratch; out: [d, n_out] f32.
extern "C" int mr_segsum_unsorted(const void* g, int g_bf16, const int* seg,
                                  int64_t n, int d, int n_out, int n_part,
                                  float* partial, float* out, void* stream) {
  if (d <= 0 || n_out < 0 || n_out > 2048 || n < 0 || n_part < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t per_block = (n + n_part - 1) / n_part;
  per_block = (per_block + kUChunk - 1) / kUChunk * kUChunk;
  if (per_block == 0) per_block = kUChunk;
  size_t smem = unsorted_smem(n_out);
  dim3 grid(static_cast<unsigned>(n_part),
            static_cast<unsigned>((d + kUCols - 1) / kUCols));
  cudaError_t err;
  if (g_bf16) {
    err = cudaFuncSetAttribute(unsorted_partial<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    unsorted_partial<__nv_bfloat16><<<grid, kUThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(g), seg, n, d, n_out, per_block,
        partial);
  } else {
    err = cudaFuncSetAttribute(unsorted_partial<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    unsorted_partial<float><<<grid, kUThreads, smem, st>>>(
        static_cast<const float*>(g), seg, n, d, n_out, per_block, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t cells = static_cast<int64_t>(d) * n_out;
  unsorted_reduce<<<mr::blocks_for(cells, 256), 256, 0, st>>>(partial, n_part,
                                                               cells, out);
  return static_cast<int>(cudaGetLastError());
}

// Floats of mr_segsum_sorted's partial scratch for n positions of d columns.
extern "C" int64_t mr_segsum_sorted_partial_len(int64_t n, int d) {
  return (n + kChunk - 1) / kChunk * 2 * d;
}

// g: [n, d] bf16 (g_bf16 != 0) or f32, row-major; uidx: [n] i32,
// non-decreasing with unit steps; seg: [2 * n_out] i32 scratch; partial:
// [ceil(n / kChunk), 2, d] f32 scratch (mr_segsum_sorted_partial_len
// floats); out: [n_out, d] f32.
extern "C" int mr_segsum_sorted(const void* g, int g_bf16, const int* uidx,
                                int64_t n, int d, int n_out, int* seg,
                                float* partial, float* out, void* stream) {
  if (d <= 0 || d > 256 || n_out < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(seg, 0, sizeof(int) * 2 * static_cast<size_t>(n_out), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    segment_bounds<<<mr::blocks_for(n, kThreads), kThreads, 0, st>>>(
        uidx, n, n_out, seg, seg + n_out);
    if (g_bf16)
      launch_sorted_cols<__nv_bfloat16>(g, uidx, n, d, n_out, seg, partial,
                                        out, st);
    else
      launch_sorted_cols<float>(g, uidx, n, d, n_out, seg, partial, out, st);
  }
  fill_empty<<<2 * 132, kThreads, 0, st>>>(uidx, n, d, n_out, out);
  return static_cast<int>(cudaGetLastError());
}
