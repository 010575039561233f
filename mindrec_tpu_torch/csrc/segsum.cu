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
// trouble on this card is contention: at the Outbrain recipe 1.7M
// positions fall on 16 live ids, so neither atomics nor one accumulator
// per id spread over the machine, and a float sum needs a fixed order to
// be deterministic.  The design sorts the *positions*, not the rows: a
// stable counting sort by id that touches only the 4-byte ids, then sums
// whole rows in sorted order, so a hot id is cut into equal pieces like
// any other.  Six small passes:
//   1. unsorted_rank: a block takes kGRange consecutive positions, a warp
//      a contiguous share of them, 32 at a time in order.
//      __match_any_sync ranks a position among the lanes of its id, a
//      per-warp counter array in shared memory ([warps, n_out] 16-bit)
//      among the warp's earlier positions; a prefix over the warps makes
//      it the rank inside the block (written as 16 bits) and leaves the
//      block's histogram row hist[block, :].  No atomics.
//   2. unsorted_block_scan: exclusive prefix of hist over the blocks, per
//      id, and the id's total.
//   3. unsorted_bases: one block scans the totals: base[s] (where id s
//      starts in sorted order), its rank among the ids that occur, and
//      the list of those ids.
//   4. unsorted_place: perm[base[s] + hist[block, s] + rank] = position,
//      one thread per position: a stable sort, so each id's positions are
//      in position order.
//   5. unsorted_chunk_sum: one warp per kUChunk consecutive sorted
//      entries.  The lanes span the row with one vector load each (8
//      bytes at D = 128 bf16, up to 16; streaming, a row is read once),
//      kURows rows in flight, the next 32 entries of perm fetched before
//      the current ones are summed.  A run's end is known from base, and
//      each (chunk, id) piece is written to row chunk + rank(id) of a
//      compact partial array (at most chunks + ids rows, each written by
//      one warp).
//   6. unsorted_combine: one block per id adds its pieces, which are
//      consecutive partial rows: warp w takes rows w, w + warps, ... in
//      order, the warps' sums are added in warp order, and column s of
//      out is written (zeros for an id without positions).
// Every sum has a fixed order: deterministic.  Bound: bytes - g read
// once (N*D*2 in bf16), seg once, out written once; the sort moves about
// 30 bytes per position beside a 256-byte row.

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

constexpr int kGWarps = 8;                 // warps per ranking block
constexpr int kGThreads = 32 * kGWarps;
constexpr int kGItems = 16;                // positions per lane
constexpr int kGRange = kGThreads * kGItems;  // positions per block
constexpr int kMaxOut = 2048;              // ids (shared-memory counters)
constexpr int kUChunk = 256;               // sorted entries per warp
constexpr int kURows = 8;                  // rows loaded ahead per warp
constexpr int kUWarps = 8;                 // warps per chunk_sum block
constexpr int kBWarps = 16;                // warps per combine block
constexpr int kBCols = 128;                // columns per combine round

// Pass 1.  rank[pos]: how many earlier positions of pos's block hold the
// same id; hist[block, s]: positions of id s in the block.
__global__ void __launch_bounds__(kGThreads)
unsorted_rank(const int* __restrict__ seg, int64_t n, int n_out,
              unsigned short* __restrict__ rank, int* __restrict__ hist) {
  __shared__ unsigned short cnt[kGWarps * kMaxOut];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kGWarps * n_out; i += kGThreads) cnt[i] = 0;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGRange +
                        warp * (32 * kGItems) + lane;
  unsigned short* mine = cnt + warp * n_out;
  int id[kGItems];
  unsigned short rk[kGItems];
#pragma unroll
  for (int k = 0; k < kGItems; ++k) {
    const int64_t pos = first + 32 * k;
    const int s = pos < n ? seg[pos] : -1;
    id[k] = (s >= 0 && s < n_out) ? s : -1;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kGItems; ++k) {
    const int s = id[k];
    const unsigned peers = __match_any_sync(kFull, s);
    const int r = __popc(peers & below);
    const int old = s >= 0 ? mine[s] : 0;
    __syncwarp();
    if (s >= 0 && r == 0)
      mine[s] = static_cast<unsigned short>(old + __popc(peers));
    __syncwarp();
    rk[k] = static_cast<unsigned short>(old + r);
  }
  __syncthreads();
  for (int s = tid; s < n_out; s += kGThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kGWarps; ++w) {
      const int c = cnt[w * n_out + s];
      cnt[w * n_out + s] = static_cast<unsigned short>(run);
      run += c;
    }
    hist[static_cast<int64_t>(blockIdx.x) * n_out + s] = run;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kGItems; ++k) {
    const int64_t pos = first + 32 * k;
    if (pos < n)
      rank[pos] = id[k] >= 0
                      ? static_cast<unsigned short>(mine[id[k]] + rk[k])
                      : static_cast<unsigned short>(0);
  }
}

// Pass 2.  hist[b, s] <- sum of hist[b', s] over b' < b; total[s] the
// sum over every block.  Block: 32 ids (lanes) x 8 shares of the blocks.
__global__ void __launch_bounds__(256)
unsorted_block_scan(int* __restrict__ hist, int n_blocks, int n_out,
                    int* __restrict__ total) {
  __shared__ int share[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  const bool ok = s < n_out;
  const int per = (n_blocks + 7) / 8;
  const int b0 = warp * per < n_blocks ? warp * per : n_blocks;
  const int b1 = b0 + per < n_blocks ? b0 + per : n_blocks;
  int sum = 0;
  if (ok)
    for (int b = b0; b < b1; ++b) sum += hist[static_cast<int64_t>(b) * n_out + s];
  share[warp][lane] = sum;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += share[w][lane];
  if (!ok) return;
  for (int b = b0; b < b1; ++b) {
    int* h = hist + static_cast<int64_t>(b) * n_out + s;
    const int c = *h;
    *h = off;
    off += c;
  }
  if (warp == 7) total[s] = off;
}

// Pass 3 (one block of 1024 threads, two ids each).  base[s]: sorted
// index where id s starts (base[n_out]: positions kept); rankp[s]: ids
// below s that occur; plist[j]: the j-th id that occurs.
__global__ void __launch_bounds__(1024)
unsorted_bases(const int* __restrict__ total, int n_out, int* __restrict__ base,
               int* __restrict__ rankp, int* __restrict__ plist) {
  __shared__ int wsum[2][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = 2 * t < n_out ? total[2 * t] : 0;
  const int c1 = 2 * t + 1 < n_out ? total[2 * t + 1] : 0;
  const int p0 = c0 > 0, p1 = c1 > 0;
  int cs = c0 + c1, ps = p0 + p1;  // inclusive scans over the threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, cs, o);
    const int b = __shfl_up_sync(kFull, ps, o);
    if (lane >= o) {
      cs += a;
      ps += b;
    }
  }
  if (lane == 31) {
    wsum[0][warp] = cs;
    wsum[1][warp] = ps;
  }
  __syncthreads();
  if (warp == 0) {
    const int a = wsum[0][lane], b = wsum[1][lane];
    int ia = a, ib = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, ia, o);
      const int y = __shfl_up_sync(kFull, ib, o);
      if (lane >= o) {
        ia += x;
        ib += y;
      }
    }
    wsum[0][lane] = ia - a;  // exclusive over the warps
    wsum[1][lane] = ib - b;
  }
  __syncthreads();
  const int ec = cs - (c0 + c1) + wsum[0][warp];  // exclusive, this thread
  const int ep = ps - (p0 + p1) + wsum[1][warp];
  if (t == 0) base[0] = 0;
  if (2 * t < n_out) {
    base[2 * t + 1] = ec + c0;
    rankp[2 * t] = ep;
    if (p0) plist[ep] = 2 * t;
  }
  if (2 * t + 1 < n_out) {
    base[2 * t + 2] = ec + c0 + c1;
    rankp[2 * t + 1] = ep + p0;
    if (p1) plist[ep + p0] = 2 * t + 1;
  }
}

// Pass 4.  perm[sorted index] = position: ids ascending, positions
// ascending inside an id.
__global__ void unsorted_place(const int* __restrict__ seg, int64_t n,
                               int n_out,
                               const unsigned short* __restrict__ rank,
                               const int* __restrict__ hist,
                               const int* __restrict__ base,
                               int* __restrict__ perm) {
  const int64_t pos = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (pos >= n) return;
  const int s = seg[pos];
  if (s < 0 || s >= n_out) return;
  perm[base[s] + hist[pos / kGRange * n_out + s] + rank[pos]] =
      static_cast<int>(pos);
}

template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// The 32-bit words of one load (a 2-byte load fills the low half).
__device__ __forceinline__ void words(unsigned short r, unsigned (&w)[4]) {
  w[0] = r;
}
__device__ __forceinline__ void words(unsigned int r, unsigned (&w)[4]) {
  w[0] = r;
}
__device__ __forceinline__ void words(uint2 r, unsigned (&w)[4]) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void words(uint4 r, unsigned (&w)[4]) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}

// Element k of a load of T values, as float32.
template <typename T>
__device__ __forceinline__ float element(const unsigned (&w)[4], int k);
template <>
__device__ __forceinline__ float element<float>(const unsigned (&w)[4], int k) {
  return __uint_as_float(w[k]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const unsigned (&w)[4],
                                                        int k) {
  return __uint_as_float((k & 1) ? (w[k >> 1] & 0xffff0000u) : (w[k >> 1] << 16));
}

// Row chunk + j of partial <- acc (this lane's E columns from col).
template <int E>
__device__ __forceinline__ void put_piece(const float (&acc)[E],
                                          float* __restrict__ partial,
                                          int64_t row, int d, int col) {
  float* dst = partial + row * d + col;
#pragma unroll
  for (int k = 0; k < E; ++k) dst[k] = acc[k];
}

// One lane's load of a row.  A load of 8 bytes or more means the row
// fills whole cache lines that nobody reads again: streaming.  Narrow
// rows (the [N, 1] presence counts) share their sectors with their
// neighbours in position order: cached.
template <typename R>
__device__ __forceinline__ R load_row(const R* p) {
  if constexpr (sizeof(R) >= 8)
    return __ldcs(p);
  else
    return __ldg(p);
}

// Pass 5.  Warp = chunk of kUChunk sorted entries; lane = E consecutive
// columns (one load of E * sizeof(T) bytes) of column group blockIdx.y.
template <typename T, int E>
__global__ void __launch_bounds__(32 * kUWarps)
unsorted_chunk_sum(const T* __restrict__ g, int d, int n_out,
                   const int* __restrict__ perm, const int* __restrict__ base,
                   const int* __restrict__ rankp, const int* __restrict__ plist,
                   float* __restrict__ partial) {
  using R = typename Raw<sizeof(T) * E>::type;
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      blockIdx.x * static_cast<int64_t>(kUWarps) + (threadIdx.x >> 5);
  const int64_t a = chunk * kUChunk;
  const int64_t kept = base[n_out];
  if (a >= kept) return;
  const int len = static_cast<int>(kept - a < kUChunk ? kept - a : kUChunk);
  const int col = (blockIdx.y * 32 + lane) * E;
  const bool active = col < d;  // d is a multiple of E
  int next_p = lane < len ? perm[a + lane] : 0;
  // the id that holds sorted entry a: the last s with base[s] <= a
  int lo = 0, hi = n_out;  // base[lo] <= a < base[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (base[mid] <= a)
      lo = mid;
    else
      hi = mid;
  }
  int j = rankp[lo];               // rank of the current id
  int64_t end = base[lo + 1] - a;  // its run ends here, chunk-local
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
  for (int b0 = 0; b0 < len; b0 += 32) {
    const int my_p = next_p;
    if (b0 + 32 < len)
      next_p = b0 + 32 + lane < len ? perm[a + b0 + 32 + lane] : 0;
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += kURows) {
      if (b0 + r0 >= len) break;  // the same for every lane
      R v[kURows];
#pragma unroll
      for (int r = 0; r < kURows; ++r) {
        const int64_t p = __shfl_sync(kFull, my_p, r0 + r);
        if (active && b0 + r0 + r < len)
          v[r] = load_row(reinterpret_cast<const R*>(g + p * d + col));
      }
#pragma unroll
      for (int r = 0; r < kURows; ++r) {
        const int i = b0 + r0 + r;
        if (i >= len) break;  // the same for every lane
        if (i == end) {       // the next id that occurs starts here
          if (active) put_piece<E>(acc, partial, chunk + j, d, col);
#pragma unroll
          for (int k = 0; k < E; ++k) acc[k] = 0.f;
          ++j;
          end = base[plist[j] + 1] - a;
        }
        if (active) {
          unsigned w[4];
          words(v[r], w);
#pragma unroll
          for (int k = 0; k < E; ++k) acc[k] += element<T>(w, k);
        }
      }
    }
  }
  if (active) put_piece<E>(acc, partial, chunk + j, d, col);
}

// Pass 6.  Block s: out[:, s] = sum of id s's pieces, rows
// first chunk + rank .. last chunk + rank of partial, in a fixed order.
__global__ void __launch_bounds__(32 * kBWarps)
unsorted_combine(const float* __restrict__ partial, int d, int n_out,
                 const int* __restrict__ base, const int* __restrict__ rankp,
                 float* __restrict__ out) {
  __shared__ float red[kBWarps][kBCols];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t a = base[s], e = base[s + 1];
  int64_t row0 = 0, rows = 0;
  if (e > a) {
    row0 = a / kUChunk + rankp[s];
    rows = (e - 1) / kUChunk - a / kUChunk + 1;
  }
  for (int c0 = 0; c0 < d; c0 += kBCols) {
    float acc[kBCols / 32];
#pragma unroll
    for (int k = 0; k < kBCols / 32; ++k) acc[k] = 0.f;
    for (int64_t r = warp; r < rows; r += 4 * kBWarps) {
      float v[4][kBCols / 32];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t rr = r + q * kBWarps;
#pragma unroll
        for (int k = 0; k < kBCols / 32; ++k) {
          const int c = c0 + lane + 32 * k;
          v[q][k] = (rr < rows && c < d) ? partial[(row0 + rr) * d + c] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 0; k < kBCols / 32; ++k) acc[k] += v[q][k];
      }
    }
#pragma unroll
    for (int k = 0; k < kBCols / 32; ++k) red[warp][lane + 32 * k] = acc[k];
    __syncthreads();
    for (int c = threadIdx.x; c < kBCols && c0 + c < d; c += 32 * kBWarps) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kBWarps; ++w) sum += red[w][c];
      out[static_cast<int64_t>(c0 + c) * n_out + s] = sum;
    }
    __syncthreads();
  }
}

// Ints of the sort's scratch: rank (16 bits each), hist, total, base,
// rankp, plist, perm.
struct UnsortedScratch {
  int64_t blocks, rank, hist, total, base, rankp, plist, perm, len;
  UnsortedScratch(int64_t n, int n_out) {
    blocks = (n + kGRange - 1) / kGRange;
    rank = 0;
    hist = rank + (n + 1) / 2;
    total = hist + blocks * n_out;
    base = total + n_out;
    rankp = base + n_out + 1;
    plist = rankp + n_out;
    perm = plist + n_out + 1;  // one past the last id that occurs is read
    len = perm + n;
  }
};

template <typename T, int E>
void launch_unsorted_sum(const void* g, int64_t n, int d, int n_out,
                         const int* scratch, const UnsortedScratch& o,
                         float* partial, cudaStream_t st) {
  dim3 grid(mr::blocks_for((n + kUChunk - 1) / kUChunk, kUWarps),
            static_cast<unsigned>((d + 32 * E - 1) / (32 * E)));
  unsorted_chunk_sum<T, E><<<grid, 32 * kUWarps, 0, st>>>(
      static_cast<const T*>(g), d, n_out, scratch + o.perm, scratch + o.base,
      scratch + o.rankp, scratch + o.plist, partial);
}

// The widest load (E elements, at most 16 bytes) that keeps every row
// aligned and, where the row allows, every lane busy.
template <typename T>
void launch_unsorted_vec(const void* g, int64_t n, int d, int n_out,
                         const int* scratch, const UnsortedScratch& o,
                         float* partial, cudaStream_t st) {
  constexpr int kMaxE = 16 / static_cast<int>(sizeof(T));
  int e = kMaxE;
  while (e > 1 && (d % e != 0 || 32 * e > d ||
                   reinterpret_cast<uintptr_t>(g) % (e * sizeof(T)) != 0))
    e /= 2;
  if (e == 8) {
    if constexpr (kMaxE >= 8)
      launch_unsorted_sum<T, 8>(g, n, d, n_out, scratch, o, partial, st);
  } else if (e == 4) {
    launch_unsorted_sum<T, 4>(g, n, d, n_out, scratch, o, partial, st);
  } else if (e == 2) {
    launch_unsorted_sum<T, 2>(g, n, d, n_out, scratch, o, partial, st);
  } else {
    launch_unsorted_sum<T, 1>(g, n, d, n_out, scratch, o, partial, st);
  }
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

// Ints of mr_segsum_unsorted's scratch for n positions and n_out ids.
extern "C" int64_t mr_segsum_unsorted_scratch_len(int64_t n, int n_out) {
  return UnsortedScratch(n, n_out).len;
}

// Floats of mr_segsum_unsorted's partial: a row of d per (chunk, id) piece.
extern "C" int64_t mr_segsum_unsorted_partial_len(int64_t n, int d, int n_out) {
  return ((n + kUChunk - 1) / kUChunk + n_out) * d;
}

// g: [n, d] bf16 (g_bf16 != 0) or f32; seg: [n] i32, any order; ids
// outside [0, n_out) add nothing; scratch: i32, partial: f32 (the two
// lengths above); out: [d, n_out] f32, every column written.
extern "C" int mr_segsum_unsorted(const void* g, int g_bf16, const int* seg,
                                  int64_t n, int d, int n_out, int* scratch,
                                  float* partial, float* out, void* stream) {
  if (d <= 0 || n_out < 0 || n_out > kMaxOut || n < 0 || n > INT32_MAX ||
      (d + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(d) * n_out, st));
  const UnsortedScratch o(n, n_out);
  unsigned short* rank = reinterpret_cast<unsigned short*>(scratch + o.rank);
  int* hist = scratch + o.hist;
  unsorted_rank<<<static_cast<unsigned>(o.blocks), kGThreads, 0, st>>>(
      seg, n, n_out, rank, hist);
  unsorted_block_scan<<<(n_out + 31) / 32, 256, 0, st>>>(
      hist, static_cast<int>(o.blocks), n_out, scratch + o.total);
  unsorted_bases<<<1, 1024, 0, st>>>(scratch + o.total, n_out,
                                     scratch + o.base, scratch + o.rankp,
                                     scratch + o.plist);
  unsorted_place<<<mr::blocks_for(n, kThreads), kThreads, 0, st>>>(
      seg, n, n_out, rank, hist, scratch + o.base, scratch + o.perm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_bf16)
    launch_unsorted_vec<__nv_bfloat16>(g, n, d, n_out, scratch, o, partial, st);
  else
    launch_unsorted_vec<float>(g, n, d, n_out, scratch, o, partial, st);
  unsorted_combine<<<n_out, 32 * kBWarps, 0, st>>>(
      partial, d, n_out, scratch + o.base, scratch + o.rankp, out);
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
