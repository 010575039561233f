// Sorted segment-sum (mr_segsum_sorted, at the end of the namespace):
// out[u, c] = sum of g[perm[i], c] over sorted positions i with
// uidx_sorted[i] == u (perm the identity when it is not given), summed in
// float32 and stored row-major [n_out, D] (the wrapper hands the callers
// its transpose, the reference's [D, n_out] layout).
//
// Replaces mindrec_tpu/ops/pallas/stream_segsum.py:streamed_segsum
// (row_major=True), which built a one-hot [W, C] matrix per 256-row chunk
// of the already sorted rows and summed on the TPU's matrix unit; the
// reference's step gathers g[perm] in front of it.  Here the kernel reads
// the batch-order rows through perm itself, so the gather (a read and a
// write of every row) is gone.  Bound: bytes - g read once (N*D*2 in
// bf16), perm, uidx once, out written once; at the multitable recipe's
// multi group 3.1M rows of 256 bytes, ~0.25 ms at 3.35 TB/s.  On emb128
// nearly every run is one row, on the multi group runs average ~116 rows
// and the compacted stream's pad run is ~150k rows, so the design has to
// be fast for both.  Two passes:
//   1. sorted_chunk_sum: a team of lanes (as many as 16-byte loads span a
//      row: 16 at D = 128 bf16, 32 at D = 256; a lane takes up to 8
//      loads per row for wider f32 rows) walks a chunk of kSChunk sorted
//      positions.  Rows are fetched with 16-byte vector loads straight
//      into registers, kSRows rows in flight per team; the next kSRows
//      perm entries and ids load while the current rows are summed.  At
//      D = 128 bf16 a warp keeps 4 KB in flight, and with ~20 warps per SM
//      that is ~80 KB per SM, past the ~25 KB that 3.35 TB/s over ~1 us of
//      latency needs, so registers (no cp.async, no shared memory) hold
//      the loads.  Whether a run is whole or crosses the chunk's edge is
//      read from the chunk's own ids and its two neighbours, uidx[a-1] and
//      uidx[b]: a whole run goes to row u of out as one coalesced row, the
//      chunk's first run (if it began earlier) to partial[chunk][0], its
//      last (if it goes on) to partial[chunk][1].  No pass finds segment
//      bounds and nothing is memset: every thread also writes its share of
//      the zero rows (ids in [0, n_out) below uidx[0] or above uidx[n-1];
//      unit steps leave no other row empty) with 16-byte stores while its
//      first rows are in flight.
//   2. sorted_span_sum: a block per kSWarps chunks; a warp finds whether a
//      run starts in its chunk and goes on (ballot over the next chunks'
//      first ids counts the partial rows).  A short run (at most
//      kSWarpRows partials, nearly all) is added by that warp alone with
//      every row in flight; a longer one by the whole block, thread (row
//      stripe, 4 columns) taking every stripes-th row with kSLoads loads
//      in flight and the stripes added in order: a hot run is spread over
//      the block, not walked by a warp.
// Every sum is taken in a fixed order: deterministic, no atomics.
//
// Column-major sorted segment-sum (mr_segsum_cols, below): the same sum
// for the logical [D, N] gradient of stream_segsum.py:streamed_segsum with
// row_major=False (the one-hot matmul contracted over the position axis),
// into [D, n_out] with every column written.  The feature-major step holds
// its sorted gradients as a contiguous [N, D] array and passes the
// transposed view (strides (1, D)), so the kernel reads row-major memory
// and no transpose copy sits in front of it.  Bound: bytes - g read once
// (N*D*2 in bf16), uidx once, out written once; at the DeepFM shape 91% of
// out's columns lie past the last segment, so most of the bytes are the
// zero tail, and the design keeps every byte on a streaming path:
//   1. cols_tile_sum: a block takes a tile of P consecutive positions (P
//      from D and the element size, so that three blocks fit an SM, which
//      the registers are held to).  The tile's rows are one contiguous
//      span of P*D elements: its 16-byte chunks are loaded into registers
//      (element loads at unaligned ends) and, while those are in flight,
//      the block writes its share of the zero columns (below uidx[0] and
//      above uidx[n-1]) with 16-byte stores; then the chunks go to shared
//      memory.  Each warp walks P/8 positions in order, lanes across the
//      D columns, and sums each run in float32: a run that ends inside the
//      warp's positions goes to an output tile [D][P + 1] in shared
//      memory, the warp's first and last runs to per-warp slots, which one
//      thread per column adds in warp order.  The tile's segments leave as
//      rows out[d, u0:u1] of consecutive floats (the transpose happens in
//      shared memory).  A run that crosses the tile's start or end goes to
//      partial[tile][0] or [1] instead;
//   2. cols_span_sum: a block per tile whose last segment starts in it and
//      crosses its end.  Warp 0 counts the tiles the segment covers (32 at
//      a time, by ballot); thread (stripe, column) adds every
//      stripes-th partial row and the stripes are added in order, so a hot
//      id of thousands of positions is spread over the block, not walked
//      by one thread.
// Fixed order, no atomics: deterministic.

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

constexpr int kCWarps = 8;  // warps per block, both passes
constexpr int kCThreads = 32 * kCWarps;
constexpr int kCMaxTile = 512;  // positions per tile, at most
constexpr int kCMaxD = 256;     // feature rows
constexpr int kCAhead = 4;      // rows read ahead per warp
constexpr int kCLoads = 8;      // 16-byte loads in flight per thread
constexpr int kCMinBlocks = 3;  // blocks per SM the registers must allow
constexpr size_t kCSmem = 74 * 1024;  // per block: three blocks per SM

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Bytes of the g tile's shared memory: p rows of d elements and up to 15
// bytes of lead room, so that the 16-byte chunks of g keep their alignment.
__host__ __device__ inline size_t cols_gtile_bytes(int p, int d, int elem) {
  return up16(static_cast<size_t>(p) * d * elem + 16);
}

// Shared memory of cols_tile_sum for tiles of p positions: the ids, the
// g tile, the output tile [d][p + 1] and the warps' edge sums [warps][2][d].
inline size_t cols_smem(int p, int d, int elem) {
  return up16(sizeof(int) * p) + cols_gtile_bytes(p, d, elem) +
         sizeof(float) * (static_cast<size_t>(d) * (p + 1) + 2 * kCWarps * d);
}

// Positions per tile: the largest multiple of 32 up to kCMaxTile whose
// block fits kCSmem (32 when none does: d > 112 in float32).
inline int cols_tile(int d, int elem) {
  for (int p = kCMaxTile; p > 32; p -= 32)
    if (cols_smem(p, d, elem) <= kCSmem) return p;
  return 32;
}

// Zero columns [a, b) of every row of out [d, n_out]: share `part` of
// `parts` of the rows' 16-byte slots.  A row's slots past its aligned
// float4s are one more, whose thread zeroes the unaligned ends.
__device__ void zero_cols(float* __restrict__ out, int d, int n_out, int a,
                          int b, int part, int parts) {
  if (a >= b) return;
  const int64_t per_row = (b - a) / 4 + 1;
  const int64_t total = per_row * d;
  const int64_t s0 = total * part / parts, s1 = total * (part + 1) / parts;
  for (int64_t row = s0 / per_row; row * per_row < s1; ++row) {
    float* r = out + row * n_out;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(r + a) >> 2) & 3);
    const int a4 = a + ((4 - mis) & 3);  // the first 16-byte aligned column
    const int nv = b - a4 >= 4 ? (b - a4) / 4 : 0;
    const int64_t k0 = s0 > row * per_row ? s0 - row * per_row : 0;
    const int64_t k1 = s1 - row * per_row < per_row ? s1 - row * per_row : per_row;
    for (int64_t k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
      if (k < nv) {
        reinterpret_cast<float4*>(r + a4)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (k == nv) {
        for (int c = a; c < (a4 < b ? a4 : b); ++c) r[c] = 0.f;
        for (int c = a4 + 4 * nv > a ? a4 + 4 * nv : a; c < b; ++c) r[c] = 0.f;
      }
    }
  }
}

// Pass 1.  Block = tile of tile_len positions (blocks past the last tile
// write zero columns only); see the header.
template <typename T, int CPL>
__global__ void __launch_bounds__(kCThreads, kCMinBlocks)
cols_tile_sum(const T* __restrict__ g, const int* __restrict__ uidx,
              int64_t n, int d, int n_out, int tile_len,
              float* __restrict__ out, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = tile_len, ostride = P + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* sid = reinterpret_cast<int*>(smem);
  unsigned char* gtile = smem + up16(sizeof(int) * P);
  float* otile =
      reinterpret_cast<float*>(gtile + cols_gtile_bytes(P, d, sizeof(T)));
  float* wsum = otile + static_cast<size_t>(d) * ostride;

  const int64_t tile = blockIdx.x, p0 = tile * P;
  const int len = p0 < n ? static_cast<int>(n - p0 < P ? n - p0 : P) : 0;
  // the tile's span of g, [g0, g1), and its 16-byte chunks [v0, v1)
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(g) + p0 * d * sizeof(T);
  const uintptr_t g1 = g0 + static_cast<uintptr_t>(len) * d * sizeof(T);
  const uintptr_t base = g0 & ~static_cast<uintptr_t>(15);
  const uintptr_t v0 = (g0 + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t v1 = g1 & ~static_cast<uintptr_t>(15);
  const int nvec = v1 > v0 ? static_cast<int>((v1 - v0) / 16) : 0;
  const uint4* src = reinterpret_cast<const uint4*>(v0);
  uint4* dst = reinterpret_cast<uint4*>(gtile + (v0 - base));
  uint4 r[kCLoads];
#pragma unroll
  for (int q = 0; q < kCLoads; ++q) {
    const int k = q * kCThreads + tid;
    if (k < nvec) r[q] = __ldcs(src + k);
  }
  {  // while the loads are in flight: this block's share of the zero columns
    int lo = n_out, hi = n_out - 1;  // no positions: every column is empty
    if (n > 0) {
      lo = uidx[0];
      hi = uidx[n - 1];
      lo = lo < 0 ? 0 : (lo > n_out ? n_out : lo);
      hi = hi < -1 ? -1 : (hi > n_out - 1 ? n_out - 1 : hi);
    }
    zero_cols(out, d, n_out, 0, lo, blockIdx.x, gridDim.x);
    zero_cols(out, d, n_out, hi + 1, n_out, blockIdx.x, gridDim.x);
  }
  if (len == 0) return;
#pragma unroll
  for (int q = 0; q < kCLoads; ++q) {
    const int k = q * kCThreads + tid;
    if (k < nvec) dst[k] = r[q];
  }
  for (int k0 = kCLoads * kCThreads; k0 < nvec; k0 += kCLoads * kCThreads) {
#pragma unroll
    for (int q = 0; q < kCLoads; ++q) {
      const int k = k0 + q * kCThreads + tid;
      if (k < nvec) r[q] = __ldcs(src + k);
    }
#pragma unroll
    for (int q = 0; q < kCLoads; ++q) {
      const int k = k0 + q * kCThreads + tid;
      if (k < nvec) dst[k] = r[q];
    }
  }
  // the elements before the first chunk and after the last one
  const T* gs = reinterpret_cast<const T*>(g0);
  T* gt = reinterpret_cast<T*>(gtile + (g0 - base));
  const uintptr_t h1 = v0 < g1 ? v0 : g1;
  const int head = static_cast<int>((h1 - g0) / sizeof(T));
  const int tail = static_cast<int>(((v1 > h1 ? v1 : h1) - g0) / sizeof(T));
  for (int i = tid; i < head; i += kCThreads) gt[i] = gs[i];
  for (int i = tail + tid; i < len * d; i += kCThreads) gt[i] = gs[i];
  for (int i = tid; i < len; i += kCThreads) sid[i] = uidx[p0 + i];
  __syncthreads();

  const int u_first = sid[0], u_last = sid[len - 1];
  const bool before = p0 > 0 && uidx[p0 - 1] == u_first;
  const bool after = p0 + len < n && uidx[p0 + len] == u_last;
  // each warp: its positions in order, lanes across the columns; a run
  // that ends inside them -> otile, its first and last runs -> wsum
  const int per = P / kCWarps;
  const int q0 = warp * per, q1 = q0 + per < len ? q0 + per : len;
  if (q0 < q1) {
    float acc[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
    int cur = sid[q0];
    bool first = true;
    for (int i0 = q0; i0 < q1; i0 += kCAhead) {
      float v[kCAhead][CPL];
#pragma unroll
      for (int a = 0; a < kCAhead; ++a) {
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = lane + 32 * k;
          v[a][k] = (i0 + a < q1 && c < d) ? mr::to_f(gt[(i0 + a) * d + c]) : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < kCAhead; ++a) {
        if (i0 + a >= q1) break;  // the same for every lane
        const int u = sid[i0 + a];
        if (u != cur) {
          const int j = cur - u_first;
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int c = lane + 32 * k;
            if (c < d) {
              if (first)
                wsum[warp * 2 * d + c] = acc[k];
              else if (j < P)  // always, with unit steps
                otile[c * ostride + j] = acc[k];
            }
            acc[k] = 0.f;
          }
          cur = u;
          first = false;
        }
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] += v[a][k];
      }
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < d) wsum[(warp * 2 + (first ? 0 : 1)) * d + c] = acc[k];
    }
  }
  __syncthreads();
  // one thread per column: the warps' edge sums in warp order
  for (int c = tid; c < d; c += kCThreads) {
    auto emit = [&](int u, float x) {
      if (u < 0 || u >= n_out) return;
      if (u == u_first && before)
        partial[tile * 2 * d + c] = x;
      else if (u == u_last && after)
        partial[(tile * 2 + 1) * d + c] = x;
      else if (u - u_first < P)
        otile[c * ostride + (u - u_first)] = x;
    };
    int cur = sid[0];
    float s = 0.f;
    for (int w = 0; w < kCWarps && w * per < len; ++w) {
      const int a = w * per, e = (a + per < len ? a + per : len) - 1;
      const int fu = sid[a], lu = sid[e];
      const float f = wsum[w * 2 * d + c];
      if (w > 0 && fu == cur) {
        s += f;
      } else {
        if (w > 0) emit(cur, s);
        cur = fu;
        s = f;
      }
      if (lu != fu) {
        emit(cur, s);
        cur = lu;
        s = wsum[(w * 2 + 1) * d + c];
      }
    }
    emit(cur, s);
  }
  __syncthreads();
  // the segments that lie wholly in the tile: a row of floats per column
  int64_t j_lo = before ? 1 : 0;
  int64_t j_hi = static_cast<int64_t>(u_last) - u_first + (after ? 0 : 1);
  if (j_lo < -static_cast<int64_t>(u_first)) j_lo = -static_cast<int64_t>(u_first);
  if (j_hi > static_cast<int64_t>(n_out) - u_first) j_hi = static_cast<int64_t>(n_out) - u_first;
  if (j_hi > P) j_hi = P;
  const int cnt = j_hi > j_lo ? static_cast<int>(j_hi - j_lo) : 0;
  for (int e = tid; e < cnt * d; e += kCThreads) {
    const int c = e / cnt, j = static_cast<int>(j_lo) + e - c * cnt;
    out[static_cast<int64_t>(c) * n_out + u_first + j] = otile[c * ostride + j];
  }
}

// Pass 2.  Block = tile: if the tile's last segment starts in it and
// crosses its end, warp 0 counts the tiles the segment covers (32 at a
// time, by ballot); then thread (stripe, column) adds the partial rows
// stripe, stripe + stripes, ... (slot 1 of the first tile, slot 0 of each
// later one) and the stripes are added in order: a hot id's rows are
// spread over the block, in a fixed order.
__global__ void __launch_bounds__(kCThreads)
cols_span_sum(const int* __restrict__ uidx, int64_t n, int d, int n_out,
              int tile_len, const float* __restrict__ partial,
              float* __restrict__ out) {
  __shared__ int rows_s;
  __shared__ float red[kCThreads];
  const int P = tile_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x, a = tile * P, b = a + P;
  if (b >= n) return;  // the last tile's runs end inside it
  const int u = uidx[b - 1];
  if (uidx[b] != u || u < 0 || u >= n_out) return;        // ends in the tile
  if (a > 0 && uidx[a] == u && uidx[a - 1] == u) return;  // began earlier
  if (warp == 0) {
    const int64_t tiles = (n + P - 1) / P;
    int rows = 1;
    for (int64_t t0 = tile + 1;; t0 += 32) {
      const int64_t tt = t0 + lane;
      const unsigned in = __ballot_sync(kFull, tt < tiles && uidx[tt * P] == u);
      if (in != kFull) {
        rows += __ffs(~in) - 1;
        break;
      }
      rows += 32;
    }
    if (lane == 0) rows_s = rows;
  }
  __syncthreads();
  const int rows = rows_s;
  const int stripes = kCThreads / d;  // d <= kCThreads
  const int stripe = threadIdx.x / d, c = threadIdx.x - stripe * d;
  if (stripe < stripes) {
    float s = 0.f;
#pragma unroll 4
    for (int r = stripe; r < rows; r += stripes)
      s += partial[((tile + r) * 2 + (r == 0 ? 1 : 0)) * d + c];
    red[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < d) {
    float s = 0.f;
    for (int k = 0; k < stripes; ++k) s += red[k * d + threadIdx.x];
    out[static_cast<int64_t>(threadIdx.x) * n_out + u] = s;
  }
}

template <typename T, int CPL>
cudaError_t launch_cols(const void* g, const int* uidx, int64_t n, int d,
                        int n_out, float* partial, float* out,
                        cudaStream_t st) {
  static int sms = 0;  // 0: the attributes below are not set yet
  if (sms == 0) {      // shared memory above 48 KB is opted into once
    int dev = 0;
    const size_t most = cols_smem(32, kCMaxD, 4);  // the largest block
    cudaError_t err = cudaFuncSetAttribute(
        cols_tile_sum<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most > kCSmem ? most : kCSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cols_tile_sum<T, CPL>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int p = cols_tile(d, sizeof(T));
  const int64_t tiles = (n + p - 1) / p;
  // at least two blocks per SM share the zero columns
  const int64_t blocks = tiles > 2 * sms ? tiles : 2 * sms;
  cols_tile_sum<T, CPL><<<static_cast<unsigned>(blocks), kCThreads,
                          cols_smem(p, d, sizeof(T)), st>>>(
      static_cast<const T*>(g), uidx, n, d, n_out, p, out, partial);
  if (tiles > 1)
    cols_span_sum<<<static_cast<unsigned>(tiles - 1), kCThreads, 0, st>>>(
        uidx, n, d, n_out, p, partial, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols_d(const void* g, const int* uidx, int64_t n, int d,
                          int n_out, float* partial, float* out,
                          cudaStream_t st) {
  if (d <= 32) return launch_cols<T, 1>(g, uidx, n, d, n_out, partial, out, st);
  if (d <= 64) return launch_cols<T, 2>(g, uidx, n, d, n_out, partial, out, st);
  if (d <= 96) return launch_cols<T, 3>(g, uidx, n, d, n_out, partial, out, st);
  if (d <= 128) return launch_cols<T, 4>(g, uidx, n, d, n_out, partial, out, st);
  return launch_cols<T, 8>(g, uidx, n, d, n_out, partial, out, st);
}

constexpr int kSChunk = 256;    // positions per team in sorted_chunk_sum
constexpr int kSRows = 8;       // rows in flight per team
constexpr int kSThreads = 256;  // threads per block, both passes
constexpr int kSWarps = kSThreads / 32;
constexpr int kSLoads = 8;      // partial rows in flight per thread, span pass
constexpr int kSWarpRows = 8;   // runs of at most this many partials: a warp
constexpr int kSMinBlocks = 2;  // blocks per SM the registers must allow

// Row of g that sorted position i reads: perm[i] (int32 or int64), or i
// when there is no perm; g has fewer than 2**31 rows.
__device__ __forceinline__ int row_of(const int* __restrict__ p32,
                                          const long long* __restrict__ p64,
                                          int64_t i) {
  if (p64 != nullptr) return static_cast<int>(p64[i]);
  if (p32 != nullptr) return p32[i];
  return static_cast<int>(i);
}

// Zero floats [0, len) of p, shared by `parts` threads (this one is
// `part`): 16-byte stores between the unaligned ends.
__device__ void zero_floats(float* __restrict__ p, int64_t len, int64_t part,
                            int64_t parts) {
  if (len <= 0) return;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  const int64_t head = ((4 - mis) & 3) < len ? ((4 - mis) & 3) : len;
  const int64_t nv = (len - head) / 4, rest = len - head - 4 * nv;
  float4* v = reinterpret_cast<float4*>(p + head);
  for (int64_t k = part; k < nv; k += parts)
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (part < head) p[part] = 0.f;
  if (part < rest) p[head + 4 * nv + part] = 0.f;
}

// E consecutive floats of acc to dst, in 16-byte stores where E allows.
template <int E>
__device__ __forceinline__ void store_vec(float* __restrict__ dst,
                                          const float (&acc)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  } else {
    dst[0] = acc[0];
  }
}

// Pass 1.  A team of team_w lanes takes a chunk of kSChunk consecutive
// sorted positions; lane tl holds vectors tl, tl + team_w, ... (K of
// them) of E elements of a row.  Rows are fetched through perm kSRows at a
// time, and the next kSRows rows and ids are fetched while the current
// rows are summed.  A run is flushed when its id changes: to
// partial[chunk][0] when it is the chunk's first run and began before the
// chunk, to partial[chunk][1] when it is the last run and goes on past the
// chunk, else to row u of out.  Every thread of the grid also writes its
// share of the zero rows of out (ids in [0, n_out) below uidx[0] or above
// uidx[n-1]) while its first rows are in flight.
template <typename T, int E, int K>
__global__ void __launch_bounds__(kSThreads, kSMinBlocks)
sorted_chunk_sum(const T* __restrict__ g, const int* __restrict__ perm32,
                 const long long* __restrict__ perm64,
                 const int* __restrict__ uidx, int64_t n, int d, int n_out,
                 int team_w, float* __restrict__ out,
                 float* __restrict__ partial) {
  using R = typename Raw<sizeof(T) * E>::type;
  const int64_t gtid =
      blockIdx.x * static_cast<int64_t>(kSThreads) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t team = (gtid >> 5) * (32 / team_w) + lane / team_w;
  const int tl = lane & (team_w - 1);
  const int nv = d / E;  // vectors per row
  const int64_t a = team * kSChunk;
  const int len =
      a < n ? static_cast<int>(n - a < kSChunk ? n - a : kSChunk) : 0;

  int p[kSRows];
  int u[kSRows];
  R v[kSRows][K];
  auto fetch = [&](int i0, int(&pp)[kSRows], int(&uu)[kSRows]) {
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      if (i0 + r < len) {
        pp[r] = row_of(perm32, perm64, a + i0 + r);
        uu[r] = uidx[a + i0 + r];
      }
    }
  };
  auto load_rows = [&](int i0) {
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      const R* row =
          reinterpret_cast<const R*>(g + static_cast<int64_t>(p[r]) * d);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tl + team_w * k;
        if (i0 + r < len && j < nv) v[r][k] = __ldg(row + j);
      }
    }
  };
  if (len > 0) {
    fetch(0, p, u);
    load_rows(0);
  }
  {  // while the rows are in flight: this thread's share of the zero rows
    int lo = n_out, hi = n_out - 1;  // no positions: every row is empty
    if (n > 0) {
      lo = uidx[0];
      hi = uidx[n - 1];
      lo = lo < 0 ? 0 : (lo > n_out ? n_out : lo);
      hi = hi < -1 ? -1 : (hi > n_out - 1 ? n_out - 1 : hi);
    }
    const int64_t parts = static_cast<int64_t>(gridDim.x) * kSThreads;
    zero_floats(out, static_cast<int64_t>(lo) * d, gtid, parts);
    zero_floats(out + static_cast<int64_t>(hi + 1) * d,
                static_cast<int64_t>(n_out - 1 - hi) * d, gtid, parts);
  }
  if (len == 0) return;

  // does the first run begin before the chunk, does the last go on past it
  const int u_first = uidx[a], u_last = uidx[a + len - 1];
  const bool cross_start = a > 0 && uidx[a - 1] == u_first;
  const bool cross_end = a + len < n && uidx[a + len] == u_last;
  float acc[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.f;
  int cur = u_first;
  bool first = true;
  auto flush = [&](bool last) {
    if (cur < 0 || cur >= n_out) return;
    float* dst;
    if (first && cross_start)
      dst = partial + (team * 2) * d;
    else if (last && cross_end)
      dst = partial + (team * 2 + 1) * d;
    else
      dst = out + static_cast<int64_t>(cur) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tl + team_w * k;
      if (j < nv) store_vec<E>(dst + j * E, acc[k]);
    }
  };
  for (int i0 = 0;; i0 += kSRows) {
    int pn[kSRows], un[kSRows];
    const bool more = i0 + kSRows < len;
    if (more) fetch(i0 + kSRows, pn, un);
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      if (i0 + r >= len) break;  // the same for every lane of the team
      if (u[r] != cur) {
        flush(false);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] = 0.f;
        cur = u[r];
        first = false;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (tl + team_w * k < nv) {
          unsigned w[4];
          words(v[r][k], w);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] += element<T>(w, e);
        }
      }
    }
    if (!more) break;
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      p[r] = pn[r];
      u[r] = un[r];
    }
    load_rows(i0 + kSRows);
  }
  flush(true);
}

// V floats at src (16-byte aligned when V == 4).
template <int V>
__device__ __forceinline__ void load_floats(const float* src, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = src[k];
  }
}

// Pass 2.  Warp w of block b checks chunk b * kSWarps + w: does a run
// start in it and go on past its end?  If so, it counts the chunks the run
// covers (32 at a time, by ballot); the run's partial rows are slot 1 of
// the first chunk and slot 0 of each later one.  A run of at most
// kSWarpRows rows (nearly all of them) is added by the warp alone, every
// row in flight at once, lanes across vectors of V columns.  Then, for
// each longer run of the block in turn, the whole block adds it: thread
// (stripe, vector) adds rows stripe, stripe + stripes, ..., kSLoads in
// flight, and the stripes are added in order into row u of out.  A hot
// id's partials are spread over the block; every order is fixed.
template <int V>
__global__ void __launch_bounds__(kSThreads)
sorted_span_sum(const int* __restrict__ uidx, int64_t n, int d, int n_out,
                const float* __restrict__ partial, float* __restrict__ out) {
  __shared__ int rows_s[kSWarps];
  __shared__ float red[kSThreads * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols_v = d / V;  // V divides d
  const int64_t chunks = (n + kSChunk - 1) / kSChunk;
  const int64_t c = blockIdx.x * static_cast<int64_t>(kSWarps) + warp;
  // partial row r of the run that starts in chunk c0
  auto row = [&](int64_t c0, int r) {
    return partial + ((c0 + r) * 2 + (r == 0 ? 1 : 0)) * d;
  };
  int rows = 0;
  if (c < chunks - 1) {  // the last chunk's runs end inside it
    const int64_t a = c * kSChunk, b = a + kSChunk;
    const int u = uidx[b - 1];
    const bool owns = uidx[b] == u && u >= 0 && u < n_out &&
                      !(a > 0 && uidx[a] == u && uidx[a - 1] == u);
    if (owns) {  // the same for every lane
      rows = 1;
      for (int64_t t0 = c + 1;; t0 += 32) {
        const int64_t tt = t0 + lane;
        const unsigned in =
            __ballot_sync(kFull, tt < chunks && uidx[tt * kSChunk] == u);
        if (in != kFull) {
          rows += __ffs(~in) - 1;
          break;
        }
        rows += 32;
      }
    }
    if (rows > 0 && rows <= kSWarpRows) {
      for (int j = lane; j < cols_v; j += 32) {
        float x[kSWarpRows][V];
#pragma unroll
        for (int r = 0; r < kSWarpRows; ++r)
          if (r < rows) load_floats<V>(row(c, r) + j * V, x[r]);
        float t[V];
#pragma unroll
        for (int k = 0; k < V; ++k) t[k] = 0.f;
#pragma unroll
        for (int r = 0; r < kSWarpRows; ++r)
          if (r < rows)
#pragma unroll
            for (int k = 0; k < V; ++k) t[k] += x[r][k];
#pragma unroll
        for (int k = 0; k < V; ++k)
          out[static_cast<int64_t>(u) * d + j * V + k] = t[k];
      }
      rows = 0;
    }
  }
  if (lane == 0) rows_s[warp] = rows;
  __syncthreads();
  const int stripes = kSThreads / cols_v;
  const int stripe = threadIdx.x / cols_v;
  const int cv = threadIdx.x - stripe * cols_v;
  for (int w = 0; w < kSWarps; ++w) {
    const int nrows = rows_s[w];  // the same for the whole block
    if (nrows == 0) continue;
    const int64_t cw = blockIdx.x * static_cast<int64_t>(kSWarps) + w;
    const int u = uidx[(cw + 1) * kSChunk - 1];
    if (stripe < stripes) {
      float s[V];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = 0.f;
      int r = stripe;
      for (; r + (kSLoads - 1) * stripes < nrows; r += kSLoads * stripes) {
        float x[kSLoads][V];
#pragma unroll
        for (int q = 0; q < kSLoads; ++q)
          load_floats<V>(row(cw, r + q * stripes) + cv * V, x[q]);
#pragma unroll
        for (int q = 0; q < kSLoads; ++q)
#pragma unroll
          for (int k = 0; k < V; ++k) s[k] += x[q][k];
      }
      for (; r < nrows; r += stripes) {
        float x[V];
        load_floats<V>(row(cw, r) + cv * V, x);
#pragma unroll
        for (int k = 0; k < V; ++k) s[k] += x[k];
      }
#pragma unroll
      for (int k = 0; k < V; ++k) red[stripe * d + cv * V + k] = s[k];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += kSThreads) {
      float t = 0.f;
      for (int k = 0; k < stripes; ++k) t += red[k * d + col];
      out[static_cast<int64_t>(u) * d + col] = t;
    }
    __syncthreads();
  }
}

// K loads of E elements per lane: a row of at most 256 elements needs
// E * K <= 8, so no other instance is built.
template <typename T, int E, int K>
void launch_chunk_sum(dim3 grid, const void* g, const int* p32,
                      const long long* p64, const int* uidx, int64_t n, int d,
                      int n_out, int team_w, float* partial, float* out,
                      cudaStream_t st) {
  if constexpr (E * K <= 8)
    sorted_chunk_sum<T, E, K><<<grid, kSThreads, 0, st>>>(
        static_cast<const T*>(g), p32, p64, uidx, n, d, n_out, team_w, out,
        partial);
}

template <typename T, int E>
void launch_sorted_k(const void* g, const int* p32, const long long* p64,
                     const int* uidx, int64_t n, int d, int n_out,
                     float* partial, float* out, cudaStream_t st) {
  const int nv = d / E;
  int team_w = 1;  // the least power of two of lanes that spans a row
  while (team_w < nv && team_w < 32) team_w *= 2;
  const int per = (nv + 31) / 32;  // vectors per lane: E * per <= 8
  const int64_t chunks = (n + kSChunk - 1) / kSChunk;
  const int64_t teams_per_block = kSThreads / team_w;
  int64_t blocks = (chunks + teams_per_block - 1) / teams_per_block;
  if (blocks < 2 * 132) blocks = 2 * 132;  // threads enough for the zero rows
  const dim3 grid(static_cast<unsigned>(blocks));
  if (per <= 1)
    launch_chunk_sum<T, E, 1>(grid, g, p32, p64, uidx, n, d, n_out, team_w,
                              partial, out, st);
  else if (per <= 2)
    launch_chunk_sum<T, E, 2>(grid, g, p32, p64, uidx, n, d, n_out, team_w,
                              partial, out, st);
  else if (per <= 4)
    launch_chunk_sum<T, E, 4>(grid, g, p32, p64, uidx, n, d, n_out, team_w,
                              partial, out, st);
  else
    launch_chunk_sum<T, E, 8>(grid, g, p32, p64, uidx, n, d, n_out, team_w,
                              partial, out, st);
}

// The widest load (E elements, at most 16 bytes) that keeps every row
// aligned.
template <typename T>
void launch_sorted(const void* g, const int* p32, const long long* p64,
                   const int* uidx, int64_t n, int d, int n_out,
                   float* partial, float* out, cudaStream_t st) {
  constexpr int kMaxE = 16 / static_cast<int>(sizeof(T));
  int e = kMaxE;
  while (e > 1 && (d % e != 0 ||
                   reinterpret_cast<uintptr_t>(g) % (e * sizeof(T)) != 0))
    e /= 2;
  if (e == 8) {
    if constexpr (kMaxE >= 8)
      launch_sorted_k<T, 8>(g, p32, p64, uidx, n, d, n_out, partial, out, st);
  } else if (e == 4) {
    launch_sorted_k<T, 4>(g, p32, p64, uidx, n, d, n_out, partial, out, st);
  } else if (e == 2) {
    launch_sorted_k<T, 2>(g, p32, p64, uidx, n, d, n_out, partial, out, st);
  } else {
    launch_sorted_k<T, 1>(g, p32, p64, uidx, n, d, n_out, partial, out, st);
  }
}

}  // namespace

// Floats of mr_segsum_cols's partial scratch for n positions of d rows
// of bf16 (g_bf16 != 0) or f32: two rows of d per tile.
extern "C" int64_t mr_segsum_cols_partial_len(int64_t n, int d, int g_bf16) {
  if (d <= 0 || d > kCMaxD) return 0;
  const int p = cols_tile(d, g_bf16 ? 2 : 4);
  return (n + p - 1) / p * 2 * d;
}

// g: the [d, n] gradient as a contiguous row-major [n, d] array (the
// transposed view's memory), bf16 (g_bf16 != 0) or f32; uidx: [n] i32,
// non-decreasing with unit steps; partial: f32 scratch
// (mr_segsum_cols_partial_len floats); out: [d, n_out] f32, every column
// written.
extern "C" int mr_segsum_cols(const void* g, int g_bf16, const int* uidx,
                              int64_t n, int d, int n_out, float* partial,
                              float* out, void* stream) {
  if (d <= 0 || d > kCMaxD || n_out < 0 || n < 0 || n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      g_bf16 ? launch_cols_d<__nv_bfloat16>(g, uidx, n, d, n_out, partial, out, st)
             : launch_cols_d<float>(g, uidx, n, d, n_out, partial, out, st));
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

// Floats of mr_segsum_sorted's partial scratch for n positions of d
// columns: two rows of d per chunk.
extern "C" int64_t mr_segsum_sorted_partial_len(int64_t n, int d) {
  return (n + kSChunk - 1) / kSChunk * 2 * d;
}

// g: [rows, d] bf16 (g_bf16 != 0) or f32, row-major; perm: [n] sorted
// position -> row of g, int32 (perm_bytes 4) or int64 (8), or none
// (perm_bytes 0: position i reads row i); uidx: [n] i32, non-decreasing
// with unit steps; partial: f32 scratch (mr_segsum_sorted_partial_len
// floats); out: [n_out, d] f32, every row written.
extern "C" int mr_segsum_sorted(const void* g, int g_bf16, const void* perm,
                                int perm_bytes, const int* uidx, int64_t n,
                                int d, int n_out, float* partial, float* out,
                                void* stream) {
  if (d <= 0 || d > 256 || n_out < 0 || n < 0 || n > INT32_MAX ||
      (perm_bytes != 0 && perm_bytes != 4 && perm_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p32 = perm_bytes == 4 ? static_cast<const int*>(perm) : nullptr;
  const long long* p64 =
      perm_bytes == 8 ? static_cast<const long long*>(perm) : nullptr;
  if (g_bf16)
    launch_sorted<__nv_bfloat16>(g, p32, p64, uidx, n, d, n_out, partial, out,
                                 st);
  else
    launch_sorted<float>(g, p32, p64, uidx, n, d, n_out, partial, out, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= kSChunk) return static_cast<int>(err);
  const int64_t chunks = (n + kSChunk - 1) / kSChunk;
  const unsigned blocks =
      static_cast<unsigned>((chunks - 1 + kSWarps - 1) / kSWarps);
  if (d % 4 == 0)
    sorted_span_sum<4><<<blocks, kSThreads, 0, st>>>(uidx, n, d, n_out,
                                                     partial, out);
  else
    sorted_span_sum<1><<<blocks, kSThreads, 0, st>>>(uidx, n, d, n_out,
                                                     partial, out);
  return static_cast<int>(cudaGetLastError());
}
