// Fused table pump on feature-major [dp, vc] storage: the lazy column
// update of one batch (LazyAdam or FTRL-proximal, in place) and the gather
// of the next batch's columns from the updated table,
// rows[p, j] = table'[p, next[j]], in one pass.
//
// Replaces mindrec_tpu/ops/pallas/stream_fused.py: fused_adam_gather and
// fused_ftrl_gather, which walked a flat schedule of (tile, update chunks,
// gather chunks) over every touched tile of the table, combined gradients
// and gathered with one-hot matmuls, and copied gather-only tiles through
// VMEM.  The kernel's whole contract is that the gather sees the update.
// Here one block works a range of table columns: it updates the columns of
// the range's gradient slots exactly as update_cols.cu does (the slot that starts
// a run of equal columns sums the run and updates once; the arithmetic is
// shared, update_cols.cuh), waits at __syncthreads(), and then gathers its
// next ids from the values it has just written.  A column belongs to one
// range, so no barrier across the grid is needed; a range with gradients
// and no next ids only updates, a range with next ids and no gradients
// only reads.
//
// The ranges follow the ids, not the table: equal column ranges put the
// dense part of the id space (Criteo's small fields) on one block, which
// then ran alone for most of the kernel.  fused_bounds takes every
// kSlots-th column of each sorted id list as a boundary and merges the two
// boundary lists by rank (a binary search in the other list per
// candidate), so a range holds at most kSlots gradient slots and kSlots
// next ids (plus a run of equal columns), and stores beside each boundary
// where it falls in both lists, so a block reads its two windows and
// searches nothing.  kBlocks resident blocks walk the ranges (the many
// empty ranges of a sentinel-padded list cost one read each).  Next
// columns outside [0, vc) (the sentinel pads) belong to no range; every
// block writes a share of their zeros before its walk.  A block
// has kSlots threads for each of kPar sublanes at a time: threads of the
// update take consecutive slots of one sublane and threads of the gather
// consecutive j, so gradient reads and row writes coalesce.
// Bound: bytes - those of the column update plus those of the column
// gather, less one read of the columns that both touch.

#include "update_cols.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSlots = 256;       // ids between two boundaries of a list
constexpr int kPar = kThreads / kSlots;  // sublanes a block works on at once
constexpr int kBlocks = 264;  // resident blocks: two per multiprocessor

// First index in [0, n) whose (ascending) column is >= key, else n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ cols, int n,
                                           int64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + (hi - lo) / 2;
    if (cols[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Number of boundaries b in [0, nb) of a list (its every kSlots-th column)
// that are < key (or <= key with `inclusive`).
__device__ __forceinline__ int boundaries_below(const int* __restrict__ cols,
                                                int nb, int key,
                                                bool inclusive) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    int mid = lo + (hi - lo) / 2;
    int c = cols[static_cast<int64_t>(mid) * kSlots];
    if (c < key || (inclusive && c == key))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The two boundary lists merged in ascending order (gradient boundaries
// first among equals), plus a last boundary at vc.  For the boundary of
// rank k, its column clamped into [0, vc]: bounds[0][k] and bounds[1][k]
// are the first gradient slot and the first next id at or past it.
// bounds is [2, nb + 1], nb = nbu + nbg; one thread per boundary.
__global__ void fused_bounds(const int* __restrict__ cols, int n, int nbu,
                             const int* __restrict__ next, int n_g, int nbg,
                             int64_t vc, int* __restrict__ bounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nb = nbu + nbg;
  if (i > nb) return;
  int64_t c;
  int rank = nb;
  if (i == nb) {
    c = vc;
  } else if (i < nbu) {
    c = cols[static_cast<int64_t>(i) * kSlots];
    rank = i + boundaries_below(next, nbg, static_cast<int>(c), false);
  } else {
    const int j = i - nbu;
    c = next[static_cast<int64_t>(j) * kSlots];
    rank = j + boundaries_below(cols, nbu, static_cast<int>(c), true);
  }
  c = c < 0 ? 0 : (c > vc ? vc : c);
  bounds[rank] = lower_bound(cols, n, c);
  bounds[nb + 1 + rank] = lower_bound(next, n_g, c);
}

// The windows of column range k: [s0, s1) of the gradient slots and
// [g0, g1) of the next ids.
struct Windows {
  int s0, s1, g0, g1;
};

__device__ __forceinline__ Windows block_windows(const int* __restrict__ bounds,
                                                 int range_blocks, int k) {
  const int* g = bounds + (range_blocks + 1);
  return Windows{bounds[k], bounds[k + 1], g[k], g[k + 1]};
}

// rows[p, j] = table[p, next[j]] for the block's window [g0, g1); table is
// read through a plain pointer, after the block's own writes.
template <typename TW>
__device__ __forceinline__ void gather_window(const TW* table, int64_t vc,
                                              int dp,
                                              const int* __restrict__ next,
                                              int n_g, int g0, int g1,
                                              float* __restrict__ rows) {
  for (int j = g0 + threadIdx.x % kSlots; j < g1; j += kSlots) {
    const int c = next[j];
    for (int p = threadIdx.x / kSlots; p < dp; p += kPar)
      rows[static_cast<int64_t>(p) * n_g + j] =
          mr::to_f(table[static_cast<int64_t>(p) * vc + c]);
  }
}

// Zero rows[:, j] for the next ids outside [0, vc): the head [0, h0) of
// negative ids and the tail [t0, n_g) of ids >= vc.  Block zb of nzb.
__device__ __forceinline__ void zero_outside(int h0, int t0, int n_g, int dp,
                                             float* __restrict__ rows, int zb,
                                             int nzb) {
  const int cnt = h0 + (n_g - t0);
  for (int p = 0; p < dp; ++p) {
    float* row = rows + static_cast<int64_t>(p) * n_g;
    for (int k = zb * kThreads + threadIdx.x; k < cnt; k += nzb * kThreads)
      row[k < h0 ? k : t0 + (k - h0)] = 0.f;
  }
}

// One optimizer step of element idx from its summed gradient.
template <typename TW, typename TS>
struct AdamUpdate {
  TW* table;
  TS* m;
  TS* v;
  mr::AdamHyper h;
  __device__ __forceinline__ void operator()(int64_t idx, float sum) const {
    mr::adam_element(table, m, v, idx, sum, h);
  }
};

template <typename TW>
struct FtrlUpdate {
  TW* table;
  float* accum;
  float* linear;
  mr::FtrlHyper h;
  __device__ __forceinline__ void operator()(int64_t idx, float sum) const {
    mr::ftrl_element(table, accum, linear, idx, sum, h);
  }
};

// Every block first writes its share of the zeros of the sentinel outputs
// (stores that drain while it works) and then walks the column ranges
// k = block, block + grid, ... (most ranges of a sentinel-padded id list
// are empty and cost one read).
template <typename TW, typename Update>
__global__ void __launch_bounds__(kThreads)
fused_kernel(TW* table, Update update, int64_t vc, int dp,
             const int* __restrict__ cols, const float* __restrict__ g, int n,
             int fold, const int* __restrict__ next, int n_g,
             float* __restrict__ rows, const int* __restrict__ bounds,
             int range_blocks) {
  // the first and the last boundary sit at the ends of the live next ids
  const int* next_at = bounds + (range_blocks + 1);
  zero_outside(next_at[0], next_at[range_blocks], n_g, dp, rows, blockIdx.x,
               gridDim.x);
  for (int k = blockIdx.x; k < range_blocks; k += gridDim.x) {
    const Windows w = block_windows(bounds, range_blocks, k);
    if (w.s0 == w.s1 && w.g0 == w.g1) continue;  // the same for every thread
    for (int p = threadIdx.x / kSlots; p < dp; p += kPar) {
      for (int u = w.s0 + threadIdx.x % kSlots; u < w.s1; u += kSlots) {
        int c;
        float sum, touch;
        if (!mr::run_sum(cols, g, n, vc, dp, fold, u, p, &c, &sum, &touch))
          continue;
        if (touch > 0.f) update(static_cast<int64_t>(p) * vc + c, sum);
      }
    }
    __syncthreads();  // the block's updates are visible to its gather
    gather_window(table, vc, dp, next, n_g, w.g0, w.g1, rows);
  }
}

bool bad_fused(int64_t vc, int dp, int n, int fold, int n_g) {
  return mr::bad_cols_shape(vc, dp, n, fold) || n_g < 0 || vc > INT32_MAX;
}

// Fill bounds, then run the fused kernel over the column ranges.
template <typename TW, typename Update>
void launch_fused(void* table, const Update& update, int64_t vc, int dp,
                  const int* cols, const float* g, int n, int fold,
                  const int* next, int n_g, float* rows, int* bounds,
                  cudaStream_t st) {
  const int nbu = (n + kSlots - 1) / kSlots, nbg = (n_g + kSlots - 1) / kSlots;
  const int range_blocks = nbu + nbg;
  fused_bounds<<<mr::blocks_for(range_blocks + 1, kSlots), kSlots, 0, st>>>(
      cols, n, nbu, next, n_g, nbg, vc, bounds);
  fused_kernel<TW, Update><<<kBlocks, kThreads, 0, st>>>(
      static_cast<TW*>(table), update, vc, dp, cols, g, n, fold, next, n_g,
      rows, bounds, range_blocks);
}

template <typename TW, typename TS>
void launch_adam(void* table, void* m, void* v, const mr::AdamHyper& h,
                 int64_t vc, int dp, const int* cols, const float* g, int n,
                 int fold, const int* next, int n_g, float* rows, int* bounds,
                 cudaStream_t st) {
  const AdamUpdate<TW, TS> update{static_cast<TW*>(table), static_cast<TS*>(m),
                                  static_cast<TS*>(v), h};
  launch_fused<TW>(table, update, vc, dp, cols, g, n, fold, next, n_g, rows,
                   bounds, st);
}

template <typename TW>
void launch_ftrl(void* table, float* accum, float* linear,
                 const mr::FtrlHyper& h, int64_t vc, int dp, const int* cols,
                 const float* g, int n, int fold, const int* next, int n_g,
                 float* rows, int* bounds, cudaStream_t st) {
  const FtrlUpdate<TW> update{static_cast<TW*>(table), accum, linear, h};
  launch_fused<TW>(table, update, vc, dp, cols, g, n, fold, next, n_g, rows,
                   bounds, st);
}

}  // namespace

// Ints of the bounds scratch of both fused kernels for n gradient slots and
// n_g next ids: [2, ceil(n / kSlots) + ceil(n_g / kSlots) + 1].
extern "C" int64_t mr_fused_bounds_len(int64_t n, int n_g) {
  const int64_t nb = (n + kSlots - 1) / kSlots +
                     (static_cast<int64_t>(n_g) + kSlots - 1) / kSlots;
  return 2 * (nb + 1);
}

// table: [dp, vc] f32 or bf16 (table_bf16); m, v: [dp, vc] f32 or bf16
// (state_bf16); cols: [n] i32 ascending; g: [dp + 8, n] f32; lr_t: one f32
// on the device; next: [n_g] i32 ascending; rows: [dp, n_g] f32, every
// element written; bounds: i32 scratch of mr_fused_bounds_len(n, n_g)
// elements.
extern "C" int mr_fused_adam_gather(
    void* table, int table_bf16, void* m, void* v, int state_bf16, int64_t vc,
    int dp, const int* cols, const float* g, int n, int fold,
    const float* lr_t, float b1, float one_minus_b1, float b2,
    float one_minus_b2, float eps, float inv_scale, const int* next, int n_g,
    float* rows, int* bounds, void* stream) {
  if (bad_fused(vc, dp, n, fold, n_g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::AdamHyper h{lr_t, b1, one_minus_b1, b2, one_minus_b2, eps,
                        inv_scale};
  if (table_bf16 && state_bf16)
    launch_adam<__nv_bfloat16, __nv_bfloat16>(table, m, v, h, vc, dp, cols, g,
                                              n, fold, next, n_g, rows, bounds,
                                              st);
  else if (table_bf16)
    launch_adam<__nv_bfloat16, float>(table, m, v, h, vc, dp, cols, g, n, fold,
                                      next, n_g, rows, bounds, st);
  else if (state_bf16)
    launch_adam<float, __nv_bfloat16>(table, m, v, h, vc, dp, cols, g, n, fold,
                                      next, n_g, rows, bounds, st);
  else
    launch_adam<float, float>(table, m, v, h, vc, dp, cols, g, n, fold, next,
                              n_g, rows, bounds, st);
  return static_cast<int>(cudaGetLastError());
}

// table: [dp, vc] f32 or bf16; accum, linear: [dp, vc] f32; the other
// arguments as in mr_fused_adam_gather.
extern "C" int mr_fused_ftrl_gather(
    void* table, int table_bf16, float* accum, float* linear, int64_t vc,
    int dp, const int* cols, const float* g, int n, int fold, float lr,
    float l1, float two_l2, float inv_scale, const int* next, int n_g,
    float* rows, int* bounds, void* stream) {
  if (bad_fused(vc, dp, n, fold, n_g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::FtrlHyper h{lr, l1, two_l2, inv_scale};
  if (table_bf16)
    launch_ftrl<__nv_bfloat16>(table, accum, linear, h, vc, dp, cols, g, n,
                               fold, next, n_g, rows, bounds, st);
  else
    launch_ftrl<float>(table, accum, linear, h, vc, dp, cols, g, n, fold, next,
                       n_g, rows, bounds, st);
  return static_cast<int>(cudaGetLastError());
}
