// Fused table pump on feature-major [dp, vc] storage: the lazy column
// update of one batch (LazyAdam or FTRL-proximal, in place) and the gather
// of the next batch's columns from the updated table,
// rows[p, j] = table'[p, next[j]], in one launch.
//
// Replaces mindrec_tpu/ops/pallas/stream_fused.py: fused_adam_gather and
// fused_ftrl_gather, which walked a flat schedule of (tile, update chunks,
// gather chunks) over every touched tile of the table, combined gradients
// and gathered with one-hot matmuls, and copied gather-only tiles through
// VMEM.  The kernel's whole contract is that the gather sees the update.
//
// What bounds it is sectors and the rows: each touched element of the
// weight and its two state arrays is a 32-byte sector of its own, read and
// written; each gather-only column is dp sectors read; the rows are
// dp x n_g float32 written once (at the DeepFM shapes 91% of them the
// zeros of sentinel pads).  The gather needs nothing from the update but
// the columns the update writes, so the design keeps the two apart and
// runs them side by side: no thread of the launch waits for another.  A
// block takes one of two roles (the first blocks alternate, so both start
// at once):
// * update blocks run the column updates' code (update_cols.cuh) on the
//   touch-augmented rows: LazyAdam at every fold and FTRL at fold 1 a slot
//   and kSub sublanes per thread (update_slot), blocks striding over the
//   slots; FTRL at fold > 1 update_cols.cu's layout, a lane per slot over
//   all sublanes with the touched elements compacted over the warp.  The head
//   of a run of equal columns also finds its column among the sorted next
//   ids, while its weight and state loads are in flight, and writes, for
//   every next id j that names it, rows[p, j] for each of its sublanes:
//   the weight as stored where the touch gate opened, as loaded where it
//   did not (at fold > 1 the head loads its untouched sublanes, the lane
//   that updates a touched element writes that one);
// * gather blocks take 256 next ids x kGRows sublanes: an id outside
//   [0, vc) gives zeros; an id whose column is in the update list is left
//   to that column's head; any other column's values are loaded (all in
//   flight before the stores) and written.  Nobody writes those columns
//   in this launch, so the loads start at once.
// So every rows element is written by exactly one thread, from a value no
// other thread changes after it is read, and the launch needs no barrier.
// Equal next ids (fold 8: next = ids // 8) all take the head's column; the
// untouched sublanes of a shared column keep their values; a zeroed touch
// row leaves its sublane as it was.  Both lookups (a column among the next
// ids, a next id among the update columns) are warp_span: a warp's keys
// ascend with its lanes, so the warp places them together in a few
// dependent loads where a binary search per thread takes twenty.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W) the two halves barely
// overlap: at the large shapes both are bound by device memory, and the
// head's search lengthens every update round, so the launch takes about
// as long as the separate update and gather kernels (PERF.md, section 6, by
// pass).  Designs that made gathers wait for the update instead (a grid
// claiming work items in order; per-block flags or a done mark with
// counters of blocks) paid more in per-block synchronisation, at 6,500 to
// 65,000 blocks a launch, than they saved.  Bound: bytes - cols, next, the
// gradient and touch rows of the live slots read once, each touched
// element's weight and two state values read and written once, every
// other element of the next columns read once, and the rows written once.

#include "update_cols.cuh"

namespace {

constexpr int kThreads = 256;  // threads of a block, of either role
constexpr int kSub = 2;        // sublanes per update thread
constexpr int kMaxBlocksX = 1024;  // update blocks along the slots; they stride
constexpr int kGRows = 8;      // sublanes per gather thread
constexpr int kWindows = 4;    // windows of 32 a warp walks in warp_span
constexpr int kMinBlocks = 5;  // resident blocks the registers must allow
constexpr int kFoldMinBlocks = 4;  // the same at fold > 1
constexpr unsigned kAll = 0xffffffffu;

// First index in [0, n) whose (ascending) value is >= key, else n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The entries of a sorted list equal to a key: [j0, j1).
struct Span {
  int j0, j1;
};

// The span of key in the ascending a[0, len) for each lane with need
// (the others get an empty span), found by the warp together.  The needy
// lanes' keys ascend with the lane (they come from consecutive sorted
// slots or next ids), so a 32-way search by the whole warp places the
// smallest (three rounds of 32 loads at 624,000 entries), and windows of
// 32 entries from there, one coalesced load each, place the rest by
// shuffles: a few dependent loads against a binary search's twenty.  A
// lane still open after kWindows windows searches alone.  Every lane of
// the warp calls it.
__device__ __forceinline__ Span warp_span(const int* __restrict__ a, int len,
                                          int key, bool need) {
  const int lane = threadIdx.x & 31;
  const unsigned needy = __ballot_sync(kAll, need);
  if (needy == 0) return Span{0, 0};
  const int key0 = __shfl_sync(kAll, key, __ffs(needy) - 1);
  int lo = 0, hi = len;  // the smallest key's lower bound is in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int pos = lo + (lane + 1) * step - 1;
    const int cnt = __popc(__ballot_sync(kAll, pos < hi && a[pos] < key0));
    if (cnt < 32) hi = min(hi, lo + (cnt + 1) * step - 1);
    lo += cnt * step;
  }
  int j0 = -1, j1 = -1, base = lo;
  bool open = need;
  for (int w = 0; w < kWindows && __any_sync(kAll, open); ++w, base += 32) {
    const int x = base + lane < len ? a[base + lane] : INT32_MAX;
    int lt = 0, le = 0;  // entries of the window below and not above key
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      if (__shfl_sync(kAll, x, lt + s - 1) < key) lt += s;
      if (__shfl_sync(kAll, x, le + s - 1) <= key) le += s;
    }
    const int last = __shfl_sync(kAll, x, 31);
    if (last < key) lt = 32;
    if (last <= key) le = 32;
    if (open && j0 < 0 && lt < 32) j0 = base + lt;
    if (open && le < 32) {
      j1 = base + le;
      open = false;
    }
  }
  if (open) {
    if (j0 < 0) j0 = base + lower_bound(a + base, len - base, key);
    j1 = j0 + lower_bound(a + j0, len - j0, key + 1);
  }
  return need ? Span{j0, j1} : Span{0, 0};
}

// Rows policy of the slot layout: a head writes its kSub sublanes into
// every j of its span.
struct SlotRows {
  static constexpr bool kOn = true;
  using At = Span;
  const int* next;
  int n_g, dp;
  float* rows;
  __device__ __forceinline__ At find(int c, bool head) const {
    return warp_span(next, n_g, c, head);
  }
  template <int R>
  __device__ __forceinline__ void write(At at, int p0,
                                        const float (&wq)[R]) const {
    for (int j = at.j0; j < at.j1; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (p0 + r < dp) rows[static_cast<int64_t>(p0 + r) * n_g + j] = wq[r];
    }
  }
  __device__ __forceinline__ void untouched(At, int, unsigned) const {}
  __device__ __forceinline__ void stage(int, At) const {}
  __device__ __forceinline__ void element(int, int, float) const {}
};

// Rows policy of the folded layout: the head loads and writes its
// untouched sublanes and stages its span for the lanes that update its
// touched elements (spans: the warp's 32 in shared memory).
template <typename TW>
struct FoldRows {
  static constexpr bool kOn = true;
  using At = Span;
  const TW* table;
  int64_t vc;
  const int* next;
  int n_g, dp;
  float* rows;
  Span* spans;
  __device__ __forceinline__ At find(int c, bool head) const {
    return warp_span(next, n_g, c, head);
  }
  template <int R>
  __device__ __forceinline__ void write(At, int, const float (&)[R]) const {}
  __device__ __forceinline__ void untouched(At at, int c,
                                            unsigned mask) const {
    if (at.j0 == at.j1) return;
    float w[mr::kFoldMax];
#pragma unroll
    for (int p = 0; p < mr::kFoldMax; ++p)
      w[p] = (p < dp && !((mask >> p) & 1u))
                 ? mr::to_f(table[static_cast<int64_t>(p) * vc + c])
                 : 0.f;
    for (int j = at.j0; j < at.j1; ++j) {
#pragma unroll
      for (int p = 0; p < mr::kFoldMax; ++p)
        if (p < dp && !((mask >> p) & 1u))
          rows[static_cast<int64_t>(p) * n_g + j] = w[p];
    }
  }
  __device__ __forceinline__ void stage(int lane, At at) const {
    spans[lane] = at;
  }
  __device__ __forceinline__ void element(int head, int p, float w) const {
    const Span at = spans[head];
    for (int j = at.j0; j < at.j1; ++j)
      rows[static_cast<int64_t>(p) * n_g + j] = w;
  }
};

// Block b's role and its index k among the blocks of that role: the
// first 2 min(nu, ng) blocks alternate update and gather, so both roles
// start at once; the rest take the larger role.
__device__ __forceinline__ bool update_block(int nu, int ng, int* k) {
  const int b = blockIdx.x, both = nu < ng ? nu : ng;
  if (b < 2 * both) {
    *k = b >> 1;
    return !(b & 1);
  }
  *k = b - both;
  return nu > ng;
}

// Gather block k: next ids j = 256 (k / ysub) + threadIdx.x, the kGRows
// sublanes from kGRows (k % ysub).
template <typename TW>
__device__ __forceinline__ void gather_round(const TW* table, int64_t vc,
                                             int dp,
                                             const int* __restrict__ cols,
                                             int n,
                                             const int* __restrict__ next,
                                             int n_g, float* __restrict__ rows,
                                             int k) {
  const int ysub = (dp + kGRows - 1) / kGRows;
  const int64_t j = static_cast<int64_t>(k / ysub) * kThreads + threadIdx.x;
  const int p0 = k % ysub * kGRows;
  const bool in = j < n_g;
  const int c = in ? next[j] : -1;
  const bool live = c >= 0 && c < vc;
  const Span s = warp_span(cols, n, c, live);
  if (!in || s.j1 > s.j0) return;  // its head writes a shared column's rows
  float v[kGRows];
#pragma unroll
  for (int r = 0; r < kGRows; ++r)
    v[r] = (live && p0 + r < dp)
               ? mr::to_f(table[static_cast<int64_t>(p0 + r) * vc + c])
               : 0.f;
#pragma unroll
  for (int r = 0; r < kGRows; ++r)
    if (p0 + r < dp) rows[static_cast<int64_t>(p0 + r) * n_g + j] = v[r];
}

// LazyAdam at every fold (Opt = AdamCols) and FTRL at fold 1 (FtrlCols).
// Update block k takes the slot schedule: the slots from 256 (k % nux)
// in strides of 256 nux, the kSub sublanes from kSub (k / nux); a gather
// block takes 256 next ids.
template <typename Opt>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_cols_kernel(Opt opt, int64_t vc, int dp, const int* __restrict__ cols,
                  const float* __restrict__ g, int n, int fold,
                  const int* __restrict__ next, int n_g,
                  float* __restrict__ rows, int nux, int nu, int ng) {
  int k;
  if (!update_block(nu, ng, &k)) {
    gather_round(opt.table, vc, dp, cols, n, next, n_g, rows, k);
    return;
  }
  opt.ready();
  const SlotRows out{next, n_g, dp, rows};
  const int p0 = k / nux * kSub;
  for (int64_t b = static_cast<int64_t>(k % nux) * kThreads;
       mr::live_round(cols, n, vc, b); b += static_cast<int64_t>(nux) * kThreads)
    mr::update_slot<kSub>(opt, vc, dp, cols, mr::AugRows{g, n, dp}, n,
                          fold, static_cast<int>(b) + threadIdx.x, p0, out);
}

// FTRL at fold > 1: update block k takes the slots from 256 k in strides
// of 256 nu, each warp 32 of them over all dp sublanes.
template <typename TW>
__global__ void __launch_bounds__(kThreads, kFoldMinBlocks)
fused_fold_kernel(TW* table, float* accum, float* linear, int64_t vc, int dp,
                  const int* __restrict__ cols, const float* __restrict__ g,
                  int n, mr::FtrlHyper h, const int* __restrict__ next,
                  int n_g, float* __restrict__ rows, int nu, int ng) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 stage[kWarps][32 * mr::kFoldRow];
  __shared__ Span spans[kWarps][32];
  int k;
  if (!update_block(nu, ng, &k)) {
    gather_round(table, vc, dp, cols, n, next, n_g, rows, k);
    return;
  }
  const int w = threadIdx.x >> 5;
  const FoldRows<TW> out{table, vc, next, n_g, dp, rows, spans[w]};
  for (int64_t b = static_cast<int64_t>(k) * kThreads;
       mr::live_round(cols, n, vc, b); b += static_cast<int64_t>(nu) * kThreads)
    mr::ftrl_fold_round(table, accum, linear, vc, dp, cols,
                        mr::AugRows{g, n, dp}, n, h,
                        static_cast<int>(b) + threadIdx.x, stage[w], out);
}

// Blocks along the slots of an update: one per 256, at most kMaxBlocksX
// (they stride over the rest).
int slot_blocks(int n) {
  const int bx = static_cast<int>(mr::blocks_for(n, kThreads));
  return bx < kMaxBlocksX ? bx : kMaxBlocksX;
}

// Gather blocks of a launch: one per 256 next ids x kGRows sublanes.
int gather_blocks(int n_g, int dp) {
  return static_cast<int>(mr::blocks_for(n_g, kThreads)) *
         ((dp + kGRows - 1) / kGRows);
}

bool bad_fused(int64_t vc, int dp, int n, int fold, int n_g) {
  return mr::bad_cols_shape(vc, dp, n, fold) || n_g < 0 || vc > INT32_MAX;
}

template <typename Opt>
void launch_cols(const Opt& opt, int64_t vc, int dp, const int* cols,
                 const float* g, int n, int fold, const int* next, int n_g,
                 float* rows, cudaStream_t st) {
  const int nux = slot_blocks(n), nu = nux * ((dp + kSub - 1) / kSub);
  const int ng = gather_blocks(n_g, dp);
  if (nu + ng == 0) return;
  fused_cols_kernel<Opt><<<nu + ng, kThreads, 0, st>>>(
      opt, vc, dp, cols, g, n, fold, next, n_g, rows, nux, nu, ng);
}

template <typename TW, typename TS>
void launch_adam(void* table, void* m, void* v, const mr::AdamHyper& h,
                 int64_t vc, int dp, const int* cols, const float* g, int n,
                 int fold, const int* next, int n_g, float* rows,
                 cudaStream_t st) {
  const mr::AdamCols<TW, TS> opt{static_cast<TW*>(table), static_cast<TS*>(m),
                                 static_cast<TS*>(v), h, 0.f};
  launch_cols(opt, vc, dp, cols, g, n, fold, next, n_g, rows, st);
}

template <typename TW>
void launch_ftrl(void* table, float* accum, float* linear,
                 const mr::FtrlHyper& h, int64_t vc, int dp, const int* cols,
                 const float* g, int n, int fold, const int* next, int n_g,
                 float* rows, cudaStream_t st) {
  if (fold == 1) {
    const mr::FtrlCols<TW> opt{static_cast<TW*>(table), accum, linear, h};
    launch_cols(opt, vc, dp, cols, g, n, fold, next, n_g, rows, st);
    return;
  }
  const int nu = slot_blocks(n), ng = gather_blocks(n_g, dp);
  if (nu + ng == 0) return;
  fused_fold_kernel<TW><<<nu + ng, kThreads, 0, st>>>(
      static_cast<TW*>(table), accum, linear, vc, dp, cols, g, n, h, next, n_g,
      rows, nu, ng);
}

}  // namespace

// table: [dp, vc] f32 or bf16 (table_bf16); m, v: [dp, vc] f32 or bf16
// (state_bf16); cols: [n] i32 ascending; g: [dp + 8, n] f32; lr_t: one f32
// on the device; next: [n_g] i32 ascending; rows: [dp, n_g] f32, every
// element written.
extern "C" int mr_fused_adam_gather(
    void* table, int table_bf16, void* m, void* v, int state_bf16, int64_t vc,
    int dp, const int* cols, const float* g, int n, int fold,
    const float* lr_t, float b1, float one_minus_b1, float b2,
    float one_minus_b2, float eps, float inv_scale, const int* next, int n_g,
    float* rows, void* stream) {
  if (bad_fused(vc, dp, n, fold, n_g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::AdamHyper h{lr_t, b1, one_minus_b1, b2, one_minus_b2, eps,
                        inv_scale};
  if (table_bf16 && state_bf16)
    launch_adam<__nv_bfloat16, __nv_bfloat16>(table, m, v, h, vc, dp, cols, g,
                                              n, fold, next, n_g, rows, st);
  else if (table_bf16)
    launch_adam<__nv_bfloat16, float>(table, m, v, h, vc, dp, cols, g, n, fold,
                                      next, n_g, rows, st);
  else if (state_bf16)
    launch_adam<float, __nv_bfloat16>(table, m, v, h, vc, dp, cols, g, n, fold,
                                      next, n_g, rows, st);
  else
    launch_adam<float, float>(table, m, v, h, vc, dp, cols, g, n, fold, next,
                              n_g, rows, st);
  return static_cast<int>(cudaGetLastError());
}

// table: [dp, vc] f32 or bf16; accum, linear: [dp, vc] f32; the other
// arguments as in mr_fused_adam_gather.
extern "C" int mr_fused_ftrl_gather(
    void* table, int table_bf16, float* accum, float* linear, int64_t vc,
    int dp, const int* cols, const float* g, int n, int fold, float lr,
    float l1, float two_l2, float inv_scale, const int* next, int n_g,
    float* rows, void* stream) {
  if (bad_fused(vc, dp, n, fold, n_g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::FtrlHyper h{lr, l1, two_l2, inv_scale};
  if (table_bf16)
    launch_ftrl<__nv_bfloat16>(table, accum, linear, h, vc, dp, cols, g, n,
                               fold, next, n_g, rows, st);
  else
    launch_ftrl<float>(table, accum, linear, h, vc, dp, cols, g, n, fold, next,
                       n_g, rows, st);
  return static_cast<int>(cudaGetLastError());
}
