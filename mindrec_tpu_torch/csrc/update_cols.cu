// Lazy column updates on feature-major [dp, vc] storage: LazyAdam and
// FTRL-proximal, in place.
//
// Replaces mindrec_tpu/ops/pallas/stream_update.py: streamed_adam_cols
// and streamed_ftrl_cols.  The TPU kernels streamed every touched tile of
// the table through VMEM, summed the sorted gradient columns into it with
// one-hot matmuls (a flat (tile, chunk) schedule) and updated whole
// tiles under a touch mask.  Here only the touched columns are read and
// written.
//
// Input: cols [n] sorted storage columns (unique ids // fold, padded
// with sentinels) and grads_aug [dp + 8, n]: per slot its gradient
// (multiplied by the loss scale) and 8 touch rows.  Duplicate columns
// (fold-8 tables: neighbouring ids share a column; the tiny group gives 8
// slots per column) are contiguous because cols is sorted.  The slot
// that starts a run of equal columns sums the run's gradients and touch
// rows in slot order and updates the column once, so no two threads
// write one element and no compaction or host sync is needed.
//
// What bounds it is sectors: every touched element of the weight and its
// two state arrays is a 32-byte sector of its own, read and written,
// unless neighbouring sorted columns share it; the arithmetic is nothing
// beside that.  So the design keeps many such loads in flight and wastes
// no thread: thread (u, y) takes slot u for the kSub sublanes from
// kSub * y.  It reads the column, its neighbours (the run test) and its
// kSub gradient values together (one wait for memory), then starts its
// 3 * kSub loads of weight and state before any arithmetic, and stores
// under the touch gate.  A warp's lanes are consecutive slots, so the
// gradient rows are read coalesced and the sorted columns of one table
// row share sectors.  More sublanes per thread cost registers and so
// warps in flight: on the card 1, 2 and 4 are within 2% of each other at
// the large tables and 8 and 16 are slower; 2 loses least over the
// shapes of the driven paths.  cols is sorted, so the
// sentinel pads are its tail: at most kMaxBlocksX blocks stride over the
// slots 256 at a time and stop at the first round that starts on a
// sentinel, so the pads (91% of the slots in the DeepFM steps) cost each
// block one load and no blocks of their own.
//
// Touch (exact, as stream_update.py:_expand_touch): fold 1 - touch row 0
// gates every sublane; fold 8 (dim 1) - touch row p gates sublane p.
// Touch comes from the touch rows, never from G != 0: a slot with a zero
// gradient still updates, and a zeroed touch row (ids absent from a tiny
// group's batch) leaves the column as it was.  Columns outside [0, vc)
// (the sentinel (2**31-2) // fold) are skipped.  Arithmetic is float32
// with G = sum / loss_scale, in the order of the plain PyTorch versions
// (built with --fmad=false); stored values round to their type.  The
// Adam rate lr_t arrives as a device scalar, so the step never waits on
// the host.  Bound: bytes - cols and grads_aug read once, and each
// touched element's weight and two state values read and written once.
//
// Which kernel serves which table:
// * adam_cols_kernel - LazyAdam, every fold (the layout above);
// * ftrl_cols_kernel - FTRL at fold 1 (the layout above);
// * ftrl_fold_kernel - FTRL at fold > 1 (dp <= fold <= 8: the folded wide
//   tables, [8, vc / 8]; their weight and state, 3 x 2.6 MB at the
//   multitable recipe's w128, and grads_aug sit in L2).  In the layout
//   above 4 blocks each load every slot's column and neighbours for 2 of
//   the 8 sublanes, a run's head walks its run with dependent loads, and
//   every lane runs the FTRL arithmetic (IEEE square roots and
//   divisions, most of the instructions) for its sublanes though a slot
//   of a folded table with unique ids touches one sublane of 8: the
//   launch is bound by latency and issued instructions, not bytes.  Here
//   a lane takes one slot over all dp sublanes (so cols is read once):
//   its column, the columns beside the warp's two edges and its dp
//   gradient and dp touch values are loaded together, coalesced across
//   the warp.  The warp finds run heads by comparing neighbouring columns
//   with shuffles and a ballot; each lane stages its values in shared
//   memory (16-byte rows, padded against bank conflicts) and a head adds
//   its followers' rows in slot order, so the sums stay bit-equal to the
//   plain version's.  (Fetching them with shuffles instead costs every
//   lane 2 dp shuffles per step of the longest run: 0.0044-0.0048 ms
//   against 0.0033-0.0038 at the small tables, NVIDIA H100 80GB HBM3 at
//   700 W.)  Only a run
//   that crosses the warp's last lane is finished by a walk of loads past
//   the edge (runs are at most 8 slots at fold 8 with unique ids, but any
//   length is allowed).  Then the warp compacts its heads' touched
//   elements (a scan of their counts) into the same shared memory, and
//   each lane updates about one element: its weight and state loads, the
//   arithmetic once, and the stores.

#include "update_cols.cuh"

namespace {

constexpr int kThreads = 256;  // slots per block and round
constexpr int kSub = 2;        // sublanes per thread
constexpr int kMaxBlocksX = 1024;  // blocks along the slots; they stride

// A block takes the slots [b, b + 256) for b = 256 blockIdx.x and on in
// strides of the grid.  True while round b has work: it starts inside
// the slots and its first column is not past the table (cols is sorted,
// so every later round's is).
__device__ __forceinline__ bool live_round(const int* __restrict__ cols, int n,
                                           int64_t vc, int64_t b) {
  return b < n && cols[b] < vc;
}

template <typename TW, typename TS>
__global__ void __launch_bounds__(kThreads)
adam_cols_kernel(TW* __restrict__ table, TS* __restrict__ m,
                 TS* __restrict__ v, int64_t vc, int dp,
                 const int* __restrict__ cols, const float* __restrict__ g,
                 int n, int fold, mr::AdamHyper h) {
  const int p0 = blockIdx.y * kSub;
  const float lr_t = *h.lr_t;
  for (int64_t b = blockIdx.x * kThreads; live_round(cols, n, vc, b);
       b += gridDim.x * kThreads) {
    const int u = static_cast<int>(b) + threadIdx.x;
    if (u >= n) continue;
    int c;
    float sum[kSub], touch[kSub];
    if (!mr::run_sums<kSub>(cols, g, n, vc, dp, fold, u, p0, &c, sum, touch))
      continue;
    float w[kSub], mo[kSub], vo[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const int64_t idx = static_cast<int64_t>(p0 + r) * vc + c;
      if (p0 + r < dp) {
        w[r] = mr::to_f(table[idx]);
        mo[r] = mr::to_f(m[idx]);
        vo[r] = mr::to_f(v[idx]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (p0 + r < dp && touch[r] > 0.f) {
        const int64_t idx = static_cast<int64_t>(p0 + r) * vc + c;
        float w2, m2, v2;
        mr::adam_step(w[r], mo[r], vo[r], sum[r], h, lr_t, &w2, &m2, &v2);
        table[idx] = mr::from_f<TW>(w2);
        m[idx] = mr::from_f<TS>(m2);
        v[idx] = mr::from_f<TS>(v2);
      }
    }
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads)
ftrl_cols_kernel(TW* __restrict__ table, float* __restrict__ accum,
                 float* __restrict__ linear, int64_t vc, int dp,
                 const int* __restrict__ cols, const float* __restrict__ g,
                 int n, int fold, mr::FtrlHyper h) {
  const int p0 = blockIdx.y * kSub;
  for (int64_t b = blockIdx.x * kThreads; live_round(cols, n, vc, b);
       b += gridDim.x * kThreads) {
    const int u = static_cast<int>(b) + threadIdx.x;
    if (u >= n) continue;
    int c;
    float sum[kSub], touch[kSub];
    if (!mr::run_sums<kSub>(cols, g, n, vc, dp, fold, u, p0, &c, sum, touch))
      continue;
    float w[kSub], ao[kSub], lo[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const int64_t idx = static_cast<int64_t>(p0 + r) * vc + c;
      if (p0 + r < dp) {
        w[r] = mr::to_f(table[idx]);
        ao[r] = accum[idx];
        lo[r] = linear[idx];
      }
    }
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (p0 + r < dp && touch[r] > 0.f) {
        const int64_t idx = static_cast<int64_t>(p0 + r) * vc + c;
        float w2, a2, l2;
        mr::ftrl_step(w[r], ao[r], lo[r], sum[r], h, &w2, &a2, &l2);
        table[idx] = mr::from_f<TW>(w2);
        accum[idx] = a2;
        linear[idx] = l2;
      }
    }
  }
}

constexpr int kFoldMax = 8;        // sublanes of a folded table
constexpr int kFoldThreads = 64;   // slots per block and round
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldBlocks = 8192;  // blocks of the folded FTRL; they stride
constexpr int kFoldRow = 5;        // float4 staged per lane (4 + padding)

template <typename TW>
__global__ void __launch_bounds__(kFoldThreads)
ftrl_fold_kernel(TW* __restrict__ table, float* __restrict__ accum,
                 float* __restrict__ linear, int64_t vc, int dp,
                 const int* __restrict__ cols, const float* __restrict__ g,
                 int n, mr::FtrlHyper h) {
  constexpr unsigned kAll = 0xffffffffu;
  // per warp: its lanes' gradient and touch values, then (once the runs
  // are summed) its touched elements: column, sum and sublane
  __shared__ float4 smem[kFoldWarps][32 * kFoldRow];
  const int lane = threadIdx.x & 31;
  float4* mine = smem[threadIdx.x >> 5] + lane * kFoldRow;
  int* e_col = reinterpret_cast<int*>(smem[threadIdx.x >> 5]);
  float* e_sum = reinterpret_cast<float*>(e_col + 32 * kFoldMax);
  unsigned char* e_sub =
      reinterpret_cast<unsigned char*>(e_sum + 32 * kFoldMax);
  const float* t0 = g + static_cast<int64_t>(dp) * n;  // touch rows
  for (int64_t b = blockIdx.x * kFoldThreads; live_round(cols, n, vc, b);
       b += gridDim.x * kFoldThreads) {
    const int u = static_cast<int>(b) + threadIdx.x;
    const bool in = u < n;
    // the slot's column, the columns beside the warp's edges, and its dp
    // gradient and dp touch values: one wait for memory
    const int c = in ? cols[u] : -1;
    int edge = -1;
    if (lane == 0 && in && u > 0) edge = cols[u - 1];
    if (lane == 31 && u + 1 < n) edge = cols[u + 1];
    float G[kFoldMax], touch[kFoldMax];
#pragma unroll
    for (int p = 0; p < kFoldMax; ++p) {
      const bool ld = in && p < dp;
      G[p] = ld ? g[static_cast<int64_t>(p) * n + u] : 0.f;
      touch[p] = ld ? t0[static_cast<int64_t>(p) * n + u] : 0.f;
    }
    int prev = __shfl_up_sync(kAll, c, 1);
    if (lane == 0) prev = edge;
    const int next = __shfl_sync(kAll, edge, 31);  // column after the warp
    // runs start at slot 0, where the column changes, and past n
    const unsigned starts = __ballot_sync(kAll, !in || u == 0 || prev != c);
    const bool head = ((starts >> lane) & 1u) && in && c >= 0 && c < vc;
    const unsigned later = starts & ~((2u << lane) - 1u);
    const int end = later ? __ffs(later) - 1 : 32;  // run's end in the warp
    const int len = end - lane;
    // a head adds its followers' values from their rows of the stage, in
    // slot order
    mine[0] = make_float4(G[0], G[1], G[2], G[3]);
    mine[1] = make_float4(G[4], G[5], G[6], G[7]);
    mine[2] = make_float4(touch[0], touch[1], touch[2], touch[3]);
    mine[3] = make_float4(touch[4], touch[5], touch[6], touch[7]);
    __syncwarp();
    if (head) {
      for (int k = 1; k < len; ++k) {
        const float4* f = mine + k * kFoldRow;
        const float4 a = f[0], b = f[1], x = f[2], y = f[3];
        G[0] += a.x; G[1] += a.y; G[2] += a.z; G[3] += a.w;
        G[4] += b.x; G[5] += b.y; G[6] += b.z; G[7] += b.w;
        touch[0] += x.x; touch[1] += x.y; touch[2] += x.z; touch[3] += x.w;
        touch[4] += y.x; touch[5] += y.y; touch[6] += y.z; touch[7] += y.w;
      }
      if (end == 32 && next == c) {  // the run crosses the warp's edge
        for (int k = u + len; k < n && cols[k] == c; ++k) {
#pragma unroll
          for (int p = 0; p < kFoldMax; ++p) {
            if (p >= dp) break;
            G[p] += g[static_cast<int64_t>(p) * n + k];
            touch[p] += t0[static_cast<int64_t>(p) * n + k];
          }
        }
      }
    }
    // compact the heads' touched elements over the warp, so that a lane
    // updates about one element instead of every lane all dp sublanes
    unsigned mask = 0;
#pragma unroll
    for (int p = 0; p < kFoldMax; ++p)
      if (head && p < dp && touch[p] > 0.f) mask |= 1u << p;
    const int cnt = __popc(mask);
    int first = cnt;  // inclusive scan of the counts over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kAll, first, o);
      if (lane >= o) first += x;
    }
    const int total = __shfl_sync(kAll, first, 31);
    first -= cnt;
    __syncwarp();  // every head has read the stage
#pragma unroll
    for (int p = 0; p < kFoldMax; ++p) {
      if ((mask >> p) & 1u) {
        e_col[first] = c;
        e_sum[first] = G[p];
        e_sub[first] = static_cast<unsigned char>(p);
        ++first;
      }
    }
    __syncwarp();
    for (int i = lane; i < total; i += 32) {
      const int64_t idx = static_cast<int64_t>(e_sub[i]) * vc + e_col[i];
      float w2, a2, l2;
      mr::ftrl_step(mr::to_f(table[idx]), accum[idx], linear[idx], e_sum[i],
                    h, &w2, &a2, &l2);
      table[idx] = mr::from_f<TW>(w2);
      accum[idx] = a2;
      linear[idx] = l2;
    }
    __syncwarp();  // the next round writes the stage again
  }
}

inline dim3 cols_grid(int n, int dp) {
  const unsigned bx = mr::blocks_for(n, kThreads);
  return dim3(bx < kMaxBlocksX ? bx : kMaxBlocksX,
              static_cast<unsigned>((dp + kSub - 1) / kSub));
}

template <typename TW, typename TS>
void launch_adam(void* table, void* m, void* v, int64_t vc, int dp,
                 const int* cols, const float* g, int n, int fold,
                 const mr::AdamHyper& h, cudaStream_t st) {
  adam_cols_kernel<TW, TS><<<cols_grid(n, dp), kThreads, 0, st>>>(
      static_cast<TW*>(table), static_cast<TS*>(m), static_cast<TS*>(v), vc,
      dp, cols, g, n, fold, h);
}

}  // namespace

// table: [dp, vc] f32 or bf16 (table_bf16); m, v: [dp, vc] f32 or bf16
// (state_bf16); cols: [n] i32 sorted; g: [dp + 8, n] f32; lr_t: one f32
// on the device.  fold 1, or fold <= 8 with dp <= fold (emb_dim 1).
extern "C" int mr_adam_cols(void* table, int table_bf16, void* m, void* v,
                            int state_bf16, int64_t vc, int dp,
                            const int* cols, const float* g, int n, int fold,
                            const float* lr_t, float b1, float one_minus_b1,
                            float b2, float one_minus_b2, float eps,
                            float inv_scale, void* stream) {
  if (mr::bad_cols_shape(vc, dp, n, fold))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::AdamHyper h{lr_t, b1, one_minus_b1, b2, one_minus_b2, eps,
                        inv_scale};
  if (table_bf16 && state_bf16)
    launch_adam<__nv_bfloat16, __nv_bfloat16>(table, m, v, vc, dp, cols, g, n,
                                              fold, h, st);
  else if (table_bf16)
    launch_adam<__nv_bfloat16, float>(table, m, v, vc, dp, cols, g, n, fold, h,
                                      st);
  else if (state_bf16)
    launch_adam<float, __nv_bfloat16>(table, m, v, vc, dp, cols, g, n, fold, h,
                                      st);
  else
    launch_adam<float, float>(table, m, v, vc, dp, cols, g, n, fold, h, st);
  return static_cast<int>(cudaGetLastError());
}

// table: [dp, vc] f32 or bf16; accum, linear: [dp, vc] f32; the other
// arguments as in mr_adam_cols.
extern "C" int mr_ftrl_cols(void* table, int table_bf16, float* accum,
                            float* linear, int64_t vc, int dp,
                            const int* cols, const float* g, int n, int fold,
                            float lr, float l1, float two_l2, float inv_scale,
                            void* stream) {
  if (mr::bad_cols_shape(vc, dp, n, fold))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::FtrlHyper h{lr, l1, two_l2, inv_scale};
  if (fold > 1) {
    const unsigned bx = mr::blocks_for(n, kFoldThreads);
    const unsigned blocks = bx < kFoldBlocks ? bx : kFoldBlocks;
    if (table_bf16)
      ftrl_fold_kernel<__nv_bfloat16><<<blocks, kFoldThreads, 0, st>>>(
          static_cast<__nv_bfloat16*>(table), accum, linear, vc, dp, cols, g,
          n, h);
    else
      ftrl_fold_kernel<float><<<blocks, kFoldThreads, 0, st>>>(
          static_cast<float*>(table), accum, linear, vc, dp, cols, g, n, h);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = cols_grid(n, dp);
  if (table_bf16) {
    ftrl_cols_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(table), accum, linear, vc, dp, cols, g, n,
        fold, h);
  } else {
    ftrl_cols_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<float*>(table), accum, linear, vc, dp, cols, g, n, fold, h);
  }
  return static_cast<int>(cudaGetLastError());
}
