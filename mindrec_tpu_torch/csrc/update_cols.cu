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
//
// The folded layout's round lives in update_cols.cuh (ftrl_fold_round),
// shared with the fused update + gather of fused_cols.cu, which runs the
// slot layout above as update_cols.cuh's update_slot.  adam_cols and
// ftrl_cols at fold 1 keep their own copy of it: built from the shared
// one they ran 1.2% slower at the DeepFM fm shape, in turns on an NVIDIA
// H100 80GB HBM3 at 700 W.

#include "update_cols.cuh"

namespace {

constexpr int kThreads = 256;  // slots per block and round
constexpr int kSub = 2;        // sublanes per thread
constexpr int kMaxBlocksX = 1024;  // blocks along the slots; they stride

template <typename TW, typename TS>
__global__ void __launch_bounds__(kThreads)
adam_cols_kernel(TW* __restrict__ table, TS* __restrict__ m,
                 TS* __restrict__ v, int64_t vc, int dp,
                 const int* __restrict__ cols, const float* __restrict__ g,
                 int n, int fold, mr::AdamHyper h) {
  const int p0 = blockIdx.y * kSub;
  const float lr_t = *h.lr_t;
  for (int64_t b = blockIdx.x * kThreads; mr::live_round(cols, n, vc, b);
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
  for (int64_t b = blockIdx.x * kThreads; mr::live_round(cols, n, vc, b);
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

constexpr int kFoldThreads = 64;   // slots per block and round
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldBlocks = 8192;  // blocks of the folded FTRL; they stride

template <typename TW>
__global__ void __launch_bounds__(kFoldThreads)
ftrl_fold_kernel(TW* __restrict__ table, float* __restrict__ accum,
                 float* __restrict__ linear, int64_t vc, int dp,
                 const int* __restrict__ cols, const float* __restrict__ g,
                 int n, mr::FtrlHyper h) {
  __shared__ float4 smem[kFoldWarps][32 * mr::kFoldRow];
  for (int64_t b = blockIdx.x * kFoldThreads; mr::live_round(cols, n, vc, b);
       b += gridDim.x * kFoldThreads)
    mr::ftrl_fold_round(table, accum, linear, vc, dp, cols, g, n, h,
                        static_cast<int>(b) + threadIdx.x,
                        smem[threadIdx.x >> 5], mr::NoRows{});
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

template <typename TW>
void launch_ftrl(void* table, float* accum, float* linear, int64_t vc, int dp,
                 const int* cols, const float* g, int n, int fold,
                 const mr::FtrlHyper& h, cudaStream_t st) {
  if (fold > 1) {
    const unsigned bx = mr::blocks_for(n, kFoldThreads);
    ftrl_fold_kernel<TW><<<bx < kFoldBlocks ? bx : kFoldBlocks, kFoldThreads,
                           0, st>>>(static_cast<TW*>(table), accum, linear,
                                    vc, dp, cols, g, n, h);
    return;
  }
  ftrl_cols_kernel<TW><<<cols_grid(n, dp), kThreads, 0, st>>>(
      static_cast<TW*>(table), accum, linear, vc, dp, cols, g, n, fold, h);
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
  if (table_bf16)
    launch_ftrl<__nv_bfloat16>(table, accum, linear, vc, dp, cols, g, n, fold,
                               h, st);
  else
    launch_ftrl<float>(table, accum, linear, vc, dp, cols, g, n, fold, h, st);
  return static_cast<int>(cudaGetLastError());
}
