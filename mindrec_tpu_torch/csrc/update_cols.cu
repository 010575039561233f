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
// write one element and no compaction or host sync is needed.  Thread
// (u, p) handles slot u and sublane p; a warp's lanes take consecutive
// slots of one sublane, so the gradient rows are read coalesced and the
// sorted columns of one table row share sectors.
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

#include "update_cols.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TW, typename TS>
__global__ void adam_cols_kernel(TW* __restrict__ table, TS* __restrict__ m,
                                 TS* __restrict__ v, int64_t vc, int dp,
                                 const int* __restrict__ cols,
                                 const float* __restrict__ g, int n, int fold,
                                 mr::AdamHyper h) {
  int u = blockIdx.x * kThreads + threadIdx.x;
  int p = blockIdx.y;
  if (u >= n) return;
  int c;
  float sum, touch;
  if (!mr::run_sum(cols, g, n, vc, dp, fold, u, p, &c, &sum, &touch)) return;
  if (!(touch > 0.f)) return;
  mr::adam_element(table, m, v, static_cast<int64_t>(p) * vc + c, sum, h);
}

template <typename TW>
__global__ void ftrl_cols_kernel(TW* __restrict__ table,
                                 float* __restrict__ accum,
                                 float* __restrict__ linear, int64_t vc,
                                 int dp, const int* __restrict__ cols,
                                 const float* __restrict__ g, int n, int fold,
                                 mr::FtrlHyper h) {
  int u = blockIdx.x * kThreads + threadIdx.x;
  int p = blockIdx.y;
  if (u >= n) return;
  int c;
  float sum, touch;
  if (!mr::run_sum(cols, g, n, vc, dp, fold, u, p, &c, &sum, &touch)) return;
  if (!(touch > 0.f)) return;
  mr::ftrl_element(table, accum, linear, static_cast<int64_t>(p) * vc + c, sum,
                   h);
}

template <typename TW, typename TS>
void launch_adam(void* table, void* m, void* v, int64_t vc, int dp,
                 const int* cols, const float* g, int n, int fold,
                 const mr::AdamHyper& h, cudaStream_t st) {
  dim3 grid(mr::blocks_for(n, kThreads), static_cast<unsigned>(dp));
  adam_cols_kernel<TW, TS><<<grid, kThreads, 0, st>>>(
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
  dim3 grid(mr::blocks_for(n, kThreads), static_cast<unsigned>(dp));
  const mr::FtrlHyper h{lr, l1, two_l2, inv_scale};
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
