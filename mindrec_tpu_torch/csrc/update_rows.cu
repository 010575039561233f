// Lazy row updates on row_packed storage: LazyAdam and FTRL-proximal.
//
// Replaces mindrec_tpu/ops/pallas/stream_update_rows.py:
// streamed_adam_rows and streamed_ftrl_rows.  The TPU kernels streamed
// every tile of the table through VMEM and placed the gradients with
// one-hot matmuls, because scattered row access was slow there.  Here
// one thread owns one (unique slot u, lane k < dim) pair and reads and
// writes only lane sub[u]*dim + k of storage row rows[u] of the table
// and its state, in place.  The sorted unique ids are distinct, so no
// two threads touch the same element: no atomics.
//
// Touch rules (exact): a slot is skipped when rows[u] is outside
// [0, n_rows) (the sentinel 2**31-2 always is) or present[u] == 0;
// every other slot updates, even with a zero gradient; lanes of sibling
// logical rows in the same storage row are never written.  G is the
// slot's summed gradient divided by the loss scale.  Arithmetic is
// float32; stored values round to their type (bf16 round-to-nearest).
// The Adam rate lr_t arrives as a device scalar, so the step never waits
// on the host.  Bound: bytes - per slot the ids and gradient, and per
// touched element its weight and state read once and written once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool slot_index(const int* __restrict__ rows,
                                           const int* __restrict__ sub,
                                           const int* __restrict__ present,
                                           int u, int k, int dim, int n_rows,
                                           int ld, int64_t* idx) {
  int row = rows[u];
  if (row < 0 || row >= n_rows) return false;
  if (present != nullptr && present[u] == 0) return false;
  int lane = sub[u] * dim + k;
  if (lane < 0 || lane >= ld) return false;
  *idx = static_cast<int64_t>(row) * ld + lane;
  return true;
}

template <typename TW, typename TS>
__global__ void adam_rows_kernel(TW* __restrict__ table, TS* __restrict__ m,
                                 TS* __restrict__ v,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ sub,
                                 const int* __restrict__ present,
                                 const float* __restrict__ g,
                                 const float* __restrict__ lr_t_ptr, int n_uq,
                                 int dim, int n_rows, int ld, float b1,
                                 float one_minus_b1, float b2,
                                 float one_minus_b2, float eps,
                                 float inv_scale) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<int64_t>(n_uq) * dim) return;
  int u = static_cast<int>(t / dim);
  int k = static_cast<int>(t - static_cast<int64_t>(u) * dim);
  int64_t idx;
  if (!slot_index(rows, sub, present, u, k, dim, n_rows, ld, &idx)) return;
  float G = g[t] * inv_scale;
  float m_new = b1 * mr::to_f(m[idx]) + one_minus_b1 * G;
  float v_new = b2 * mr::to_f(v[idx]) + one_minus_b2 * G * G;
  float upd = *lr_t_ptr * m_new / (sqrtf(v_new) + eps);
  table[idx] = mr::from_f<TW>(mr::to_f(table[idx]) - upd);
  m[idx] = mr::from_f<TS>(m_new);
  v[idx] = mr::from_f<TS>(v_new);
}

template <typename TW>
__global__ void ftrl_rows_kernel(TW* __restrict__ table,
                                 float* __restrict__ accum,
                                 float* __restrict__ linear,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ sub,
                                 const int* __restrict__ present,
                                 const float* __restrict__ g, int n_uq,
                                 int dim, int n_rows, int ld, float lr,
                                 float l1, float two_l2, float inv_scale) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<int64_t>(n_uq) * dim) return;
  int u = static_cast<int>(t / dim);
  int k = static_cast<int>(t - static_cast<int64_t>(u) * dim);
  int64_t idx;
  if (!slot_index(rows, sub, present, u, k, dim, n_rows, ld, &idx)) return;
  float G = g[t] * inv_scale;
  float w = mr::to_f(table[idx]);
  float a_old = accum[idx];
  float lin = linear[idx];
  float a_new = a_old + G * G;
  float sq_new = sqrtf(a_new);
  float sigma = (sq_new - sqrtf(a_old)) / lr;
  float lin_new = lin + G - sigma * w;
  float quad = sq_new / lr + two_l2;
  float w_new = 0.f;
  if (fabsf(lin_new) > l1) {
    float sgn = lin_new > 0.f ? 1.f : -1.f;
    w_new = (sgn * l1 - lin_new) / quad;
  }
  table[idx] = mr::from_f<TW>(w_new);
  accum[idx] = a_new;
  linear[idx] = lin_new;
}

template <typename TW, typename TS>
void launch_adam(void* table, void* m, void* v, const int* rows,
                 const int* sub, const int* present, const float* g,
                 const float* lr_t, int n_uq, int dim, int n_rows, int ld,
                 float b1, float omb1, float b2, float omb2, float eps,
                 float inv_scale, cudaStream_t st) {
  unsigned blocks = mr::blocks_for(static_cast<int64_t>(n_uq) * dim, kThreads);
  adam_rows_kernel<TW, TS><<<blocks, kThreads, 0, st>>>(
      static_cast<TW*>(table), static_cast<TS*>(m), static_cast<TS*>(v), rows,
      sub, present, g, lr_t, n_uq, dim, n_rows, ld, b1, omb1, b2, omb2, eps,
      inv_scale);
}

}  // namespace

// table: [n_rows, ld] f32 or bf16 (table_bf16); m, v: same shape, f32 or
// bf16 (state_bf16); rows, sub, present (nullable): [n_uq] i32;
// g: [n_uq, dim] f32; lr_t: one f32 on the device.
extern "C" int mr_adam_rows(void* table, int table_bf16, void* m, void* v,
                            int state_bf16, const int* rows, const int* sub,
                            const int* present, const float* g,
                            const float* lr_t, int n_uq, int dim, int n_rows,
                            int ld, float b1, float one_minus_b1, float b2,
                            float one_minus_b2, float eps, float inv_scale,
                            void* stream) {
  if (n_uq < 0 || dim <= 0 || ld <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_uq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_bf16 && state_bf16) {
    launch_adam<__nv_bfloat16, __nv_bfloat16>(
        table, m, v, rows, sub, present, g, lr_t, n_uq, dim, n_rows, ld, b1,
        one_minus_b1, b2, one_minus_b2, eps, inv_scale, st);
  } else if (table_bf16) {
    launch_adam<__nv_bfloat16, float>(table, m, v, rows, sub, present, g, lr_t,
                                      n_uq, dim, n_rows, ld, b1, one_minus_b1,
                                      b2, one_minus_b2, eps, inv_scale, st);
  } else if (state_bf16) {
    launch_adam<float, __nv_bfloat16>(table, m, v, rows, sub, present, g, lr_t,
                                      n_uq, dim, n_rows, ld, b1, one_minus_b1,
                                      b2, one_minus_b2, eps, inv_scale, st);
  } else {
    launch_adam<float, float>(table, m, v, rows, sub, present, g, lr_t, n_uq,
                              dim, n_rows, ld, b1, one_minus_b1, b2,
                              one_minus_b2, eps, inv_scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: [n_rows, ld] f32 or bf16; accum, linear: [n_rows, ld] f32.
extern "C" int mr_ftrl_rows(void* table, int table_bf16, float* accum,
                            float* linear, const int* rows, const int* sub,
                            const int* present, const float* g, int n_uq,
                            int dim, int n_rows, int ld, float lr, float l1,
                            float two_l2, float inv_scale, void* stream) {
  if (n_uq < 0 || dim <= 0 || ld <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_uq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned blocks = mr::blocks_for(static_cast<int64_t>(n_uq) * dim, kThreads);
  if (table_bf16) {
    ftrl_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(table), accum, linear, rows, sub, present,
        g, n_uq, dim, n_rows, ld, lr, l1, two_l2, inv_scale);
  } else {
    ftrl_rows_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<float*>(table), accum, linear, rows, sub, present, g, n_uq,
        dim, n_rows, ld, lr, l1, two_l2, inv_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
