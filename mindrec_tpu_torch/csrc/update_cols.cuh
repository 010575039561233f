// Device arithmetic shared by the lazy column updates (update_cols.cu)
// and the fused update + gather (fused_cols.cu): the sum of a run of equal
// sorted columns and one LazyAdam / FTRL-proximal step of one element,
// float32, in the order of the plain PyTorch versions (built with
// --fmad=false); stored values round to their type.
#pragma once

#include "common.cuh"

namespace mr {

// Sum of the run of equal columns that starts at slot u, for sublane p's
// gradient row and the touch row that gates it (fold 1: touch row 0;
// fold 8: touch row p).  g is [dp + 8, n].  Returns false when u does not
// start a run or its column is outside [0, vc).
__device__ __forceinline__ bool run_sum(const int* __restrict__ cols,
                                        const float* __restrict__ g, int n,
                                        int64_t vc, int dp, int fold, int u,
                                        int p, int* col, float* G,
                                        float* touch) {
  int c = cols[u];
  if (c < 0 || c >= vc) return false;
  if (u > 0 && cols[u - 1] == c) return false;
  const float* gp = g + static_cast<int64_t>(p) * n;
  const float* tp = g + static_cast<int64_t>(dp + (fold == 1 ? 0 : p)) * n;
  float s = gp[u], t = tp[u];
  for (int k = u + 1; k < n && cols[k] == c; ++k) {
    s += gp[k];
    t += tp[k];
  }
  *col = c;
  *G = s;
  *touch = t;
  return true;
}

struct AdamHyper {
  const float* lr_t;  // bias-corrected rate, one float32 on the device
  float b1, one_minus_b1, b2, one_minus_b2, eps, inv_scale;
};

struct FtrlHyper {
  float lr, l1, two_l2, inv_scale;
};

template <typename TW, typename TS>
__device__ __forceinline__ void adam_element(TW* table, TS* m, TS* v,
                                             int64_t idx, float sum,
                                             const AdamHyper& h) {
  float G = sum * h.inv_scale;
  float m_new = h.b1 * to_f(m[idx]) + h.one_minus_b1 * G;
  float v_new = h.b2 * to_f(v[idx]) + h.one_minus_b2 * G * G;
  float upd = *h.lr_t * m_new / (sqrtf(v_new) + h.eps);
  table[idx] = from_f<TW>(to_f(table[idx]) - upd);
  m[idx] = from_f<TS>(m_new);
  v[idx] = from_f<TS>(v_new);
}

template <typename TW>
__device__ __forceinline__ void ftrl_element(TW* table, float* accum,
                                             float* linear, int64_t idx,
                                             float sum, const FtrlHyper& h) {
  float G = sum * h.inv_scale;
  float w = to_f(table[idx]);
  float a_old = accum[idx];
  float lin = linear[idx];
  float a_new = a_old + G * G;
  float sq_new = sqrtf(a_new);
  float sigma = (sq_new - sqrtf(a_old)) / h.lr;
  float lin_new = lin + G - sigma * w;
  float quad = sq_new / h.lr + h.two_l2;
  float w_new = 0.f;
  if (fabsf(lin_new) > h.l1) {
    float sgn = lin_new > 0.f ? 1.f : -1.f;
    w_new = (sgn * h.l1 - lin_new) / quad;
  }
  table[idx] = from_f<TW>(w_new);
  accum[idx] = a_new;
  linear[idx] = lin_new;
}

inline bool bad_cols_shape(int64_t vc, int dp, int n, int fold) {
  return vc < 0 || dp <= 0 || dp > 65535 || n < 0 ||
         !(fold == 1 || (fold > 1 && fold <= 8 && dp <= fold));
}

}  // namespace mr
