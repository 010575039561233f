// Device arithmetic shared by the lazy column updates (update_cols.cu)
// and the fused update + gather (fused_cols.cu): the sums of a run of equal
// sorted columns and one LazyAdam / FTRL-proximal step of one element,
// float32, in the order of the plain PyTorch versions (built with
// --fmad=false); stored values round to their type.
#pragma once

#include "common.cuh"

namespace mr {

// Sums of the run of equal columns that starts at slot u, for the R
// sublanes from p0: each sublane's gradient row and the touch row that
// gates it (fold 1: touch row 0 for all; fold 8: touch row p), added in
// slot order.  g is [dp + 8, n].  The column, its two neighbours and the
// slot's own R + 1 (fold 8: 2 R) values are loaded together, before any
// test, so a thread waits for memory once here; the slots behind it in a
// run are added after.  Returns false when u does not start a run or its
// column is outside [0, vc); sublanes at or past dp get zeros.
template <int R>
__device__ __forceinline__ bool run_sums(const int* __restrict__ cols,
                                         const float* __restrict__ g, int n,
                                         int64_t vc, int dp, int fold, int u,
                                         int p0, int* col, float (&G)[R],
                                         float (&touch)[R]) {
  const int c = cols[u];
  const bool after = u > 0 && cols[u - 1] == c;
  const bool before = u + 1 < n && cols[u + 1] == c;
  const float* t0 = g + static_cast<int64_t>(dp) * n;
  float t = fold == 1 ? t0[u] : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r;
    G[r] = p < dp ? g[static_cast<int64_t>(p) * n + u] : 0.f;
    touch[r] = (fold != 1 && p < dp) ? t0[static_cast<int64_t>(p) * n + u] : 0.f;
  }
  if (c < 0 || c >= vc || after) return false;
  if (before) {  // a run: add the slots behind u, in slot order
    int len = 2;
    while (u + len < n && cols[u + len] == c) ++len;
    if (fold == 1)
      for (int k = 1; k < len; ++k) t += t0[u + k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      if (p >= dp) continue;
      const float* gp = g + static_cast<int64_t>(p) * n;
      for (int k = 1; k < len; ++k) G[r] += gp[u + k];
      if (fold != 1) {
        const float* tr = t0 + static_cast<int64_t>(p) * n;
        for (int k = 1; k < len; ++k) touch[r] += tr[u + k];
      }
    }
  }
  if (fold == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) touch[r] = t;
  }
  *col = c;
  return true;
}

// The same sums for one sublane p, for the fused update + gather, whose
// threads take a slot and a sublane each: the tests come first, so a slot
// that does not start a run loads no gradient.
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

// One LazyAdam step of an element from its loaded values.
__device__ __forceinline__ void adam_step(float w, float m, float v, float sum,
                                          const AdamHyper& h, float lr_t,
                                          float* w_new, float* m_new,
                                          float* v_new) {
  float G = sum * h.inv_scale;
  float m2 = h.b1 * m + h.one_minus_b1 * G;
  float v2 = h.b2 * v + h.one_minus_b2 * G * G;
  float upd = lr_t * m2 / (sqrtf(v2) + h.eps);
  *w_new = w - upd;
  *m_new = m2;
  *v_new = v2;
}

template <typename TW, typename TS>
__device__ __forceinline__ void adam_element(TW* table, TS* m, TS* v,
                                             int64_t idx, float sum,
                                             const AdamHyper& h) {
  float w2, m2, v2;
  adam_step(to_f(table[idx]), to_f(m[idx]), to_f(v[idx]), sum, h, *h.lr_t,
            &w2, &m2, &v2);
  table[idx] = from_f<TW>(w2);
  m[idx] = from_f<TS>(m2);
  v[idx] = from_f<TS>(v2);
}

// One FTRL-proximal step of an element from its loaded values.
__device__ __forceinline__ void ftrl_step(float w, float a_old, float lin,
                                          float sum, const FtrlHyper& h,
                                          float* w_new, float* a_new,
                                          float* lin_new) {
  float G = sum * h.inv_scale;
  float a2 = a_old + G * G;
  float sq_new = sqrtf(a2);
  float sigma = (sq_new - sqrtf(a_old)) / h.lr;
  float l2 = lin + G - sigma * w;
  float quad = sq_new / h.lr + h.two_l2;
  float w2 = 0.f;
  if (fabsf(l2) > h.l1) {
    float sgn = l2 > 0.f ? 1.f : -1.f;
    w2 = (sgn * h.l1 - l2) / quad;
  }
  *w_new = w2;
  *a_new = a2;
  *lin_new = l2;
}

template <typename TW>
__device__ __forceinline__ void ftrl_element(TW* table, float* accum,
                                             float* linear, int64_t idx,
                                             float sum, const FtrlHyper& h) {
  float w2, a2, l2;
  ftrl_step(to_f(table[idx]), accum[idx], linear[idx], sum, h, &w2, &a2, &l2);
  table[idx] = from_f<TW>(w2);
  accum[idx] = a2;
  linear[idx] = l2;
}

inline bool bad_cols_shape(int64_t vc, int dp, int n, int fold) {
  return vc < 0 || dp <= 0 || dp > 65535 || n < 0 ||
         !(fold == 1 || (fold > 1 && fold <= 8 && dp <= fold));
}

}  // namespace mr
