// Device code shared by the lazy column updates (update_cols.cu) and the
// fused update + gather (fused_cols.cu): the sums of a run of equal sorted
// columns, one LazyAdam / FTRL-proximal step of one element, float32, in
// the order of the plain PyTorch versions (built with --fmad=false), the
// folded FTRL round that both run, and the update of one slot's R
// sublanes (update_slot: the column updates take 8 staged sublanes a
// thread, the fused kernel 2).  Stored values round to their type.
//
// A layout takes a Rows policy: what a run head does with the column it
// owns besides updating it.  NoRows (the column update) does nothing, and
// the compiler drops every call; the fused kernel's policies write the
// head's column, as stored, into the rows of the next ids that name it.
//
// It also takes an input accessor, where each slot's gradient and touch
// values come from: AugRows (the touch-augmented rows of make_aug_grads,
// which the fused kernel reads) or Sums (the summed gradient where the
// segment sum left it, touch made from the fold sub-rows and a gate, which
// the column updates read, in update_cols.cu staged in shared memory).
#pragma once

#include "common.cuh"

namespace mr {

// grads_aug [dp + 8, n]: slot u's gradient in rows 0..dp-1, its touch in
// the 8 rows under them (fold 1: touch row 0 gates every sublane; fold 8:
// touch row p gates sublane p).
struct AugRows {
  const float* g;
  int n, dp;
  __device__ __forceinline__ float grad(int p, int u) const {
    return g[static_cast<int64_t>(p) * n + u];
  }
  __device__ __forceinline__ float touch(int p, int u) const {
    return g[static_cast<int64_t>(dp + p) * n + u];
  }
};

// The summed gradient [dp, n] in place, element (p, u) at
// g[u * slot + p * lane] (any two strides: the transposed view of the
// segment sum's row-major [n, width] rows, or a contiguous [dp, n]), and
// the touch that make_aug_grads and the gate multiply would give it:
// gate[u * gate_step] (one flag when gate_step is 0; 1 without a gate),
// at fold > 1 only on sublane p == sub[u] (sub: the slot's fold sub-row;
// null at fold 1).  Products and sums of 0 and 1 are exact, so the sums
// of a run and every update are the augmented rows' bit for bit.
struct Sums {
  const float* g;
  int64_t slot, lane;
  const int* sub;
  const float* gate;
  int gate_step;
  __device__ __forceinline__ float grad(int p, int u) const {
    return __ldg(g + u * slot + p * lane);
  }
  __device__ __forceinline__ float touch(int p, int u) const {
    const float t =
        gate ? __ldg(gate + static_cast<int64_t>(u) * gate_step) : 1.f;
    return sub == nullptr || __ldg(sub + u) == p ? t : 0.f;
  }
};

// Sums of the run of equal columns that starts at slot u, for the R
// sublanes from p0: each sublane's gradient and the touch that gates it
// (fold 1: touch 0 for all; fold 8: touch p), added in slot order, read
// through the accessor in.  The column, its two neighbours and the slot's
// own R + 1 (fold 8: 2 R) values are loaded together, before any test, so
// a thread waits for memory once here; the slots behind it in a run are
// added after.  Returns false when u does not start a run or its column
// is outside [0, vc); sublanes at or past dp get zeros.
template <int R, typename In>
__device__ __forceinline__ bool run_sums(const int* __restrict__ cols,
                                         const In& in, int n, int64_t vc,
                                         int dp, int fold, int u, int p0,
                                         int* col, float (&G)[R],
                                         float (&touch)[R]) {
  const int c = cols[u];
  const bool after = u > 0 && cols[u - 1] == c;
  const bool before = u + 1 < n && cols[u + 1] == c;
  float t = fold == 1 ? in.touch(0, u) : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r;
    G[r] = p < dp ? in.grad(p, u) : 0.f;
    touch[r] = (fold != 1 && p < dp) ? in.touch(p, u) : 0.f;
  }
  if (c < 0 || c >= vc || after) return false;
  if (before) {  // a run: add the slots behind u, in slot order
    int len = 2;
    while (u + len < n && cols[u + len] == c) ++len;
    if (fold == 1)
      for (int k = 1; k < len; ++k) t += in.touch(0, u + k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      if (p >= dp) continue;
      for (int k = 1; k < len; ++k) G[r] += in.grad(p, u + k);
      if (fold != 1)
        for (int k = 1; k < len; ++k) touch[r] += in.touch(p, u + k);
    }
  }
  if (fold == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) touch[r] = t;
  }
  *col = c;
  return true;
}

// The slots [b, b + width) of a round hold work while the round starts
// inside the slots and its first column is not past the table (cols is
// sorted, so every later round's is): the sentinel pads at the tail of
// cols cost a block one load.
__device__ __forceinline__ bool live_round(const int* __restrict__ cols, int n,
                                           int64_t vc, int64_t b) {
  return b < n && cols[b] < vc;
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

// The optimizers as the slot layout uses them: load() reads an element's
// weight and state, update() steps it from its summed gradient, stores it
// and returns the weight as stored.  ready() runs once per thread before
// the first element (LazyAdam reads its device-side rate there).
template <typename TW, typename TS>
struct AdamCols {
  TW* table;
  TS* m;
  TS* v;
  AdamHyper h;
  float lr_t;
  struct Elt {
    float w, a, b;
  };
  __device__ __forceinline__ void ready() { lr_t = *h.lr_t; }
  __device__ __forceinline__ Elt load(int64_t idx) const {
    return Elt{to_f(table[idx]), to_f(m[idx]), to_f(v[idx])};
  }
  __device__ __forceinline__ float update(int64_t idx, const Elt& e,
                                          float sum) const {
    float w2, m2, v2;
    adam_step(e.w, e.a, e.b, sum, h, lr_t, &w2, &m2, &v2);
    const TW wq = from_f<TW>(w2);
    table[idx] = wq;
    m[idx] = from_f<TS>(m2);
    v[idx] = from_f<TS>(v2);
    return to_f(wq);
  }
};

template <typename TW>
struct FtrlCols {
  TW* table;
  float* accum;
  float* linear;
  FtrlHyper h;
  struct Elt {
    float w, a, b;
  };
  __device__ __forceinline__ void ready() {}
  __device__ __forceinline__ Elt load(int64_t idx) const {
    return Elt{to_f(table[idx]), accum[idx], linear[idx]};
  }
  __device__ __forceinline__ float update(int64_t idx, const Elt& e,
                                          float sum) const {
    float w2, a2, l2;
    ftrl_step(e.w, e.a, e.b, sum, h, &w2, &a2, &l2);
    const TW wq = from_f<TW>(w2);
    table[idx] = wq;
    accum[idx] = a2;
    linear[idx] = l2;
    return to_f(wq);
  }
};

// The Rows policy of the column updates: a head does nothing more.
// (find() is called by every lane of a warp together, need marking the
// heads.)
struct NoRows {
  static constexpr bool kOn = false;
  struct At {};
  __device__ __forceinline__ At find(int, bool) const { return At{}; }
  template <int R>
  __device__ __forceinline__ void write(At, int, const float (&)[R]) const {}
  __device__ __forceinline__ void untouched(At, int, unsigned) const {}
  __device__ __forceinline__ void stage(int, At) const {}
  __device__ __forceinline__ void element(int, int, float) const {}
};

// Slot u (none when u >= n) for the R sublanes from p0: the run test and sums, then every
// load of weight and state before any arithmetic, the update of the
// touched sublanes, and rows.write() of each sublane's weight as stored
// (as loaded where the touch gate kept it) where rows.find() places the
// head's column (it runs while the loads are in flight).  With a Rows
// policy that writes, every lane of the warp calls it together.
template <int R, typename Opt, typename Rows, typename In>
__device__ __forceinline__ void update_slot(const Opt& opt, int64_t vc, int dp,
                                            const int* __restrict__ cols,
                                            const In& in, int n, int fold,
                                            int u, int p0, const Rows& rows) {
  int c = 0;
  float sum[R], touch[R], wq[R];
  const bool head =
      u < n && run_sums<R>(cols, in, n, vc, dp, fold, u, p0, &c, sum, touch);
  typename Opt::Elt e[R];
  if (head) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (p0 + r < dp) e[r] = opt.load(static_cast<int64_t>(p0 + r) * vc + c);
  }
  typename Rows::At at{};
  if (Rows::kOn) at = rows.find(c, head);
  if (head) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (p0 + r >= dp) continue;
      wq[r] = e[r].w;
      if (touch[r] > 0.f)
        wq[r] =
            opt.update(static_cast<int64_t>(p0 + r) * vc + c, e[r], sum[r]);
    }
  }
  if (Rows::kOn) rows.write(at, p0, wq);
}

constexpr int kFoldMax = 8;  // sublanes of a folded table
constexpr int kFoldRow = 5;  // float4 staged per lane (4 + padding)

// One round of the folded FTRL layout (ftrl_fold_kernel, update_cols.cu):
// lane (threadIdx.x & 31) takes slot u over all dp <= 8 sublanes.
// stage: the warp's 32 * kFoldRow float4 of shared memory.  The head of a
// run finds its column's next ids (rows.find(), while the gradients load),
// writes the untouched sublanes' rows (rows.untouched()) and stages what it
// found (rows.stage()); the lane that updates a touched element writes its
// rows (rows.element()).
template <typename TW, typename Rows, typename In>
__device__ __forceinline__ void ftrl_fold_round(
    TW* table, float* accum, float* linear, int64_t vc, int dp,
    const int* __restrict__ cols, const In& in, int n, const FtrlHyper& h,
    int u, float4* stage, const Rows& rows) {
  constexpr unsigned kAll = 0xffffffffu;
  // per warp: its lanes' gradient and touch values, then (once the runs
  // are summed) its touched elements: column, sum and sublane (with the
  // head's lane in the high bits when Rows writes)
  const int lane = threadIdx.x & 31;
  float4* mine = stage + lane * kFoldRow;
  int* e_col = reinterpret_cast<int*>(stage);
  float* e_sum = reinterpret_cast<float*>(e_col + 32 * kFoldMax);
  unsigned char* e_sub =
      reinterpret_cast<unsigned char*>(e_sum + 32 * kFoldMax);
  const bool live = u < n;
  // the slot's column, the columns beside the warp's edges, and its dp
  // gradient and dp touch values: one wait for memory
  const int c = live ? cols[u] : -1;
  int edge = -1;
  if (lane == 0 && live && u > 0) edge = cols[u - 1];
  if (lane == 31 && u + 1 < n) edge = cols[u + 1];
  float G[kFoldMax], touch[kFoldMax];
#pragma unroll
  for (int p = 0; p < kFoldMax; ++p) {
    const bool ld = live && p < dp;
    G[p] = ld ? in.grad(p, u) : 0.f;
    touch[p] = ld ? in.touch(p, u) : 0.f;
  }
  int prev = __shfl_up_sync(kAll, c, 1);
  if (lane == 0) prev = edge;
  const int next = __shfl_sync(kAll, edge, 31);  // column after the warp
  // runs start at slot 0, where the column changes, and past n
  const unsigned starts = __ballot_sync(kAll, !live || u == 0 || prev != c);
  const bool head = ((starts >> lane) & 1u) && live && c >= 0 && c < vc;
  typename Rows::At at{};
  if (Rows::kOn) at = rows.find(c, head);
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
          G[p] += in.grad(p, k);
          touch[p] += in.touch(p, k);
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
  if (Rows::kOn && head) rows.untouched(at, c, mask);
  rows.stage(lane, at);
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
      e_sub[first] = static_cast<unsigned char>(Rows::kOn ? p | lane << 3 : p);
      ++first;
    }
  }
  __syncwarp();
  for (int i = lane; i < total; i += 32) {
    const int s = e_sub[i];
    const int p = Rows::kOn ? s & 7 : s;
    const int64_t idx = static_cast<int64_t>(p) * vc + e_col[i];
    float w2, a2, l2;
    ftrl_step(to_f(table[idx]), accum[idx], linear[idx], e_sum[i], h, &w2,
              &a2, &l2);
    const TW wq = from_f<TW>(w2);
    table[idx] = wq;
    accum[idx] = a2;
    linear[idx] = l2;
    rows.element(s >> 3, p, to_f(wq));
  }
  __syncwarp();  // the next round writes the stage again
}

inline bool bad_cols_shape(int64_t vc, int dp, int n, int fold) {
  return vc < 0 || dp <= 0 || dp > 65535 || n < 0 ||
         !(fold == 1 || (fold > 1 && fold <= 8 && dp <= fold));
}

}  // namespace mr
