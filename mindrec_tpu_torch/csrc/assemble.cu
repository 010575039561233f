// The multitable model's feature assembly, forward and backward, from each
// id group's batch-order rows (ops/kernels/assemble.py binds it).
//
// Forward: for every sample b, deep_in[b] (bf16, the MLP's input) is the
// continuous values, then per group either its F positions' deep-table
// lanes side by side (copied), or, for a pooled group, the full-length
// mean of each field's masked rows: sum_i bf16(row_i * bf16(mask_i)) in
// float32, times 1/L, rounded once to bf16.  wide[b] (float32) sums every
// position's folded wide-table lane, the owning sublane id % fold (times
// the mask in a pooled group), per group and then over the groups.
// Backward: each group's gradient rows [N, width] bf16 are written whole,
// once: the deep-table lanes from d deep_in (a pooled field's gradient
// times 1/L in float32, rounded to bf16, then times the mask), the owning
// wide sublane bf16(d wide) (times the mask), zeros in every other lane.
// The rounding is the plain PyTorch version's (assemble_plain, which
// repeats the model's apply_rows_batch arithmetic on the groups' rows), so
// the results are bit-equal where a float32 sum's order does not matter.
//
// Replaces no Pallas kernel: the JAX reference leaves this assembly to
// XLA's fusion (mindrec_tpu/models/multitable.py:274-283).  In PyTorch it
// was some twenty passes a step (slices, fold masks, the mask product and
// its float32 copy, a one-hot pooling matmul, a float32 concatenation cast
// again to bf16, and in backward a zero-filled buffer of the group's full
// width per slice, plus a copy and a bf16 add).  Bound: bytes.  At the
// multitable recipe (batch 131072; positions: multi 5,111,808, indicator
// 1,703,936, emb128 393,216, single 786,432) the forward reads each
// position's live lanes once, by 32-byte sectors (160 B a 64-lane
// position, 288 B an emb128 one), the masks, ids and continuous values,
// and writes deep_in once (~1.93 GB); the backward reads d deep_in once
// and writes every gradient row once (~2.73 GB): ~1.4 ms at 3.35 TB/s.
// On an NVIDIA H100 80GB HBM3 at 700 W they take 0.87 and 1.09 ms (the
// PyTorch version 6.4 and 13.8 ms).
//
// Design.  Both kernels give a warp to a sample and walk its data in
// order: a group's part of deep_in is contiguous (chunk c of 8 lanes at
// column out_off + 8 c), and so are a sample's gradient rows in each group
// (vector v at 8 v past its first row).  So every store is 16 bytes,
// neighbouring lanes on neighbouring addresses (a warp's 512 contiguous
// bytes), every load of a row 16 bytes beside its neighbours', and the
// indices advance by adding, without a division per vector.  A lane
// loads two chunks or vectors before it stores either.  Forward: a pooled
// chunk sums its field's rows in registers; then the lanes take the
// sample's positions for the wide lanes and a warp shuffle sums each
// group.  Backward: a deep vector reads its 16 bytes of d deep_in, the
// wide vector one id; the other lanes are zeros.  When the continuous
// width leaves deep_in's chunks off 16-byte boundaries, its loads and
// stores go element by element.

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 4;
constexpr int kMaxFields = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // samples per block, a warp each
// forward blocks an SM must hold: caps the registers (48), 40 warps an SM
constexpr int kFwdBlocks = 5;

struct Group {
  const __nv_bfloat16* rows;  // [N, width]
  const int* ids;             // [N]
  __nv_bfloat16* grad;        // [N, width], backward
  const float* mask[kMaxFields];  // pooled: [B, len[k]] each
  float inv[kMaxFields];          // pooled: float32(1 / len[k])
  int len[kMaxFields];
  int start[kMaxFields];  // first position of field k within a sample
  int64_t width;
  int F;         // positions per sample
  int deep_off;  // first lane of the deep table
  int deep_dim;  // its lanes, a multiple of 8
  int wide_off;  // first lane of the folded wide table, a multiple of 8
  int fold;      // <= 8
  int out_off;   // first column of the group's part of deep_in
  int nf;        // pooled fields; 0 copies the F rows
  int chunks;    // 8-lane chunks of deep_in per sample
};

struct Plan {
  Group g[kMaxGroups];
  int ng;
  int64_t B;
  int out_w;
  int cont_dim;
  int vec;  // deep_in's chunks lie on 16-byte boundaries
  const float* cont;  // [B, cont_dim]
  __nv_bfloat16* deep_in;  // [B, out_w]
  float* wide;  // [B]
  const __nv_bfloat16* d_deep;  // [B, out_w]
  const float* d_wide;  // [B]
};

// 8 bf16 lanes, two a word, the lower lane in the low half
struct V8 {
  uint32_t w[4];
};

__device__ __forceinline__ float lane_f(const V8& v, int e) {
  const uint32_t w = v.w[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// round to bf16 and back
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

__device__ __forceinline__ V8 load8(const __nv_bfloat16* p, bool vec) {
  V8 v;
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v.w[e] = static_cast<uint32_t>(s[2 * e]) |
               (static_cast<uint32_t>(s[2 * e + 1]) << 16);
  }
  return v;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const V8& v,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else {
    unsigned short* s = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[2 * e] = static_cast<unsigned short>(v.w[e] & 0xffffu);
      s[2 * e + 1] = static_cast<unsigned short>(v.w[e] >> 16);
    }
  }
}

__device__ __forceinline__ int sub_row(int id, int fold) {
  const int s = id % fold;  // torch.remainder: never negative
  return s < 0 ? s + fold : s;
}

// Advances (f, q), a position and its chunk q < per, by 32 chunks.
__device__ __forceinline__ void advance32(int& f, int& q, int per) {
  q += 32;
  while (q >= per) {
    q -= per;
    ++f;
  }
}

// The value of pooled chunk c (field c / per, lanes 8 * (c % per)) of
// sample b's part of deep_in.
__device__ __forceinline__ V8 pooled_chunk(const Group& g, int64_t b, int c) {
  const int per = g.deep_dim >> 3;
  const int k = c / per;
  const int L = g.len[k];
  const float* m = g.mask[k] + b * L;
  const __nv_bfloat16* r = g.rows + (b * g.F + g.start[k]) * g.width +
                           g.deep_off + (c - k * per) * 8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll 2
  for (int i = 0; i < L; ++i) {
    const V8 x = load8(r + i * g.width, true);
    const float mk = bf(__ldg(m + i));
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += bf(lane_f(x, e) * mk);
  }
  const float inv = g.inv[k];
  V8 v;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v.w[e] = pack2(acc[2 * e] * inv, acc[2 * e + 1] * inv);
  return v;
}

// One warp per sample.  A group's chunks are contiguous in deep_in (chunk
// c at column out_off + 8 c), so the lanes walk them in order, two a lane
// loaded before either is stored.
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
assemble_fwd_kernel(const __grid_constant__ Plan p) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (b >= p.B) return;
  __nv_bfloat16* out = p.deep_in + b * p.out_w;
  for (int c = lane; c < p.cont_dim; c += 32)
    out[c] = __float2bfloat16_rn(p.cont[b * p.cont_dim + c]);
  float sum = 0.0f;
  for (int gi = 0; gi < p.ng; ++gi) {
    const Group& g = p.g[gi];
    __nv_bfloat16* o = out + g.out_off;
    const __nv_bfloat16* rows = g.rows + b * g.F * g.width;
    if (g.nf == 0) {
      const int per = g.deep_dim >> 3;
      int f = lane / per, q = lane - f * per;
      for (int c = lane; c < g.chunks; c += 64) {
        const V8 x = load8(rows + f * g.width + g.deep_off + q * 8, true);
        advance32(f, q, per);
        const bool two = c + 32 < g.chunks;
        V8 y;
        if (two) y = load8(rows + f * g.width + g.deep_off + q * 8, true);
        advance32(f, q, per);
        store8(o + c * 8, x, p.vec);
        if (two) store8(o + (c + 32) * 8, y, p.vec);
      }
    } else {
      for (int c = lane; c < g.chunks; c += 32)
        store8(o + c * 8, pooled_chunk(g, b, c), p.vec);
    }
    // the wide lanes: a lane's positions, then a warp sum per group
    float part = 0.0f;
    int k = 0;
    for (int f = lane; f < g.F; f += 32) {
      const int sub = sub_row(__ldg(g.ids + b * g.F + f), g.fold);
      float w = __bfloat162float(rows[f * g.width + g.wide_off + sub]);
      if (g.nf > 0) {
        while (k + 1 < g.nf && f >= g.start[k + 1]) ++k;
        w = bf(w * bf(__ldg(g.mask[k] + b * g.len[k] + f - g.start[k])));
      }
      part += w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    sum = gi == 0 ? part : sum + part;
  }
  if (lane == 0) p.wide[b] = sum;
}

// Gradient vector of lanes [l0, l0 + 8) of position f of sample b.
__device__ __forceinline__ V8 bwd_vec(const Group& g, const Plan& p,
                                      int64_t b, int f, int l0, int& k,
                                      float wide_g) {
  V8 v = {{0u, 0u, 0u, 0u}};
  if (g.nf > 0)
    while (k + 1 < g.nf && f >= g.start[k + 1]) ++k;
  if (l0 >= g.deep_off && l0 < g.deep_off + g.deep_dim) {
    const __nv_bfloat16* src =
        p.d_deep + b * p.out_w + g.out_off + (l0 - g.deep_off);
    if (g.nf == 0) {
      v = load8(src + f * g.deep_dim, p.vec);
    } else {
      const V8 s = load8(src + k * g.deep_dim, p.vec);
      const float mk = bf(__ldg(g.mask[k] + b * g.len[k] + f - g.start[k]));
      const float inv = g.inv[k];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v.w[e] = pack2(bf(lane_f(s, 2 * e) * inv) * mk,
                       bf(lane_f(s, 2 * e + 1) * inv) * mk);
    }
  } else if (l0 == g.wide_off) {
    const int sub = sub_row(__ldg(g.ids + b * g.F + f), g.fold);
    float w = wide_g;
    if (g.nf > 0)
      w = bf(w * bf(__ldg(g.mask[k] + b * g.len[k] + f - g.start[k])));
    const uint32_t wb = __bfloat16_as_ushort(__float2bfloat16_rn(w));
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e == sub) v.w[e >> 1] = (e & 1) ? wb << 16 : wb;
  }
  return v;
}

// One warp per sample.  A sample's gradient rows are contiguous in each
// group (vector v of the sample at 8 v past its first row), so the lanes
// walk them in order, two a lane computed before either is stored.
__global__ void __launch_bounds__(kThreads)
assemble_bwd_kernel(const __grid_constant__ Plan p) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (b >= p.B) return;
  const float wide_g = bf(__ldg(p.d_wide + b));
  for (int gi = 0; gi < p.ng; ++gi) {
    const Group& g = p.g[gi];
    __nv_bfloat16* o = g.grad + b * g.F * g.width;
    const int rv = static_cast<int>(g.width >> 3);
    const int n = g.F * rv;
    int f = lane / rv, q = lane - f * rv, k = 0;
    for (int v = lane; v < n; v += 64) {
      const V8 x = bwd_vec(g, p, b, f, q * 8, k, wide_g);
      advance32(f, q, rv);
      const bool two = v + 32 < n;
      V8 y;
      if (two) y = bwd_vec(g, p, b, f, q * 8, k, wide_g);
      advance32(f, q, rv);
      store8(o + v * 8, x, true);
      if (two) store8(o + (v + 32) * 8, y, true);
    }
  }
}

// Fills a Plan from flat arrays (see mr_assemble_fwd); 0 or an error code.
int make_plan(Plan* p, int ng, int64_t B, int out_w, int cont_dim,
              const int64_t* ptrs, const int* ints, const float* invs) {
  if (ng < 1 || ng > kMaxGroups || B < 1 || cont_dim < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p->ng = ng;
  p->B = B;
  p->out_w = out_w;
  p->cont_dim = cont_dim;
  p->vec = cont_dim % 8 == 0 && out_w % 8 == 0;
  int col = cont_dim;
  for (int gi = 0; gi < ng; ++gi) {
    Group& g = p->g[gi];
    const int64_t* pp = ptrs + gi * (3 + kMaxFields);
    const int* ii = ints + gi * (8 + kMaxFields);
    g.rows = reinterpret_cast<const __nv_bfloat16*>(pp[0]);
    g.ids = reinterpret_cast<const int*>(pp[1]);
    g.grad = reinterpret_cast<__nv_bfloat16*>(pp[2]);
    g.width = ii[0];
    g.F = ii[1];
    g.deep_off = ii[2];
    g.deep_dim = ii[3];
    g.wide_off = ii[4];
    g.fold = ii[5];
    g.nf = ii[6];
    if (g.F < 1 || g.width % 8 != 0 || g.deep_off % 8 != 0 ||
        g.deep_dim < 8 || g.deep_dim % 8 != 0 ||
        g.deep_off + g.deep_dim > g.width || g.nf < 0 || g.nf > kMaxFields ||
        g.wide_off < 0 || g.wide_off % 8 != 0 || g.fold < 1 || g.fold > 8 ||
        g.wide_off + g.fold > g.width ||
        (g.wide_off < g.deep_off + g.deep_dim &&
         g.deep_off < g.wide_off + g.fold))
      return static_cast<int>(cudaErrorInvalidValue);
    int start = 0;
    for (int k = 0; k < g.nf; ++k) {
      g.mask[k] = reinterpret_cast<const float*>(pp[3 + k]);
      g.len[k] = ii[8 + k];
      g.inv[k] = invs[gi * kMaxFields + k];
      g.start[k] = start;
      start += g.len[k];
    }
    if (g.nf > 0 && start != g.F) return static_cast<int>(cudaErrorInvalidValue);
    g.out_off = col;
    g.chunks = (g.nf > 0 ? g.nf : g.F) * (g.deep_dim / 8);
    col += g.chunks * 8;
  }
  if (col != out_w) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Per group gi (ng <= 4): ptrs[gi * 11 + ...] = rows, ids, grad (unused in
// forward), the pooled fields' masks (8 slots); ints[gi * 16 + ...] =
// width, F, deep_off, deep_dim, wide_off, fold, nf, (unused),
// the fields' lengths (8 slots); invs[gi * 8 + k] = float32(1 / len[k]).
// deep_in: [B, out_w] bf16, out_w = cont_dim + the groups' columns; wide:
// [B] float32.
extern "C" int mr_assemble_fwd(int ng, int64_t B, int out_w, int cont_dim,
                               const int64_t* ptrs, const int* ints,
                               const float* invs, const float* cont,
                               void* deep_in, float* wide, void* stream) {
  Plan p;
  const int rc = make_plan(&p, ng, B, out_w, cont_dim, ptrs, ints, invs);
  if (rc != 0) return rc;
  p.cont = cont;
  p.deep_in = static_cast<__nv_bfloat16*>(deep_in);
  p.wide = wide;
  p.d_deep = nullptr;
  p.d_wide = nullptr;
  assemble_fwd_kernel<<<mr::blocks_for(B, kWarps), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The same plan; d_deep: [B, out_w] bf16, d_wide: [B] float32; writes
// every group's grad [N, width] bf16 whole.
extern "C" int mr_assemble_bwd(int ng, int64_t B, int out_w, int cont_dim,
                               const int64_t* ptrs, const int* ints,
                               const float* invs, const void* d_deep,
                               const float* d_wide, void* stream) {
  Plan p;
  const int rc = make_plan(&p, ng, B, out_w, cont_dim, ptrs, ints, invs);
  if (rc != 0) return rc;
  p.cont = nullptr;
  p.deep_in = nullptr;
  p.wide = nullptr;
  p.d_deep = static_cast<const __nv_bfloat16*>(d_deep);
  p.d_wide = d_wide;
  assemble_bwd_kernel<<<mr::blocks_for(B, kWarps), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
