// Row-major gather of feature-major table columns into the unique-row
// buffer: buf[j, off + p] = table[p, cols[j]] for every sublane p < dp,
// in place; a slot whose column lies outside [0, vc) (the sentinel
// (2**31-2) // fold) keeps the buffer's content.
//
// Replaces mindrec_tpu/ops/pallas/stream_gather.py:streamed_gather_rows,
// which streamed every tile of the [Dp, Vc] table through VMEM and placed
// the columns with one-hot matmuls (a chunk schedule over sorted ids).
// Here only the touched columns are read.  The table is feature-major: a
// column's dp values lie 4*vc bytes apart, while the buffer is row-major.
// Duplicate columns (folded tables, the tiny group's arange(2048) // 8)
// only read.  Bound: bytes - per slot its column (4 B), the dp values of
// each distinct touched column, and the dp written lanes of each valid
// slot; a row of the table moves in 32-byte sectors, so the floor is the
// sectors that hold a touched column.  Two paths, chosen by dp:
//
// * narrow (dp <= 8: the folded wide tables, [8, vc / 8] fold 8).  The
//   table is a few MB and sits in L2, and a slot writes 32 bytes of a
//   row 1 KB from the next slot's, so a shared-memory transpose costs
//   more than it saves.  What bounds the launch is those scattered 32-byte
//   writes (PyTorch's fill of the same lanes alone takes 0.014 ms at the
//   w128 launch, 3.5x the byte bound, on an NVIDIA H100 80GB HBM3 at
//   700 W) and latency.  No
//   shared memory and no barrier: a thread takes kNarrowSlots whole
//   slots, loads their columns, then all their sublanes (8 independent
//   loads in flight per slot), and writes each slot's lanes as one or
//   two 16-byte stores (4-byte stores when off or width leave the row
//   unaligned).
// * wide (dp 9..256; the step's deep tables have dp 64 and 128).  Bound
//   by the table's sectors.  A block takes kSlots consecutive slots; for
//   each group of 4 sublanes its warps read table[p, cols[j]] across the
//   slots (the columns are sorted, so neighbouring lanes read nearby
//   addresses), kQuads groups (16 loads) in flight per thread before they
//   go to shared memory as 16-byte stores.  The staged tile is sized to
//   dp (dynamic shared memory, rows of dp rounded up to 32 floats, so
//   more blocks fit an SM) and XOR-swizzled in 16-byte chunks, so both
//   the staging stores and the row reads are free of bank conflicts.
//   Then each slot's row is written as runs of 16-byte stores across
//   lanes (4-byte stores when unaligned).
//
// Both paths run blocks of kSmallThreads threads below kSmallN slots (the
// small groups' launches, latency-bound: more, shorter blocks) and of
// kThreads above; the wide path also below kTinyN slots, where a block
// has an SM to itself and more warps shorten its write phase.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmallThreads = 128;  // threads per block in [kTinyN, kSmallN)
constexpr int64_t kSmallN = 65536;  // slots
constexpr int64_t kTinyN = 4096;    // slots; the wide path keeps kThreads
constexpr int kSlots = 32;       // slots per block, wide path: a lane each
constexpr int kMaxDp = 256;      // sublanes staged per slot
constexpr int kQuads = 4;        // 4-sublane groups loaded before staging
constexpr int kNarrowDp = 8;     // dp up to this takes the narrow path
constexpr int kNarrowSlots = 1;  // slots per thread, narrow path

// 16-byte chunks per staged slot row: dp rounded up to 32 floats, so the
// swizzle q ^ (slot & 7) stays inside the row
__host__ __device__ inline int row_quads(int dp) { return (dp + 31) / 32 * 8; }

// Stores the 4 lanes from p of a row (those below dp): one 16-byte store
// when vec and all 4 are lanes of the table, else 4-byte stores.
__device__ __forceinline__ void store4(float* row, int p, int dp, bool vec,
                                      float a, float b, float c, float d) {
  if (vec && p + 4 <= dp) {
    *reinterpret_cast<float4*>(row + p) = make_float4(a, b, c, d);
    return;
  }
  if (p < dp) row[p] = a;
  if (p + 1 < dp) row[p + 1] = b;
  if (p + 2 < dp) row[p + 2] = c;
  if (p + 3 < dp) row[p + 3] = d;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
gather_rows_narrow(const T* __restrict__ table, int64_t vc, int dp,
                   const int* __restrict__ cols, int64_t n,
                   float* __restrict__ buf, int64_t width, int off,
                   bool vec) {
  const int64_t j0 =
      static_cast<int64_t>(blockIdx.x) * (THREADS * kNarrowSlots) +
      threadIdx.x;
  int c[kNarrowSlots];
#pragma unroll
  for (int k = 0; k < kNarrowSlots; ++k) {
    const int64_t j = j0 + k * THREADS;
    const int x = j < n ? cols[j] : -1;
    c[k] = (x >= 0 && x < vc) ? x : -1;
  }
  float v[kNarrowSlots][kNarrowDp];
#pragma unroll
  for (int k = 0; k < kNarrowSlots; ++k)
#pragma unroll
    for (int p = 0; p < kNarrowDp; ++p)
      v[k][p] = (c[k] >= 0 && p < dp)
                    ? mr::to_f(table[static_cast<int64_t>(p) * vc + c[k]])
                    : 0.f;
#pragma unroll
  for (int k = 0; k < kNarrowSlots; ++k) {
    if (c[k] < 0) continue;
    float* row = buf + (j0 + k * THREADS) * width + off;
#pragma unroll
    for (int p = 0; p < kNarrowDp; p += 4)
      store4(row, p, dp, vec, v[k][p], v[k][p + 1], v[k][p + 2], v[k][p + 3]);
  }
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
gather_rows_wide(const T* __restrict__ table, int64_t vc, int dp,
                 const int* __restrict__ cols, int64_t n,
                 float* __restrict__ buf, int64_t width, int off, bool vec) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float4 tile[];  // [kSlots][row_quads(dp)], swizzled
  __shared__ int scol[kSlots];
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kSlots;
  const int t = threadIdx.x;
  if (t < kSlots) {
    const int c = j0 + t < n ? cols[j0 + t] : -1;
    scol[t] = (c >= 0 && c < vc) ? c : -1;
  }
  __syncthreads();
  const int rq = row_quads(dp);
  const int nq = (dp + 3) / 4;  // chunks that hold sublanes
  // stage: lane s takes slot s, warp w the chunks w, w + kWarps, ...
  const int s = t & 31;
  const int c = scol[s];
  if (c >= 0) {
    for (int q0 = t >> 5; q0 < nq; q0 += kWarps * kQuads) {
      float v[kQuads][4];
#pragma unroll
      for (int k = 0; k < kQuads; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 4 * (q0 + kWarps * k) + i;
          v[k][i] = p < dp
                        ? mr::to_f(table[static_cast<int64_t>(p) * vc + c])
                        : 0.f;
        }
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        const int q = q0 + kWarps * k;
        if (q < nq)
          tile[s * rq + (q ^ (s & 7))] =
              make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
      }
    }
  }
  __syncthreads();
  // write: lpr lanes per slot row (a power of two >= the row's chunks,
  // at most 32), so a warp writes 32 / lpr rows at a time
  const int lpr = nq > 16 ? 32 : (nq > 8 ? 16 : 8);
  for (int r = t / lpr; r < kSlots; r += THREADS / lpr) {
    if (scol[r] < 0) continue;
    float* row = buf + (j0 + r) * width + off;
    for (int q = t % lpr; q < nq; q += lpr) {
      const float4 x = tile[r * rq + (q ^ (r & 7))];
      store4(row, 4 * q, dp, vec, x.x, x.y, x.z, x.w);
    }
  }
}

template <typename T, int THREADS>
void launch(const void* table, int64_t vc, int dp, const int* cols,
            int64_t n, float* buf, int64_t width, int off, bool vec,
            cudaStream_t st) {
  const T* tb = static_cast<const T*>(table);
  if (dp <= kNarrowDp) {
    gather_rows_narrow<T, THREADS>
        <<<mr::blocks_for(n, THREADS * kNarrowSlots), THREADS, 0, st>>>(
            tb, vc, dp, cols, n, buf, width, off, vec);
  } else {
    const size_t smem = sizeof(float4) * kSlots * row_quads(dp);  // <= 32 KB
    gather_rows_wide<T, THREADS><<<mr::blocks_for(n, kSlots), THREADS, smem,
                                   st>>>(tb, vc, dp, cols, n, buf, width, off,
                                         vec);
  }
}

template <typename T>
void launch_sized(const void* table, int64_t vc, int dp, const int* cols,
                  int64_t n, float* buf, int64_t width, int off, bool vec,
                  cudaStream_t st) {
  if (n < kSmallN && (dp <= kNarrowDp || n >= kTinyN))
    launch<T, kSmallThreads>(table, vc, dp, cols, n, buf, width, off, vec, st);
  else
    launch<T, kThreads>(table, vc, dp, cols, n, buf, width, off, vec, st);
}

}  // namespace

// table: [dp, vc] f32 or bf16 (table_bf16), feature-major; cols: [n] i32;
// buf: [n, width] f32, row-major, written in lanes [off, off + dp).
extern "C" int mr_gather_rows(const void* table, int table_bf16, int64_t vc,
                              int dp, const int* cols, int64_t n, float* buf,
                              int64_t width, int off, void* stream) {
  if (dp <= 0 || dp > kMaxDp || off < 0 || off + dp > width || n < 0 ||
      vc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte stores need every row's first lane on a 16-byte boundary
  const bool vec = off % 4 == 0 && width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(buf) % 16 == 0;
  if (table_bf16)
    launch_sized<__nv_bfloat16>(table, vc, dp, cols, n, buf, width, off, vec,
                                st);
  else
    launch_sized<float>(table, vc, dp, cols, n, buf, width, off, vec, st);
  return static_cast<int>(cudaGetLastError());
}
