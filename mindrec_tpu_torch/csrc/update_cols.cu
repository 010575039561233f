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
// with sentinels) and each slot's summed gradient (multiplied by the loss
// scale) where the step's segment sum left it: g [dp, n] with two strides,
// element (p, u) at g[u * slot + p * lane].  The segment sum writes
// row-major [n, width] rows, a group's tables side by side in their lanes,
// so a deep table's sums are the transposed view at slot stride width and
// lane stride 1; a tiny group's, the DeepFM column path's and a column
// slice's are contiguous rows (slot stride 1); a folded table's re-masked
// lanes are what the re-mask returns.  Beside them: sub [n], the slots'
// fold sub-rows (fold > 1), and an optional gate, [n] (a tiny group's
// presence), one flag (the overflow guard) or their product.  Duplicate
// columns (fold-8 tables: neighbouring ids share a column; the tiny group
// gives 8 slots per column) are contiguous because cols is sorted.  The
// slot that starts a run of equal columns sums the run's gradients and
// touch in slot order and updates the column once, so no two threads
// write one element and no compaction or host sync is needed.
//
// Touch (exact, as stream_update.py:_expand_touch of make_aug_grads' touch
// rows times the gate): fold 1 - the slot's gate (1 without one) gates
// every sublane; fold 8 (dim 1) - sublane sub[u] gets the gate, the others
// 0.  Products and sums of 0 and 1 are exact and only touch > 0 is
// tested, so every result is the augmented rows' bit for bit.  Touch never
// comes from G != 0: a slot with a zero gradient still updates, and a
// zeroed gate (ids absent from a tiny group's batch) leaves the column as
// it was.  Columns outside [0, vc) (the sentinel (2**31-2) // fold) are
// skipped.  Arithmetic is float32 with G = sum / loss_scale, in the order
// of the plain PyTorch versions (built with --fmad=false); stored values
// round to their type.  The Adam rate lr_t arrives as a device scalar, so
// the step never waits on the host.  Bound: bytes - cols read once, each
// live slot's dp sums (and its sub and gate) once, each touched element's
// weight and two state values read and written once.
//
// What bounds it is sectors: every touched element of the weight and its
// two state arrays is a 32-byte sector of its own, read and written,
// unless neighbouring sorted columns share it; the arithmetic is nothing
// beside that.  So the design keeps many such loads in flight and wastes
// no thread.  cols is sorted, so the sentinel pads are its tail: at most
// kMaxBlocksX blocks stride over the slots 256 at a time and stop at the
// first round that starts on a sentinel, so the pads (91% of the slots in
// the DeepFM steps, most of the multitable emb64 groups') cost each block
// one load and no blocks of their own.
//
// Which kernel serves which table:
// * adam_cols_kernel - LazyAdam, every fold; ftrl_cols_kernel - FTRL at
//   fold 1.  Two layouts, by where a slot's sums lie:
//   - its sublanes adjacent (lane stride 1: the row layout's rows, slot
//     stride width), staged (tile_rounds).  A warp of consecutive slots
//     reading a few sublanes each touches 32 sectors and uses a fraction
//     of each, and the blocks of the other sublanes fetch the same
//     sectors again (2 sublanes a thread on the strided sums: 1.43 ms at
//     emb128).  So a block takes 256 slots over the 8 sublanes of its
//     blockIdx.y, one 32-byte sector of each slot's row, and stages them
//     in shared memory first (two 16-byte loads per slot), with an odd
//     row stride so that a warp's 32 slots read 32 banks; then a thread
//     takes its slot's 8 sublanes (update_cols.cuh's update_slot with R
//     8: 24 loads of weight and state in flight before any arithmetic).
//     A warp's lanes are still consecutive slots at one sublane, so the
//     sorted columns of a table row share sectors.  Each live slot's sums
//     are read from HBM once; a run that crosses the tile's end reads its
//     tail in place.  At emb128 (295k live slots of 393k at width 256) it
//     takes 0.893 ms, where the slot layout below took 0.827 on the
//     contiguous touch-augmented copy that the step no longer builds
//     (NVIDIA H100 80GB HBM3 at 700 W, graph replay): 64 slots by four
//     sublane pairs took 1.045, 128 slots by 8 0.934, 256 slots by 4
//     sublanes per thread 0.962, 32 slots over all 128 sublanes 1.068,
//     and a prefetch of the run test's columns beside the staging
//     nothing.  What is left is the strided read of a sector per slot.
//   - its slots adjacent (slot stride 1: the DeepFM column path's and a
//     tiny group's contiguous [dp, n], a folded table's re-masked copy),
//     read in place (slot_rounds): thread (u, y) takes slot u for the kSub
//     sublanes from kSub * y.  It reads the column, its neighbours (the
//     run test) and its kSub sums together (one wait for memory), then
//     starts its 3 * kSub loads of weight and state before any
//     arithmetic, and stores under the touch gate.  A warp's lanes are
//     consecutive slots, so the sums are read coalesced and the sorted
//     columns of one table row share sectors.  More sublanes per thread
//     cost registers and so warps in flight: on the card 1, 2 and 4 were
//     within 2% of each other at the large tables and 8 and 16 slower;
//     the staged layout's 8 took the DeepFM fm launch from 0.092 to 0.114
//     ms and the folded linear one from 0.010 to 0.016.
//   Either way blockIdx.y has no ceiling, so any dp is covered.
// * ftrl_fold_kernel - FTRL at fold > 1 (dp <= fold <= 8: the folded wide
//   tables, [8, vc / 8]; their weight and state, 3 x 2.6 MB at the
//   multitable recipe's w128, and the sums sit in L2).  In a slot layout
//   several blocks each load every slot's column and neighbours for a few
//   of the 8 sublanes, a run's head walks its run with dependent loads,
//   and every lane runs the FTRL arithmetic (IEEE square roots and
//   divisions, most of the instructions) for its sublanes though a slot
//   of a folded table with unique ids touches one sublane of 8: the
//   launch is bound by latency and issued instructions, not bytes.  Here
//   a lane takes one slot over all dp sublanes (so cols is read once; a
//   re-masked row-major [n, 8] row is one 32-byte sector): its column,
//   the columns beside the warp's two edges and its dp gradient and dp
//   touch values are loaded together, coalesced across the warp.  The
//   warp finds run heads by comparing neighbouring columns with shuffles
//   and a ballot; each lane stages its values in shared memory (16-byte
//   rows, padded against bank conflicts) and a head adds its followers'
//   rows in slot order, so the sums stay bit-equal to the plain
//   version's.  (Fetching them with shuffles instead costs every lane 2
//   dp shuffles per step of the longest run: 0.0044-0.0048 ms against
//   0.0033-0.0038 at the small tables, NVIDIA H100 80GB HBM3 at 700 W.)
//   Only a run that crosses the warp's last lane is finished by a walk of
//   loads past the edge (runs are at most 8 slots at fold 8 with unique
//   ids, but any length is allowed).  Then the warp compacts its heads'
//   touched elements (a scan of their counts) into the same shared
//   memory, and each lane updates about one element: its weight and state
//   loads, the arithmetic once, and the stores.
//
// Building a touch-augmented copy [dp + 8, n] of the sums for these
// kernels instead (make_aug_grads' torch.cat, a transposing copy of every
// slot, the sentinel tail included) took 14.8 of the multitable step's
// 60.8 ms on an NVIDIA H100 80GB HBM3 at 700 W, roughly 0.3 TB/s, and was
// then read straight back.  The folded round lives in update_cols.cuh
// (ftrl_fold_round) and the slot's update in update_slot, shared with the
// fused update + gather of fused_cols.cu, which reads augmented rows.

#include "update_cols.cuh"

namespace {

constexpr int kMaxBlocksX = 1024;  // blocks along the slots; they stride
constexpr int kSlots = 256;        // slots per block and round
constexpr int kSub = 2;            // sublanes per thread, unstaged
constexpr int kTileSub = 8;        // a tile's sublanes: 32 bytes of a slot's row
constexpr int kTileSlots = kSlots;  // a tile's slots, a thread each
constexpr int kTileLd = kTileSub + 1;  // odd: a warp's 32 slots, 32 banks

// The slots [base, base + m) of a Sums over the sublanes [p_lo, p_lo + 8)
// staged in shared memory, slot i's sublane p at tile[i * 9 + p - p_lo]; a
// slot outside the tile (the rest of a run past its end) is read in place.
struct SumsTile {
  mr::Sums in;
  const float* tile;
  int base, m, p_lo;
  __device__ __forceinline__ float grad(int p, int u) const {
    const unsigned i = static_cast<unsigned>(u - base);
    return i < static_cast<unsigned>(m) ? tile[i * kTileLd + p - p_lo]
                                        : in.grad(p, u);
  }
  __device__ __forceinline__ float touch(int p, int u) const {
    return in.touch(p, u);
  }
};

// The block stages its tile: np <= 8 sublanes from p_lo of m slots.  vec
// (lane stride 1, np 8, 16-byte aligned): each slot's 32-byte sector as
// two float4 loads, a warp reading 16 whole sectors; otherwise, by the
// smaller stride, a warp reads consecutive lanes of a slot or consecutive
// slots of a lane.
__device__ __forceinline__ void stage_tile(const mr::Sums& in, int base,
                                           int m, int p_lo, int np, bool vec,
                                           float* tile) {
  const float* g0 = in.g + base * in.slot + p_lo * in.lane;
  if (vec) {
    for (int e = threadIdx.x; e < 2 * m; e += kTileSlots) {
      const int i = e >> 1, h = e & 1;
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(g0 + i * in.slot) + h);
      float* d = tile + i * kTileLd + 4 * h;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
  } else if (in.lane <= in.slot) {
    for (int e = threadIdx.x; e < m * np; e += kTileSlots) {
      const int i = e / np, p = e - i * np;
      tile[i * kTileLd + p] = __ldg(g0 + i * in.slot + p * in.lane);
    }
  } else {
    for (int e = threadIdx.x; e < m * np; e += kTileSlots) {
      const int p = e / m, i = e - p * m;
      tile[i * kTileLd + p] = __ldg(g0 + i * in.slot + p * in.lane);
    }
  }
}

// The layout of adam_cols_kernel and ftrl_cols_kernel: a block of 256
// slots over the 8 sublanes of its blockIdx.y, a thread a slot; each
// round's sums are staged first, so that each slot's sector of them is
// read once, then each thread runs update_slot on its slot's 8 sublanes.
template <typename Opt>
__device__ __forceinline__ void tile_rounds(Opt opt, int64_t vc, int dp,
                                            const int* __restrict__ cols,
                                            int n, int fold,
                                            const mr::Sums& in, int vec) {
  __shared__ float tile[kTileSlots * kTileLd];
  const int p_lo = blockIdx.y * kTileSub;
  const int np = dp - p_lo < kTileSub ? dp - p_lo : kTileSub;
  opt.ready();
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kTileSlots;
       mr::live_round(cols, n, vc, b);
       b += static_cast<int64_t>(gridDim.x) * kTileSlots) {
    const int base = static_cast<int>(b);
    const int m = n - base < kTileSlots ? n - base : kTileSlots;
    __syncthreads();  // every warp is done with the last tile
    stage_tile(in, base, m, p_lo, np, vec != 0 && np == kTileSub, tile);
    __syncthreads();
    const SumsTile t{in, tile, base, m, p_lo};
    mr::update_slot<kTileSub>(opt, vc, dp, cols, t, n, fold,
                              base + threadIdx.x, p_lo, mr::NoRows{});
  }
}

// The layout for sums whose slots are adjacent (slot stride 1): a block
// of 256 slots over the kSub sublanes from kSub blockIdx.y, a thread a slot,
// reading its sums in place (a warp's loads are coalesced along the slots).
template <typename Opt>
__device__ __forceinline__ void slot_rounds(Opt opt, int64_t vc, int dp,
                                            const int* __restrict__ cols,
                                            int n, int fold,
                                            const mr::Sums& in) {
  const int p0 = blockIdx.y * kSub;
  opt.ready();
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kSlots;
       mr::live_round(cols, n, vc, b);
       b += static_cast<int64_t>(gridDim.x) * kSlots)
    mr::update_slot<kSub>(opt, vc, dp, cols, in, n, fold,
                          static_cast<int>(b) + threadIdx.x, p0, mr::NoRows{});
}

// kStaged: tile_rounds (a slot's sublanes adjacent), else slot_rounds.
template <typename TW, typename TS, bool kStaged>
__global__ void __launch_bounds__(kSlots)
adam_cols_kernel(mr::AdamCols<TW, TS> opt, int64_t vc, int dp,
                 const int* __restrict__ cols, int n, int fold, mr::Sums in,
                 int vec) {
  if constexpr (kStaged)
    tile_rounds(opt, vc, dp, cols, n, fold, in, vec);
  else
    slot_rounds(opt, vc, dp, cols, n, fold, in);
}

template <typename TW, bool kStaged>
__global__ void __launch_bounds__(kSlots)
ftrl_cols_kernel(mr::FtrlCols<TW> opt, int64_t vc, int dp,
                 const int* __restrict__ cols, int n, mr::Sums in, int vec) {
  if constexpr (kStaged)
    tile_rounds(opt, vc, dp, cols, n, 1, in, vec);
  else
    slot_rounds(opt, vc, dp, cols, n, 1, in);
}

constexpr int kFoldThreads = 64;   // slots per block and round
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldBlocks = 8192;  // blocks of the folded FTRL; they stride

template <typename TW>
__global__ void __launch_bounds__(kFoldThreads)
ftrl_fold_kernel(TW* __restrict__ table, float* __restrict__ accum,
                 float* __restrict__ linear, int64_t vc, int dp,
                 const int* __restrict__ cols, const mr::Sums in, int n,
                 mr::FtrlHyper h) {
  __shared__ float4 smem[kFoldWarps][32 * mr::kFoldRow];
  for (int64_t b = blockIdx.x * kFoldThreads; mr::live_round(cols, n, vc, b);
       b += gridDim.x * kFoldThreads)
    mr::ftrl_fold_round(table, accum, linear, vc, dp, cols, in, n, h,
                        static_cast<int>(b) + threadIdx.x,
                        smem[threadIdx.x >> 5], mr::NoRows{});
}

// Staged where a slot's sublanes are adjacent (lane stride 1: the row
// layout's rows); the grid (blockIdx.x fastest, at most kMaxBlocksX along
// the slots) over the layout's sublane groups; and whether a slot's 8
// sublanes are one aligned 32-byte sector.
inline bool staged(const mr::Sums& in) { return in.lane == 1; }

inline dim3 cols_grid(int n, int dp, bool stage) {
  const unsigned bx = mr::blocks_for(n, kSlots);
  const int per = stage ? kTileSub : kSub;
  return dim3(bx < kMaxBlocksX ? bx : kMaxBlocksX,
              static_cast<unsigned>((dp + per - 1) / per));
}

inline int vec_of(const mr::Sums& in) {
  return in.lane == 1 && in.slot % 4 == 0 &&
         reinterpret_cast<uintptr_t>(in.g) % 16 == 0;
}

template <typename TW, typename TS>
void launch_adam(void* table, void* m, void* v, int64_t vc, int dp,
                 const int* cols, int n, int fold, const mr::Sums& in,
                 const mr::AdamHyper& h, cudaStream_t st) {
  const mr::AdamCols<TW, TS> opt{static_cast<TW*>(table), static_cast<TS*>(m),
                                 static_cast<TS*>(v), h, 0.f};
  const bool stage = staged(in);
  const dim3 grid = cols_grid(n, dp, stage);
  if (stage)
    adam_cols_kernel<TW, TS, true><<<grid, kSlots, 0, st>>>(
        opt, vc, dp, cols, n, fold, in, vec_of(in));
  else
    adam_cols_kernel<TW, TS, false><<<grid, kSlots, 0, st>>>(
        opt, vc, dp, cols, n, fold, in, 0);
}

template <typename TW>
void launch_ftrl(void* table, float* accum, float* linear, int64_t vc, int dp,
                 const int* cols, int n, int fold, const mr::Sums& in,
                 const mr::FtrlHyper& h, cudaStream_t st) {
  if (fold > 1) {
    const unsigned bx = mr::blocks_for(n, kFoldThreads);
    ftrl_fold_kernel<TW><<<bx < kFoldBlocks ? bx : kFoldBlocks, kFoldThreads,
                           0, st>>>(static_cast<TW*>(table), accum, linear,
                                    vc, dp, cols, in, n, h);
    return;
  }
  const mr::FtrlCols<TW> opt{static_cast<TW*>(table), accum, linear, h};
  const bool stage = staged(in);
  const dim3 grid = cols_grid(n, dp, stage);
  if (stage)
    ftrl_cols_kernel<TW, true><<<grid, kSlots, 0, st>>>(opt, vc, dp, cols, n,
                                                        in, vec_of(in));
  else
    ftrl_cols_kernel<TW, false><<<grid, kSlots, 0, st>>>(opt, vc, dp, cols, n,
                                                         in, 0);
}

// The Sums contract beside bad_cols_shape's: sub given exactly at fold > 1,
// strides that reach no element outside the sums.
bool bad_sums(int fold, const mr::Sums& in) {
  return (fold > 1) != (in.sub != nullptr) || in.slot < 0 || in.lane < 0 ||
         in.gate_step < 0 || in.gate_step > 1;
}

}  // namespace

// table: [dp, vc] f32 or bf16 (table_bf16); m, v: [dp, vc] f32 or bf16
// (state_bf16); cols: [n] i32 sorted; g: the sums [dp, n] f32 at
// g[u * slot + p * lane]; sub: [n] i32 (fold > 1) or null (fold 1); gate:
// [n] f32 (gate_step 1), one f32 (gate_step 0) or null; lr_t: one f32 on
// the device.  fold 1, or fold <= 8 with dp <= fold (emb_dim 1).
extern "C" int mr_adam_cols_sums(void* table, int table_bf16, void* m, void* v,
                                 int state_bf16, int64_t vc, int dp,
                                 const int* cols, const float* g, int64_t slot,
                                 int64_t lane, const int* sub,
                                 const float* gate, int gate_step, int n,
                                 int fold, const float* lr_t, float b1,
                                 float one_minus_b1, float b2,
                                 float one_minus_b2, float eps,
                                 float inv_scale, void* stream) {
  const mr::Sums in{g, slot, lane, sub, gate, gate_step};
  if (mr::bad_cols_shape(vc, dp, n, fold) || bad_sums(fold, in))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::AdamHyper h{lr_t, b1, one_minus_b1, b2, one_minus_b2, eps,
                        inv_scale};
  if (table_bf16 && state_bf16)
    launch_adam<__nv_bfloat16, __nv_bfloat16>(table, m, v, vc, dp, cols, n,
                                              fold, in, h, st);
  else if (table_bf16)
    launch_adam<__nv_bfloat16, float>(table, m, v, vc, dp, cols, n, fold, in,
                                      h, st);
  else if (state_bf16)
    launch_adam<float, __nv_bfloat16>(table, m, v, vc, dp, cols, n, fold, in,
                                      h, st);
  else
    launch_adam<float, float>(table, m, v, vc, dp, cols, n, fold, in, h, st);
  return static_cast<int>(cudaGetLastError());
}

// table: [dp, vc] f32 or bf16; accum, linear: [dp, vc] f32; the other
// arguments as in mr_adam_cols_sums.
extern "C" int mr_ftrl_cols_sums(void* table, int table_bf16, float* accum,
                                 float* linear, int64_t vc, int dp,
                                 const int* cols, const float* g, int64_t slot,
                                 int64_t lane, const int* sub,
                                 const float* gate, int gate_step, int n,
                                 int fold, float lr, float l1, float two_l2,
                                 float inv_scale, void* stream) {
  const mr::Sums in{g, slot, lane, sub, gate, gate_step};
  if (mr::bad_cols_shape(vc, dp, n, fold) || bad_sums(fold, in))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mr::FtrlHyper h{lr, l1, two_l2, inv_scale};
  if (table_bf16)
    launch_ftrl<__nv_bfloat16>(table, accum, linear, vc, dp, cols, n, fold,
                               in, h, st);
  else
    launch_ftrl<float>(table, accum, linear, vc, dp, cols, n, fold, in, h, st);
  return static_cast<int>(cudaGetLastError());
}
