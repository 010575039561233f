// Span marks: device time of a named phase of the train step.
//
// Replaces no TPU kernel: the reference times its step on the host only.
// A captured step's host time is its enqueue, and a profiler range opened
// while a CUDA graph is captured is never replayed, so a span inside the
// step has to be a node of the graph.  One mark is one thread of one
// block that reads %globaltimer (nanoseconds, the card's own clock) and
// writes a few int64 words of a small buffer that lives for the process
// (utils/profiling.py allocates it before any capture, outside every
// graph's pool).  Inside a capture the launch becomes a graph node and
// runs on every replay; eagerly it is a plain launch.  Stream order puts
// the mark after the work before it and before the work after it, so an
// exit mark minus its enter mark is the device time of the work between.
// Bound: the launch itself (a few microseconds); nothing is read back per
// step.
//
// Buffer (int64): [0] the last top-level exit, [1] the ns between a
// top-level exit and the next top-level enter, [2] how many such gaps,
// [3] spare; then start[slots], total_ns[slots], count[slots].

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kEnter = 1;
constexpr int kTop = 4;
constexpr int kHead = 4;

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

}  // namespace

// At global scope so that a trace names it `span_mark`.
__global__ void span_mark(int64_t* __restrict__ buf, int slots, int id,
                          int flags) {
  const int64_t now = global_ns();
  int64_t* start = buf + kHead;
  int64_t* total = start + slots;
  int64_t* count = total + slots;
  if (flags & kEnter) {
    if ((flags & kTop) && buf[0] != 0) {
      buf[1] += now - buf[0];
      buf[2] += 1;
    }
    start[id] = now;
  } else {
    total[id] += now - start[id];
    count[id] += 1;
    if (flags & kTop) buf[0] = now;
  }
}

extern "C" int mr_span_mark(void* buf, int slots, int id, int flags,
                            void* stream) {
  if (slots <= 0 || id < 0 || id >= slots)
    return static_cast<int>(cudaErrorInvalidValue);
  span_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(buf), slots, id, flags);
  return static_cast<int>(cudaGetLastError());
}
