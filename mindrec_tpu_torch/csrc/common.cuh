// Shared helpers of the port's CUDA kernels (plain C interface, bound
// with ctypes by ops/kernels/_build.py).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mr {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace mr
