// Shared helpers of the hand-written attention kernels (CUDA C++, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// The finite "minus infinity" of the reference (repro.kernels.ref.NEG_INF):
// a row with no live key stays finite through exp(s - m).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace repro_torch
