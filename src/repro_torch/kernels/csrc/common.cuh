// Shared helpers of the hand-written attention kernels (CUDA C++, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// Loads P consecutive elements at p (aligned to P * sizeof(T) when that is
// 4, 8 or 16 bytes) as float32.
template <typename T, int P>
__device__ __forceinline__ void load_f32(const T* p, float (&r)[P]) {
  constexpr int kBytes = P * sizeof(T);
  if constexpr (kBytes == 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < P; ++j) r[j] = to_f32(e[j]);
  } else if constexpr (kBytes == 8) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < P; ++j) r[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) r[j] = to_f32(p[j]);
  }
}

// A lane of a warp that spans a row of DH holds ceil(DH/32) consecutive
// dims from lane * ceil(DH/32); where that does not divide DH (dh 80: 3 a
// lane) the last live lane's run passes the row's end, so its loads and
// stores stop at DH.
template <int DH>
__host__ __device__ constexpr bool ragged_lanes() {
  return DH % ((DH + 31) / 32) != 0;
}

// Loads a lane's dims [d0, d0 + P) of a row of DH at p (= row + d0) as
// float32, those at or past DH as 0.
template <typename T, int P, int DH>
__device__ __forceinline__ void load_lane(const T* p, int d0,
                                          float (&r)[P]) {
  if constexpr (ragged_lanes<DH>()) {
#pragma unroll
    for (int j = 0; j < P; ++j) r[j] = d0 + j < DH ? to_f32(p[j]) : 0.f;
  } else {
    load_f32<T, P>(p, r);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sets a kernel's dynamic shared memory to `bytes` and its carveout to the
// most shared memory, once a device (of the first 64): the attributes
// belong to the current device, and `done` (the caller's own, one per
// kernel) marks the devices already set.
template <class Kernel>
inline cudaError_t set_smem_once(std::atomic<uint64_t>& done, Kernel kernel,
                                 size_t bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace repro_torch
