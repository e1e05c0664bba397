// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t (the RG-LRU core of
// recurrentgemma's prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lru_scan.py::lru_scan (Pallas, grid
// (B, D/128, S/256) with the sequence axis innermost and sequential, the
// running state carried in VMEM scratch across sequence blocks).
//
// What bounds it on the H100: the bytes. A call reads a and x once and
// writes h once (3*B*S*D elements) for 2 flops per element, so its least
// time is those bytes over 3.35 TB/s: ~0.030 ms at the outer serving shape
// (1, 2040, 4096) in float32.
//
// Design:
//  * one thread per (b, d) channel walks S in order, the TPU kernel's
//    order (h = a[t] * h + x[t]); the carry is float32 in a register;
//  * grid (B, ceil(D/64)), 64 threads a block: neighbouring threads own
//    neighbouring channels, so every load of a[t], x[t] and every store of
//    h[t] is coalesced across d;
//  * a[t] and x[t] do not depend on h, so a thread loads the next kU steps
//    of both into registers while it computes the current kU (double
//    buffer): 2*kU loads in flight per thread hide the memory latency. The
//    buffers hold the raw elements, converted to float32 where they are
//    used: converting at the load made each bf16 load wait for the one
//    before it (on an H100, bf16 took 0.98 ms against f32's 0.13 at the
//    outer shape);
//  * the product and the sum round separately (__fmul_rn, __fadd_rn: no FMA
//    contraction), as the plain version's two operations do, so in float32
//    the kernel equals the plain version bit for bit; h_t is written in
//    x's dtype, the carry stays float32.
//
// What holds it back: at B 1 the grid is 64 blocks on 132 SMs, each thread
// a serial chain of S steps. A chunked two-pass scan over S (local scans of
// S chunks, then a pass carrying each chunk's end state) would fill the
// card; that is later work.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 64;
constexpr int kU = 16;      // steps loaded ahead

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                const float* __restrict__ h0, T* __restrict__ h, int S,
                int D) {
  const int b = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)b * S * D + d;
  const T* ab = a + base;
  const T* xb = x + base;
  T* hb = h + base;
  float st = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;

  // raw elements: converted to float32 only where they are used, so the
  // loads of a chunk are all issued before the first one is waited on
  T ra[kU], rx[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u < S) {
      ra[u] = ab[(size_t)u * D];
      rx[u] = xb[(size_t)u * D];
    }
  }
  for (int t0 = 0; t0 < S; t0 += kU) {
    T na[kU], nx[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + kU + u;
      if (t < S) {
        na[u] = ab[(size_t)t * D];
        nx[u] = xb[(size_t)t * D];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      if (t < S) {
        st = __fadd_rn(__fmul_rn(to_f32(ra[u]), st), to_f32(rx[u]));
        hb[(size_t)t * D] = from_f32<T>(st);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ra[u] = na[u];
      rx[u] = nx[u];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* h,
                   int B, int S, int D, cudaStream_t stream) {
  dim3 grid(B, (D + kThreads - 1) / kThreads);
  lru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(h), S, D);
  return cudaGetLastError();
}

}  // namespace

// a, x, h (B, S, D) of one dtype; h0 (B, D) float32 or null (zeros). All
// contiguous. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_lru_scan(const void* a, const void* x, const void* h0,
                              void* h, int B, int S, int D, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(a, x, h0, h, B, S, D, st);
  if (dtype == kFloat32) return launch<float>(a, x, h0, h, B, S, D, st);
  return cudaErrorInvalidValue;
}
