// STMC streaming-conv contraction, the per-frame hot loop of the paper's
// streaming U-Net, for Hopper (sm_90a):
//   y[b, n] = sum_kc window[b, kc] * w[kc, n] + bias[n]
// over the flattened window (B, K*Cin) and kernel (K*Cin, Cout), with
// float32 accumulation.
//
// Replaces the TPU kernel repro/kernels/stmc_conv.py::stmc_conv (Pallas,
// grid over (B/128, Cout/128) tiles with the whole K*Cin contraction of a
// tile in VMEM; B and Cout padded to 128).
//
// What bounds it on the H100: the bytes. At the U-Net's shapes B <= 32
// rows meet up to 19.25 MB of float32 weights a layer (decoder 2 of
// soi-unet-dns: K*Cin 7248, Cout 664), i.e. at most 2*B = 64 flops per
// weight element, below the 80 flops per float32 element (67 TFLOP/s over
// 3.35 TB/s) where the arithmetic would bound it. Least time at decoder 2:
// 19.25 MB / 3.35 TB/s = 5.7 us, whatever B <= 32.
//
// Design:
//  * a block owns 32 output columns (one warp's width) and BB rows of B,
//    grid (ceil(Cout/32), ceil(B/BB)), BB in {1, 2, 4, 8} the least power
//    of two >= min(B, 8): a warp reads each weight row w[kc, n0:n0+32] as
//    one coalesced line and uses it for all BB rows, so each weight row is
//    read once for all B rows up to 8 (ceil(B/8) times beyond);
//  * the block's 16 warps split K*Cin (warp s takes rows s, s+16, ...), and
//    each thread keeps 16 weight loads in flight: raw elements, converted
//    to float32 where they are used, so the loads do not wait on each other;
//  * the window tile (BB rows x 4096/BB contraction rows, float32, laid
//    out [kc][BB] so one warp-wide broadcast serves all BB rows) is staged
//    in shared memory tile by tile: the window of decoder 2 at B 32 (928 KB
//    in float32) does not fit whole;
//  * float32 accumulators, one per row the thread owns; the 16 warps'
//    partial sums are added in shared memory in a fixed order, with no
//    atomics, so a float32 result is the same from run to run; the bias is
//    added in float32 and the cast to the output dtype comes at the store;
//  * the ragged edges of B and Cout are masked here (the TPU kernel pads
//    both to 128).
//
// What holds it back: at B 1 the grid is ceil(Cout/32) blocks, 21 at
// decoder 2 and 4 at decoder 7, on 132 SMs; the few SMs in use cannot keep
// enough bytes in flight to reach the card's memory rate. Split-K across
// blocks (a cluster or a second pass) or TMA loads of the weight tiles are
// later work.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;           // output columns of a block
constexpr int kSmemFloats = 4096;   // window tile, then the partial sums
constexpr int kU = 16;              // weight loads in flight per thread

// acc[r] += xs[r] * wf for the BB rows of one contraction row
template <int BB>
__device__ __forceinline__ void fma_rows(const float* xs, float wf,
                                         float (&acc)[BB]) {
  if constexpr (BB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BB / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(xs)[q];
      acc[4 * q + 0] = fmaf(x.x, wf, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(x.y, wf, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x.z, wf, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x.w, wf, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < BB; ++r) acc[r] = fmaf(xs[r], wf, acc[r]);
  }
}

template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
stmc_conv_kernel(const T* __restrict__ win, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, int B,
                 int KC, int N) {
  constexpr int TK = kSmemFloats / BB;    // contraction rows of a tile
  static_assert(kWarps * BB * kCols <= kSmemFloats, "partials fit");
  __shared__ __align__(16) float smem[kSmemFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int r0 = blockIdx.y * BB;
  const T* wcol = w + n;                  // read only where n < N

  float acc[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < KC; k0 += TK) {
    const int tk = min(TK, KC - k0);
    __syncthreads();                      // the last tile is consumed
    // stage window[r0:r0+BB, k0:k0+tk] as float32 [kc][BB], coalesced
    // over kc; rows past B are zeros
    for (int i = threadIdx.x; i < BB * TK; i += kThreads) {
      const int r = i / TK;
      const int kc = i - r * TK;
      float v = 0.f;
      if (r0 + r < B && kc < tk)
        v = to_f32(win[(size_t)(r0 + r) * KC + k0 + kc]);
      smem[kc * BB + r] = v;
    }
    __syncthreads();
    if (n < N) {
      for (int j0 = warp; j0 < tk; j0 += kWarps * kU) {
        T wv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = j0 + u * kWarps;
          if (j < tk) wv[u] = wcol[(size_t)(k0 + j) * N];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = j0 + u * kWarps;
          if (j < tk) fma_rows<BB>(smem + j * BB, to_f32(wv[u]), acc);
        }
      }
    }
  }

  // the 16 warps' partial sums, added in warp order
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BB; ++r) smem[(warp * BB + r) * kCols + lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < BB * kCols; i += kThreads) {
    const int r = i / kCols;
    const int c = i - r * kCols;
    const int row = r0 + r;
    const int col = blockIdx.x * kCols + c;
    if (row < B && col < N) {
      float s = 0.f;
      for (int q = 0; q < kWarps; ++q) s += smem[(q * BB + r) * kCols + c];
      if (bias != nullptr) s += to_f32(bias[col]);
      y[(size_t)row * N + col] = from_f32<T>(s);
    }
  }
}

template <typename T, int BB>
cudaError_t launch(const void* win, const void* w, const void* bias, void* y,
                   int B, int KC, int N, cudaStream_t stream) {
  dim3 grid((N + kCols - 1) / kCols, (B + BB - 1) / BB);
  stmc_conv_kernel<T, BB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(win), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), B, KC, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* win, const void* w, const void* bias,
                     void* y, int B, int KC, int N, cudaStream_t stream) {
  if (B == 1) return launch<T, 1>(win, w, bias, y, B, KC, N, stream);
  if (B == 2) return launch<T, 2>(win, w, bias, y, B, KC, N, stream);
  if (B <= 4) return launch<T, 4>(win, w, bias, y, B, KC, N, stream);
  return launch<T, 8>(win, w, bias, y, B, KC, N, stream);
}

}  // namespace

// window (B, KC) and w (KC, N) of one dtype, bias (N,) of that dtype or
// null, y (B, N) written in that dtype; KC = K*Cin. All contiguous.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_stmc_conv(const void* win, const void* w,
                               const void* bias, void* y, int B, int KC,
                               int N, int dtype, void* stream) {
  if (B <= 0 || KC <= 0 || N <= 0 || (B + 7) / 8 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(win, w, bias, y, B, KC, N, st);
  if (dtype == kFloat32) return dispatch<float>(win, w, bias, y, B, KC, N, st);
  return cudaErrorInvalidValue;
}
