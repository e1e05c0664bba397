// Chunked-prefill attention at absolute positions, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chunk_attention.py::chunk_attention
// (Pallas, grid (B, Hkv, q_blocks, k_blocks) with the k axis sequential and
// m/l/acc in VMEM scratch across k steps).
//
// C query rows at absolute positions qp attend to Sk cache-plus-chunk key
// rows at absolute positions kp (-1 = empty ring row). A key is live for a
// query iff kp >= 0 && kp <= qp (&& kp > qp - window when a window is set).
//
// What bounds it on the H100: at the serving shapes (q (1,256,16,128)
// against Sk = 1344 keys; the middle's (1,128,16,128) against 896 frames)
// the live (query, key) pairs cost ~4*H*dh flops each, ~0.2-0.5 GFLOP a call,
// against a few MB of q/k/v/o: on the tensor cores the bound is a few us
// either way. This kernel does its products in scalar float32 FMA on the
// CUDA cores, like flash_attention.cu, so its real limit is the FMA issue
// rate and the shared-memory reads that feed it.
//
// Design (flash_attention.cu with the position test instead of the index
// causal limit):
//  * grid (ceil(C/64), B*H): a block owns 64 query rows of one head, its q
//    tile and their positions in shared memory;
//  * cache rows are not sorted by position (a ring), so the block walks all
//    of Sk in 64-key tiles; no tile is skipped, so a query row with no live
//    key anywhere (qp = -1 pad) averages V over every key, as the
//    reference does;
//  * the mask is computed in the kernel from the two position lanes;
//    masked scores take the finite -1e30, keys past Sk (the ragged last
//    tile) take probability 0, and the finalize divides by max(l, 1e-30),
//    so every row comes out finite;
//  * K/V are read at Hkv heads (q head h reads KV head h / G);
//  * 256 threads as a 16x16 grid, a thread owning 4 rows x 4 keys of the
//    score tile and 4 rows x dh/16 output dims; optional logit softcap
//    applied before the mask, as in the reference.
// What holds it back: scalar FMAs instead of mma.sync/wgmma, and at the
// serving shapes only 64 (outer) or 32 (middle) blocks on 132 SMs.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             ((size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) +
              (size_t)BK * DH + (size_t)BQ * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out,
                       int C, int Sk, int H, int Hkv, int window, float scale,
                       float softcap) {
  constexpr int LD = DH + 1;      // padded row of the q and k tiles
  constexpr int LP = BK + 1;      // padded row of the probability tile
  constexpr int DPT = DH / 16;    // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * DH;
  int* sQp = reinterpret_cast<int*>(sP + BQ * LP);
  int* sKp = sQp + BQ;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_row = (size_t)H * DH;
  const size_t kv_row = (size_t)Hkv * DH;
  const T* qb = q + ((size_t)b * C * H + h) * DH;
  const T* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const T* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  const int* qpb = qpos + (size_t)b * C;
  const int* kpb = kpos + (size_t)b * Sk;

  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    sQ[r * LD + d] =
        q0 + r < C ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }
  if (tid < BQ) sQp[tid] = q0 + tid < C ? qpb[q0 + tid] : -1;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();     // previous tile's consumers are done with sK/sV/sP
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const bool in = k0 + r < Sk;
      const size_t off = (size_t)(k0 + r) * kv_row + d;
      sK[r * LD + d] = in ? to_f32(kb[off]) : 0.f;
      sV[r * DH + d] = in ? to_f32(vb[off]) : 0.f;
    }
    if (tid < BK) sKp[tid] = k0 + tid < Sk ? kpb[k0 + tid] : -1;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = sQp[tr + 16 * i];
      float rmax = kNegInf;
      bool in_range[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = sKp[tc + 16 * j];
        in_range[j] = k0 + tc + 16 * j < Sk;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool allow = kp >= 0 && kp <= qp &&
                           (window <= 0 || kp > qp - window);
        s[i][j] = allow ? x : kNegInf;
        if (in_range[j]) rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys past Sk do not exist: probability 0, not the uniform share
        // a masked key gets while the row has no live key yet
        const float p = in_range[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        sP[(tr + 16 * i) * LP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[kk * DH + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tr + 16 * i) * LP + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r >= C) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = out + ((size_t)b * C + r) * q_row + (size_t)h * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tc + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qpos, const void* kpos, void* out, int B,
                   int C, int Sk, int H, int Hkv, int window, float scale,
                   float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      chunk_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((C + BQ - 1) / BQ, B * H);
  chunk_attention_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<T*>(out), C, Sk, H, Hkv,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dh(int DH, const void* q, const void* k, const void* v,
                  const void* qpos, const void* kpos, void* out, int B, int C,
                  int Sk, int H, int Hkv, int window, float scale,
                  float softcap, cudaStream_t st) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, qpos, kpos, out, B, C, Sk, H, Hkv,
                                  window, scale, softcap, st);
    case 32: return launch<T, 32>(q, k, v, qpos, kpos, out, B, C, Sk, H, Hkv,
                                  window, scale, softcap, st);
    case 64: return launch<T, 64>(q, k, v, qpos, kpos, out, B, C, Sk, H, Hkv,
                                  window, scale, softcap, st);
    case 128: return launch<T, 128>(q, k, v, qpos, kpos, out, B, C, Sk, H,
                                    Hkv, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, C, H, dh); k, v (B, Sk, Hkv, dh); qpos (B, C) int32; kpos (B, Sk)
// int32; out (B, C, H, dh); contiguous. window <= 0: none; softcap <= 0:
// none. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_chunk_attention(const void* q, const void* k,
                                     const void* v, const void* qpos,
                                     const void* kpos, void* out, int B,
                                     int C, int Sk, int H, int Hkv, int DH,
                                     int window, float scale, float softcap,
                                     int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dh<__nv_bfloat16>(DH, q, k, v, qpos, kpos, out, B, C, Sk, H,
                                Hkv, window, scale, softcap, st);
  if (dtype == kFloat32)
    return by_dh<float>(DH, q, k, v, qpos, kpos, out, B, C, Sk, H, Hkv,
                        window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
