// Causal flash attention for whole-prompt prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas, grid (B*H, q_blocks, k_blocks) with the k axis sequential, m/l/acc
// in VMEM scratch, fully masked causal blocks skipped with pl.when). As
// there, the value head dim DV may differ from the query/key head dim DQK:
// the MLA prefill of deepseek-v2 attends with q/k at 192 (qk_nope 128 +
// qk_rope 64) and v at 128.
//
// What bounds it on the H100: at the GQA serving shape (S=1024, H=16,
// dh=128, bf16) the causal work is ~4.3 GFLOP against ~17 MB of q/k/v/o, so
// on the tensor cores the two bounds are near balanced (~4 us each); at the
// MLA shape (S=1024, H=128, DQK=192, DV=128) it is ~43 GFLOP against ~134 MB
// (~43 us against ~40 us). This kernel does its products in scalar float32
// FMA on the CUDA cores instead, so its real limit is the FMA issue rate and
// the shared-memory reads that feed it; moving the two products onto
// mma.sync/wgmma is the next step.
//
// Design:
//  * grid (ceil(Sq/64), B*H): a block owns 64 query rows of one head. The q
//    tile sits in shared memory (float32), and the block walks 64-key tiles
//    up to the causal limit of its last row; tiles wholly past the diagonal
//    are never loaded, as the TPU kernel's pl.when(live) skips them;
//  * K/V are read at Hkv heads (q head h reads KV head h / G), so the GQA
//    repeat of the reference's caller is not needed;
//  * 256 threads form a 16x16 grid; a thread owns 4 query rows x 4 keys of
//    the score tile and 4 rows x DV/16 dims of the output, in registers. Row
//    max and sum reduce over the 16 threads of a row with shuffles;
//  * online softmax in float32 with the finite -1e30 mask value, q_offset
//    (absolute position of query row 0) and an optional logit softcap;
//  * q/k tiles are padded by one float per row so that the 16 threads of a
//    row group read 16 different banks.
// The head dims are template parameters, instantiated for (DQK, DV) in
// (16,16), (32,32), (64,64), (128,128) and (192,128). Shared memory is
// ~113 KB at (128,128) and ~145 KB at (192,128), above the 48 KB default,
// so the launch raises the limit with cudaFuncSetAttribute first.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (DQK + 1) + (size_t)BK * (DQK + 1) + (size_t)BK * DV +
          (size_t)BQ * (BK + 1));
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int Hkv, int q_offset, int causal,
                       float scale, float softcap) {
  constexpr int LD = DQK + 1;     // padded row of the q and k tiles
  constexpr int LP = BK + 1;      // padded row of the probability tile
  constexpr int DPT = DV / 16;    // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * DV;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_row = (size_t)H * DQK;
  const size_t k_row = (size_t)Hkv * DQK;
  const size_t v_row = (size_t)Hkv * DV;
  const size_t o_row = (size_t)H * DV;
  const T* qb = q + ((size_t)b * Sq * H + h) * DQK;
  const T* kb = k + ((size_t)b * Sk * Hkv + hk) * DQK;
  const T* vb = v + ((size_t)b * Sk * Hkv + hk) * DV;

  for (int i = tid; i < BQ * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK;
    sQ[r * LD + d] =
        q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // causal: no key past the last real query row of this tile is live
  const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();     // previous tile's consumers are done with sK/sV/sP
    if constexpr (DQK == DV) {
      // one pass loads a K and a V element (the tile load is a large part
      // of a step at these head dims)
      for (int i = tid; i < BK * DQK; i += kThreads) {
        const int r = i / DQK, d = i % DQK;
        const bool in = k0 + r < Sk;
        const size_t off = (size_t)(k0 + r) * k_row + d;
        sK[r * LD + d] = in ? to_f32(kb[off]) : 0.f;
        sV[r * DV + d] = in ? to_f32(vb[off]) : 0.f;
      }
    } else {
      for (int i = tid; i < BK * DQK; i += kThreads) {
        const int r = i / DQK, d = i % DQK;
        sK[r * LD + d] =
            k0 + r < Sk ? to_f32(kb[(size_t)(k0 + r) * k_row + d]) : 0.f;
      }
      for (int i = tid; i < BK * DV; i += kThreads) {
        const int r = i / DV, d = i % DV;
        sV[r * DV + d] =
            k0 + r < Sk ? to_f32(vb[(size_t)(k0 + r) * v_row + d]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
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
      const int q_pos = q_offset + q0 + tr + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool allow = k_pos < Sk && (!causal || k_pos <= q_pos);
        s[i][j] = allow ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
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
      for (int j = 0; j < DPT; ++j) vv[j] = sV[kk * DV + tc + 16 * j];
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
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = out + ((size_t)b * Sq + r) * o_row + (size_t)h * DV;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tc + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int Hkv, int q_offset,
                   int causal, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DQK, DV>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, DQK, DV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv,
      q_offset, causal, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dims(int DQK, int DV, const void* q, const void* k,
                    const void* v, void* out, int B, int Sq, int Sk, int H,
                    int Hkv, int q_offset, int causal, float scale,
                    float softcap, cudaStream_t st) {
#define REPRO_FLASH_CASE(QK, V)                                          \
  if (DQK == QK && DV == V)                                              \
    return launch<T, QK, V>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset,   \
                            causal, scale, softcap, st);
  REPRO_FLASH_CASE(16, 16)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(192, 128)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, DQK); k (B, Sk, Hkv, DQK); v (B, Sk, Hkv, DV); out
// (B, Sq, H, DV); contiguous. softcap <= 0: none. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int Hkv, int DQK, int DV,
                                     int q_offset, int causal, float scale,
                                     float softcap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(DQK, DV, q, k, v, out, B, Sq, Sk, H, Hkv,
                                  q_offset, causal, scale, softcap, st);
  if (dtype == kFloat32)
    return by_dims<float>(DQK, DV, q, k, v, out, B, Sq, Sk, H, Hkv, q_offset,
                          causal, scale, softcap, st);
  return cudaErrorInvalidValue;
}
