// Absorbed-MLA chunked-prefill attention at absolute positions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/chunk_attention.py::mla_chunk_attention (Pallas, grid
// (B, q_blocks, k_blocks) with the k axis sequential and m/l/acc of all H
// heads in VMEM scratch).
//
// C query rows at absolute positions qp attend to Sk cache-plus-chunk rows
// at absolute positions kp (-1 = empty ring row). q_lat (B, C, H, L)
// carries W_UK already, so a key's score is
//   (q_lat . latent_row + q_rope . rope_row) * scale
// and the value is the latent row itself: out (B, C, H, L). A key is live
// for a query iff kp >= 0 && kp <= qp.
//
// What bounds it on the H100: at the serving chunk (C 256 against Sk 1344,
// H 128, L 512, R 64) the (query, key) pairs cost 2*(L+R+L) flops per head,
// ~96 GFLOP a call (~97 us on the tensor cores) against ~40 MB of q/out and
// ~1.5 MB of latent rows: operations. This kernel runs them as scalar
// float32 FMAs on the CUDA cores, so the FMA issue rate and the
// shared-memory reads that feed it bound it, ~100x above that.
//
// Design (chunk_attention.cu with two score terms and the latent as the
// value):
//  * grid (ceil(C/32), B*H): a block owns 32 query rows of one head; their
//    q_lat and q_rope rows sit side by side in one shared tile of L+R
//    float32 columns, the key rows the same way (latent then rope), so one
//    pass over L+R columns gives both score terms. The value is the key
//    tile's first L columns: no third tile is loaded. At L+R = 576 the two
//    tiles take ~144 KB, which is why the tiles are 32 rows, not the 64 of
//    chunk_attention.cu;
//  * cache rows are not sorted by position (a ring), so the block walks all
//    of Sk in 32-key tiles; a query row with no live key anywhere (qp = -1
//    pad) averages the latent over every key, as the reference does;
//  * the mask is computed in the kernel from the two position lanes;
//    masked scores take the finite -1e30, keys past Sk (the ragged last
//    tile) take probability 0, and the finalize divides by max(l, 1e-30),
//    so every row comes out finite;
//  * 256 threads as a 16x16 grid, a thread owning 2 rows x 2 keys of the
//    score tile and 2 rows x L/16 output dims;
//  * the dims are template parameters: (L, R) = (512, 64) for deepseek-v2
//    and (16, 8) for the small test stacks; float32 and bfloat16.
// What holds it back: scalar FMAs instead of mma.sync/wgmma, and every
// block reading the latent rows of all Sk keys for one head (the H heads
// of a query tile share them through L2, not through shared memory).
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int kThreads = 256;

template <int L, int R>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (L + R + 1) + (size_t)BK * (L + R + 1) +
                          (size_t)BQ * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int L, int R>
__global__ void __launch_bounds__(kThreads)
mla_chunk_attention_kernel(const T* __restrict__ q_lat,
                           const T* __restrict__ q_rope,
                           const T* __restrict__ latent,
                           const T* __restrict__ rope,
                           const int* __restrict__ qpos,
                           const int* __restrict__ kpos, T* __restrict__ out,
                           int C, int Sk, int H, float scale) {
  constexpr int D = L + R;        // score columns
  constexpr int LD = D + 1;       // padded row of the q and key tiles
  constexpr int LP = BK + 1;      // padded row of the probability tile
  constexpr int DPT = L / 16;     // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sP = sK + BK * LD;
  int* sQp = reinterpret_cast<int*>(sP + BQ * LP);
  int* sKp = sQp + BQ;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const T* qlb = q_lat + ((size_t)b * C * H + h) * L;
  const T* qrb = q_rope + ((size_t)b * C * H + h) * R;
  const T* latb = latent + (size_t)b * Sk * L;
  const T* ropeb = rope + (size_t)b * Sk * R;
  const int* qpb = qpos + (size_t)b * C;
  const int* kpb = kpos + (size_t)b * Sk;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < C) {
      const size_t row = (size_t)(q0 + r) * H;
      x = d < L ? to_f32(qlb[row * L + d]) : to_f32(qrb[row * R + d - L]);
    }
    sQ[r * LD + d] = x;
  }
  if (tid < BQ) sQp[tid] = q0 + tid < C ? qpb[q0 + tid] : -1;

  float m[2], l[2], acc[2][DPT];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();     // previous tile's consumers are done with sK/sP
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float x = 0.f;
      if (k0 + r < Sk) {
        const size_t row = (size_t)(k0 + r);
        x = d < L ? to_f32(latb[row * L + d]) : to_f32(ropeb[row * R + d - L]);
      }
      sK[r * LD + d] = x;
    }
    if (tid < BK) sKp[tid] = k0 + tid < Sk ? kpb[k0 + tid] : -1;
    __syncthreads();

    float s[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[2], kv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) qv[i] = sQ[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = sK[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = sQp[tr + 16 * i];
      float rmax = kNegInf;
      bool in_range[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = sKp[tc + 16 * j];
        in_range[j] = k0 + tc + 16 * j < Sk;
        const bool allow = kp >= 0 && kp <= qp;
        s[i][j] = allow ? s[i][j] * scale : kNegInf;
        if (in_range[j]) rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
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

    // the value is the latent: the key tile's first L columns
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float p0 = sP[tr * LP + kk];
      const float p1 = sP[(tr + 16) * LP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float v = sK[kk * LD + tc + 16 * j];
        acc[0][j] += p0 * v;
        acc[1][j] += p1 * v;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r >= C) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = out + (((size_t)b * C + r) * H + h) * L;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tc + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int L, int R>
cudaError_t launch(const void* ql, const void* qr, const void* lat,
                   const void* rope, const void* qpos, const void* kpos,
                   void* out, int B, int C, int Sk, int H, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<L, R>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      mla_chunk_attention_kernel<T, L, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((C + BQ - 1) / BQ, B * H);
  mla_chunk_attention_kernel<T, L, R><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(ql), static_cast<const T*>(qr),
      static_cast<const T*>(lat), static_cast<const T*>(rope),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<T*>(out), C, Sk, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dims(int L, int R, const void* ql, const void* qr,
                    const void* lat, const void* rope, const void* qpos,
                    const void* kpos, void* out, int B, int C, int Sk, int H,
                    float scale, cudaStream_t st) {
  if (L == 512 && R == 64)
    return launch<T, 512, 64>(ql, qr, lat, rope, qpos, kpos, out, B, C, Sk,
                              H, scale, st);
  if (L == 16 && R == 8)
    return launch<T, 16, 8>(ql, qr, lat, rope, qpos, kpos, out, B, C, Sk, H,
                            scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_lat (B, C, H, L); q_rope (B, C, H, R); latent (B, Sk, L); rope
// (B, Sk, R); qpos (B, C) int32; kpos (B, Sk) int32; out (B, C, H, L);
// contiguous. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_mla_chunk_attention(const void* q_lat,
                                         const void* q_rope,
                                         const void* latent, const void* rope,
                                         const void* qpos, const void* kpos,
                                         void* out, int B, int C, int Sk,
                                         int H, int L, int R, float scale,
                                         int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Sk <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(L, R, q_lat, q_rope, latent, rope, qpos,
                                  kpos, out, B, C, Sk, H, scale, st);
  if (dtype == kFloat32)
    return by_dims<float>(L, R, q_lat, q_rope, latent, rope, qpos, kpos, out,
                          B, C, Sk, H, scale, st);
  return cudaErrorInvalidValue;
}
