// The gradient of causal flash attention (flash_attention.cu), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel (no
// custom_vjp under repro/kernels), its gradient is XLA's autodiff of
// repro/kernels/ref.py::chunked_flash_attention. On the card the forward
// is a hand-written launch that autograd cannot see through, so training
// needs this one.
//
// The standard recompute scheme (FlashAttention-2), with the forward's
// row log-sum-exp lse (B, H, Sq) f32 in place of the score matrix:
//   delta  = rowsum(dO * O)                        one warp a row
//   P      = exp(S * scale - lse), masked to 0      S = Q K^T
//   dP     = dO V^T,   dS = P * (dP - delta)
//   dV     = sum over the group's query heads and rows of P^T dO
//   dK     = sum over the same of dS^T Q * scale
//   dQ     = dS K * scale
// Three launches: the delta pre-pass; dkdv, one block per (key tile of
// 64, batch, KV head), walking every query head of its GQA group and
// every query tile that can see a key of the tile; dq, one block per
// (query tile of 64, batch, head), walking the key tiles up to the causal
// limit of its last row. S and dP are recomputed in both. Tiles that no
// row can see are never loaded (q_offset and Sk respected). No atomics:
// each output is summed by one thread in a fixed order, so a result
// repeats bit for bit.
//
// What bounds it on the H100: at qwen3's training shape (B 8, S 128, H 16,
// Hkv 8, dh 128) the backward moves ~25 MB in bf16 (q, k, v, o, dO, lse in;
// dq, dk, dv out) against ~1.4 GFLOP of causal products: ~7.5 us of bytes
// against ~1.4 us on the tensor cores. This first kernel is the simple,
// right one: both dtypes are loaded into float32 shared memory and every
// product runs as float32 FMAs on the CUDA cores (as the forward's float32
// body), so it is bound by those (67 TFLOP/s) and by shared-memory
// traffic, far from the bytes. 256 threads a block form a 16 x 16 grid; a
// thread owns 4 x 4 entries of the 64 x 64 score tile and 4 rows x dh/16
// dims of its accumulators. Tiles are padded by one float a row so the 16
// threads of a row group read 16 banks. Shared memory: ~162 KB (dkdv) and
// ~146 KB (dq) at dh 128. mma.sync or wgmma products are later work
// (ROADMAP.md, Queue 2).
#include <atomic>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int BQ = 64;          // query rows a tile
constexpr int BK = 64;          // keys a tile
constexpr int kThreads = 256;   // 16 x 16

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp a
// (b, i, h) row of the contiguous (B, Sq, H, D) layout.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int Sq, int H, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + (size_t)row * D;
  const T* dp = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f32(op[d]) * to_f32(dp[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, i = (row / H) % Sq, b = row / H / Sq;
    delta[((size_t)b * H + h) * Sq + i] = acc;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles; P and dS (keys x queries); lse and delta of a tile
  return sizeof(float) * (4 * (size_t)64 * (D + 1) +
                          2 * (size_t)64 * (64 + 1) + 2 * 64);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; dS (queries x keys)
  return sizeof(float) * (4 * (size_t)64 * (D + 1) + (size_t)64 * (64 + 1));
}

// Copies ROWS rows of D elements (row r at g + r * stride) into shared rows
// of D + 1 floats; rows at or past n_valid are zero-filled.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(float* s, const T* g,
                                          size_t stride, int n_valid,
                                          int tid) {
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D;
    s[r * (D + 1) + d] = r < n_valid ? to_f32(g[(size_t)r * stride + d])
                                     : 0.f;
  }
}

// dK and dV of BK keys of one KV head: rows tr + 16 i (keys) by columns
// tc + 16 j (queries) of the transposed score tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
            int Hkv, int q_offset, int causal, float scale) {
  constexpr int LD = D + 1, LP = BQ + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;         // dO
  float* sP = sO + BQ * LD;         // P, keys x queries
  float* sS = sP + BK * LP;         // dS, keys x queries
  float* sL = sS + BK * LP;         // lse of the query tile
  float* sD = sL + BQ;              // delta of the query tile

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = H / Hkv;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_row = (size_t)H * D, k_row = (size_t)Hkv * D;
  const size_t kv_off = ((size_t)b * Sk + k0) * k_row + (size_t)hk * D;

  load_rows<T, BK, D>(sK, k + kv_off, k_row, Sk - k0, tid);
  load_rows<T, BK, D>(sV, v + kv_off, k_row, Sk - k0, tid);

  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // query row i sees key k0 iff q_offset + i >= k0: earlier tiles are
  // wholly masked and never loaded
  const int q_first = causal ? max(0, k0 - q_offset) / BQ * BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const size_t qo_off = (size_t)b * Sq * q_row + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += BQ) {
      __syncthreads();   // the previous tile's readers are done
      load_rows<T, BQ, D>(sQ, q + qo_off + (size_t)q0 * q_row, q_row,
                          Sq - q0, tid);
      load_rows<T, BQ, D>(sO, dout + qo_off + (size_t)q0 * q_row, q_row,
                          Sq - q0, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lb[q0 + tid] : 0.f;
        sD[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(tr + 16 * i) * LD + d];
          vv[i] = sV[(tr + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tc + 16 * j) * LD + d];
          ov[j] = sO[(tc + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * ov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k_pos = k0 + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q0 + tc + 16 * j;
          const bool allow = k_pos < Sk && qi < Sq &&
                             (!causal || k_pos <= q_offset + qi);
          const float p =
              allow ? expf(s[i][j] * scale - sL[tc + 16 * j]) : 0.f;
          sP[(tr + 16 * i) * LP + tc + 16 * j] = p;
          sS[(tr + 16 * i) * LP + tc + 16 * j] =
              p * (dp[i][j] - sD[tc + 16 * j]);
        }
      }
      __syncthreads();

      // dV += P dO, dK += dS Q over the tile's queries, in order
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float ov[DPT], qv[DPT];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          ov[j] = sO[qq * LD + tc + 16 * j];
          qv[j] = sQ[qq * LD + tc + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sP[(tr + 16 * i) * LP + qq];
          const float ds = sS[(tr + 16 * i) * LP + qq];
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            acc_v[i][j] += p * ov[j];
            acc_k[i][j] += ds * qv[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + tr + 16 * i;
    if (r >= Sk) continue;
    const size_t off = ((size_t)b * Sk + r) * k_row + (size_t)hk * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[off + tc + 16 * j] = from_f32<T>(acc_k[i][j] * scale);
      dv[off + tc + 16 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// dQ of BQ query rows of one head: rows tr + 16 i (queries) by columns
// tc + 16 j (keys) of the score tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int q_offset,
          int causal, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;         // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;         // dS, queries x keys

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_row = (size_t)H * D, k_row = (size_t)Hkv * D;
  const size_t qo_off = ((size_t)b * Sq + q0) * q_row + (size_t)h * D;
  const size_t kv_base = (size_t)b * Sk * k_row + (size_t)hk * D;

  load_rows<T, BQ, D>(sQ, q + qo_off, q_row, Sq - q0, tid);
  load_rows<T, BQ, D>(sO, dout + qo_off, q_row, Sq - q0, tid);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    const size_t at = ((size_t)b * H + h) * Sq + qi;
    row_lse[i] = qi < Sq ? lse[at] : 0.f;
    row_delta[i] = qi < Sq ? delta[at] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // causal: no key past the last real query row of this tile is live
  const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, BK, D>(sK, k + kv_base + (size_t)k0 * k_row, k_row,
                        Sk - k0, tid);
    load_rows<T, BK, D>(sV, v + kv_base + (size_t)k0 * k_row, k_row,
                        Sk - k0, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(tr + 16 * i) * LD + d];
        ov[i] = sO[(tr + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tc + 16 * j) * LD + d];
        vv[j] = sV[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tc + 16 * j;
        const bool allow = k_pos < Sk && qi < Sq &&
                           (!causal || k_pos <= q_offset + qi);
        const float p = allow ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sS[(tr + 16 * i) * LP + tc + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys, in order
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float kv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = sK[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sS[(tr + 16 * i) * LP + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] += ds * kv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    T* row = dq + ((size_t)b * Sq + qi) * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      row[tc + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int Hkv, int q_offset, int causal,
                   float scale, cudaStream_t st) {
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  constexpr size_t kv_bytes = dkdv_smem_bytes<D>();
  constexpr size_t q_bytes = dq_smem_bytes<D>();
  cudaError_t e = set_smem_once(dkdv_set, dkdv_kernel<T, D>, kv_bytes);
  if (e == cudaSuccess) e = set_smem_once(dq_set, dq_kernel<T, D>, q_bytes);
  if (e != cudaSuccess) return e;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  delta_kernel<T, D><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                       kThreads, 0, st>>>(static_cast<const T*>(o), tdo,
                                          delta, Sq, H, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<T, D><<<dim3((Sk + BK - 1) / BK, B * Hkv), kThreads, kv_bytes,
                      st>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
                            static_cast<T*>(dv), Sq, Sk, H, Hkv, q_offset,
                            causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<T, D><<<dim3((Sq + BQ - 1) / BQ, B * H), kThreads, q_bytes,
                    st>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
                          Sq, Sk, H, Hkv, q_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int Hkv, int q_offset, int causal,
                   float scale, cudaStream_t st) {
#define REPRO_FLASH_BWD_CASE(DIM)                                           \
  if (D == DIM)                                                            \
    return launch<T, DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, \
                          Sk, H, Hkv, q_offset, causal, scale, st);
  REPRO_FLASH_BWD_CASE(16)
  REPRO_FLASH_BWD_CASE(32)
  REPRO_FLASH_BWD_CASE(64)
  REPRO_FLASH_BWD_CASE(128)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); o, dout (B, Sq, H, D);
// lse (the forward's) and delta (scratch) float32 (B, H, Sq); contiguous,
// one dtype for every tensor but lse and delta. D in {16, 32, 64, 128}.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int Hkv, int D, int q_offset,
    int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dim<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 B, Sq, Sk, H, Hkv, q_offset, causal, scale,
                                 st);
  if (dtype == kFloat32)
    return by_dim<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                         Sk, H, Hkv, q_offset, causal, scale, st);
  return cudaErrorInvalidValue;
}
