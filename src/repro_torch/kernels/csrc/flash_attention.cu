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
// dh=128, bf16) the causal work is ~4.3 GFLOP against ~12.6 MB of q/k/v/o,
// ~4.3 us on the tensor cores against ~3.8 us of bytes; at the MLA shape
// (S=1024, H=128, DQK=192, DV=128) ~43 GFLOP against ~168 MB (~44 us of
// operations against ~50 us of bytes). Both are near balanced, so the
// products must run on the tensor cores and K/V must stream without stalls.
//
// Two bodies, chosen by the element type:
//
// bfloat16 (every serving path): FlashAttention-2 on mma.sync.
//  * 4 warps a block; a warp owns MT m-tiles of 16 query rows of one head:
//    MT 1 (64 rows a block) up to d_qk 128, MT 2 (128 rows a block) at the
//    MLA's d_qk 192, where it halves the K/V tile reads a query row costs
//    (grid (B*H, ceil(Sq / (64 MT)))). The q-tile index is reversed, so the
//    tiles with the most keys are scheduled first and the short ones fill the
//    tail;
//  * Q is copied once by cp.async into shared memory. At MT 1 ldmatrix
//    moves it once into A fragments that stay in registers (d_qk/16 k-steps
//    x 4 registers); at MT 2 registers do not hold both m-tiles and each
//    k-step reloads them from shared memory;
//  * K/V tiles (64 keys, 32 at d_qk 192) stay bf16 in a 2-stage ring fed
//    by cp.async.cg 16-byte copies (rows past Sk are zero-filled): tile j+1
//    loads while tile j is multiplied. Rows are padded by 16 bytes, so the
//    8 row addresses of an ldmatrix hit 8 different bank groups. Shared
//    memory: 85 KB at (128,128), 92 KB at (192,128): two blocks an SM;
//  * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate) with K
//    fragments by ldmatrix; scale, softcap, the k_pos < Sk and causal
//    masks (with q_offset, finite -1e30, tested only on tiles that cross
//    the diagonal or Sk) and the online softmax (base 2, ex2.approx) work on
//    the f32 accumulator fragments; row max reduces by shuffles within a
//    quad, the row sum stays per thread until the end;
//  * P is rounded to bf16 in registers and used directly as the A operand
//    of P V (the m16n8k16 C layout of two score tiles is the A layout of
//    one k-step), V fragments by ldmatrix.trans; O accumulates in f32
//    registers, is divided by max(l, 1e-30) and leaves through the warp's
//    own rows of the Q tile as 16-byte stores. No atomics: a result
//    repeats bit for bit.
//  What holds it back: each warp runs mma.sync on its own and walks its
//  tiles as a chain (load fragments, 2 products, softmax between them, no
//  second warpgroup to overlap the softmax with), at ~255 registers a
//  thread, so 8 warps an SM reach ~130 TFLOP/s at qwen3's shape and ~210
//  at the MLA's on an H100 SXM at 700 W, a fifth of the tensor cores'
//  989. wgmma with TMA and warp specialisation (a producer warp, ping-pong
//  consumer warpgroups) is the next step.
//
// float32 (the dtype of the card-vs-CPU parity checks): the scalar body,
// kept on the CUDA cores. On the tensor cores float32 would become TF32
// and lose the 1e-3 parity of the logits.
//  * grid (ceil(Sq/64), B*H): a block owns 64 query rows of one head. The
//    q tile sits in shared memory (float32), and the block walks 64-key
//    tiles up to the causal limit of its last row; tiles wholly past the
//    diagonal are never loaded, as the TPU kernel's pl.when(live) skips
//    them;
//  * 256 threads form a 16x16 grid; a thread owns 4 query rows x 4 keys of
//    the score tile and 4 rows x DV/16 dims of the output, in registers. Row
//    max and sum reduce over the 16 threads of a row with shuffles;
//  * online softmax in float32 with the finite -1e30 mask value, q_offset
//    (absolute position of query row 0) and an optional logit softcap;
//  * q/k tiles are padded by one float per row so that the 16 threads of a
//    row group read 16 different banks. Shared memory is ~113 KB at
//    (128,128) and ~145 KB at (192,128).
//
// In both, an optional float32 lse (B, H, Sq) receives each row's
// log-sum-exp of the scaled logits, which flash_attention_bwd.cu reads to
// recompute the probabilities; serving passes null and nothing more is
// written.
//
// In both, K/V are read at Hkv heads (q head h reads KV head h / G), so the
// GQA repeat of the reference's caller is not needed. The head dims are
// template parameters, instantiated for (DQK, DV) in (16,16), (32,32),
// (64,64), (128,128) and (192,128). Shared memory above the 48 KB default
// is asked for with cudaFuncSetAttribute before each launch.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int Hkv, int q_offset, int causal, float scale,
                       float softcap) {
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
    // the row's log-sum-exp of the scaled logits, for the backward
    if (lse != nullptr && tc == 0)
      lse[((size_t)b * H + h) * Sq + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 body: mma.sync m16n8k16 on the tensor cores.
// ---------------------------------------------------------------------------
namespace tensor_cores {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // 4 warps
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kPad = 8;             // bf16 per row of padding (16 bytes)

// A warp owns MT m-tiles of 16 query rows (a block 64 * MT rows) and walks
// tiles of BKT keys.
template <int DQK, int DV, int MT, int BKT>
constexpr size_t smem_bytes() {
  // the Q tile, then the stages of K, then the stages of V
  return sizeof(bf16) * ((size_t)64 * MT * (DQK + kPad) +
                         (size_t)kStages * BKT * (DQK + kPad) +
                         (size_t)kStages * BKT * (DV + kPad));
}

// Copies ROWS rows of D bf16 (row i at g + i * stride) into shared rows of
// LD bf16; rows at or past n_valid are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          size_t stride, int n_valid,
                                          int tid) {
  constexpr int kChunks = D / 8;           // 16-byte chunks a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (kTotal % kThreads && i >= kTotal) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < n_valid;
    cp_async_16(smem_addr(s + r * LD + c * 8),
                g + (in ? (size_t)r * stride : 0) + c * 8, in);
  }
}

template <int DQK, int DV, int MT, int BKT>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int Hkv, int q_offset, int causal, float scale,
                       float softcap) {
  constexpr int LQ = DQK + kPad, LK = DQK + kPad, LV = DV + kPad;
  constexpr int KS = DQK / 16;    // k-steps of Q K^T
  constexpr int NS = BKT / 8;     // score n-tiles (8 keys each)
  constexpr int NO = DV / 8;      // output n-tiles (8 dims each)
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && BKT % 16 == 0,
                "head dims and key tile: multiples of 16");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  constexpr int kBQ = 64 * MT;    // query rows a block
  bf16* sK = sQ + kBQ * LQ;       // the stages of BKT x LK
  bf16* sV = sK + kStages * BKT * LK;   // the stages of BKT x LV

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // fragment row group, column pair
  const int wr = warp * 16 * MT;            // the warp's first row
  const size_t q_row = (size_t)H * DQK;
  const size_t k_row = (size_t)Hkv * DQK;
  const size_t v_row = (size_t)Hkv * DV;
  const size_t o_row = (size_t)H * DV;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * DQK;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * DV;

  // causal: no key past the last real query row of this tile is live
  const int last_q = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + BKT - 1) / BKT : 0;

  // copy groups: the Q tile, then one per key tile, kStages - 1 ahead
  load_tile<kBQ, DQK, LQ>(sQ, q + (((size_t)b * Sq + q0) * H + h) * DQK,
                          q_row, Sq - q0, tid);
  cp_async_commit();
  auto load_keys = [&](int j) {   // key tile j into stage j % kStages
    const int st = j % kStages, first = j * BKT;
    load_tile<BKT, DQK, LK>(sK + st * BKT * LK, kb + (size_t)first * k_row,
                            k_row, Sk - first, tid);
    load_tile<BKT, DV, LV>(sV + st * BKT * LV, vb + (size_t)first * v_row,
                           v_row, Sk - first, tid);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_keys(j);
    cp_async_commit();
  }

  // ldmatrix x4: lanes 8i..8i+7 address the rows of 8x8 matrix i
  const int lr = lane % 8, lm = lane / 8;
  // Q's A fragments of m-tile i at k-step kk; with one m-tile a warp they
  // stay in registers for the whole walk, else each k-step reloads them
  auto q_frag = [&](uint32_t (&a)[4], int i, int kk) {
    ldmatrix_x4(a, smem_addr(sQ + (wr + 16 * i + lr + (lm & 1) * 8) * LQ +
                             kk * 16 + (lm >> 1) * 8));
  };
  uint32_t qreg[MT == 1 ? KS : 1][4];
  if constexpr (MT == 1) {
    cp_async_wait<kStages - 1>();   // the Q tile has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) q_frag(qreg[kk], 0, kk);
  }

  float o[MT][NO][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  // rows 16i + g + 8r of the warp's 16 * MT: running max (logit x log2 e)
  // and this thread's share of the running sum
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
  const int row_pos = q_offset + q0 + wr + g;
  const float scale2 = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + kStages - 1 < n_tiles) load_keys(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // key tile j (and Q) has landed
    __syncthreads();
    const int k0 = j * BKT;
    const bf16* tK = sK + j % kStages * BKT * LK;
    const bf16* tV = sV + j % kStages * BKT * LV;

    // S = Q K^T: per k-step, one ldmatrix x4 of K (n-tiles 2n and 2n+1)
    // feeds two mma for each of the warp's Q m-tiles
    float s[MT][NS][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if constexpr (MT == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[i][e] = qreg[kk][e];
        } else {
          q_frag(qa[i], i, kk);
        }
      }
#pragma unroll
      for (int n = 0; n < NS / 2; ++n) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(tK + (n * 16 + lr + (lm >> 1) * 8) * LK +
                                  kk * 16 + (lm & 1) * 8));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma(s[i][2 * n], qa[i], kf[0], kf[1]);
          mma(s[i][2 * n + 1], qa[i], kf[2], kf[3]);
        }
      }
    }

    // logits x log2 e, capped and masked: s[i][n][0..1] are row 16i + g,
    // s[i][n][2..3] row 16i + g + 8, at keys k0 + 8n + 2t (+1). Only a tile
    // that crosses Sk or the causal diagonal of the block's first row needs
    // the mask.
    const bool masked = k0 + BKT > Sk ||
                        (causal && k0 + BKT - 1 > q_offset + q0);
    float corr[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if (softcap > 0.f)
            x = softcap * tanhf(s[i][n][e] * scale / softcap) * kLog2e;
          else
            x = s[i][n][e] * scale2;
          if (masked) {
            const int k_pos = k0 + n * 8 + 2 * t + (e & 1);
            const int q_pos = row_pos + 16 * i + (e >> 1) * 8;
            const bool allow = k_pos < Sk && (!causal || k_pos <= q_pos);
            x = allow ? x : kNegInf;
          }
          s[i][n][e] = x;
          rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
        const float m_new = fmaxf(m[i][r], rmax[r]);
        corr[i][r] = fast_exp2(m[i][r] - m_new);
        m[i][r] = m_new;
        l[i][r] *= corr[i][r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][n][e] = fast_exp2(s[i][n][e] - m[i][e >> 1]);
          l[i][e >> 1] += s[i][n][e];
        }
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[i][n][0] *= corr[i][0];
        o[i][n][1] *= corr[i][0];
        o[i][n][2] *= corr[i][1];
        o[i][n][3] *= corr[i][1];
      }
    }

    // O += P V: score n-tiles 2kk and 2kk+1 (C layout) are the A fragment
    // of k-step kk; one ldmatrix.trans x4 of V (n-tiles 2n and 2n+1) feeds
    // four mma
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        pa[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
        pa[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
        pa[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
        pa[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(tV + (kk * 16 + lr + (lm & 1) * 8) *
                                                 LV + n * 16 + (lm >> 1) * 8));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma(o[i][2 * n], pa[i], vf[0], vf[1]);
          mma(o[i][2 * n + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();              // every warp is done with tile j's stage
  }

  // the row sums over the quad, then O / l through the warp's own rows of
  // the Q tile (no other warp reads them) and out as 16-byte stores
  bf16* sO = sQ + wr * LQ;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 1);
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 2);
      inv[r] = 1.f / fmaxf(l[i][r], 1e-30f);
      // the row's log-sum-exp of the scaled logits (m is in log2 units),
      // for the backward
      const int row = q0 + wr + 16 * i + g + 8 * r;
      if (lse != nullptr && t == 0 && row < Sq)
        lse[((size_t)b * H + h) * Sq + row] =
            (m[i][r] + log2f(l[i][r])) * kLn2;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(sO + (16 * i + g) * LQ + n * 8 + 2 * t) =
          pack_bf16(o[i][n][0] * inv[0], o[i][n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sO + (16 * i + g + 8) * LQ + n * 8 +
                                   2 * t) =
          pack_bf16(o[i][n][2] * inv[1], o[i][n][3] * inv[1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = DV / 8;
#pragma unroll
  for (int it = 0; it < 16 * MT * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    const int row = q0 + wr + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + ((size_t)b * Sq + row) * o_row +
                                (size_t)h * DV + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LQ + c * 8);
  }
}

template <int DQK, int DV, int MT, int BKT>
cudaError_t launch_tiles(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Sk, int H,
                         int Hkv, int q_offset, int causal, float scale,
                         float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DQK, DV, MT, BKT>();
  void (*kernel)(const bf16*, const bf16*, const bf16*, bf16*, float*, int,
                 int, int, int, int, int, float, float) =
      flash_attention_kernel<DQK, DV, MT, BKT>;
  // set on every launch: the attributes belong to the current device
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sq + 64 * MT - 1) / (64 * MT));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Sk, H,
      Hkv, q_offset, causal, scale, softcap);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int Hkv,
                   int q_offset, int causal, float scale, float softcap,
                   cudaStream_t stream) {
  // cp.async and the output stores move 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return cudaErrorMisalignedAddress;
  // d_qk 192 (MLA): two m-tiles a warp halve the K/V tile reads a query
  // row costs; Q is then read from shared memory at every k-step and the
  // key tile shrinks to 32 so that registers and two blocks an SM fit
  if constexpr (DQK > 128)
    return launch_tiles<DQK, DV, 2, 32>(q, k, v, out, lse, B, Sq, Sk, H, Hkv,
                                        q_offset, causal, scale, softcap,
                                        stream);
  else
    return launch_tiles<DQK, DV, 1, 64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv,
                                        q_offset, causal, scale, softcap,
                                        stream);
}

}  // namespace tensor_cores

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int Hkv,
                   int q_offset, int causal, float scale, float softcap,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tensor_cores::launch<DQK, DV>(q, k, v, out, lse, B, Sq, Sk, H, Hkv,
                                         q_offset, causal, scale, softcap,
                                         stream);
  } else {
    constexpr size_t bytes = smem_bytes<DQK, DV>();
    // set on every launch: the attribute belongs to the current device
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, DQK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + BQ - 1) / BQ, B * H);
    flash_attention_kernel<T, DQK, DV><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, Hkv,
        q_offset, causal, scale, softcap);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t by_dims(int DQK, int DV, const void* q, const void* k,
                    const void* v, void* out, float* lse, int B, int Sq,
                    int Sk, int H, int Hkv, int q_offset, int causal,
                    float scale, float softcap, cudaStream_t st) {
#define REPRO_FLASH_CASE(QK, V)                                          \
  if (DQK == QK && DV == V)                                              \
    return launch<T, QK, V>(q, k, v, out, lse, B, Sq, Sk, H, Hkv,        \
                            q_offset, causal, scale, softcap, st);
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
// (B, Sq, H, DV); contiguous. lse: float32 (B, H, Sq), the rows'
// log-sum-exp of the scaled logits for the backward, or null (serving:
// nothing more is written). softcap <= 0: none. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int Sq, int Sk, int H, int Hkv,
                                     int DQK, int DV, int q_offset,
                                     int causal, float scale, float softcap,
                                     int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(DQK, DV, q, k, v, out, lse, B, Sq, Sk, H,
                                  Hkv, q_offset, causal, scale, softcap, st);
  if (dtype == kFloat32)
    return by_dims<float>(DQK, DV, q, k, v, out, lse, B, Sq, Sk, H, Hkv,
                          q_offset, causal, scale, softcap, st);
  return cudaErrorInvalidValue;
}
