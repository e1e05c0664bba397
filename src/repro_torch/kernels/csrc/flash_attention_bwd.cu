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
//   delta  = rowsum(dO * O)
//   P      = exp(S * scale - lse), masked to 0      S = Q K^T
//   dP     = dO V^T,   dS = P * (dP - delta)
//   dV     = sum over the group's query heads and rows of P^T dO
//   dK     = sum over the same of dS^T Q * scale
//   dQ     = dS K * scale
// Three launches in float32: the delta pre-pass; dkdv, one block per key
// tile of one (batch, KV head), walking every query head of its GQA group
// and every query tile that can see a key of the tile; dq, one block per
// query tile of one head, walking the key tiles up to the causal limit of
// its last row. S and dP are recomputed in both. In bfloat16 dq goes
// first and computes delta from its own tiles for dkdv: two launches.
// Tiles that no row can see are never loaded (q_offset and Sk respected).
// No atomics: each output is summed by one owner in a fixed order, so a
// result repeats bit for bit. GQA is read at Hkv heads.
//
// What bounds it on the H100: at qwen3's training shape (B 8, S 128, H 16,
// Hkv 8, dh 128) the backward moves ~25 MB in bf16 (q, k, v, o, dO, lse in;
// dq, dk, dv out) against ~1.35 GFLOP of causal products: ~7.5 us of bytes
// against ~1.4 us on the tensor cores; at S 1024 and 4096 (B 1) the
// products bound it (10.7 and 172 GFLOP: ~11 and ~174 us).
//
// Two bodies, chosen by the element type:
//
// bfloat16 (training): FlashAttention-2's backward on mma.sync m16n8k16
// (bf16 in, f32 accumulate), the forward's bf16 body turned around. The
// plan (chosen by a reading of the alternatives on the H100, PERF.md §6):
//  * dq (4 warps of 16 query rows, 64 a block) is the forward's loop: Q,
//    dO and O copied once by cp.async; each warp sums its rows' delta =
//    rowsum(dO * O) from shared memory and writes it for dkdv (O sits in
//    the ring's last V stage until the ring needs it); K/V tiles of 64
//    keys through a 2-stage cp.async ring; S = Q K^T and dP = dO V^T, then
//    P = exp2(S scale log2 e - lse log2 e) and dS = P (dP - delta) on the
//    f32 accumulators, masked only on tiles that cross Sq, Sk or the
//    diagonal; dS rounded to bf16 straight into A fragments (the C layout
//    of two score tiles is the A layout of one k-step); dQ += dS K with K
//    by ldmatrix.trans. Query tiles are scheduled heaviest first.
//  * dkdv: a block owns 32 keys and holds two groups of 2 warps; warp w of
//    a group owns 16 key rows, the A rows of all four products. The groups
//    split the walk (the group's G query heads, each with its query tiles
//    of 32 rows that see a key of the block; tile i to group i % 2), each
//    through its own 2-stage cp.async ring of Q, dO, lse and delta tiles.
//    K and V sit in shared memory and their A fragments are reloaded by
//    ldmatrix at every k-step (held in registers they would not fit beside
//    dK and dV). S^T = K Q^T and dP^T = V dO^T with Q and dO as B
//    fragments; P^T and dS^T as in dq, packed to bf16 A fragments; dV +=
//    P^T dO and dK += dS^T Q with dO and Q by ldmatrix.trans. dK and dV stay
//    in f32 registers for the walk; at its end group 0 adds group 1's sums
//    (through the rings' shared memory, in group order) and writes them
//    through its own rows of the K/V tiles as 16-byte stores. Key tiles
//    are scheduled first tile first (the most query rows).
//  * Rows are padded by 16 bytes in shared memory, so the 8 row addresses
//    of an ldmatrix hit 8 bank groups. Shared memory at dh 128: ~86 KB
//    (dkdv) and ~102 KB (dq), two blocks an SM. Registers at dh 128
//    (ptxas): dq 248 a thread, dkdv 254 of the 255 a thread can have (no
//    spill; its dK and dV accumulators alone take 128).
//  * MLA (d_qk 192, d_v 128, deepseek-v2's prefill): every product runs
//    over its own width (S^T, dQ, dK over d_qk; dP^T, dV and delta over
//    d_v; o and dO are d_v wide). dK and dV of a warp's 16 keys would take
//    160 f32 accumulators a thread beside S^T's and dP^T's 32 at d_qk 192,
//    past what 254 registers at d 128 leave, so there the two warp groups
//    of a dK/dV block split the columns instead of the walk: each walks
//    every query tile through its own ring and keeps half of dK's (96) and
//    of dV's (64) columns, and nothing is summed across groups at the end
//    (S^T and dP^T are computed by both: 1.5x the products). dQ halves its
//    key tile to 32 there (S and dP take 32 accumulators beside dQ's 96)
//    and keeps O in a region of its own (a 32-key V stage cannot hold 64
//    rows of it). Shared memory: ~106 KB (dkdv) and ~101 KB (dq), two
//    blocks an SM.
//  What holds it back: mma.sync reads both operands from registers, so
//  every product's B fragments come from shared memory for 16 rows (and
//  again for each warp that shares them): the kernels issue about one
//  ldmatrix x4 for every 1.6 mma and are bound by shared-memory bandwidth
//  before the tensor cores; registers cap an SM at 8 warps. wgmma with TMA
//  (operands straight from shared memory, a producer warp) is the next
//  step (ROADMAP.md, Queue 2 B8). Measured on an H100 SXM at 700 W: 0.028
//  ms at the training shape (SDPA's backward 0.029; the first design
//  0.18-0.21), 0.11 ms at (1, 1024) and 0.95 at (1, 4096), ~2x SDPA's
//  backward there, 180 TFLOP/s useful (PERF.md, row 2b).
//
// float32 (the dtype of the card-vs-CPU parity checks): the first design,
// kept on the CUDA cores (on the tensor cores float32 would become TF32
// and lose the 2e-5 parity). Both inputs are loaded into float32 shared
// memory synchronously and every product runs as float32 FMAs; 256
// threads a block form a 16 x 16 grid, a thread owning 4 x 4 entries of
// the 64 x 64 score tile and 4 rows x dh/16 dims of its accumulators.
// Tiles are padded by one float a row so the 16 threads of a row group
// read 16 banks. Shared memory: ~162 KB (dkdv) and ~146 KB (dq) at dh 128.
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

template <int DQK, int DV>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles; P and dS (keys x queries); lse and delta of a tile
  return sizeof(float) * (2 * (size_t)64 * (DQK + 1) +
                          2 * (size_t)64 * (DV + 1) +
                          2 * (size_t)64 * (64 + 1) + 2 * 64);
}

template <int DQK, int DV>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; dS (queries x keys)
  return sizeof(float) * (2 * (size_t)64 * (DQK + 1) +
                          2 * (size_t)64 * (DV + 1) + (size_t)64 * (64 + 1));
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

// s[i][j] += sum_d a[i][d] b[j][d] over DA dims and t[i][j] += sum_d c[i][d]
// e[j][d] over DC dims: rows r0 + 16 i of the shared tiles a (stride LA)
// and c (LC), columns c0 + 16 j of b (LA) and e (LC); the dims both sums
// share run in one loop, each sum in order of d.
template <int DA, int DC>
__device__ __forceinline__ void two_products(
    float (&s)[4][4], float (&t)[4][4], const float* a, const float* b,
    const float* c, const float* e, int r0, int c0) {
  constexpr int LA = DA + 1, LC = DC + 1;
  constexpr int DM = DA < DC ? DA : DC;
#pragma unroll 4
  for (int d = 0; d < DM; ++d) {
    float av[4], cv[4], bv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(r0 + 16 * i) * LA + d];
      cv[i] = c[(r0 + 16 * i) * LC + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(c0 + 16 * j) * LA + d];
      ev[j] = e[(c0 + 16 * j) * LC + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += av[i] * bv[j];
        t[i][j] += cv[i] * ev[j];
      }
  }
  // the rest of the wider product (MLA: Q K^T's last 64 dims)
#pragma unroll 4
  for (int d = DM; d < DA; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] += a[(r0 + 16 * i) * LA + d] * b[(c0 + 16 * j) * LA + d];
  }
#pragma unroll 4
  for (int d = DM; d < DC; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t[i][j] += c[(r0 + 16 * i) * LC + d] * e[(c0 + 16 * j) * LC + d];
  }
}

// dK and dV of BK keys of one KV head: rows tr + 16 i (keys) by columns
// tc + 16 j (queries) of the transposed score tile. Q, K and dK are DQK
// wide, V, dO and dV DV wide.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
            int Hkv, int q_offset, int causal, float scale) {
  constexpr int LQ = DQK + 1, LV = DV + 1, LP = BQ + 1;
  constexpr int QPT = DQK / 16, VPT = DV / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LQ;
  float* sQ = sV + BK * LV;
  float* sO = sQ + BQ * LQ;         // dO
  float* sP = sO + BQ * LV;         // P, keys x queries
  float* sS = sP + BK * LP;         // dS, keys x queries
  float* sL = sS + BK * LP;         // lse of the query tile
  float* sD = sL + BQ;              // delta of the query tile

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = H / Hkv;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_row = (size_t)H * DQK, o_row = (size_t)H * DV;
  const size_t k_row = (size_t)Hkv * DQK, v_row = (size_t)Hkv * DV;
  const size_t k_off = ((size_t)b * Sk + k0) * k_row + (size_t)hk * DQK;
  const size_t v_off = ((size_t)b * Sk + k0) * v_row + (size_t)hk * DV;

  load_rows<T, BK, DQK>(sK, k + k_off, k_row, Sk - k0, tid);
  load_rows<T, BK, DV>(sV, v + v_off, v_row, Sk - k0, tid);

  float acc_k[4][QPT], acc_v[4][VPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc_v[i][j] = 0.f;
  }

  // query row i sees key k0 iff q_offset + i >= k0: earlier tiles are
  // wholly masked and never loaded
  const int q_first = causal ? max(0, k0 - q_offset) / BQ * BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * DQK;
    const size_t o_off = (size_t)b * Sq * o_row + (size_t)h * DV;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += BQ) {
      __syncthreads();   // the previous tile's readers are done
      load_rows<T, BQ, DQK>(sQ, q + q_off + (size_t)q0 * q_row, q_row,
                            Sq - q0, tid);
      load_rows<T, BQ, DV>(sO, dout + o_off + (size_t)q0 * o_row, o_row,
                           Sq - q0, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lb[q0 + tid] : 0.f;
        sD[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T over DQK and dP^T = V dO^T over DV
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      two_products<DQK, DV>(s, dp, sK, sQ, sV, sO, tr, tc);
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
        float ov[VPT], qv[QPT];
#pragma unroll
        for (int j = 0; j < VPT; ++j) ov[j] = sO[qq * LV + tc + 16 * j];
#pragma unroll
        for (int j = 0; j < QPT; ++j) qv[j] = sQ[qq * LQ + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sP[(tr + 16 * i) * LP + qq];
          const float ds = sS[(tr + 16 * i) * LP + qq];
#pragma unroll
          for (int j = 0; j < VPT; ++j) acc_v[i][j] += p * ov[j];
#pragma unroll
          for (int j = 0; j < QPT; ++j) acc_k[i][j] += ds * qv[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + tr + 16 * i;
    if (r >= Sk) continue;
    T* kr = dk + ((size_t)b * Sk + r) * k_row + (size_t)hk * DQK;
    T* vr = dv + ((size_t)b * Sk + r) * v_row + (size_t)hk * DV;
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      kr[tc + 16 * j] = from_f32<T>(acc_k[i][j] * scale);
#pragma unroll
    for (int j = 0; j < VPT; ++j) vr[tc + 16 * j] = from_f32<T>(acc_v[i][j]);
  }
}

// dQ of BQ query rows of one head: rows tr + 16 i (queries) by columns
// tc + 16 j (keys) of the score tile. Q, K and dQ are DQK wide, V and dO
// DV wide.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int q_offset,
          int causal, float scale) {
  constexpr int LQ = DQK + 1, LP = BK + 1, QPT = DQK / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LQ;         // dO
  float* sK = sO + BQ * (DV + 1);
  float* sV = sK + BK * LQ;
  float* sS = sV + BK * (DV + 1);   // dS, queries x keys

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_row = (size_t)H * DQK, o_row = (size_t)H * DV;
  const size_t k_row = (size_t)Hkv * DQK, v_row = (size_t)Hkv * DV;
  const size_t q_off = ((size_t)b * Sq + q0) * q_row + (size_t)h * DQK;
  const size_t o_off = ((size_t)b * Sq + q0) * o_row + (size_t)h * DV;
  const size_t k_base = (size_t)b * Sk * k_row + (size_t)hk * DQK;
  const size_t v_base = (size_t)b * Sk * v_row + (size_t)hk * DV;

  load_rows<T, BQ, DQK>(sQ, q + q_off, q_row, Sq - q0, tid);
  load_rows<T, BQ, DV>(sO, dout + o_off, o_row, Sq - q0, tid);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    const size_t at = ((size_t)b * H + h) * Sq + qi;
    row_lse[i] = qi < Sq ? lse[at] : 0.f;
    row_delta[i] = qi < Sq ? delta[at] : 0.f;
  }

  float acc[4][QPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[i][j] = 0.f;

  // causal: no key past the last real query row of this tile is live
  const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, BK, DQK>(sK, k + k_base + (size_t)k0 * k_row, k_row,
                          Sk - k0, tid);
    load_rows<T, BK, DV>(sV, v + v_base + (size_t)k0 * v_row, v_row,
                         Sk - k0, tid);
    __syncthreads();

    // S = Q K^T over DQK and dP = dO V^T over DV
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    two_products<DQK, DV>(s, dp, sQ, sK, sO, sV, tr, tc);
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
      float kv[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) kv[j] = sK[kk * LQ + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sS[(tr + 16 * i) * LP + kk];
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[i][j] += ds * kv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    T* row = dq + ((size_t)b * Sq + qi) * q_row + (size_t)h * DQK;
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      row[tc + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 body: mma.sync m16n8k16 on the tensor cores.
// ---------------------------------------------------------------------------
namespace tensor_cores {

using bf16 = __nv_bfloat16;

// The plan (PERF.md §6): dK/dV's blocks hold kQueryGroups groups of
// kKeyWarps warps (16 keys each) that split the walk's query tiles of
// kQueryTile rows, summed at the end in group order; dQ computes delta
// (rowsum(dO * O)) from its tiles for dK/dV, which runs after it.
constexpr int kKeyWarps = 2;        // dK/dV: warps a group (16 keys each)
constexpr int kQueryTile = 32;      // dK/dV: query rows a tile of a ring
constexpr int kQueryGroups = 2;     // dK/dV: warp groups a block
constexpr int kPass = 32;           // dK/dV: query columns a pass
constexpr int kQRows = 64;          // dQ: query rows a block (4 warps)
constexpr int kStages = 2;          // depth of every ring
constexpr int kPad = 8;             // bf16 per row of padding (16 bytes)

// MLA's d_qk 192 (d_v 128). dK and dV of a warp's 16 keys would take 160
// f32 accumulators a thread beside the 32 of S^T and dP^T, past the 254
// registers d 128 already holds, so there the two groups of a dK/dV block
// split the columns instead of the walk: each walks every query tile and
// keeps half of dK's and of dV's columns (48 + 32 accumulators). dQ halves
// its key tile, so S and dP take 32 accumulators beside dQ's 96.
template <int DQK>
__host__ __device__ constexpr bool split_columns() { return DQK > 128; }

template <int DQK>
__host__ __device__ constexpr int dq_keys() { return DQK > 128 ? 32 : 64; }

template <int DQK, int DV>
constexpr size_t dkdv_smem_bytes() {
  // K and V of the block's keys; each group's stages of Q and dO; then
  // each group's stages of lse and delta
  return sizeof(bf16) * ((size_t)16 * kKeyWarps +
                         (size_t)kQueryGroups * kStages * kQueryTile) *
             (DQK + DV + 2 * kPad) +
         sizeof(float) * 2 * (size_t)kQueryGroups * kStages * kQueryTile;
}

template <int DQK, int DV>
constexpr size_t dq_smem_bytes() {
  // the Q and dO tiles, the stages of K and of V, and O where the ring's
  // last V stage cannot hold it (a key tile shorter than kQRows)
  constexpr int kKeys = dq_keys<DQK>();
  return sizeof(bf16) *
         ((size_t)kQRows * (DQK + DV + 2 * kPad) +
          (size_t)kStages * kKeys * (DQK + DV + 2 * kPad) +
          (kKeys == kQRows ? 0 : (size_t)kQRows * (DV + kPad)));
}

// Copies ROWS rows of D bf16 (row i at g + i * stride) into shared rows of
// D + kPad bf16 by 16-byte cp.async, THREADS threads from tid; rows at or
// past n_valid are zero-filled.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          size_t stride, int n_valid,
                                          int tid) {
  constexpr int kChunks = D / 8;           // 16-byte chunks a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (kTotal % THREADS && i >= kTotal) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < n_valid;
    cp_async_16(smem_addr(s + r * (D + kPad) + c * 8),
                g + (in ? (size_t)r * stride : 0) + c * 8, in);
  }
}

// Waits for the THREADS threads of named barrier `id` (not 0: the block's)
template <int THREADS>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// Writes a warp's 16 x C f32 accumulator (m16n8k16 C layout, times mul)
// as bf16 through 16 rows of shared memory (row stride LD) whose C columns
// from s only this warp touches, then out as 16-byte stores: row r to g +
// r * stride while first + r < n_rows.
template <int C, int LD>
__device__ __forceinline__ void store_rows(const float (&acc)[C / 8][4],
                                           float mul, bf16* s, bf16* g,
                                           size_t stride, int first,
                                           int n_rows, int lane) {
  const int gr = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    *reinterpret_cast<uint32_t*>(s + gr * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(s + (gr + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int kChunks = C / 8;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    if (first + r < n_rows)
      *reinterpret_cast<uint4*>(g + (size_t)r * stride + c * 8) =
          *reinterpret_cast<const uint4*>(s + r * LD + c * 8);
  }
}

// dK and dV of 16 KW keys of one KV head. The block's QG groups of KW
// warps split the walk: the tiles are the group's G query heads, each
// with its QT-row query tiles that see a key of the block, in that order,
// and group i takes tiles i, i + QG, ... through its own kStages ring of
// cp.async copies (at DQK 192 every group takes every tile and keeps its
// half of the columns: split_columns). Warp w of a group owns keys
// k0 + 16 w .. +15, the A rows of every product: S^T = K Q^T and dP^T =
// V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and dS^T packed from
// the accumulators. At the end group 0 adds group 1's sums to its own.
template <int DQK, int DV>
__global__ void __launch_bounds__(32 * kKeyWarps * kQueryGroups,
                                  8 / (kKeyWarps * kQueryGroups))
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
            int H, int Hkv, int q_offset, int causal, float scale) {
  constexpr int KW = kKeyWarps, QT = kQueryTile, QG = kQueryGroups;
  static_assert(QG == 2, "group 0 sums group 1's dK and dV");
  constexpr bool kSplit = split_columns<DQK>();
  constexpr int kThreads = 32 * KW * QG;
  constexpr int GT = 32 * KW;       // threads a group
  constexpr int BKB = 16 * KW;      // keys a block
  constexpr int LQ = DQK + kPad, LV = DV + kPad;
  constexpr int KSQ = DQK / 16;     // k-steps of S^T (over d_qk)
  constexpr int KSV = DV / 16;      // k-steps of dP^T (over d_v)
  constexpr int NQ = kPass / 8;     // score n-tiles of a pass (8 queries)
  constexpr int CK = kSplit ? DQK / QG : DQK;   // dK columns a group keeps
  constexpr int CV = kSplit ? DV / QG : DV;     // dV columns a group keeps
  constexpr int NK = CK / 8, NV = CV / 8;       // accumulator n-tiles
  static_assert(CK % 16 == 0 && CV % 16 == 0, "ldmatrix x4 pairs");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + BKB * LQ;
  bf16* rings = sV + BKB * LV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / KW, gtid = tid % GT;
  // this group's ring: kStages tiles of QT x LQ of Q, of QT x LV of dO,
  // then kStages x QT floats of lse and of delta
  bf16* sQ = rings + grp * kStages * QT * (LQ + LV);
  bf16* sO = sQ + kStages * QT * LQ;
  float* sL = reinterpret_cast<float*>(rings + QG * kStages * QT * (LQ + LV)) +
              grp * 2 * kStages * QT;
  float* sD = sL + kStages * QT;

  const int k0 = blockIdx.y * BKB;  // the first key tiles see the most rows
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int g = lane / 4, t = lane % 4;     // fragment row group, column pair
  const int wr = warp % KW * 16;            // the warp's first key row
  const size_t q_row = (size_t)H * DQK, o_row = (size_t)H * DV;
  const size_t k_row = (size_t)Hkv * DQK, v_row = (size_t)Hkv * DV;
  const size_t k_off = ((size_t)b * Sk + k0) * k_row + (size_t)hk * DQK;
  const size_t v_off = ((size_t)b * Sk + k0) * v_row + (size_t)hk * DV;
  const int ck0 = kSplit ? grp * CK : 0;    // the group's first columns
  const int cv0 = kSplit ? grp * CV : 0;

  // query row i sees key k0 iff q_offset + i >= k0: earlier tiles are
  // wholly masked and never loaded
  const int q_first = causal ? max(0, k0 - q_offset) / QT * QT : 0;
  const int n_qt = q_first < Sq ? (Sq - q_first + QT - 1) / QT : 0;
  const int n_tiles = G * n_qt;
  const int n_mine =
      kSplit ? n_tiles
             : (n_tiles > grp ? (n_tiles - grp + QG - 1) / QG : 0);
  auto tile_of = [&](int i) { return kSplit ? i : grp + i * QG; };

  // copy groups: K and V (the whole block), then one per tile of this
  // group, kStages - 1 ahead
  load_tile<BKB, DQK, kThreads>(sK, k + k_off, k_row, Sk - k0, tid);
  load_tile<BKB, DV, kThreads>(sV, v + v_off, v_row, Sk - k0, tid);
  cp_async_commit();
  auto load_queries = [&](int i) {   // group's tile i into stage i % kStages
    const int st = i % kStages, j = tile_of(i);
    const int h = hk * G + j / n_qt, q0 = q_first + j % n_qt * QT;
    const size_t qo = ((size_t)b * Sq + q0) * q_row + (size_t)h * DQK;
    const size_t oo = ((size_t)b * Sq + q0) * o_row + (size_t)h * DV;
    load_tile<QT, DQK, GT>(sQ + st * QT * LQ, q + qo, q_row, Sq - q0, gtid);
    load_tile<QT, DV, GT>(sO + st * QT * LV, dout + oo, o_row, Sq - q0,
                          gtid);
    const size_t at = ((size_t)b * H + h) * Sq + q0;
    for (int r = gtid; r < QT; r += GT) {
      const bool in = q0 + r < Sq;
      cp_async_4(smem_addr(sL + st * QT + r), lse + at + (in ? r : 0), in);
      cp_async_4(smem_addr(sD + st * QT + r), delta + at + (in ? r : 0), in);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine) load_queries(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();     // K and V have landed: every warp
  __syncthreads();                  // reads rows another group copied

  float ak[NK][4], av[NV][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[n][e] = 0.f;
  // ldmatrix x4: lanes 8i..8i+7 address the rows of 8x8 matrix i
  const int lr = lane % 8, lm = lane / 8;
  const uint32_t k_frag = (wr + lr + (lm & 1) * 8) * LQ + (lm >> 1) * 8;
  const uint32_t v_frag = (wr + lr + (lm & 1) * 8) * LV + (lm >> 1) * 8;
  const int key = k0 + wr + g;              // rows g and g + 8: key, key + 8
  const float scale2 = scale * kLog2e;
  const int bar = 1 + grp;                  // the group's barrier

  for (int i = 0; i < n_mine; ++i) {
    if (i + kStages - 1 < n_mine) load_queries(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // the group's tile i has landed
    group_sync<GT>(bar);
    const int st = i % kStages, j = tile_of(i);
    const int q0 = q_first + j % n_qt * QT;
    const bf16* tQ = sQ + st * QT * LQ;
    const bf16* tO = sO + st * QT * LV;
    const float* tL = sL + st * QT;
    const float* tD = sD + st * QT;
    // only a tile that crosses Sk, Sq or the causal diagonal needs the mask
    const bool masked = k0 + BKB > Sk || q0 + QT > Sq ||
                        (causal && k0 + BKB - 1 > q_offset + q0);

#pragma unroll
    for (int c0 = 0; c0 < QT; c0 += kPass) {
      // S^T = K Q^T and dP^T = V dO^T over the pass's kPass queries: per
      // k-step one ldmatrix x4 of Q (of dO) gives n-tiles 2n and 2n+1
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSQ; ++kk) {
        uint32_t ka[4];
        ldmatrix_x4(ka, smem_addr(sK + k_frag + kk * 16));
#pragma unroll
        for (int n = 0; n < NQ / 2; ++n) {
          uint32_t qf[4];
          ldmatrix_x4(qf, smem_addr(tQ + (c0 + n * 16 + lr + (lm >> 1) * 8) *
                                             LQ + kk * 16 + (lm & 1) * 8));
          mma(s[2 * n], ka, qf[0], qf[1]);
          mma(s[2 * n + 1], ka, qf[2], qf[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KSV; ++kk) {
        uint32_t va[4];
        ldmatrix_x4(va, smem_addr(sV + v_frag + kk * 16));
#pragma unroll
        for (int n = 0; n < NQ / 2; ++n) {
          uint32_t of[4];
          ldmatrix_x4(of, smem_addr(tO + (c0 + n * 16 + lr + (lm >> 1) * 8) *
                                             LV + kk * 16 + (lm & 1) * 8));
          mma(dp[2 * n], va, of[0], of[1]);
          mma(dp[2 * n + 1], va, of[2], of[3]);
        }
      }

      // P^T = exp2(S^T scale log2 e - lse log2 e), masked to 0, and
      // dS^T = P^T (dP^T - delta): s[n][e] is key row g + 8 (e >> 1),
      // query column c0 + 8 n + 2 t + (e & 1). Rounded to bf16, the score
      // n-tiles 2kk and 2kk + 1 are the A fragment of k-step kk
      uint32_t pa[NQ / 2][4], da[NQ / 2][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = c0 + n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(tL + col);
        const float2 d2 = *reinterpret_cast<const float2*>(tD + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dq = (e & 1) ? d2.y : d2.x;
          float x = fast_exp2(fmaf(s[n][e], scale2, -lq * kLog2e));
          if (masked) {
            const int k_pos = key + (e >> 1) * 8;
            const int qi = q0 + col + (e & 1);
            const bool allow = k_pos < Sk && qi < Sq &&
                               (!causal || k_pos <= q_offset + qi);
            x = allow ? x : 0.f;
          }
          p[e] = x;
          ds[e] = x * (dp[n][e] - dq);
        }
        pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[n / 2][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q over the group's columns: one
      // ldmatrix.trans x4 of dO (of Q) gives n-tiles 2n and 2n + 1 of
      // k-step kk
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const int row = c0 + kk * 16 + lr + (lm & 1) * 8;
#pragma unroll
        for (int n = 0; n < NV / 2; ++n) {
          uint32_t of[4];
          ldmatrix_x4_trans(of, smem_addr(tO + row * LV + cv0 + n * 16 +
                                          (lm >> 1) * 8));
          mma(av[2 * n], pa[kk], of[0], of[1]);
          mma(av[2 * n + 1], pa[kk], of[2], of[3]);
        }
#pragma unroll
        for (int n = 0; n < NK / 2; ++n) {
          uint32_t qf[4];
          ldmatrix_x4_trans(qf, smem_addr(tQ + row * LQ + ck0 + n * 16 +
                                          (lm >> 1) * 8));
          mma(ak[2 * n], da[kk], qf[0], qf[1]);
          mma(ak[2 * n + 1], da[kk], qf[2], qf[3]);
        }
      }
    }
    group_sync<GT>(bar);          // the group is done with tile i's stage
  }
  cp_async_wait<0>();

  if constexpr (!kSplit) {
    // group 1's sums into group 0's through the rings (both groups are
    // done with them): thread x of a group keeps dK's element e of n-tile
    // n at red[(n * 4 + e) * GT + x], dV's after them
    static_assert((NK + NV) * 4 * GT * sizeof(float) <=
                      (size_t)QG * kStages * QT * (LQ + LV) * sizeof(bf16),
                  "the rings hold the partial sums");
    float* red = reinterpret_cast<float*>(rings);
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(n * 4 + e) * GT + gtid] = ak[n][e];
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((NK + n) * 4 + e) * GT + gtid] = av[n][e];
    }
    __syncthreads();
    if (grp != 0) return;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[n][e] += red[(n * 4 + e) * GT + gtid];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        av[n][e] += red[((NK + n) * 4 + e) * GT + gtid];
    // out through the warp's own rows of the K and V tiles (the other
    // groups' warps that read them are done)
    __syncwarp();
  } else {
    // every warp is done reading K and V: each writes its columns of its
    // rows, which no other warp touches
    __syncthreads();
  }
  store_rows<CK, LQ>(ak, scale, sK + wr * LQ + ck0,
                     dk + k_off + (size_t)wr * k_row + ck0, k_row, k0 + wr,
                     Sk, lane);
  store_rows<CV, LV>(av, 1.f, sV + wr * LV + cv0,
                     dv + v_off + (size_t)wr * v_row + cv0, v_row, k0 + wr,
                     Sk, lane);
}

// dQ of 64 query rows of one head. Warp w owns rows q0 + 16 w .. +15:
// S = Q K^T and dP = dO V^T, dS = P (dP - delta) packed from the
// accumulators, dQ += dS K. The block walks the key tiles (dq_keys) up to
// the causal limit of its last row; they arrive through a kStages ring.
// The block first copies its O rows into the ring's last V stage (or, at
// DQK 192, a region of their own) and computes its rows' delta =
// rowsum(dO * O) there, for itself and for dK/dV.
template <int DQK, int DV>
__global__ void __launch_bounds__(128, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
          int H, int Hkv, int q_offset, int causal, float scale) {
  constexpr int kThreads = 128;
  constexpr int kKeys = dq_keys<DQK>();
  constexpr int LQ = DQK + kPad, LV = DV + kPad;
  constexpr int KSQ = DQK / 16;     // k-steps of S (over d_qk)
  constexpr int KSV = DV / 16;      // k-steps of dP (over d_v)
  constexpr int NS = kKeys / 8;     // score n-tiles (8 keys)
  constexpr int ND = DQK / 8;       // accumulator n-tiles (8 dims)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sO = sQ + kQRows * LQ;      // dO
  bf16* sK = sO + kQRows * LV;      // kStages tiles of kKeys x LQ
  bf16* sV = sK + kStages * kKeys * LQ;   // kStages tiles of kKeys x LV

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;   // heaviest first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const size_t q_row = (size_t)H * DQK, o_row = (size_t)H * DV;
  const size_t k_row = (size_t)Hkv * DQK, v_row = (size_t)Hkv * DV;
  const size_t q_off = ((size_t)b * Sq + q0) * q_row + (size_t)h * DQK;
  const size_t o_off = ((size_t)b * Sq + q0) * o_row + (size_t)h * DV;
  const bf16* kb = k + (size_t)b * Sk * k_row + (size_t)hk * DQK;
  const bf16* vb = v + (size_t)b * Sk * v_row + (size_t)hk * DV;

  // causal: no key past the last real query row of this tile is live
  const int last_q = q_offset + min(q0 + kQRows, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kKeys - 1) / kKeys : 0;

  // copy groups: Q and dO (and O), then one per key tile, kStages - 1
  // ahead
  static_assert(kStages >= 2, "O waits in a V stage the ring fills last");
  bf16* sOut = kKeys == kQRows ? sV + (kStages - 1) * kKeys * LV
                               : sV + kStages * kKeys * LV;
  load_tile<kQRows, DQK, kThreads>(sQ, q + q_off, q_row, Sq - q0, tid);
  load_tile<kQRows, DV, kThreads>(sO, dout + o_off, o_row, Sq - q0, tid);
  load_tile<kQRows, DV, kThreads>(sOut, o + o_off, o_row, Sq - q0, tid);
  cp_async_commit();
  auto load_keys = [&](int j) {   // key tile j into stage j % kStages
    const int st = j % kStages, first = j * kKeys;
    load_tile<kKeys, DQK, kThreads>(sK + st * kKeys * LQ,
                                    kb + (size_t)first * k_row, k_row,
                                    Sk - first, tid);
    load_tile<kKeys, DV, kThreads>(sV + st * kKeys * LV,
                                   vb + (size_t)first * v_row, v_row,
                                   Sk - first, tid);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_keys(j);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp's 16: lse (x log2 e) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    lse2[r] = qi < Sq ? lse[((size_t)b * H + h) * Sq + qi] * kLog2e : 0.f;
  }
  {
    // delta of the warp's 16 rows, two lanes a row (rows past Sq are zero);
    // fragment rows g and g + 8 take it from lanes 2g and 2g + 16
    cp_async_wait<kStages - 1>();   // Q, dO and O have landed
    __syncthreads();
    const int r = wr + lane / 2, half = lane % 2;
    const int at = r * LV + half * (DV / 2);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < DV / 2; c += 8) {
      const uint4 ou = *reinterpret_cast<const uint4*>(sOut + at + c);
      const uint4 du = *reinterpret_cast<const uint4*>(sO + at + c);
      const bf16* oe = reinterpret_cast<const bf16*>(&ou);
      const bf16* de = reinterpret_cast<const bf16*>(&du);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc += __bfloat162float(oe[e]) * __bfloat162float(de[e]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0 && q0 + r < Sq)
      delta[((size_t)b * H + h) * Sq + q0 + r] = acc;
    dlt[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dlt[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
    __syncthreads();                // O is read: the ring may refill it
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int lr = lane % 8, lm = lane / 8;
  const uint32_t q_frag = (wr + lr + (lm & 1) * 8) * LQ + (lm >> 1) * 8;
  const uint32_t o_frag = (wr + lr + (lm & 1) * 8) * LV + (lm >> 1) * 8;
  const int row_pos = q_offset + q0 + wr + g;
  const float scale2 = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + kStages - 1 < n_tiles) load_keys(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // key tile j (and Q, dO) has landed
    __syncthreads();
    const int k0 = j * kKeys;
    const bf16* tK = sK + j % kStages * kKeys * LQ;
    const bf16* tV = sV + j % kStages * kKeys * LV;

    // S = Q K^T and dP = dO V^T: per k-step one ldmatrix x4 of K (of V)
    // gives n-tiles 2n and 2n + 1
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSQ; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(sQ + q_frag + kk * 16));
#pragma unroll
      for (int n = 0; n < NS / 2; ++n) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(tK + (n * 16 + lr + (lm >> 1) * 8) * LQ +
                                  kk * 16 + (lm & 1) * 8));
        mma(s[2 * n], qa, kf[0], kf[1]);
        mma(s[2 * n + 1], qa, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KSV; ++kk) {
      uint32_t oa[4];
      ldmatrix_x4(oa, smem_addr(sO + o_frag + kk * 16));
#pragma unroll
      for (int n = 0; n < NS / 2; ++n) {
        uint32_t vf[4];
        ldmatrix_x4(vf, smem_addr(tV + (n * 16 + lr + (lm >> 1) * 8) * LV +
                                  kk * 16 + (lm & 1) * 8));
        mma(dp[2 * n], oa, vf[0], vf[1]);
        mma(dp[2 * n + 1], oa, vf[2], vf[3]);
      }
    }

    // dS = P (dP - delta), P = exp2(S scale log2 e - lse log2 e) masked to
    // 0: s[n][e] is row g + 8 (e >> 1), key k0 + 8 n + 2 t + (e & 1). Only
    // a tile that crosses Sk, Sq or the diagonal of the block's first row
    // needs the mask
    const bool masked = k0 + kKeys > Sk || q0 + kQRows > Sq ||
                        (causal && k0 + kKeys - 1 > q_offset + q0);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fast_exp2(fmaf(s[n][e], scale2, -lse2[e >> 1]));
        if (masked) {
          const int k_pos = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = q0 + wr + g + (e >> 1) * 8;
          const bool allow = k_pos < Sk && qi < Sq &&
                             (!causal || k_pos <= row_pos + (e >> 1) * 8);
          x = allow ? x : 0.f;
        }
        s[n][e] = x * (dp[n][e] - dlt[e >> 1]);
      }
    }

    // dQ += dS K: score n-tiles 2kk and 2kk + 1 (C layout) are the A
    // fragment of k-step kk; one ldmatrix.trans x4 of K gives n-tiles 2n
    // and 2n + 1
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND / 2; ++n) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, smem_addr(tK + (kk * 16 + lr + (lm & 1) * 8) *
                                                 LQ + n * 16 +
                                        (lm >> 1) * 8));
        mma(acc[2 * n], da, kf[0], kf[1]);
        mma(acc[2 * n + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();              // every warp is done with tile j's stage
  }

  // out through the warp's own rows of the Q tile
  cp_async_wait<0>();
  __syncwarp();
  store_rows<DQK, LQ>(acc, scale, sQ + wr * LQ,
                      dq + q_off + (size_t)wr * q_row, q_row, q0 + wr, Sq,
                      lane);
}

// dQ, which writes delta: float32 (B, H, Sq) scratch; then dK/dV.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int Hkv, int q_offset, int causal,
                   float scale, cudaStream_t st) {
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  constexpr size_t kv_bytes = dkdv_smem_bytes<DQK, DV>();
  constexpr size_t q_bytes = dq_smem_bytes<DQK, DV>();
  cudaError_t e = set_smem_once(dkdv_set, dkdv_kernel<DQK, DV>, kv_bytes);
  if (e == cudaSuccess)
    e = set_smem_once(dq_set, dq_kernel<DQK, DV>, q_bytes);
  if (e != cudaSuccess) return e;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  dq_kernel<DQK, DV><<<dim3(B * H, (Sq + kQRows - 1) / kQRows), 128,
                       q_bytes, st>>>(
      tq, tk, tv, static_cast<const bf16*>(o), tdo, lse, delta,
      static_cast<bf16*>(dq), Sq, Sk, H, Hkv, q_offset, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int kBlockKeys = 16 * kKeyWarps;
  dkdv_kernel<DQK, DV><<<dim3(B * Hkv, (Sk + kBlockKeys - 1) / kBlockKeys),
                         32 * kKeyWarps * kQueryGroups, kv_bytes, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, Hkv, q_offset, causal, scale);
  return cudaGetLastError();
}

}  // namespace tensor_cores

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int Hkv, int q_offset, int causal,
                   float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the bf16 body's copies, loads and stores move 16 bytes at a time
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
         reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
         reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) %
        16)
      return cudaErrorMisalignedAddress;
    return tensor_cores::launch<DQK, DV>(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, B, Sq, Sk, H, Hkv,
                                         q_offset, causal, scale, st);
  } else {
    static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
    constexpr size_t kv_bytes = dkdv_smem_bytes<DQK, DV>();
    constexpr size_t q_bytes = dq_smem_bytes<DQK, DV>();
    cudaError_t e =
        set_smem_once(dkdv_set, dkdv_kernel<T, DQK, DV>, kv_bytes);
    if (e == cudaSuccess)
      e = set_smem_once(dq_set, dq_kernel<T, DQK, DV>, q_bytes);
    if (e != cudaSuccess) return e;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    const int rows = B * Sq * H;
    delta_kernel<T, DV><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                          kThreads, 0, st>>>(static_cast<const T*>(o), tdo,
                                             delta, Sq, H, rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dkdv_kernel<T, DQK, DV><<<dim3((Sk + BK - 1) / BK, B * Hkv), kThreads,
                              kv_bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Sk, H, Hkv, q_offset, causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dq_kernel<T, DQK, DV><<<dim3((Sq + BQ - 1) / BQ, B * H), kThreads,
                            q_bytes, st>>>(tq, tk, tv, tdo, lse, delta,
                                           static_cast<T*>(dq), Sq, Sk, H,
                                           Hkv, q_offset, causal, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t by_dims(int DQK, int DV, const void* q, const void* k,
                    const void* v, const void* o, const void* dout,
                    const float* lse, float* delta, void* dq, void* dk,
                    void* dv, int B, int Sq, int Sk, int H, int Hkv,
                    int q_offset, int causal, float scale, cudaStream_t st) {
#define REPRO_FLASH_BWD_CASE(QK, V)                                         \
  if (DQK == QK && DV == V)                                                \
    return launch<T, QK, V>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,   \
                            Sq, Sk, H, Hkv, q_offset, causal, scale, st);
  REPRO_FLASH_BWD_CASE(16, 16)
  REPRO_FLASH_BWD_CASE(32, 32)
  REPRO_FLASH_BWD_CASE(64, 64)
  REPRO_FLASH_BWD_CASE(128, 128)
  REPRO_FLASH_BWD_CASE(192, 128)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dq (B, Sq, H, DQK); k, dk (B, Sk, Hkv, DQK); v, dv (B, Sk, Hkv, DV);
// o, dout (B, Sq, H, DV); lse (the forward's) and delta (scratch) float32
// (B, H, Sq); contiguous, one dtype for every tensor but lse and delta.
// (DQK, DV) in {(16, 16), (32, 32), (64, 64), (128, 128), (192, 128)}.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int Hkv, int DQK, int DV,
    int q_offset, int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(DQK, DV, q, k, v, o, dout, lse, delta, dq,
                                  dk, dv, B, Sq, Sk, H, Hkv, q_offset,
                                  causal, scale, st);
  if (dtype == kFloat32)
    return by_dims<float>(DQK, DV, q, k, v, o, dout, lse, delta, dq, dk, dv,
                          B, Sq, Sk, H, Hkv, q_offset, causal, scale, st);
  return cudaErrorInvalidValue;
}
