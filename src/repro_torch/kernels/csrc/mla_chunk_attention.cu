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
// for a query iff kp >= 0 && kp <= qp. Masked scores take the finite
// -1e30, keys past Sk take probability 0 and the finalize divides by
// max(l, 1e-30): a query with no live key (qp = -1 pad) averages the latent
// over every key, as the reference does.
//
// What bounds it on the H100: operations. At deepseek-v2's serving chunk
// (C 256 against Sk 1344, 768 + 256 rows live, H 128, L 512, R 64) the live
// (query, key) pairs cost 2*(L+R+L) flops a head, ~64 GFLOP (~63 us on the
// tensor cores), against ~71 MB of q_lat, q_rope and out and ~1.2 MB of
// live latent rows (~22 us at the memory rate).
// This is MQA with G = H = 128 heads on one KV head, d_qk 576, d_v 512.
//
// Two bodies, chosen by the element type (and the widths):
//
// bfloat16 at (L, R) = (512, 64) (the serving path): flash attention on
// mma.sync, one latent tile for 64 heads.
//  * grid (ceil(H/64), C, B), the query index reversed (the queries with
//    the most live keys start first): a block's 64 rows are 64 heads of
//    one query, so every row shares one qp and the tile skip below is
//    exact per block. Its q_lat | q_rope rows sit side by side in one
//    shared tile of L+R columns (74,752 B, padded), the key rows the same
//    way (latent then rope) in a 2-stage cp.async.cg ring of 32-key tiles
//    (74,752 B), so one pass over L+R columns gives both score terms, and
//    the value is the key tile's first L columns, read by ldmatrix.trans:
//    no third tile. Shared memory 155,648 B: one block an SM;
//  * registers are the limit: O is 16 x 512 f32 a warp, 256 registers a
//    thread. So 8 warps form two halves of 4: warp (m-tile i, half h) owns
//    rows 16i.. and output columns 256h.. (16 x 256 f32, 128 registers),
//    and for S = Q K^T the keys 16h.. of each tile (one product per score,
//    no half recomputes the other's). The halves' row maxima meet in
//    shared memory, each warp writes its P rounded to bf16 into a shared
//    64 x 32 tile (5 KB), and both halves take the whole P tile as the A
//    operand of P V. 128 rows a block (two m-tiles a warp) would halve the
//    latent rows a query reads through L2, but its O alone would fill the
//    SM's 256 KB of registers;
//  * dead tiles are skipped: a 32-key tile with no kp in [0, qp] (one int
//    a lane, read two tiles ahead, and a warp vote) costs no copy and no
//    product. That is bit-neutral for a query that sees a key; a block that
//    skipped a tile and saw no key at all walks every tile again, and a
//    pad query's block (qp < 0) never skips. The same body compiled as
//    mla_chunk_walk_kernel (kernels/chunk_attention.py::mla_chunk_walk)
//    has thread 0 count the tiles skipped and walked again and write them
//    out; the serving kernel carries no counter;
//  * three barriers a tile: the tile has landed (the next tile's copy is
//    issued after it, into the stage every warp is then done with), the
//    row maxima, the P tile. The online softmax runs in base 2
//    (ex2.approx) on the f32 fragments; O leaves through the Q tile as
//    16-byte stores. No atomics: results repeat bit for bit.
//  What holds it back: Q K^T reloads its Q and K fragments from shared
//  memory at every k-step (2 ldmatrix for 2 mma), so shared-memory reads,
//  not the tensor cores, set a tile's time; one block an SM leaves 8 warps
//  to hide the latency; each block reads the live latent rows of its query
//  once through L2 (2 blocks a query at H 128). wgmma, which reads B from
//  shared memory itself, is the next step (ROADMAP Queue 2 B8).
//
// float32 (the dtype of the card-vs-CPU parity checks), and bfloat16 at the
// test stacks' (16, 8) (L + R = 24 is no multiple of 16): the scalar body
// on the CUDA cores.
//  * grid (ceil(C/32), B*H): a block owns 32 query rows of one head; their
//    q_lat and q_rope rows sit side by side in one shared tile of L+R
//    float32 columns, the key rows the same way, so one pass gives both
//    score terms and the value is the key tile's first L columns. At L+R =
//    576 the two tiles take ~144 KB, so the tiles are 32 rows;
//  * the block walks all of Sk in 32-key tiles;
//  * 256 threads as a 16x16 grid, a thread owning 2 rows x 2 keys of the
//    score tile and 2 rows x L/16 output dims.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// The bfloat16 body: mma.sync m16n8k16 on the tensor cores.
// ---------------------------------------------------------------------------
namespace tensor_cores {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps: 4 m-tiles x 2 halves
constexpr int kRows = 64;              // heads of one query a block
constexpr int kTileKeys = 32;          // keys a tile: 16 a half
constexpr int kStages = 2;             // depth of the latent | rope ring
constexpr int kPad = 8;                // bf16 per row of padding (16 bytes)
constexpr int kLP = kTileKeys + kPad;  // row of the P tile

template <int L, int R>
constexpr size_t smem_bytes() {
  // the Q tile, the stages of latent | rope, the P tile, then both halves'
  // row maxima and row sums
  return sizeof(bf16) * ((size_t)(kRows + kStages * kTileKeys) *
                             (L + R + kPad) +
                         (size_t)kRows * kLP) +
         sizeof(float) * 4 * kRows;
}

// kCount: also count the walk into `walk` (the serving kernel leaves it
// out and keeps its registers).
template <int L, int R, bool kCount>
__device__ __forceinline__ void mla_body(const bf16* __restrict__ q_lat,
                                         const bf16* __restrict__ q_rope,
                                         const bf16* __restrict__ latent,
                                         const bf16* __restrict__ rope,
                                         const int* __restrict__ qpos,
                                         const int* __restrict__ kpos,
                                         bf16* __restrict__ out,
                                         int* __restrict__ walk, int C,
                                         int Sk, int H, float scale) {
  constexpr int D = L + R;              // score columns
  constexpr int LD = D + kPad;          // padded row of the Q and key tiles
  constexpr int KS = D / 16;            // k-steps of Q K^T
  constexpr int LH = L / 2;             // output columns of a half
  constexpr int NO = LH / 8;            // output n-tiles of a warp
  constexpr int kChunks = D / 8;        // 16-byte chunks a row
  constexpr int kLatChunks = L / 8;
  static_assert(L % 32 == 0 && R % 16 == 0,
                "latent: a multiple of 32, rope: of 16");
  static_assert(kTileKeys * kChunks % kThreads == 0,
                "whole copies a thread");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + kRows * LD;                   // the stages of latent|rope
  bf16* sP = sK + kStages * kTileKeys * LD;
  float* sMax = reinterpret_cast<float*>(sP + kRows * kLP);  // [half][row]
  float* sSum = sMax + 2 * kRows;                            // [half][row]

  const int h0 = blockIdx.x * kRows;
  const int qi = gridDim.y - 1 - blockIdx.y;    // the latest query first
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // fragment row group, column pair
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix row, matrix
  const int row0 = (warp % 4) * 16;         // the warp's m-tile
  const int half = warp / 4;                // its keys of a tile, columns of O
  const size_t q_head0 = ((size_t)b * C + qi) * H;
  const bf16* latb = latent + (size_t)b * Sk * L;
  const bf16* ropeb = rope + (size_t)b * Sk * R;
  const int* kpb = kpos + (size_t)b * Sk;
  const int qp = qpos[(size_t)b * C + qi];

  // copy group 0: the q_lat | q_rope rows of the block's heads (heads past
  // H zero-filled)
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = h0 + r < H;
    const size_t row = in ? q_head0 + h0 + r : 0;
    const bf16* src = c < kLatChunks ? q_lat + row * L + c * 8
                                     : q_rope + row * R + (c - kLatChunks) * 8;
    cp_async_16(smem_addr(sQ + r * LD + c * 8), src, in);
  }
  cp_async_commit();

  const int n_tiles = (Sk + kTileKeys - 1) / kTileKeys;
  // the position of tile j's key `lane` (-1 past Sk)
  auto tile_pos = [&](int j) {
    const int key = j * kTileKeys + lane;
    return j < n_tiles && key < Sk ? kpb[key] : -1;
  };
  // does the query see a key of the tile? (every warp alike)
  auto tile_live = [&](int p) {
    return __any_sync(0xffffffffu, p >= 0 && p <= qp) != 0;
  };
  auto load_keys = [&](int j) {   // key tile j into stage j % kStages
    const int first = j * kTileKeys;
    bf16* d = sK + (j % kStages) * kTileKeys * LD;
#pragma unroll
    for (int it = 0; it < kTileKeys * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const bool in = first + r < Sk;
      const size_t key = in ? first + r : 0;
      const bf16* src = c < kLatChunks
                            ? latb + key * L + c * 8
                            : ropeb + key * R + (c - kLatChunks) * 8;
      cp_async_16(smem_addr(d + r * LD + c * 8), src, in);
    }
  };

  const float scale2 = scale * kLog2e;
  const float past = __int_as_float(0xff800000);   // -inf: keys past Sk
  float o[NO][4];
  // rows g and g + 8 of the warp's m-tile: running max (logit x log2 e,
  // alike in both halves) and this thread's share of the running sum
  float m[2], l[2];
  // the walk's counts (thread 0's alone): tiles skipped, walked again
  __shared__ int walked[2];
  if (kCount && tid == 0) walked[0] = walked[1] = 0;

  // pass 0 skips dead tiles (a pad query's block never does); pass 1, if
  // the query saw no key, walks every tile
  for (int pass = 0;; ++pass) {
    const bool skip = pass == 0 && qp >= 0;
    if (kCount && pass > 0 && tid == 0) walked[1] = n_tiles;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    // positions of tiles j (cur), j + 1 (nxt) and j + 2 (far): a tile's
    // vote reads a position loaded a whole tile earlier. Tile 0 is copied
    // before its vote (a dead one costs a copy, not a wait).
    cp_async_wait<0>();          // no copy of the last pass is in flight
    int cur = tile_pos(0), nxt = tile_pos(1);
    load_keys(0);
    cp_async_commit();
    bool live_cur = !skip || tile_live(cur);
    bool skipped = !live_cur;

    for (int j = 0; j < n_tiles; ++j) {
      const int far = tile_pos(j + 2);
      const bool has_nxt = j + 1 < n_tiles;
      const bool live_nxt = has_nxt && (!skip || tile_live(nxt));
      skipped |= has_nxt && !live_nxt;
      // key tile j (and Q) has landed, and every warp is done with tile
      // j - 1 (its stage, which tile j + 1 then takes, its row maxima and
      // its P tile)
      if (live_cur || live_nxt) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (live_nxt) load_keys(j + 1);
      cp_async_commit();
      if (kCount && !live_cur && tid == 0) ++walked[0];
      if (live_cur) {
        const int k0 = j * kTileKeys;
        const bf16* tK = sK + (j % kStages) * kTileKeys * LD;

        // S = Q K^T over the half's 16 keys (n-tiles 0, 1)
        float s[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qa[4], kf[4];
          ldmatrix_x4(qa, smem_addr(sQ + (row0 + lr + (lm & 1) * 8) * LD +
                                    kk * 16 + (lm >> 1) * 8));
          ldmatrix_x4(kf, smem_addr(tK + (half * 16 + lr + (lm >> 1) * 8) *
                                             LD +
                                    kk * 16 + (lm & 1) * 8));
          mma(s[0], qa, kf[0], kf[1]);
          mma(s[1], qa, kf[2], kf[3]);
        }

        // logits x log2 e, masked: x[n][0..1] row g, x[n][2..3] row g + 8,
        // at tile keys 16 half + 8n + 2t (+1), whose positions those lanes
        // hold
        float x[2][4], rmax[2] = {past, past};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int kk = half * 16 + n * 8 + 2 * t + e1;
            const int kp = __shfl_sync(0xffffffffu, cur, kk);
            const bool allow = kp >= 0 && kp <= qp;
            const bool in = k0 + kk < Sk;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + e1;
              const float v =
                  allow ? s[n][e] * scale2 : (in ? kNegInf : past);
              x[n][e] = v;
              rmax[r] = fmaxf(rmax[r], v);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
        }
        if (t == 0) {
          sMax[half * kRows + row0 + g] = rmax[0];
          sMax[half * kRows + row0 + g + 8] = rmax[1];
        }
        __syncthreads();
        // the tile's row max over both halves, taken alike by both
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + g + 8 * r;
          const float m_new =
              fmaxf(m[r], fmaxf(sMax[row], sMax[kRows + row]));
          corr[r] = fast_exp2(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
        // P = 2^(x - m) (0 past Sk), rounded to bf16 into the P tile
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[n][e] = fast_exp2(x[n][e] - m[e >> 1]);
            l[e >> 1] += x[n][e];
          }
          bf16* pr = sP + half * 16 + n * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(pr + (row0 + g) * kLP) =
              pack_bf16(x[n][0], x[n][1]);
          *reinterpret_cast<uint32_t*>(pr + (row0 + g + 8) * kLP) =
              pack_bf16(x[n][2], x[n][3]);
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
        __syncthreads();

        // O += P V over the half's columns: per k-step one ldmatrix x4 of P
        // (A) and one ldmatrix.trans x4 of the latent a pair of n-tiles
#pragma unroll
        for (int kk = 0; kk < kTileKeys / 16; ++kk) {
          uint32_t pa[4];
          ldmatrix_x4(pa, smem_addr(sP + (row0 + lr + (lm & 1) * 8) * kLP +
                                    kk * 16 + (lm >> 1) * 8));
#pragma unroll
          for (int n = 0; n < NO / 2; ++n) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, smem_addr(tK + (kk * 16 + lr +
                                                  (lm & 1) * 8) * LD +
                                            half * LH + n * 16 +
                                            (lm >> 1) * 8));
            mma(o[2 * n], pa, vf[0], vf[1]);
            mma(o[2 * n + 1], pa, vf[2], vf[3]);
          }
        }
      }
      cur = nxt;
      nxt = far;
      live_cur = live_nxt;
    }
    // the query saw no key after tiles were skipped: walk every tile
    if (!skipped || !__syncthreads_or(m[0] == kNegInf)) break;
  }
  cp_async_wait<0>();            // a dead tile's copy may be in flight
  if (kCount && tid == 0) {
    int* w = walk + 3 * (blockIdx.x + gridDim.x *
                                          (blockIdx.y + gridDim.y * b));
    w[0] = n_tiles;
    w[1] = walked[0];
    w[2] = walked[1];
  }

  // the row sums: over the quad, then over the halves in half order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t == 0) {
    sSum[half * kRows + row0 + g] = l[0];
    sSum[half * kRows + row0 + g + 8] = l[1];
  }
  __syncthreads();               // and every warp is done with the Q tile
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    inv[r] = 1.f / fmaxf(sSum[row] + sSum[kRows + row], 1e-30f);
  }
  // O / l through the warp's rows and columns of the Q tile, then out as
  // 16-byte stores
  bf16* sO = sQ + row0 * LD + half * LH;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(sO + g * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kOutChunks = LH / 8;
#pragma unroll 4
  for (int it = 0; it < 16 * kOutChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kOutChunks, c = i % kOutChunks;
    const int h = h0 + row0 + r;
    if (h < H)
      *reinterpret_cast<uint4*>(out + (q_head0 + h) * L + half * LH +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <int L, int R>
__global__ void __launch_bounds__(kThreads, 1)
mla_chunk_attention_kernel(const bf16* __restrict__ q_lat,
                           const bf16* __restrict__ q_rope,
                           const bf16* __restrict__ latent,
                           const bf16* __restrict__ rope,
                           const int* __restrict__ qpos,
                           const int* __restrict__ kpos,
                           bf16* __restrict__ out, int* __restrict__ walk,
                           int C, int Sk, int H, float scale) {
  mla_body<L, R, false>(q_lat, q_rope, latent, rope, qpos, kpos, out, walk,
                        C, Sk, H, scale);
}

// The same body counting its walk (kernels/chunk_attention.py::
// mla_chunk_walk, a measurement; never on the serving path).
template <int L, int R>
__global__ void __launch_bounds__(kThreads, 1)
mla_chunk_walk_kernel(const bf16* __restrict__ q_lat,
                      const bf16* __restrict__ q_rope,
                      const bf16* __restrict__ latent,
                      const bf16* __restrict__ rope,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, bf16* __restrict__ out,
                      int* __restrict__ walk, int C, int Sk, int H,
                      float scale) {
  mla_body<L, R, true>(q_lat, q_rope, latent, rope, qpos, kpos, out, walk,
                       C, Sk, H, scale);
}

template <int L, int R>
cudaError_t launch(const void* ql, const void* qr, const void* lat,
                   const void* rope, const void* qpos, const void* kpos,
                   void* out, int* walk, int B, int C, int Sk, int H,
                   float scale, cudaStream_t stream) {
  // cp.async and the output stores move 16 bytes at a time (every row
  // stride, L or R bf16, is a multiple of 16 bytes)
  if ((reinterpret_cast<uintptr_t>(ql) | reinterpret_cast<uintptr_t>(qr) |
       reinterpret_cast<uintptr_t>(lat) | reinterpret_cast<uintptr_t>(rope) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorMisalignedAddress;
  if (C > 65535 || B > 65535) return cudaErrorInvalidValue;
  constexpr size_t bytes = smem_bytes<L, R>();
  const bool count = walk != nullptr;
  void (*kernel)(const bf16*, const bf16*, const bf16*, const bf16*,
                 const int*, const int*, bf16*, int*, int, int, int, float) =
      count ? mla_chunk_walk_kernel<L, R> : mla_chunk_attention_kernel<L, R>;
  static std::atomic<uint64_t> attr_set[2];   // per kernel: zero at start
  cudaError_t e = set_smem_once(attr_set[count], kernel, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((H + kRows - 1) / kRows, C, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(ql), static_cast<const bf16*>(qr),
      static_cast<const bf16*>(lat), static_cast<const bf16*>(rope),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<bf16*>(out), walk, C, Sk, H, scale);
  return cudaGetLastError();
}

}  // namespace tensor_cores

template <typename T>
cudaError_t by_dims(int L, int R, const void* ql, const void* qr,
                    const void* lat, const void* rope, const void* qpos,
                    const void* kpos, void* out, int* walk, int B, int C,
                    int Sk, int H, float scale, cudaStream_t st) {
  if (L == 512 && R == 64) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return tensor_cores::launch<512, 64>(ql, qr, lat, rope, qpos, kpos,
                                           out, walk, B, C, Sk, H, scale,
                                           st);
    else if (walk)
      return cudaErrorInvalidValue;   // the scalar body keeps no walk
    else
      return launch<T, 512, 64>(ql, qr, lat, rope, qpos, kpos, out, B, C,
                                Sk, H, scale, st);
  }
  // both dtypes on the scalar body: L + R = 24 is no multiple of 16
  if (L == 16 && R == 8 && !walk)
    return launch<T, 16, 8>(ql, qr, lat, rope, qpos, kpos, out, B, C, Sk, H,
                            scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_lat (B, C, H, L); q_rope (B, C, H, R); latent (B, Sk, L); rope
// (B, Sk, R); qpos (B, C) int32; kpos (B, Sk) int32; out (B, C, H, L);
// contiguous (the bfloat16 body also 16-byte aligned). walk (the bfloat16
// body at (512, 64) only, else null): int32 (ceil(H/64) * C * B, 3) that
// the kernel fills with each block's key tiles, tiles skipped and tiles
// walked again. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_mla_chunk_attention(const void* q_lat,
                                         const void* q_rope,
                                         const void* latent, const void* rope,
                                         const void* qpos, const void* kpos,
                                         void* out, void* walk, int B, int C,
                                         int Sk, int H, int L, int R,
                                         float scale, int dtype,
                                         void* stream) {
  if (B <= 0 || C <= 0 || Sk <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(L, R, q_lat, q_rope, latent, rope, qpos,
                                  kpos, out, static_cast<int*>(walk), B, C,
                                  Sk, H, scale, st);
  if (dtype == kFloat32)
    return by_dims<float>(L, R, q_lat, q_rope, latent, rope, qpos, kpos, out,
                          static_cast<int*>(walk), B, C, Sk, H, scale, st);
  return cudaErrorInvalidValue;
}
