// Chunked-prefill attention at absolute positions, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chunk_attention.py::chunk_attention
// (Pallas, grid (B, Hkv, q_blocks, k_blocks) with the k axis sequential and
// m/l/acc in VMEM scratch across k steps).
//
// C query rows at absolute positions qp attend to Sk cache-plus-chunk key
// rows at absolute positions kp (-1 = empty ring row). A key is live for a
// query iff kp >= 0 && kp <= qp (&& kp > qp - window when a window is set).
// Masked scores take the finite -1e30, keys past Sk take probability 0 and
// the finalize divides by max(l, 1e-30): a query row with no live key at
// all (qp = -1 pad) averages V over every key, as the reference does.
//
// What bounds it on the H100: at qwen3's serving chunk (q (1,256,16,128)
// against Sk = 1088 ring + 256 chunk rows, 768 + 256 of them live, Hkv 8)
// the live (query, key) pairs cost ~1.9 GFLOP (~1.9 us on the tensor
// cores) against ~6 MB of q/k/v/o (~1.9 us): balanced, a few us either way.
// The middle's chunk (1,128,16,128) against 896 rows is half that.
//
// Two bodies, chosen by the element type:
//
// bfloat16 (every serving path): flash attention on mma.sync, one K/V tile
// for all the heads that share it, dead key tiles skipped.
//  * a block's 64 rows are (query, head) pairs of one KV head: flat rows
//    f = query * G + head-in-group, so at qwen3's G 2 a block holds 32
//    queries x 2 heads and each K/V tile is read once for both heads (the
//    scalar body read it once a head). The G heads of a query are adjacent
//    in q, so the Q tile is runs of G*dh; each row's mask uses its query's
//    position. 4 warps, 16 rows each. The q-tile index is reversed, so the
//    tiles with the most live keys start first;
//  * the key axis is split into n_split ranges of split_keys (a multiple
//    of 64; kernels/chunk_attention.py::chunk_split picks them from the
//    shapes only, about two blocks an SM): grid (ceil(C*G/64), B*Hkv,
//    n_split). With one range the block writes out itself; with more, each
//    block writes a float32 partial (m, l, acc) a row and
//    chunk_combine_kernel merges them in split order, one warp an output
//    row (a lane dh/32 dims, float4 loads of the partials);
//  * ring rows are not sorted by position, so no range of tiles can be
//    cut by index; instead a block skips a 64-key tile that no row of it
//    can see: every kp < 0, > its greatest qp, or <= its least qp - window.
//    A tile's positions are one load of 64 ints (two a lane, read two
//    tiles ahead) and a warp vote, so a skipped tile costs no K/V copy and
//    no product. For a row that sees a live key, skipping is bit-neutral
//    (before its first live tile the correction exp2(-1e30 - m) is 0,
//    after it a dead tile adds exact zeros). A row that sees no key would
//    average only the tiles walked, so a block that skipped a tile and
//    holds such a row walks its range again without skipping, unless (one
//    of several ranges, no window) the row sees a key elsewhere in Sk and
//    its partial weighs 0 in the merge. The same body compiled as
//    chunk_walk_kernel (Args::walk, kernels/chunk_attention.py::chunk_walk)
//    has thread 0 count the tiles skipped and walked again and write them
//    out, so a measurement reads what the kernel did; the serving kernel
//    carries no counter (at its 255 registers, counters in it spilled);
//  * Q comes in once by cp.async and stays in shared memory: its A
//    fragments are read by ldmatrix at each k-step (kept in registers
//    beside the split's state, they spilled). K/V tiles of 64 keys stay
//    bf16 in a 2-stage ring fed by cp.async.cg 16-byte copies (rows past
//    Sk zero-filled), rows padded by 16 bytes so ldmatrix is
//    conflict-free: 87,040 B of shared memory at dh 128, two blocks an SM.
//    One barrier a tile: tile j has landed, and the copy of tile j + 1 is
//    issued after it, into the stage every warp is then done with;
//  * S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulate, K by
//    ldmatrix), then scale, softcap (before the mask), the position mask
//    and the online softmax (base 2, ex2.approx) on the f32 fragments; P is
//    rounded to bf16 in registers and is the A operand of P V (V by
//    ldmatrix.trans). No atomics: results repeat bit for bit.
//  What holds it back: each warp's tile is a chain (fragments, Q K^T,
//  softmax, P V) with no second warpgroup to overlap it, the partials'
//  round trip and a second launch when the keys are split, the position
//  mask on every tile (ring rows carry no order to exploit), and a block
//  holding pad rows (qp = -1, never on the serving path) walks its range
//  twice.
//  wgmma with TMA is the next step (ROADMAP Queue 2 B8).
//
// float32 (the dtype of the card-vs-CPU parity checks): the scalar body on
// the CUDA cores, so the parity keeps float32 products (TF32 would lose
// the 1e-3 bound).
//  * grid (ceil(C/64), B*H): a block owns 64 query rows of one head, its q
//    tile and their positions in shared memory, and walks all of Sk in
//    64-key tiles;
//  * 256 threads as a 16x16 grid, a thread owning 4 rows x 4 keys of the
//    score tile and 4 rows x dh/16 output dims.
//
// In both, K/V are read at Hkv heads (q head h reads KV head h / G), dh is
// a template parameter in {16, 32, 64, 80, 128} (80: h2o-danube-1.8b; its
// rows of 160 bytes keep every 16-byte copy aligned, 5 k-steps and 10
// output n-tiles on the tensor cores, 5 dims a thread in the scalar body),
// and an optional logit softcap is applied before the mask, as in the
// reference.
#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// The bfloat16 body: mma.sync m16n8k16 on the tensor cores.
// ---------------------------------------------------------------------------
namespace tensor_cores {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // 4 warps
constexpr int kRows = 64;           // (query, head) rows a block: 16 a warp
constexpr int kTileKeys = 64;       // keys a tile (and the split's unit)
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kPad = 8;             // bf16 per row of padding (16 bytes)
constexpr int kIntMax = 0x7fffffff;

template <int DH>
constexpr size_t smem_bytes() {
  // the Q tile, then the stages of K, then the stages of V
  return sizeof(bf16) * (size_t)(kRows + 2 * kStages * kTileKeys) *
         (DH + kPad);
}

struct Args {
  const bf16* q;        // (B, C, H, DH)
  const bf16* k;        // (B, Sk, Hkv, DH)
  const bf16* v;
  const int* qpos;      // (B, C)
  const int* kpos;      // (B, Sk)
  bf16* out;            // (B, C, H, DH)
  // n_split > 1: the float32 partials, acc (B*C*H, n_split, DH), then
  // (m, l) (B*C*H, n_split, 2): output row r's split i at r * n_split + i
  float* scratch;
  // set: chunk_walk_kernel runs and writes the walk each block made,
  // (blocks, 3) of key tiles in its range, tiles skipped, tiles walked
  // again (block x + gridDim.x * (y + gridDim.y * split)); null on the
  // serving path (chunk_attention_kernel, which counts nothing)
  int* walk;
  int B, C, Sk, H, Hkv, window, n_split, split_keys;
  float scale, softcap;
};

// grid (ceil(C*G / kRows), B*Hkv, n_split): block (x, b*Hkv + hk, split)
// owns flat rows f = query * G + head-in-group of KV head hk, and the keys
// of its split. kCount: also count the walk into a.walk (the serving
// kernel leaves it out: the counters cost it registers it has not got).
template <int DH, bool kCount>
__device__ __forceinline__ void chunk_body(const Args& a) {
  constexpr int LD = DH + kPad;
  constexpr int KS = DH / 16;           // k-steps of Q K^T
  constexpr int NS = kTileKeys / 8;     // score n-tiles (8 keys each)
  constexpr int NO = DH / 8;            // output n-tiles (8 dims each)
  constexpr int kChunks = DH / 8;       // 16-byte chunks a row
  static_assert(DH % 16 == 0, "head dim: a multiple of 16");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + kRows * LD;                   // the stages of K
  bf16* sV = sK + kStages * kTileKeys * LD;     // the stages of V

  const int G = a.H / a.Hkv;
  const int n_flat = a.C * G;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // latest first
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // fragment row group, column pair
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix row, matrix
  const size_t kv_row = (size_t)a.Hkv * DH;
  const bf16* kb = a.k + ((size_t)b * a.Sk * a.Hkv + hk) * DH;
  const bf16* vb = a.v + ((size_t)b * a.Sk * a.Hkv + hk) * DH;
  const int* qpb = a.qpos + (size_t)b * a.C;
  const int* kpb = a.kpos + (size_t)b * a.Sk;
  // the (b, query, head) row of q and out that flat row f is
  auto row_of = [&](int f) {
    return ((size_t)b * a.C + f / G) * a.H + (size_t)hk * G + f % G;
  };

  // copy group 0: the Q tile (rows past C*G zero-filled)
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = f0 + r < n_flat;
    cp_async_16(smem_addr(sQ + r * LD + c * 8),
                a.q + (in ? row_of(f0 + r) * DH : 0) + c * 8, in);
  }
  cp_async_commit();

  // rows warp*16 + g and + 8 of this thread: real or past C*G, and their
  // query's position
  bool valid[2];
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = f0 + warp * 16 + g + 8 * r;
    valid[r] = f < n_flat;
    qp[r] = valid[r] ? qpb[f / G] : -1;
  }
  // the block's least and greatest query position (every warp alike)
  int qmin = kIntMax, qmax = -kIntMax;
  for (int i = f0 / G + lane; i <= (min(f0 + kRows, n_flat) - 1) / G;
       i += 32) {
    qmin = min(qmin, qpb[i]);
    qmax = max(qmax, qpb[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }

  const int k_begin = split * a.split_keys;
  const int k_end = min(a.Sk, k_begin + a.split_keys);
  const int n_tiles = (k_end - k_begin + kTileKeys - 1) / kTileKeys;
  // the positions of tile j's keys 32h + lane (-1 past the range)
  auto tile_pos = [&](int j, int (&p)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k_begin + j * kTileKeys + 32 * h + lane;
      p[h] = j < n_tiles && key < k_end ? kpb[key] : -1;
    }
  };
  // may any row of the block see a key of the tile? (a warp vote; every
  // warp reaches the same answer)
  auto tile_live = [&](const int (&p)[2]) {
    bool any = false;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      any |= p[h] >= 0 && p[h] <= qmax &&
             (a.window <= 0 || p[h] > qmin - a.window);
    return __any_sync(0xffffffffu, any) != 0;
  };
  auto load_kv = [&](int j) {   // key tile j into stage j % kStages
    const int first = k_begin + j * kTileKeys;
    bf16* dK = sK + (j % kStages) * kTileKeys * LD;
    bf16* dV = sV + (j % kStages) * kTileKeys * LD;
#pragma unroll
    for (int it = 0; it < kTileKeys * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const bool in = first + r < k_end;
      const size_t off = in ? (size_t)(first + r) * kv_row : 0;
      cp_async_16(smem_addr(dK + r * LD + c * 8), kb + off + c * 8, in);
      cp_async_16(smem_addr(dV + r * LD + c * 8), vb + off + c * 8, in);
    }
  };

  const float scale2 = a.scale * kLog2e;
  const float past = __int_as_float(0xff800000);   // -inf: keys past Sk
  float o[NO][4];
  // rows g and g + 8: running max (logit x log2 e) and this thread's share
  // of the running sum
  float m[2], l[2];
  // the walk's counts (thread 0's alone): tiles skipped, walked again
  __shared__ int walked[2];
  if (kCount && tid == 0) walked[0] = walked[1] = 0;

  // pass 0 skips dead tiles; pass 1, if needed, walks every tile
  for (int pass = 0;; ++pass) {
    const bool skip = pass == 0;
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
    // vote reads positions loaded a whole tile earlier. Tile 0 is copied
    // before its vote (a dead one costs a copy, not a wait).
    int cur[2], nxt[2], far[2];
    cp_async_wait<0>();          // no copy of the last pass is in flight
    tile_pos(0, cur);
    tile_pos(1, nxt);
    load_kv(0);
    cp_async_commit();
    bool live_cur = !skip || tile_live(cur);
    bool skipped = !live_cur;

    for (int j = 0; j < n_tiles; ++j) {
      tile_pos(j + 2, far);
      const bool has_nxt = j + 1 < n_tiles;
      const bool live_nxt = has_nxt && (!skip || tile_live(nxt));
      skipped |= has_nxt && !live_nxt;
      // one barrier a tile: key tile j (and Q) has landed, and every warp
      // is done with tile j - 1, whose stage tile j + 1 then takes
      if (live_cur || live_nxt) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (live_nxt) load_kv(j + 1);
      cp_async_commit();
      if (kCount && !live_cur && tid == 0) ++walked[0];
      if (live_cur) {
        const int k0 = k_begin + j * kTileKeys;
        const bf16* tK = sK + (j % kStages) * kTileKeys * LD;
        const bf16* tV = sV + (j % kStages) * kTileKeys * LD;

        // S = Q K^T: per k-step one ldmatrix x4 of the warp's Q rows (A)
        // and one of K a pair of n-tiles (2n, 2n+1)
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qa[4];
          ldmatrix_x4(qa, smem_addr(sQ + (warp * 16 + lr + (lm & 1) * 8) *
                                             LD +
                                    kk * 16 + (lm >> 1) * 8));
#pragma unroll
          for (int n = 0; n < NS / 2; ++n) {
            uint32_t kf[4];
            ldmatrix_x4(kf, smem_addr(tK + (n * 16 + lr + (lm >> 1) * 8) *
                                               LD +
                                      kk * 16 + (lm & 1) * 8));
            mma(s[2 * n], qa, kf[0], kf[1]);
            mma(s[2 * n + 1], qa, kf[2], kf[3]);
          }
        }

        // logits x log2 e, capped, then masked: s[n][0..1] are row g,
        // s[n][2..3] row g + 8, at tile keys 8n + 2t (+1), whose positions
        // lane (8n + 2t) % 32 holds
        float rmax[2] = {past, past};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int kk = n * 8 + 2 * t + e1;
            const int kp = __shfl_sync(0xffffffffu, cur[n / 4], kk % 32);
            const bool in = k0 + kk < k_end;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + e1;
              float x;
              if (a.softcap > 0.f)
                x = a.softcap * tanhf(s[n][e] * a.scale / a.softcap) *
                    kLog2e;
              else
                x = s[n][e] * scale2;
              const bool allow = kp >= 0 && kp <= qp[r] &&
                                 (a.window <= 0 || kp > qp[r] - a.window);
              x = allow ? x : (in ? kNegInf : past);
              s[n][e] = x;
              rmax[r] = fmaxf(rmax[r], x);
            }
          }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
          const float m_new = fmaxf(m[r], rmax[r]);
          corr[r] = fast_exp2(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // 0 past Sk; 1 for a masked key while the row has seen none
            s[n][e] = fast_exp2(s[n][e] - m[e >> 1]);
            l[e >> 1] += s[n][e];
          }
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }

        // O += P V: score n-tiles 2kk and 2kk+1 (C layout) are the A
        // fragment of k-step kk; one ldmatrix.trans x4 of V (n-tiles 2n,
        // 2n+1) feeds two mma
#pragma unroll
        for (int kk = 0; kk < kTileKeys / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int n = 0; n < NO / 2; ++n) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, smem_addr(tV + (kk * 16 + lr +
                                                  (lm & 1) * 8) * LD +
                                            n * 16 + (lm >> 1) * 8));
            mma(o[2 * n], pa, vf[0], vf[1]);
            mma(o[2 * n + 1], pa, vf[2], vf[3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cur[h] = nxt[h];
        nxt[h] = far[h];
      }
      live_cur = live_nxt;
    }
    if (!skipped) break;
    // A row of the block saw no key after tiles were skipped: walk the
    // range again, unless no such row lacks a key in all of Sk. Without a
    // window a row sees a key iff the least position >= 0 of Sk is <= its
    // own; with one range the range is Sk.
    bool dead = (valid[0] && m[0] == kNegInf) || (valid[1] && m[1] == kNegInf);
    if (!__syncthreads_or(dead)) break;
    if (a.n_split > 1 && a.window <= 0) {
      int kmin = kIntMax;
      for (int i = lane; i < a.Sk; i += 32) {
        const int p = kpb[i];
        if (p >= 0) kmin = min(kmin, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      dead = (valid[0] && m[0] == kNegInf && qp[0] < kmin) ||
             (valid[1] && m[1] == kNegInf && qp[1] < kmin);
      if (!__syncthreads_or(dead)) break;
    }
  }
  cp_async_wait<0>();            // a dead tile's copy may be in flight
  if (kCount && tid == 0) {
    int* w = a.walk + 3 * (blockIdx.x + gridDim.x *
                                            (blockIdx.y + gridDim.y * split));
    w[0] = n_tiles;
    w[1] = walked[0];
    w[2] = walked[1];
  }

  // the row sums over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (a.n_split > 1) {
    // the float32 partial of each real row: (m, l) and the unnormalised O
    const size_t rows = (size_t)a.B * a.C * a.H;
    float* ml = a.scratch + rows * a.n_split * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
      const size_t rec =
          row_of(f0 + warp * 16 + g + 8 * r) * a.n_split + split;
      if (t == 0) *reinterpret_cast<float2*>(ml + rec * 2) =
          make_float2(m[r], l[r]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(a.scratch + rec * DH + n * 8 + 2 * t) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    return;
  }
  // one range: O / l through the warp's own rows of the Q tile (no other
  // warp reads them) and out as 16-byte stores
  bf16* sO = sQ + warp * 16 * LD;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(sO + g * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    const int f = f0 + warp * 16 + r;
    if (f < n_flat)
      *reinterpret_cast<uint4*>(a.out + row_of(f) * DH + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
chunk_attention_kernel(Args a) {
  chunk_body<DH, false>(a);
}

// The same body counting its walk (kernels/chunk_attention.py::chunk_walk,
// a measurement; never on the serving path).
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
chunk_walk_kernel(Args a) {
  chunk_body<DH, true>(a);
}

constexpr int kMergeRows = 8;       // output rows a merge block: a warp each

// The merge of the splits' partials: one warp an output row (b, query,
// head), a lane ceil(DH/32) consecutive dims (at DH 16, lanes 0..15 one
// each; at DH 80, lanes 0..26 three each, the last two past the row's end
// left out).
// The splits' maxima (logit x log2 e) reduce to M; every lane then adds its
// dims' partials in split order, weighted by 2^(m_i - M), and divides by
// max(the weighted sum of l_i, 1e-30). A split that saw no key for the row
// (m = -1e30) weighs 0 beside one that did.
template <int DH>
__global__ void __launch_bounds__(32 * kMergeRows)
chunk_combine_kernel(const float* __restrict__ acc,
                     const float* __restrict__ ml, bf16* __restrict__ out,
                     int rows, int n_split) {
  constexpr int kPer = (DH + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kMergeRows + threadIdx.x / 32;
  if (row >= rows) return;
  const float2* mlr = reinterpret_cast<const float2*>(ml) +
                      (size_t)row * n_split;
  float mx = kNegInf;
  for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, mlr[s].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const int d0 = lane * kPer;
  const bool active = d0 < DH;
  const float* ar = acc + (size_t)row * n_split * DH + (active ? d0 : 0);
  float num[kPer], den = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) num[i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float2 x = mlr[s];
    const float w = fast_exp2(x.x - mx);
    float v[kPer];
    load_lane<float, kPer, DH>(ar + (size_t)s * DH, d0, v);
    den += x.y * w;
#pragma unroll
    for (int i = 0; i < kPer; ++i) num[i] += v[i] * w;
  }
  if (!active) return;
  const float inv = 1.f / fmaxf(den, 1e-30f);
  bf16* o = out + (size_t)row * DH + d0;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (!ragged_lanes<DH>() || d0 + i < DH)
      o[i] = __float2bfloat16(num[i] * inv);
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  const bool count = a.walk != nullptr;
  void (*kernel)(Args) =
      count ? chunk_walk_kernel<DH> : chunk_attention_kernel<DH>;
  static std::atomic<uint64_t> attr_set[2];   // per kernel: zero at start
  cudaError_t e = set_smem_once(attr_set[count], kernel, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a.C * (a.H / a.Hkv) + kRows - 1) / kRows, a.B * a.Hkv,
            a.n_split);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  const int rows = a.B * a.C * a.H;
  chunk_combine_kernel<DH>
      <<<(rows + kMergeRows - 1) / kMergeRows, 32 * kMergeRows, 0, stream>>>(
          a.scratch, a.scratch + (size_t)rows * a.n_split * DH, a.out, rows,
          a.n_split);
  return cudaGetLastError();
}

// Checks the split and the pointers, then launches.
cudaError_t dispatch(const Args& a, int DH, cudaStream_t st) {
  if (a.split_keys <= 0 || a.split_keys % kTileKeys ||
      a.n_split != (a.Sk + a.split_keys - 1) / a.split_keys ||
      (a.n_split > 1 && !a.scratch) || a.n_split > 65535 ||
      (long long)a.B * a.Hkv > 65535 ||
      (long long)a.B * a.C * a.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // cp.async and the output stores move 16 bytes at a time (every row
  // stride is dh * 2 bytes, a multiple of 16)
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out) |
       reinterpret_cast<uintptr_t>(a.scratch)) % 16)
    return cudaErrorMisalignedAddress;
  switch (DH) {
    case 16: return launch<16>(a, st);
    case 32: return launch<32>(a, st);
    case 64: return launch<64>(a, st);
    case 80: return launch<80>(a, st);
    case 128: return launch<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tensor_cores

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
    case 80: return launch<T, 80>(q, k, v, qpos, kpos, out, B, C, Sk, H, Hkv,
                                  window, scale, softcap, st);
    case 128: return launch<T, 128>(q, k, v, qpos, kpos, out, B, C, Sk, H,
                                    Hkv, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, C, H, dh); k, v (B, Sk, Hkv, dh); qpos (B, C) int32; kpos (B, Sk)
// int32; out (B, C, H, dh); contiguous. window <= 0: none; softcap <= 0:
// none. bfloat16 splits the keys into n_split ranges of split_keys (a
// multiple of 64, n_split = ceil(Sk / split_keys)) and, when n_split > 1,
// takes a float32 scratch of B*C*H*n_split*(dh + 2) (16-byte aligned, like
// q, k, v and out); float32 takes n_split 1 and no scratch. walk (bfloat16
// only, else null): int32 (blocks, 3) that the kernel fills with its walk
// (Args::walk). Returns the launch's cudaError_t (0 on success).
extern "C" int repro_chunk_attention(const void* q, const void* k,
                                     const void* v, const void* qpos,
                                     const void* kpos, void* out,
                                     void* scratch, void* walk, int B,
                                     int C, int Sk, int H, int Hkv, int DH,
                                     int window, float scale, float softcap,
                                     int n_split, int split_keys, int dtype,
                                     void* stream) {
  if (B <= 0 || C <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using tensor_cores::bf16;
    const tensor_cores::Args a{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(qpos),
        static_cast<const int*>(kpos), static_cast<bf16*>(out),
        static_cast<float*>(scratch), static_cast<int*>(walk), B, C, Sk, H,
        Hkv, window, n_split, split_keys, scale, softcap};
    return tensor_cores::dispatch(a, DH, st);
  }
  if (dtype == kFloat32) {
    if (n_split != 1 || walk) return cudaErrorInvalidValue;
    return by_dh<float>(DH, q, k, v, qpos, kpos, out, B, C, Sk, H, Hkv,
                        window, scale, softcap, st);
  }
  return cudaErrorInvalidValue;
}
