// The shared body of the one-token GQA reads — over a dense ring cache
// (decode_attention.cu) and over paged pools (paged_decode_attention.cu) —
// for Hopper (sm_90a): flash-decoding, the keys of a slot split across
// blocks.
//
// Its combine kernel also merges the partials of the paged absorbed-MLA
// read (paged_mla_decode_attention.cu) at d_v 512.
//
// Both reads are this code over a row-address functor (DenseRows,
// PagedRows): the same split, the same key order within a split and the
// same combine order, so over the same logical rows the paged read equals
// the dense read bit for bit, in both dtypes and at every shape.
//
// What bounds it on the H100: the K/V read. A call streams the live K and
// V rows once (2*B*S*Hkv*dh elements) for ~4*G flops per element, far below
// the card's ~295 flop/byte balance point, so the least time is those bytes
// over 3.35 TB/s (~2.5 us at recurrentgemma's serving read, B 4, S 2048,
// one KV head of 256, bf16).
//
// Design:
//  * grid (B, Hkv * G/GB, n_split): the wrapper's decode_split
//    (kernels/decode_attention.py) cuts the S logical rows of a slot into
//    n_split ranges of split_keys (a multiple of 64, at most 512; the last
//    range may be shorter) so that about two blocks an SM run; it sees S
//    and B*Hkv only, never the page size, so a dense ring and a paged map of
//    the same rows split alike;
//  * a block first reads the row index and the live bit of each key of its
//    range into shared memory, all threads at once (the paged read's page
//    ids are read there, once, not in the key walk). A key is live iff its
//    row is backed (page_map entry > 0 when paged) and 0 <= pos <= t (and
//    pos > t - window). Rows reached through the null page are loaded and
//    masked, as the dense view the plain version gathers holds them;
//  * each block runs the online softmax over its range and writes a float32
//    partial (m, l, acc[dh]) for each of its heads to a scratch tensor the
//    wrapper allocates; decode_combine_kernel then merges the n_split
//    partials of each (slot, head) in split order (no atomics), and the
//    finalize divides by max(l, 1e-30);
//  * masked scores take the finite -1e30 and keys past S are left out: a
//    range with no live key has m = -1e30 and l = its key count, so the
//    combine drops it (weight exp(-1e30 - m) = 0) whenever another range
//    has a live key, and an all-masked slot comes out the uniform average
//    of V over its S rows, finite, as in the plain version.
//
// Two bodies, chosen by the element type:
//
// bfloat16 (every serving path), decode_mma_kernel: the block's G <= 16
// query heads of one KV head are the 16 rows of one mma.sync m16n8k16 row
// tile (rows past G are zero), so QK^T and PV run on the tensor cores, bf16
// in, f32 accumulate. 4 warps. Q comes in once by cp.async and stays in
// registers as A fragments (dh/16 k-steps x 4). The range is walked in
// tiles of 64 keys, K and V rows copied by cp.async (16 bytes a thread,
// rows past the range zero-filled) into a 2-stage ring (1 stage when a
// range is one tile), rows padded by 16 bytes so that ldmatrix is
// conflict-free; bf16 is converted only inside the mma. Per tile: each
// warp scores 16 keys (K fragments by ldmatrix), the warps' row maxima meet
// in shared memory, each warp rescales and exponentiates its scores (base
// 2, ex2.approx) and writes P, rounded to bf16, to a shared 16 x 64 tile;
// then each warp owns ceil(dh/64) pairs of 8-column n-tiles (64 columns at
// dh 256, a 16 x 64 f32 accumulator of 32 registers a thread; at dh 80 the
// 5 pairs fall 2, 2, 1, 0 to the warps) and adds P V with V fragments by
// ldmatrix.trans. Rows G..15 of the tile (G 6, 12) are zero and never
// written back. A dh-80 row is 160 bytes, so every cp.async source stays
// 16-byte aligned, and a padded shared row of 176 bytes keeps ldmatrix
// conflict-free.
//
// float32 (the dtype of the card-vs-CPU parity checks), decode_scalar_kernel:
// the scalar body on the CUDA cores, so the parity keeps float32 products.
// A block keeps the G query heads of one KV head while G*dh <= 1024, else
// the most heads that divide G within 1024/dh (8 at G 16 / dh 128, 6 at
// G 12 / dh 128); each of its 8 warps walks every 8th chunk of 8 keys (4
// at dh 256) of the range, a lane owns ceil(dh/32) consecutive head dims
// (at dh 80, 3: lanes 0..26, the last two dims of lane 26 and lanes past
// it idle), a key's score is a shuffle reduction, and the warps' states
// merge in shared memory before the partial is written.
#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

using namespace repro_torch;

namespace {

using bf16 = __nv_bfloat16;

// Keys of a split: a multiple of kSplitTile, at most kMaxSplitKeys
// (kernels/decode_attention.py::decode_split chooses)
constexpr int kSplitTile = 64;
constexpr int kMaxSplitKeys = 512;

// Slot b's row s of a dense ring cache (B, S, Hkv, dh) is row b*S + s.
struct DenseRows {
  const int* pos;      // (B, S)
  int S;
  __device__ __forceinline__ int row(int b, int s) const { return b * S + s; }
  __device__ __forceinline__ int position(int row) const { return pos[row]; }
};

// Slot b's logical row s lives in pool row page_map[b, s/P] * P + s % P;
// page 0 is the null page: its rows (< P) are loaded, as the plain
// version's gathered view holds them, and read position -1 (dead).
struct PagedRows {
  const int* pos;       // (n_pages, P)
  const int* page_map;  // (B, n_pp)
  int n_pp, P;
  __device__ __forceinline__ int row(int b, int s) const {
    return page_map[(size_t)b * n_pp + s / P] * P + s % P;
  }
  __device__ __forceinline__ int position(int row) const {
    return row >= P ? pos[row] : -1;
  }
};

struct DecodeArgs {
  const void* q;        // (B, H, DH)
  const void* k;        // rows of Hkv * DH: the cache or the pool
  const void* v;
  const int* qpos;      // (B,)
  void* out;            // (B, H, DH)
  // float32: acc (B, H, n_split, DH), then (m, l) (B, H, n_split, 2)
  float* scratch;
  int B, S, H, Hkv, window, n_split, split_keys;
  float scale;
  // (B, H) float32 natural log-sum-exp of the live scores, or nullptr (the
  // dense read's return_lse; the paged reads never ask for it)
  float* lse = nullptr;
};

// The partials' index of (slot b, query head h, split).
__device__ __forceinline__ size_t record(const DecodeArgs& a, int b, int h,
                                         int split) {
  return ((size_t)b * a.H + h) * a.n_split + split;
}

// The range of keys of a block: [split * split_keys, + count).
__device__ __forceinline__ int split_count(const DecodeArgs& a, int split) {
  return min(a.split_keys, a.S - split * a.split_keys);
}

// Reads the row index of each key of the block's range into shared memory
// (all threads; the paged read's page ids are read here, once).
template <class Rows>
__device__ __forceinline__ void split_rows(const Rows& rows,
                                           const DecodeArgs& a, int b,
                                           int split, int n, int* sRow) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sRow[i] = rows.row(b, split * a.split_keys + i);
}

// Reads the live bit of each key of the range (after split_rows and a
// barrier): its row exists and 0 <= pos <= t (and pos > t - window).
template <class Rows>
__device__ __forceinline__ void split_live(const Rows& rows,
                                           const DecodeArgs& a, int b, int n,
                                           const int* sRow,
                                           unsigned char* sLive) {
  const int t = a.qpos[b];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = sRow[i];
    const int p = rows.position(row);
    sLive[i] = row >= 0 && p >= 0 && p <= t &&
               (a.window <= 0 || p > t - a.window);
  }
}

// ---------------------------------------------------------------------------
// float32: the scalar body
// ---------------------------------------------------------------------------

constexpr int kScalarWarps = 8;

// Query heads a block keeps: the most that divide G and keep their float32
// accumulators within 1024 per lane group (32 KB of shared memory for the
// warp merge): all G of its KV head when G*DH <= 1024, 8 at G 16 / dh 128,
// 6 at G 12 / dh 128 (grid y = Hkv * G/GB, so GB must divide G or heads
// past a multiple of GB would go unread).
template <int G, int DH>
__host__ __device__ constexpr int scalar_heads() {
  int gb = G;
  while (gb > 1 && (gb * DH > 1024 || G % gb)) --gb;
  return gb;
}


// Keys a warp loads before it scores them: 8, or 4 at DH 256, where 8
// would hold 128 K/V floats a lane in registers.
template <int DH>
__host__ __device__ constexpr int chunk_keys() { return DH >= 256 ? 4 : 8; }

template <class Rows, typename T, int G, int DH>
__global__ void __launch_bounds__(kScalarWarps * 32)
decode_scalar_kernel(DecodeArgs a, Rows rows) {
  constexpr int PL = (DH + 31) / 32;  // head dims per lane
  constexpr int GB = scalar_heads<G, DH>();
  static_assert(G % GB == 0, "a block's heads must tile the group");
  constexpr int kChunk = chunk_keys<DH>();
  __shared__ int sRow[kMaxSplitKeys];
  __shared__ unsigned char sLive[kMaxSplitKeys];
  __shared__ float sm_m[kScalarWarps][GB], sm_l[kScalarWarps][GB];
  __shared__ float sm_acc[kScalarWarps][GB][DH];
  const int b = blockIdx.x, split = blockIdx.z;
  const int hk = blockIdx.y / (G / GB);
  const int h0 = hk * G + blockIdx.y % (G / GB) * GB;  // the block's heads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * PL;
  const bool lane_live = d0 < DH;    // dh < 32 leaves lanes idle

  const T* q = static_cast<const T*>(a.q);
  float qr[GB][PL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane_live) {
      load_lane<T, PL, DH>(q + ((size_t)b * a.H + (size_t)h0 + g) * DH +
                               d0, d0, qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < PL; ++j) qr[g][j] = 0.f;
    }
  }
  const int n_keys = split_count(a, split);
  split_rows(rows, a, b, split, n_keys, sRow);
  __syncthreads();
  split_live(rows, a, b, n_keys, sRow, sLive);
  __syncthreads();
  const size_t row_stride = (size_t)a.Hkv * DH;
  const T* kb = static_cast<const T*>(a.k) + (size_t)hk * DH + d0;
  const T* vb = static_cast<const T*>(a.v) + (size_t)hk * DH + d0;

  float m[GB], l[GB], acc[GB][PL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) acc[g][j] = 0.f;
  }

  for (int base = warp * kChunk; base < n_keys;
       base += kScalarWarps * kChunk) {
    float kr[kChunk][PL], vr[kChunk][PL];
    bool in_range[kChunk], live[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int i = base + c;
      in_range[c] = i < n_keys;
      const int row = in_range[c] ? sRow[i] : -1;
      live[c] = in_range[c] && sLive[i];
      if (row >= 0 && lane_live) {
        load_lane<T, PL, DH>(kb + (size_t)row * row_stride, d0, kr[c]);
        load_lane<T, PL, DH>(vb + (size_t)row * row_stride, d0, vr[c]);
      } else {
#pragma unroll
        for (int j = 0; j < PL; ++j) kr[c][j] = vr[c][j] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float sc[kChunk];
      float cm = m[g];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < PL; ++j) part += qr[g][j] * kr[c][j];
        const float dot = warp_sum(part);
        sc[c] = live[c] ? dot * a.scale : kNegInf;
        if (in_range[c]) cm = fmaxf(cm, sc[c]);
      }
      const float corr = expf(m[g] - cm);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < PL; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = in_range[c] ? expf(sc[c] - cm) : 0.f;
        psum += p;
#pragma unroll
        for (int j = 0; j < PL; ++j) acc[g][j] += p * vr[c][j];
      }
      l[g] = l[g] * corr + psum;
      m[g] = cm;
    }
  }

  // merge the warps' (m, l, acc) states into the block's partial
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (lane_live) {
#pragma unroll
      for (int j = 0; j < PL; ++j)
        if (!ragged_lanes<DH>() || d0 + j < DH)
          sm_acc[warp][g][d0 + j] = acc[g][j];
    }
  }
  __syncthreads();
  float* ml = a.scratch + (size_t)a.B * a.H * a.n_split * DH;
  for (int i = threadIdx.x; i < GB * DH; i += blockDim.x) {
    const int g = i / DH, d = i % DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kScalarWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kScalarWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    const size_t rec = record(a, b, h0 + g, split);
    a.scratch[rec * DH + d] = num;
    if (d == 0) {
      ml[rec * 2] = mx;
      ml[rec * 2 + 1] = den;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: both products on mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kTileKeys = kSplitTile;   // keys a tile: 16 a warp
constexpr int kPad = 8;                 // bf16 per row of padding (16 bytes)

template <int DH>
constexpr size_t mma_smem_bytes(int stages) {
  // the Q tile, the stages of K, the stages of V, the P tile
  return sizeof(bf16) * ((size_t)16 * (DH + kPad) +
                         (size_t)2 * stages * kTileKeys * (DH + kPad) +
                         (size_t)16 * (kTileKeys + kPad));
}

template <class Rows, typename T, int G, int DH>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_mma_kernel(DecodeArgs a, Rows rows, int stages) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core body is bf16");
  static_assert(G <= 16 && DH % 16 == 0, "one m16 row tile of heads");
  constexpr int LD = DH + kPad;          // padded K, V and Q rows
  constexpr int LP = kTileKeys + kPad;   // padded P rows
  constexpr int KS = DH / 16;            // k-steps of Q K^T
  constexpr int NP = DH / 16;            // output column pairs (2 n-tiles)
  constexpr int NPW = (NP + kMmaWarps - 1) / kMmaWarps;   // a warp's pairs
  constexpr int kThreads = kMmaWarps * 32;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(decode_smem);
  bf16* sK = sQ + 16 * LD;
  bf16* sV = sK + stages * kTileKeys * LD;
  bf16* sP = sV + stages * kTileKeys * LD;
  __shared__ int sRow[kMaxSplitKeys];
  __shared__ unsigned char sLive[kMaxSplitKeys];
  __shared__ float sMax[kMmaWarps][16], sSum[kMmaWarps][16];

  const int b = blockIdx.x, hk = blockIdx.y, split = blockIdx.z;
  const int h0 = hk * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;    // fragment row group, column pair
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix x4: row, matrix
  const size_t row_stride = (size_t)a.Hkv * DH;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)hk * DH;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)hk * DH;

  // copy groups: the Q tile (rows past G zero-filled), then one per key tile
  {
    const bf16* qb = static_cast<const bf16*>(a.q) +
                     ((size_t)b * a.H + h0) * DH;
    constexpr int kChunks = DH / 8;
    for (int i = tid; i < 16 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool in = r < G;
      cp_async_16(smem_addr(sQ + r * LD + c * 8),
                  qb + (in ? (size_t)r * DH : 0) + c * 8, in);
    }
    cp_async_commit();
  }
  const int n_keys = split_count(a, split);
  split_rows(rows, a, b, split, n_keys, sRow);
  __syncthreads();
  const int n_tiles = (n_keys + kTileKeys - 1) / kTileKeys;

  auto load_keys = [&](int j) {   // key tile j into stage j % stages
    bf16* dK = sK + (j % stages) * kTileKeys * LD;
    bf16* dV = sV + (j % stages) * kTileKeys * LD;
    constexpr int kChunks = DH / 8;       // 16-byte chunks a row
    constexpr int kTotal = kTileKeys * kChunks;
    static_assert(kTotal % kThreads == 0, "whole copy rounds");
#pragma unroll
    for (int it = 0; it < kTotal / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const int key = j * kTileKeys + r;
      const int row = key < n_keys ? sRow[key] : -1;
      const size_t off = row >= 0 ? (size_t)row * row_stride : 0;
      cp_async_16(smem_addr(dK + r * LD + c * 8), kb + off + c * 8, row >= 0);
      cp_async_16(smem_addr(dV + r * LD + c * 8), vb + off + c * 8, row >= 0);
    }
  };
  load_keys(0);
  cp_async_commit();
  // the positions load while the first K/V tile is in flight
  split_live(rows, a, b, n_keys, sRow, sLive);
  cp_async_wait<1>();       // the Q tile has landed
  __syncthreads();
  uint32_t qreg[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qreg[kk], smem_addr(sQ + (lr + (lm & 1) * 8) * LD + kk * 16 +
                                    (lm >> 1) * 8));

  // rows g and g + 8: running max (logit x log2 e, shared by every warp)
  // and this thread's share of the running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NPW][2][4];
#pragma unroll
  for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jj][h][e] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();     // key tile j has landed
    __syncthreads();        // and every warp is done with tile j - 1
    if (j + 1 < n_tiles) load_keys(j + 1);
    cp_async_commit();
    const bf16* tK = sK + (j % stages) * kTileKeys * LD;
    const bf16* tV = sV + (j % stages) * kTileKeys * LD;

    // S = Q K^T over the warp's 16 keys (n-tiles 0 and 1)
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, smem_addr(tK + (warp * 16 + lr + (lm >> 1) * 8) * LD +
                                kk * 16 + (lm & 1) * 8));
      mma(s[0], qreg[kk], kf[0], kf[1]);
      mma(s[1], qreg[kk], kf[2], kf[3]);
    }

    // logits x log2 e: s[n][0..1] row g, s[n][2..3] row g + 8, at tile
    // keys 16 warp + 8n + 2 t4 (+1); masked -1e30, past the range -inf
    const float past = __int_as_float(0xff800000);   // -inf
    float rmax[2] = {past, past};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kTileKeys + warp * 16 + n * 8 + 2 * t4 + (e & 1);
        const bool in = key < n_keys;
        const bool live = in && sLive[key];
        const float x = live ? s[n][e] * scale2 : (in ? kNegInf : past);
        s[n][e] = x;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
    }
    if (t4 == 0) {
      sMax[warp][g] = rmax[0];
      sMax[warp][g + 8] = rmax[1];
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = sMax[0][g + 8 * r];
#pragma unroll
      for (int w = 1; w < kMmaWarps; ++w)
        tile_max = fmaxf(tile_max, sMax[w][g + 8 * r]);
      const float m_new = fmaxf(m[r], tile_max);
      corr[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P = 2^(x - m) (0 past the range), rounded to bf16 into the P tile
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
      bf16* pr = sP + warp * 16 + n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(pr + g * LP) = pack_bf16(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(pr + (g + 8) * LP) =
          pack_bf16(s[n][2], s[n][3]);
    }
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[jj][h][0] *= corr[0];
        o[jj][h][1] *= corr[0];
        o[jj][h][2] *= corr[1];
        o[jj][h][3] *= corr[1];
      }
    __syncthreads();

    // O += P V over the warp's column pairs: per k-step one ldmatrix x4 of
    // P (A) and one ldmatrix.trans x4 of V a pair (n-tiles 2 pair, +1)
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, smem_addr(sP + (lr + (lm & 1) * 8) * LP + kk * 16 +
                                (lm >> 1) * 8));
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj) {
        const int pair = warp * NPW + jj;
        if (pair < NP) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_addr(tV + (kk * 16 + lr + (lm & 1) * 8) *
                                                   LD + pair * 16 +
                                               (lm >> 1) * 8));
          mma(o[jj][0], pa, vf[0], vf[1]);
          mma(o[jj][1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // the row sums: over the quad, then over the warps in warp order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t4 == 0) {
    sSum[warp][g] = l[0];
    sSum[warp][g + 8] = l[1];
  }
  __syncthreads();
  float* ml = a.scratch + (size_t)a.B * a.H * a.n_split * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= G) continue;
    const size_t rec = record(a, b, h0 + row, split);
    if (warp == 0 && t4 == 0) {
      float sum = sSum[0][row];
#pragma unroll
      for (int w = 1; w < kMmaWarps; ++w) sum += sSum[w][row];
      ml[rec * 2] = m[r];
      ml[rec * 2 + 1] = sum;
    }
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj) {
      const int pair = warp * NPW + jj;
      if (pair >= NP) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(a.scratch + rec * DH + pair * 16 + h * 8 +
                                   2 * t4) =
            make_float2(o[jj][h][2 * r], o[jj][h][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The combine: the n_split partials of each (slot, head), in split order
// ---------------------------------------------------------------------------

// Splits the combine takes: their weights and sums sit in shared memory.
constexpr int kMaxSplits = 4096;
constexpr float kLn2 = 0.6931471805599453f;

// One block a (slot, head) of whole warps (the shuffles name all 32
// lanes), a thread for every blockDim-th head dim (one dim each where DH
// <= blockDim, dh 80 on 96 threads; the MLA read's 512 on 256): the
// splits' maxima reduce to M, the weights exp(m_i - M) and sums l_i go to
// shared memory, then every thread adds its dims' partials in split order
// with 8 loads in flight. kBase2: the partials' m are logits x log2 e (the
// tensor-core bodies), else natural logits.
//
// lse (a (slot, head) float each, or nullptr): the merged log-sum-exp,
// M + log(den) in natural units, written beside the output. A (slot,
// head) whose splits saw no live key (M is the masked -1e30) then writes
// out 0 and lse -inf instead of the uniform average — the partial of a
// shard of a split cache that a merge across shards weighs 0. Without lse
// nothing changes.
template <typename T, bool kBase2>
__global__ void __launch_bounds__(256)
decode_combine_kernel(const float* __restrict__ acc,
                      const float* __restrict__ ml, T* __restrict__ out,
                      int n_split, int DH, float* __restrict__ lse) {
  __shared__ float sW[kMaxSplits], sL[kMaxSplits], sMax[8];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float2* mlb = reinterpret_cast<const float2*>(ml) +
                      (size_t)bh * n_split;
  float mx = kNegInf;
  for (int s = tid; s < n_split; s += blockDim.x) {
    const float2 x = mlb[s];
    sW[s] = x.x;
    sL[s] = x.y;
    mx = fmaxf(mx, x.x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) sMax[warp] = mx;
  __syncthreads();
  mx = sMax[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) mx = fmaxf(mx, sMax[w]);
  for (int s = tid; s < n_split; s += blockDim.x)
    sW[s] = kBase2 ? fast_exp2(sW[s] - mx) : expf(sW[s] - mx);
  __syncthreads();
  if (lse != nullptr && !(mx > 0.5f * kNegInf)) {
    // no live key in any split: weight 0 in a merge across shards
    for (int d = tid; d < DH; d += blockDim.x)
      out[(size_t)bh * DH + d] = from_f32<T>(0.f);
    if (tid == 0) lse[bh] = __int_as_float(0xff800000);   // -inf
    return;
  }
  for (int d = tid; d < DH; d += blockDim.x) {
    const float* ab = acc + (size_t)bh * n_split * DH + d;
    float den = 0.f, num = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      den += sL[s] * sW[s];
      num += ab[(size_t)s * DH] * sW[s];
    }
    out[(size_t)bh * DH + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
    if (lse != nullptr && d == 0)
      lse[bh] = kBase2 ? (mx + log2f(den)) * kLn2 : mx + logf(den);
  }
}

// ---------------------------------------------------------------------------
// Launch and dispatch
// ---------------------------------------------------------------------------

template <class Rows, typename T, int G, int DH>
cudaError_t launch(const DecodeArgs& a, const Rows& rows, cudaStream_t st) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  if constexpr (kMma) {
    // a range of one tile needs one stage
    const int stages = a.split_keys > kTileKeys ? 2 : 1;
    const size_t bytes = mma_smem_bytes<DH>(stages);
    void (*kernel)(DecodeArgs, Rows, int) = decode_mma_kernel<Rows, T, G, DH>;
    // the attribute belongs to the current device: set it once a device
    // (of the first 64), at the two-stage size that covers both launches
    static std::atomic<uint64_t> attr_set{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(attr_set.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)mma_smem_bytes<DH>(2));
      if (e != cudaSuccess) return e;
      attr_set.fetch_or(bit, std::memory_order_relaxed);
    }
    kernel<<<dim3(a.B, a.Hkv, a.n_split), kMmaWarps * 32, bytes, st>>>(
        a, rows, stages);
  } else {
    constexpr int GB = scalar_heads<G, DH>();
    decode_scalar_kernel<Rows, T, G, DH>
        <<<dim3(a.B, a.Hkv * (G / GB), a.n_split), kScalarWarps * 32, 0,
           st>>>(a, rows);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int bh = a.B * a.H;
  decode_combine_kernel<T, kMma><<<bh, (DH + 31) / 32 * 32, 0, st>>>(
      a.scratch, a.scratch + (size_t)bh * a.n_split * DH,
      static_cast<T*>(a.out), a.n_split, DH, a.lse);
  return cudaGetLastError();
}

// The instantiated (G, dh): G in {1, 2, 4, 8, 16} at dh in {16, 32, 64,
// 128, 256}, and the configs' own pairs beyond them, each only where a
// config uses it (kernels/decode_attention.py::SHAPES): G 6 and G 12 at dh
// 128 (nemotron-4-15b, mistral-large-123b) and G 4 at dh 80
// (h2o-danube-1.8b). Any other pair is refused.
template <class Rows, typename T, int G>
cudaError_t by_dh(int DH, const DecodeArgs& a, const Rows& rows,
                  cudaStream_t st) {
  if constexpr (G == 6 || G == 12) {
    if (DH == 128) return launch<Rows, T, G, 128>(a, rows, st);
    return cudaErrorInvalidValue;
  } else {
    switch (DH) {
      case 16: return launch<Rows, T, G, 16>(a, rows, st);
      case 32: return launch<Rows, T, G, 32>(a, rows, st);
      case 64: return launch<Rows, T, G, 64>(a, rows, st);
      case 80:
        if constexpr (G == 4) return launch<Rows, T, G, 80>(a, rows, st);
        return cudaErrorInvalidValue;
      case 128: return launch<Rows, T, G, 128>(a, rows, st);
      case 256: return launch<Rows, T, G, 256>(a, rows, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <class Rows, typename T>
cudaError_t by_g(int G, int DH, const DecodeArgs& a, const Rows& rows,
                 cudaStream_t st) {
  switch (G) {
    case 1: return by_dh<Rows, T, 1>(DH, a, rows, st);
    case 2: return by_dh<Rows, T, 2>(DH, a, rows, st);
    case 4: return by_dh<Rows, T, 4>(DH, a, rows, st);
    case 6: return by_dh<Rows, T, 6>(DH, a, rows, st);
    case 8: return by_dh<Rows, T, 8>(DH, a, rows, st);
    case 12: return by_dh<Rows, T, 12>(DH, a, rows, st);
    case 16: return by_dh<Rows, T, 16>(DH, a, rows, st);
    default: return cudaErrorInvalidValue;
  }
}

// Checks the plan and the pointers, then runs the split and the combine.
template <class Rows>
int decode_dispatch(const DecodeArgs& a, const Rows& rows, int DH, int dtype,
                    void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv ||
      a.split_keys <= 0 || a.split_keys % kSplitTile ||
      a.split_keys > kMaxSplitKeys || a.n_split > kMaxSplits ||
      a.n_split != (a.S + a.split_keys - 1) / a.split_keys)
    return cudaErrorInvalidValue;
  // cp.async moves 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) |
       reinterpret_cast<uintptr_t>(a.scratch)) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = a.H / a.Hkv;
  if (dtype == kBFloat16) return by_g<Rows, bf16>(G, DH, a, rows, st);
  if (dtype == kFloat32) return by_g<Rows, float>(G, DH, a, rows, st);
  return cudaErrorInvalidValue;
}

}  // namespace
