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
// What bounds it on the H100: the weight bytes. At the U-Net's shapes B <=
// 32 rows meet up to 19.25 MB of float32 weights a layer (decoder 2 of
// soi-unet-dns: K*Cin 7248, Cout 664), at most 2*B = 64 flops a weight
// element, below the 80 flops per float32 element (67 TFLOP/s over 3.35
// TB/s) where the arithmetic would bound it. Least time at decoder 2:
// 19.25 MB / 3.35 TB/s = 5.7 us, whatever B <= 32; one B 1 frame of the 14
// convs reads ~116 MB, 34.6 us. A frame's weights exceed the 50 MB L2, so
// they stream from HBM every frame.
//
// Design (the plan, kernels/stmc_conv.py::stmc_plan, sets cols, splits,
// keys_per_split and rows):
//  * split-K in a thread block cluster: the `splits` (1, 2, 4 or 8: the
//    portable cluster size) blocks of a cluster own one tile of `cols`
//    output columns and one range of keys_per_split contraction rows each,
//    so a B 1 conv runs on ceil(Cout/cols) * splits >= 132 blocks where
//    the shape allows (decoder 2: 21 x 8 = 168), and no more than the SMs
//    hold at once. The ranks' partial sums meet in distributed shared
//    memory and are added in rank order, with no atomics and no second
//    kernel: one launch a conv, and every result repeats bit for bit;
//  * 16-byte weight loads: a thread owns a group of 16 bytes of a weight
//    row (4 float32 or 8 bf16 columns); a block's threads are VL = cols /
//    group threads across a row (at least 2: a 32-byte sector) times row
//    lanes, so a warp reads whole 128-byte rows at VL 8 in float32. The
//    loads skip L1 and have the L2 fetch the 256-byte block around them
//    (the neighbouring column tile's next read). Each thread keeps two
//    chunks of rows in flight in two register buffers used in turn. Where
//    Cout * element size is no multiple of 16 bytes, or the weights'
//    pointer is not 16-byte aligned, the same kernel loads the group
//    element by element, masked at Cout (the ragged edge);
//  * every weight byte is read once at B <= 32: a block holds all `rows`
//    (the least power of two >= B, at most 32) rows of B, so each weight
//    row it loads serves every row of B (beyond 32 the grid's y repeats
//    the weights for each 32 rows). The window of the block's range comes
//    into shared memory by 4-byte cp.async copies, transposed to [kc][rows
//    (+4 pad)] (bf16: pairs of kc in 32-bit words), in two tiles of up to
//    48 KB used in turn: tile t + 1 lands while tile t is used (decoder 2
//    at B 1: its range of 906 rows in one tile);
//  * below 8 rows of B a block is 256 threads, two an SM; from 16 rows,
//    where the FMAs weigh as much as the bytes, 128 threads with 24 KB
//    tiles, three an SM, and the plan's 2-3 blocks an SM keep the SMs
//    that run one more block than others from setting the time. The
//    accumulators are float32; from 16 rows two lane halves split the rows
//    of B, and bf16 pairs of row lanes swap half a group each (one shuffle
//    of 8 bytes), so a thread adds at most 4 x 16. Partial sums leave the
//    row lanes of a warp by a shuffle butterfly, the warps' through shared
//    memory in warp order, the cluster's in rank order; the bias is added
//    in float32 and the cast to the output dtype comes at the store.
//
// What holds it back: a launch's fixed cost, ~4 us at the smallest convs
// (the cluster's two barriers, the first window copy, the reads of the
// other ranks' partials), near half of decoder 2's time at B 1; the
// weights stream at ~2 TB/s, not 3.35, in 128-byte pieces of rows 2.6 KB
// apart; from 16 rows the float32 FMAs and the window reads from shared
// memory, not the bytes, set the time, and bf16 runs its products as
// float32 FMAs, not mma.sync.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

using namespace repro_torch;
namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplits = 8;         // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

// Columns of a thread's 16-byte group of a weight row.
template <typename T>
__host__ __device__ constexpr int group_cols() { return 16 / sizeof(T); }

// Lane halves that split a block's rows of B: two from 16 rows, so a
// thread's accumulators stay at most 4 x 16 (both halves load the same
// weight bytes, one request).
template <int BB>
__host__ __device__ constexpr int b_halves() { return BB >= 16 ? 2 : 1; }

// Threads a block, and blocks an SM: below 8 rows of B 256 threads, two
// blocks an SM (at most 128 registers); from 8 rows 128 threads (more
// accumulators), and from 16 rows three blocks an SM (at most 170
// registers), so the plan's 2-3 blocks an SM are all resident at once.
template <int BB>
__host__ __device__ constexpr int block_threads() {
  return BB >= 8 ? 128 : 256;
}
template <int BB>
__host__ __device__ constexpr int blocks_per_sm() {
  return BB >= 16 ? 3 : 2;
}

// A window buffer (of two), in 32-bit words: 48 KB, 24 KB from 16 rows of
// B (three blocks an SM).
template <int BB>
__host__ __device__ constexpr int win_words() {
  return BB >= 16 ? 6144 : 12288;
}

// Padded row of the staged window, 32-bit words a contraction row (float32)
// or a pair of them (bf16): float4 reads of a row, and the row lanes of a
// warp on distinct banks.
template <int BB>
__host__ __device__ constexpr int win_ld() { return BB >= 4 ? BB + 4 : BB; }

// bf16 at 16 rows or more: a pair of row lanes swaps half a group, so a
// thread's accumulators stay rows x 4.
template <typename T, int BB>
__host__ __device__ constexpr bool pair_swap() {
  return sizeof(T) == 2 && BB >= 16;
}

// Weight rows a thread loads a chunk (two chunks in flight).
template <int BB>
__host__ __device__ constexpr int chunk_rows() { return BB >= 16 ? 4 : 8; }

// Contraction rows of a window tile: a split's range where it fits, else
// the most that fit a buffer (even, so bf16 pairs never straddle tiles).
template <int BB>
__host__ __device__ constexpr int tile_rows(int kps) {
  return kps < win_words<BB>() / win_ld<BB>()
             ? kps
             : (win_words<BB>() / win_ld<BB>()) & ~1;
}

// Shared memory of a launch, in words: the window buffers (two when a
// range takes several tiles; then the warps' partials), then the block's
// partial that the cluster reads.
template <int BB>
__host__ __device__ constexpr int smem_words(int cols, int kps) {
  const int tile = tile_rows<BB>(kps) * win_ld<BB>();
  const int bufs = (kps > tile_rows<BB>(kps) ? 2 : 1) * tile;
  const int warps = block_threads<BB>() / 32 * BB * cols;
  return (bufs > warps ? bufs : warps) + BB * cols;
}

// The staged window of a tile: float32 rows [kc][LDW], or bf16 rows in
// pairs [kc/2][LDW] of 32-bit words (row 2p in the low half), both 4-byte
// cp.async copies of the window as it lies in global memory.
template <typename T, int BB>
struct Window {
  static constexpr int LDW = win_ld<BB>();
  static constexpr bool kPairs = sizeof(T) == 2;

  // row j's values at rows 4q..4q+3 of B
  __device__ static float4 quad(const uint32_t* buf, int j, int q) {
    if constexpr (kPairs) {
      const uint4 v =
          reinterpret_cast<const uint4*>(buf + (j >> 1) * LDW)[q];
      return (j & 1) ? make_float4(hi(v.x), hi(v.y), hi(v.z), hi(v.w))
                     : make_float4(lo(v.x), lo(v.y), lo(v.z), lo(v.w));
    } else {
      return reinterpret_cast<const float4*>(buf + j * LDW)[q];
    }
  }
  __device__ static float one(const uint32_t* buf, int j, int b) {
    if constexpr (kPairs) {
      const uint32_t v = buf[(j >> 1) * LDW + b];
      return (j & 1) ? hi(v) : lo(v);
    } else {
      return __uint_as_float(buf[j * LDW + b]);
    }
  }
  __device__ static float lo(uint32_t v) { return __uint_as_float(v << 16); }
  __device__ static float hi(uint32_t v) {
    return __uint_as_float(v & 0xffff0000u);
  }

  // Copies window[r0:r0+BB, kt:kt+tk] into buf, rows past B zero-filled,
  // as 4-byte cp.async copies (bf16: a pair of contraction rows a copy;
  // rows, splits and tiles then start at even elements, so tk is even).
  // bf16 windows whose pairs do not lie on 4-byte boundaries (`pairs`
  // false) are loaded and stored here instead, element by element.
  __device__ static void stage(uint32_t* buf, const T* __restrict__ win,
                               int B, int KC, int r0, int kt, int tk,
                               bool pairs, int tid, int threads) {
    if constexpr (kPairs) {
      if (pairs) {
        for (int p = tid; p < tk / 2; p += threads) {
#pragma unroll
          for (int r = 0; r < BB; ++r) {
            const bool in = r0 + r < B;
            const T* src =
                win + (in ? (size_t)(r0 + r) * KC + kt + 2 * p : 0);
            cp_async_4(smem_addr(buf + p * LDW + r), src, in);
          }
        }
      } else {
        unsigned short* h = reinterpret_cast<unsigned short*>(buf);
        for (int i = tid; i < tk; i += threads) {
#pragma unroll
          for (int r = 0; r < BB; ++r)
            h[((i >> 1) * LDW + r) * 2 + (i & 1)] =
                r0 + r < B ? __bfloat16_as_ushort(
                                 win[(size_t)(r0 + r) * KC + kt + i])
                           : (unsigned short)0;
        }
      }
    } else {
      for (int i = tid; i < tk; i += threads) {
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          const bool in = r0 + r < B;
          const T* src = win + (in ? (size_t)(r0 + r) * KC + kt + i : 0);
          cp_async_4(smem_addr(buf + i * LDW + r), src, in);
        }
      }
    }
  }
};

// A thread's 16 bytes of weight row `row` at column `col`: one 16-byte
// load (vec), else element by element (the edge path); columns past N
// read as 0.
template <typename T>
__device__ __forceinline__ uint4 load_group(const T* __restrict__ row,
                                            int col, int N, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    // read once: no L1 line; the L2 fetches the 256-byte block around it,
    // which the neighbouring column tiles read next
    if (col < N)
      asm volatile(
          "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
          : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
          : "l"(row + col));
    return r;
  }
  constexpr int G = group_cols<T>();
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < G; ++c) {
    if (col + c < N) {
      if constexpr (sizeof(T) == 4) {
        wd[c] = __float_as_uint(row[col + c]);
      } else {
        const uint32_t bits = __bfloat16_as_ushort(row[col + c]);
        wd[c / 2] |= bits << (16 * (c % 2));
      }
    }
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// NW words of T as float32 (bf16: element 2i in the low half of word i).
template <typename T, int NW>
__device__ __forceinline__ void unpack(const uint32_t (&wd)[NW],
                                       float (&f)[NW * 4 / sizeof(T)]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(wd[i]);
    } else {
      f[2 * i] = __uint_as_float(wd[i] << 16);
      f[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
    }
  }
}

// acc[c][b] += w[c] * x[b0 + b] for BH of the BB rows of contraction row
// j.
template <typename T, int NC, int BB, int BH>
__device__ __forceinline__ void fma_row(const uint32_t* buf, int j, int b0,
                                        const float (&w)[NC],
                                        float (&acc)[NC][BH]) {
  using W = Window<T, BB>;
  if constexpr (BH % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BH / 4; ++q) {
      const float4 v = W::quad(buf, j, b0 / 4 + q);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c][4 * q + 0] = fmaf(w[c], v.x, acc[c][4 * q + 0]);
        acc[c][4 * q + 1] = fmaf(w[c], v.y, acc[c][4 * q + 1]);
        acc[c][4 * q + 2] = fmaf(w[c], v.z, acc[c][4 * q + 2]);
        acc[c][4 * q + 3] = fmaf(w[c], v.w, acc[c][4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < BH; ++b) {
      const float v = W::one(buf, j, b0 + b);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c][b] = fmaf(w[c], v, acc[c][b]);
    }
  }
}

template <typename T, int BB>
__global__ void __launch_bounds__(block_threads<BB>(), blocks_per_sm<BB>())
stmc_conv_kernel(const T* __restrict__ win, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, int B,
                 int KC, int N, int vl_log2, int kps, int vec, int pairs) {
  constexpr int G = group_cols<T>();
  constexpr bool kSwap = pair_swap<T, BB>();
  constexpr int NC = kSwap ? G / 2 : G;  // columns a thread accumulates
  constexpr int U = chunk_rows<BB>();
  constexpr int LDW = win_ld<BB>();
  constexpr int H = b_halves<BB>();
  constexpr int BH = BB / H;             // rows of B a thread accumulates
  constexpr int kThreads = block_threads<BB>();
  constexpr int kWarps = kThreads / 32;
  using W = Window<T, BB>;
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int VL = 1 << vl_log2;
  const int CT = VL * G;                   // the block's output columns
  const int LS = VL * H;                   // lanes from a row lane to the next
  const int RL = kThreads / LS;            // row lanes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgrp = tid & (VL - 1), half = (tid >> vl_log2) & (H - 1);
  const int rl = tid / LS, b0 = half * BH;
  const int col0 = (blockIdx.x / S) * CT;
  const int col = col0 + cgrp * G;
  const int r0 = blockIdx.y * BB;
  const int k_begin = rank * kps;
  const int k_end = min(KC, k_begin + kps);
  const int TK = tile_rows<BB>(kps);       // contraction rows of a tile
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + TK - 1) / TK : 0;
  const int bufs = (n_tiles > 1 ? 2 : 1) * TK * LDW;
  const int red = kWarps * BB * CT;
  uint32_t* part_words = smem + (bufs > red ? bufs : red);
  float* part = reinterpret_cast<float*>(part_words);

  float acc[NC][BH];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int b = 0; b < BH; ++b) acc[c][b] = 0.f;

  // weight rows [base, base + RL*U) of the tile at kt (tk rows)
  auto load_chunk = [&](uint4 (&dst)[U], int kt, int tk, int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + rl + u * RL;
      dst[u] = j < tk ? load_group(w + (size_t)(kt + j) * N, col, N, vec != 0)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto tile_start = [&](int t) { return k_begin + t * TK; };
  auto tile_len = [&](int t) { return min(TK, k_end - tile_start(t)); };
  auto stage = [&](int t) {
    W::stage(smem + (t & 1) * TK * LDW, win, B, KC, r0, tile_start(t),
             tile_len(t), pairs != 0, tid, kThreads);
  };

  // The chunks of rows (RL*U a chunk) run tile by tile through two
  // register buffers in turn: a chunk is used while the next one's loads
  // are in flight (a copy from one buffer to the other would wait for
  // them). The first chunk and tile 0's window go out together; tile
  // t + 1's window lands while tile t is used (its buffer was freed by
  // the barrier that ended tile t - 1).
  int t = 0, base = 0;
  auto step = [&](uint4 (&cur)[U], uint4 (&nxt)[U]) {
    const int tk = tile_len(t);
    if (base == 0) {
      if (t + 1 < n_tiles) stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();                  // tile t's window has landed
      __syncthreads();
    }
    int t2 = t, b2 = base + RL * U;
    if (b2 >= tk) {
      ++t2;
      b2 = 0;
    }
    if (t2 < n_tiles) load_chunk(nxt, tile_start(t2), tile_len(t2), b2);
    const uint32_t* xs = smem + (t & 1) * TK * LDW;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + rl + u * RL;
      const uint32_t wd[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
      if constexpr (kSwap) {
        // rows j and j ^ 1 (the partner lane, lane ^ LS): the even lane
        // keeps columns 0..3 of both, the odd lane 4..7
        const bool odd = rl & 1;
        const uint32_t s0 = odd ? wd[0] : wd[2], s1 = odd ? wd[1] : wd[3];
        const uint32_t theirs[2] = {__shfl_xor_sync(kFull, s0, LS),
                                    __shfl_xor_sync(kFull, s1, LS)};
        const uint32_t mine[2] = {odd ? wd[2] : wd[0], odd ? wd[3] : wd[1]};
        float fm[NC], ft[NC];
        unpack<T, 2>(mine, fm);
        unpack<T, 2>(theirs, ft);
        if (j < tk) fma_row<T, NC, BB, BH>(xs, j, b0, fm, acc);
        if ((j ^ 1) < tk) fma_row<T, NC, BB, BH>(xs, j ^ 1, b0, ft, acc);
      } else {
        float f[NC];
        unpack<T, 4>(wd, f);
        if (j < tk) fma_row<T, NC, BB, BH>(xs, j, b0, f, acc);
      }
    }
    if (t2 != t) __syncthreads();          // every warp is done with tile t
    t = t2;
    base = b2;
  };
  uint4 bufa[U], bufb[U];
  if (n_tiles > 0) {
    load_chunk(bufa, k_begin, tile_len(0), 0);
    stage(0);
  }
  cp_async_commit();
  while (t < n_tiles) {
    step(bufa, bufb);
    if (t >= n_tiles) break;
    step(bufb, bufa);
  }

  // the row lanes of a warp that share a column group, rows of B (and
  // swapped half of the group): a butterfly, whose lanes all end with the
  // same bits
  for (int off = kSwap ? 2 * LS : LS; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int b = 0; b < BH; ++b)
        acc[c][b] += __shfl_xor_sync(kFull, acc[c][b], off);
  }
  float* red_buf = reinterpret_cast<float*>(smem);  // the warps' partials
  if (lane / LS < (kSwap ? 2 : 1)) {
    const int sh = kSwap ? lane / LS : 0;  // the swapped half of the group
    float* dst = red_buf + (warp * BB + b0) * CT + cgrp * G + sh * NC;
#pragma unroll
    for (int b = 0; b < BH; ++b)
#pragma unroll
      for (int c = 0; c < NC; ++c) dst[b * CT + c] = acc[c][b];
  }
  __syncthreads();
  for (int e = tid; e < BB * CT; e += kThreads) {
    float s = red_buf[e];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s += red_buf[q * BB * CT + e];
    part[e] = s;
  }
  // the cluster's partials, in rank order; each rank stores a share
  cluster.sync();
  for (int e = rank * kThreads + tid; e < BB * CT; e += S * kThreads) {
    const int b = e / CT, c = e - b * CT;
    const int row = r0 + b, cc = col0 + c;
    if (row < B && cc < N) {
      float v[kMaxSplits];                 // every rank's read in flight
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        v[q] = q < S ? cluster.map_shared_rank(part, (unsigned)q)[e] : 0.f;
      float s = v[0];
#pragma unroll
      for (int q = 1; q < kMaxSplits; ++q)
        if (q < S) s += v[q];
      if (bias != nullptr) s += to_f32(bias[cc]);
      y[(size_t)row * N + cc] = from_f32<T>(s);
    }
  }
  cluster.sync();                          // no rank leaves while read
}

template <typename T, int BB>
cudaError_t launch(const void* win, const void* w, const void* bias, void* y,
                   int B, int KC, int N, int vl_log2, int splits, int kps,
                   int vec, int pairs, cudaStream_t stream) {
  const int cols = (1 << vl_log2) * group_cols<T>();
  // the most a launch of this kernel takes: two buffers, the widest cols
  static std::atomic<uint64_t> attr_set{0};
  cudaError_t e = set_smem_once(
      attr_set, stmc_conv_kernel<T, BB>,
      sizeof(uint32_t) * smem_words<BB>(8 * group_cols<T>(),
                                        2 * win_words<BB>()));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * ((N + cols - 1) / cols), (B + BB - 1) / BB, 1);
  cfg.blockDim = dim3(block_threads<BB>(), 1, 1);
  cfg.dynamicSmemBytes = sizeof(uint32_t) * smem_words<BB>(cols, kps);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, stmc_conv_kernel<T, BB>, static_cast<const T*>(win),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), B, KC, N, vl_log2, kps, vec, pairs);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_rows(int rows, const void* win, const void* w,
                    const void* bias, void* y, int B, int KC, int N,
                    int vl_log2, int splits, int kps, int vec, int pairs,
                    cudaStream_t st) {
  switch (rows) {
    case 1: return launch<T, 1>(win, w, bias, y, B, KC, N, vl_log2, splits,
                                kps, vec, pairs, st);
    case 2: return launch<T, 2>(win, w, bias, y, B, KC, N, vl_log2, splits,
                                kps, vec, pairs, st);
    case 4: return launch<T, 4>(win, w, bias, y, B, KC, N, vl_log2, splits,
                                kps, vec, pairs, st);
    case 8: return launch<T, 8>(win, w, bias, y, B, KC, N, vl_log2, splits,
                                kps, vec, pairs, st);
    case 16: return launch<T, 16>(win, w, bias, y, B, KC, N, vl_log2, splits,
                                  kps, vec, pairs, st);
    case 32: return launch<T, 32>(win, w, bias, y, B, KC, N, vl_log2, splits,
                                  kps, vec, pairs, st);
    default: return cudaErrorInvalidValue;
  }
}

int log2_exact(int x) {
  int n = 0;
  while ((1 << n) < x) ++n;
  return (1 << n) == x ? n : -1;
}

}  // namespace

// window (B, KC) and w (KC, N) of one dtype, bias (N,) of that dtype or
// null, y (B, N) written in that dtype; KC = K*Cin. All contiguous. The
// plan (kernels/stmc_conv.py::stmc_plan): `cols` output columns a block (a
// power-of-two multiple, at most 8, of the 16-byte group), `splits` blocks
// a cluster (1, 2, 4 or 8) over ranges of `kps` rows of KC, `rows` rows of
// B a block (1, 2, ..., 32). Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_stmc_conv(const void* win, const void* w,
                               const void* bias, void* y, int B, int KC,
                               int N, int cols, int splits, int kps,
                               int rows, int dtype, void* stream) {
  if (B <= 0 || KC <= 0 || N <= 0 || kps <= 0 || rows <= 0 || rows > 32 ||
      log2_exact(splits) < 0 || splits > 8 ||
      (long long)splits * kps < KC || (long long)(splits - 1) * kps >= KC ||
      (B + rows - 1) / rows > 65535)
    return cudaErrorInvalidValue;
  const int esz = dtype == kBFloat16 ? 2 : dtype == kFloat32 ? 4 : 0;
  if (esz == 0) return cudaErrorInvalidValue;
  const int vl_log2 = log2_exact(cols * esz / 16);
  if (cols * esz % 16 || vl_log2 < 0 || vl_log2 > 3)
    return cudaErrorInvalidValue;
  // the 16-byte path: whole groups in every row, and aligned
  const int vec = (long long)N * esz % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // bf16 window pairs on 4-byte boundaries: every row, split and tile
  // starts at an even element
  const int pairs = esz == 4 || (KC % 2 == 0 && kps % 2 == 0 &&
                                 reinterpret_cast<uintptr_t>(win) % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_rows<__nv_bfloat16>(rows, win, w, bias, y, B, KC, N, vl_log2,
                                  splits, kps, vec, pairs, st);
  return by_rows<float>(rows, win, w, bias, y, B, KC, N, vl_log2, splits,
                        kps, vec, pairs, st);
}
