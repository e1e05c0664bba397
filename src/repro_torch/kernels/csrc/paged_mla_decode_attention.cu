// One-token absorbed-MLA attention over paged latent pools, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/decode_attention.py::paged_mla_decode_attention (Pallas,
// grid (B, n_pp) with the page map scalar-prefetched into the latent / rope
// / position index maps, one page per sequential grid step, the online
// softmax of all H heads in VMEM scratch).
//
// q_lat (B, H, L) carries W_UK already, so a key's score is
//   (q_lat . latent_row + q_rope . rope_row) * scale
// and the value is the latent row itself: out (B, H, L). Pools are
// (n_pages, P, L), (n_pages, P, R) and (n_pages, P) positions; slot b's
// logical row s lives in page page_map[b, s / P], row s % P. Page 0 is the
// null page: it takes every discarded write, so its rows are dead. A key
// is live iff its map entry is > 0 and 0 <= pos <= t; masked scores take
// the finite -1e30, so a slot that sees no key averages the latent over
// its n_pp * P rows (the null page's included), as the plain version does.
//
// What bounds it on the H100: at the serving read (B 4, clocks ~1056,
// H 128, L 512, R 64, bf16) the live rows are ~5 MB (~1.5 us at 3.35 TB/s)
// and the work 2*B*H*rows*(L+R+L) ~ 1.2 GFLOP (~1.2 us on the tensor
// cores): near balanced. This is MQA with G = H = 128 heads on one latent
// head, d_qk 576, d_v 512.
//
// Two bodies, chosen by the element type (and the widths):
//
// bfloat16 at (L, R) = (512, 64) (the serving path): flash-decoding on
// mma.sync, the body of mla_chunk_attention.cu for one query.
//  * grid (ceil(H/64), n_split, B): kernels/decode_attention.py::mla_split
//    cuts a slot's n_pp * P logical rows (never a function of the page
//    size) into n_split ranges of keys_per_split (a multiple of 32) so that
//    the blocks, one an SM (~156 KB of shared memory), fit one wave
//    where they can (B 4 x 2 head groups x 12 ranges of 96 = 96 blocks at
//    the outer read). A block's 64 rows are 64 heads of the slot (heads
//    past H are zero rows, never stored);
//  * the block first reads its range's pool rows (page_map[b, s/P] * P +
//    s % P) into shared memory, then, while the first key tile is in
//    flight, the positions' live bits, a word of 32 a key tile. Its q_lat
//    | q_rope rows sit side by side in one shared tile, the key rows the
//    same way (latent then rope) in a 2-stage cp.async.cg ring of 32-key
//    tiles gathered through those rows (a tile spans two pages at P 16),
//    so one pass over L+R columns gives both score terms, and the value is
//    the tile's first L columns, read by ldmatrix.trans;
//  * 8 warps: warp (m-tile i, half h) owns head rows 16i.. and output
//    columns 256h.. (16 x 256 f32), and for S = Q K^T the keys 16h.. of a
//    tile. The halves' row maxima meet in shared memory, P rounded to bf16
//    goes through a shared 64 x 32 tile, both halves take it as the A
//    operand of P V. The online softmax runs in base 2 (ex2.approx);
//  * a tile whose keys are all dead (an unbacked page, a position outside
//    [0, t]) costs no copy and no product, bit-neutral for a block that
//    sees a key; a block that sees none walks its range again, so the
//    combine gives the plain version's average for a slot that sees no
//    key (the null page's rows are loaded and masked, as in the plain
//    version's gathered view);
//  * each block writes a float32 partial (m, l, acc[L]) a head to the
//    scratch the wrapper allocates; decode_common.cuh's combine merges the
//    n_split partials of each (slot, head) in split order, one block a
//    head. No atomics: results repeat bit for bit.
//  What holds it back: Q K^T reloads its Q and K fragments from shared
//  memory at every k-step, as in the chunk kernel (the split kernel takes
//  ~20 us for a block's 3 tiles at the outer read, with the prologue's two
//  dependent loads: page ids, then positions); one block an SM; and the
//  partials, 64 x 512 float32 a block (12.6 MB at the outer read), written
//  and read back by the combine, a second launch (~5 us).
//
// float32 (the dtype of the card-vs-CPU parity checks), and both dtypes at
// the test stacks' (16, 8): the scalar body on the CUDA cores, without a
// split of S.
//  * grid (H / HB, B): a block owns HB = 4 query heads of one slot; their
//    q_lat / q_rope slices sit in registers (lane l holds latent dims
//    [l*L/32, (l+1)*L/32) and rope dims [l*R/32, ...)), so every latent +
//    rope row a warp loads is scored against all HB heads and then, as the
//    value, accumulated into all HB heads' outputs;
//  * each of the 8 warps walks every 8th pair of logical keys through
//    page_map[b, s / P], row s % P, the null page's rows loaded and masked
//    (a slot that sees no key averages them too, as the plain version
//    does); the warps' (m, l, acc) states merge in shared memory and the
//    finalize divides by max(l, 1e-30).
#include <type_traits>

#include "decode_common.cuh"

using namespace repro_torch;

namespace {


constexpr int kWarps = 8;
constexpr int kChunk = 2;     // keys a warp holds in registers at once
constexpr int HB = 4;         // query heads of a block

// Loads P consecutive elements at p as float32, in 16-byte pieces where P
// fills them (p aligned to 16 bytes then), else as load_f32 does.
template <typename T, int P>
__device__ __forceinline__ void load_row(const T* p, float (&r)[P]) {
  constexpr int kPiece = 16 / sizeof(T);
  if constexpr (P > kPiece && P % kPiece == 0) {
#pragma unroll
    for (int c = 0; c < P / kPiece; ++c) {
      float part[kPiece];
      load_f32<T, kPiece>(p + c * kPiece, part);
#pragma unroll
      for (int j = 0; j < kPiece; ++j) r[c * kPiece + j] = part[j];
    }
  } else {
    load_f32<T, P>(p, r);
  }
}

template <int L>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kWarps * HB * (L + 2));
}

template <typename T, int L, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_mla_decode_attention_kernel(
    const T* __restrict__ q_lat, const T* __restrict__ q_rope,
    const T* __restrict__ lat_pool, const T* __restrict__ rope_pool,
    const int* __restrict__ pos_pool, const int* __restrict__ page_map,
    const int* __restrict__ qpos, T* __restrict__ out, int H, int n_pp,
    int P, float scale) {
  constexpr int LPL = (L + 31) / 32;   // latent dims per lane
  constexpr int RPL = (R + 31) / 32;   // rope dims per lane
  const int h0 = blockIdx.x * HB, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = n_pp * P;             // logical rows of a slot
  const int dl = lane * LPL, dr = lane * RPL;
  const bool lat_live = dl < L, rope_live = dr < R;

  float qL[HB][LPL], qR[HB][RPL];
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    const size_t row = (size_t)b * H + h0 + g;
    if (lat_live) {
      load_row<T, LPL>(q_lat + row * L + dl, qL[g]);
    } else {
#pragma unroll
      for (int j = 0; j < LPL; ++j) qL[g][j] = 0.f;
    }
    if (rope_live) {
      load_row<T, RPL>(q_rope + row * R + dr, qR[g]);
    } else {
#pragma unroll
      for (int j = 0; j < RPL; ++j) qR[g][j] = 0.f;
    }
  }
  const int t = qpos[b];
  const int* pmb = page_map + (size_t)b * n_pp;

  float m[HB], l[HB], acc[HB][LPL];
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < LPL; ++j) acc[g][j] = 0.f;
  }

  for (int base = warp * kChunk; base < S; base += kWarps * kChunk) {
    float lr[kChunk][LPL], rr[kChunk][RPL];
    bool in_range[kChunk], live[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int s = base + c;
      in_range[c] = s < S;
      const int page = in_range[c] ? pmb[s / P] : 0;
      const size_t pr = (size_t)page * P + s % P;   // pool row
      const int ps = page > 0 ? pos_pool[pr] : -1;
      live[c] = ps >= 0 && ps <= t;
      if (in_range[c] && lat_live) {
        load_row<T, LPL>(lat_pool + pr * L + dl, lr[c]);
      } else {
#pragma unroll
        for (int j = 0; j < LPL; ++j) lr[c][j] = 0.f;
      }
      if (in_range[c] && rope_live) {
        load_row<T, RPL>(rope_pool + pr * R + dr, rr[c]);
      } else {
#pragma unroll
        for (int j = 0; j < RPL; ++j) rr[c][j] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      float sc[kChunk];
      float cm = m[g];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < LPL; ++j) part += qL[g][j] * lr[c][j];
#pragma unroll
        for (int j = 0; j < RPL; ++j) part += qR[g][j] * rr[c][j];
        const float dot = warp_sum(part);
        sc[c] = live[c] ? dot * scale : kNegInf;
        if (in_range[c]) cm = fmaxf(cm, sc[c]);
      }
      const float corr = expf(m[g] - cm);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < LPL; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = in_range[c] ? expf(sc[c] - cm) : 0.f;
        psum += p;
#pragma unroll
        for (int j = 0; j < LPL; ++j) acc[g][j] += p * lr[c][j];
      }
      l[g] = l[g] * corr + psum;
      m[g] = cm;
    }
  }

  // merge the warps' partial (m, l, acc) states
  extern __shared__ float smem[];
  float* sm_m = smem;                       // [kWarps][HB]
  float* sm_l = sm_m + kWarps * HB;         // [kWarps][HB]
  float* sm_acc = sm_l + kWarps * HB;       // [kWarps][HB][L]
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    if (lane == 0) {
      sm_m[warp * HB + g] = m[g];
      sm_l[warp * HB + g] = l[g];
    }
    if (lat_live) {
#pragma unroll
      for (int j = 0; j < LPL; ++j)
        sm_acc[((size_t)warp * HB + g) * L + dl + j] = acc[g][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HB * L; i += blockDim.x) {
    const int g = i / L, d = i % L;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * HB + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * HB + g] - mx);
      den += sm_l[w * HB + g] * c;
      num += sm_acc[((size_t)w * HB + g) * L + d] * c;
    }
    out[((size_t)b * H + h0 + g) * L + d] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int L, int R>
cudaError_t scalar_launch(const void* ql, const void* qr, const void* lat,
                   const void* rope, const void* pos, const void* pm,
                   const void* qpos, void* out, int B, int H, int n_pp, int P,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<L>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      paged_mla_decode_attention_kernel<T, L, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H / HB, B);
  paged_mla_decode_attention_kernel<T, L, R>
      <<<grid, kWarps * 32, bytes, stream>>>(
          static_cast<const T*>(ql), static_cast<const T*>(qr),
          static_cast<const T*>(lat), static_cast<const T*>(rope),
          static_cast<const int*>(pos), static_cast<const int*>(pm),
          static_cast<const int*>(qpos), static_cast<T*>(out), H, n_pp, P,
          scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The bfloat16 body: mma.sync m16n8k16 on the tensor cores, S split
// ---------------------------------------------------------------------------
namespace tensor_cores {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps: 4 m-tiles x 2 halves
constexpr int kRows = 64;              // heads of one slot a block
constexpr int kTileKeys = 32;          // keys a tile: 16 a half
constexpr int kStages = 2;             // depth of the latent | rope ring
constexpr int kPad = 8;                // bf16 per row of padding (16 bytes)
constexpr int kLP = kTileKeys + kPad;  // row of the P tile
// keys a range holds at most (kernels/decode_attention.py::
// MLA_MAX_SPLIT_KEYS): their pool rows and live bits sit in shared memory
constexpr int kMaxRangeKeys = 2048;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bf16* q_lat;    // (B, H, L)
  const bf16* q_rope;   // (B, H, R)
  const bf16* lat;      // (n_pages, P, L)
  const bf16* rope;     // (n_pages, P, R)
  const int* pos;       // (n_pages, P)
  const int* page_map;  // (B, n_pp)
  const int* qpos;      // (B,)
  float* scratch;       // acc (B, H, n_split, L), then (m, l) (.., 2)
  int B, H, n_pp, P, n_split, split_keys;
  float scale;
};

template <int L, int R>
constexpr size_t tile_bytes() {
  // the Q tile, the stages of latent | rope, the P tile, then both halves'
  // row maxima and row sums
  return sizeof(bf16) * ((size_t)(kRows + kStages * kTileKeys) *
                             (L + R + kPad) +
                         (size_t)kRows * kLP) +
         sizeof(float) * 4 * kRows;
}

// ... then the live bits of a range's tiles (a word a tile) and its pool
// rows
constexpr int kMaxRangeTiles = kMaxRangeKeys / kTileKeys;
template <int L, int R>
size_t smem_bytes(int keys) {
  return tile_bytes<L, R>() + sizeof(int) * ((size_t)kMaxRangeTiles + keys);
}

template <int L, int R>
__global__ void __launch_bounds__(kThreads, 1)
paged_mla_decode_attention_kernel(Args a) {
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
  unsigned* sMask = reinterpret_cast<unsigned*>(sSum + 2 * kRows);
  int* sRow = reinterpret_cast<int*>(sMask + kMaxRangeTiles);  // pool rows

  const int h0 = blockIdx.x * kRows, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // fragment row group, column pair
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix row, matrix
  const int row0 = (warp % 4) * 16;         // the warp's m-tile
  const int half = warp / 4;                // its keys of a tile, columns of O
  const int P = a.P;
  const int s0 = blockIdx.y * a.split_keys;
  const int n_keys = min(a.split_keys, a.n_pp * P - s0);
  const int n_tiles = (n_keys + kTileKeys - 1) / kTileKeys;
  const size_t q_head0 = (size_t)b * a.H;

  // copy group 0: the q_lat | q_rope rows of the block's heads (heads past
  // H zero-filled)
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = h0 + r < a.H;
    const size_t row = in ? q_head0 + h0 + r : 0;
    const bf16* src = c < kLatChunks
                          ? a.q_lat + row * L + c * 8
                          : a.q_rope + row * R + (c - kLatChunks) * 8;
    cp_async_16(smem_addr(sQ + r * LD + c * 8), src, in);
  }
  cp_async_commit();
  // the range's pool rows, the null page's included (rows < P)
  const int* pmb = a.page_map + (size_t)b * a.n_pp;
  for (int i = tid; i < n_keys; i += kThreads) {
    const int s = s0 + i;
    sRow[i] = pmb[s / P] * P + s % P;
  }
  __syncthreads();

  // key tile j into stage j % kStages (rows past the range zero-filled)
  auto load_keys = [&](int j) {
    const int first = j * kTileKeys;
    bf16* d = sK + (j % kStages) * kTileKeys * LD;
    // one copy's address live at a time: the O accumulators hold 128
    // registers a thread here
#pragma unroll 1
    for (int it = 0; it < kTileKeys * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const int key = first + r;
      const bool in = key < n_keys;
      const size_t row = in ? sRow[key] : 0;
      const bf16* src = c < kLatChunks
                            ? a.lat + row * L + c * 8
                            : a.rope + row * R + (c - kLatChunks) * 8;
      cp_async_16(smem_addr(d + r * LD + c * 8), src, in);
    }
  };
  // tile 0 is copied before its vote (a dead one costs a copy, not a wait)
  load_keys(0);
  cp_async_commit();
  // the live bits of tile j's keys, one word (bit = key in the tile): a
  // backed row (map entry > 0) at a position in [0, t]
  const int tq = a.qpos[b];
  for (int j = warp; j < n_tiles; j += kThreads / 32) {
    const int key = j * kTileKeys + lane;
    bool live = false;
    if (key < n_keys && sRow[key] >= P) {
      const int p = a.pos[sRow[key]];
      live = p >= 0 && p <= tq;
    }
    const unsigned bits = __ballot_sync(kFull, live);
    if (lane == 0) sMask[j] = bits;
  }
  __syncthreads();

  // does a key of tile j live? (every thread alike)
  auto tile_live = [&](int j) { return sMask[j] != 0u; };

  const float scale2 = a.scale * kLog2e;
  const float past = __int_as_float(0xff800000);   // -inf: keys past the range
  float o[NO][4];
  // rows g and g + 8 of the warp's m-tile: running max (logit x log2 e,
  // alike in both halves) and this thread's share of the running sum
  float m[2], l[2];

  // pass 0 skips dead tiles; pass 1, if the block saw no key, walks every
  // tile
  for (int pass = 0;; ++pass) {
    const bool skip = pass == 0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    if (!skip) {                 // no tile was read: stage 0 is free
      cp_async_wait<0>();
      load_keys(0);
      cp_async_commit();
    }
    bool live_cur = !skip || tile_live(0);
    bool skipped = !live_cur;

    for (int j = 0; j < n_tiles; ++j) {
      const bool has_nxt = j + 1 < n_tiles;
      const bool live_nxt = has_nxt && (!skip || tile_live(j + 1));
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
      if (live_cur) {
        const int k0 = j * kTileKeys;
        const bf16* tK = sK + (j % kStages) * kTileKeys * LD;
        const unsigned live_bits = sMask[j];

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
        // at tile keys 16 half + 8n + 2t (+1)
        float x[2][4], rmax[2] = {past, past};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int kk = half * 16 + n * 8 + 2 * t + e1;
            const bool in = k0 + kk < n_keys;
            const bool allow = (live_bits >> kk) & 1u;
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
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(kFull, rmax[r], 1));
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(kFull, rmax[r], 2));
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
        // P = 2^(x - m) (0 past the range), rounded to bf16 into the P tile
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
      live_cur = live_nxt;
    }
    // the block saw no key after tiles were skipped: walk every tile
    if (!skipped || !__syncthreads_or(m[0] == kNegInf)) break;
  }
  cp_async_wait<0>();            // a dead tile's copy may be in flight

  // the row sums: over the quad, then over the halves in half order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if (t == 0) {
    sSum[half * kRows + row0 + g] = l[0];
    sSum[half * kRows + row0 + g + 8] = l[1];
  }
  __syncthreads();
  // the partial of each head: (m, l) and the unnormalised O, float32
  float* ml = a.scratch + (size_t)a.B * a.H * a.n_split * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = blockIdx.x * kRows + row0 + g + 8 * r;
    const int row = row0 + g + 8 * r;
    if (h >= a.H) continue;
    const size_t rec =
        ((size_t)blockIdx.z * a.H + h) * a.n_split + blockIdx.y;
    if (half == 0 && t == 0)
      *reinterpret_cast<float2*>(ml + rec * 2) =
          make_float2(m[r], sSum[row] + sSum[kRows + row]);
    float* ob = a.scratch + rec * L + half * LH + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(ob + n * 8) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

template <int L, int R>
cudaError_t launch(const Args& a, void* out, cudaStream_t stream) {
  // cp.async moves 16 bytes at a time (every row stride, L or R bf16, is a
  // multiple of 16 bytes); the partials go out as float2
  if ((reinterpret_cast<uintptr_t>(a.q_lat) |
       reinterpret_cast<uintptr_t>(a.q_rope) |
       reinterpret_cast<uintptr_t>(a.lat) |
       reinterpret_cast<uintptr_t>(a.rope) |
       reinterpret_cast<uintptr_t>(a.scratch)) % 16)
    return cudaErrorMisalignedAddress;
  const long long S = (long long)a.n_pp * a.P;
  if (a.split_keys <= 0 || a.split_keys > kMaxRangeKeys ||
      a.n_split != (S + a.split_keys - 1) / a.split_keys ||
      a.n_split > kMaxSplits || a.n_split > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  void (*kernel)(Args) = paged_mla_decode_attention_kernel<L, R>;
  static std::atomic<uint64_t> attr_set{0};
  cudaError_t e = set_smem_once(attr_set, kernel,
                                smem_bytes<L, R>(kMaxRangeKeys));
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.H + kRows - 1) / kRows, a.n_split, a.B), kThreads,
           smem_bytes<L, R>(a.split_keys), stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int bh = a.B * a.H;
  decode_combine_kernel<bf16, true><<<bh, 256, 0, stream>>>(
      a.scratch, a.scratch + (size_t)bh * a.n_split * L,
      static_cast<bf16*>(out), a.n_split, L, nullptr);
  return cudaGetLastError();
}

}  // namespace tensor_cores

template <typename T>
cudaError_t by_dims(int L, int R, const void* ql, const void* qr,
                    const void* lat, const void* rope, const void* pos,
                    const void* pm, const void* qpos, void* out,
                    void* scratch, int B, int H, int n_pp, int P,
                    float scale, int n_split, int split_keys,
                    cudaStream_t st) {
  if (L == 512 && R == 64) {
    if constexpr (std::is_same<T, bf16>::value) {
      const tensor_cores::Args a{
          static_cast<const bf16*>(ql), static_cast<const bf16*>(qr),
          static_cast<const bf16*>(lat), static_cast<const bf16*>(rope),
          static_cast<const int*>(pos), static_cast<const int*>(pm),
          static_cast<const int*>(qpos), static_cast<float*>(scratch), B, H,
          n_pp, P, n_split, split_keys, scale};
      return tensor_cores::launch<512, 64>(a, out, st);
    } else {
      if (n_split != 1 || H % HB) return cudaErrorInvalidValue;
      return scalar_launch<T, 512, 64>(ql, qr, lat, rope, pos, pm, qpos, out,
                                       B, H, n_pp, P, scale, st);
    }
  }
  // the scalar body in both dtypes: one range, H a multiple of HB
  if (n_split != 1 || H % HB) return cudaErrorInvalidValue;
  if (L == 16 && R == 8)
    return scalar_launch<T, 16, 8>(ql, qr, lat, rope, pos, pm, qpos, out, B,
                                   H, n_pp, P, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_lat (B, H, L); q_rope (B, H, R); lat_pool (n_pages, P, L); rope_pool
// (n_pages, P, R); pos_pool (n_pages, P) int32; page_map (B, n_pp) int32 of
// ids in [0, n_pages); qpos (B,) int32; out (B, H, L). All contiguous,
// 16-byte aligned. bfloat16 at (512, 64): scratch float32 of B * H *
// n_split * (L + 2), n_split = ceil(n_pp * P / split_keys) (kernels/
// decode_attention.py::mla_split); else scratch null, n_split 1 and H a
// multiple of 4. Returns the launches' cudaError_t (0 on success).
extern "C" int repro_paged_mla_decode_attention(
    const void* q_lat, const void* q_rope, const void* lat_pool,
    const void* rope_pool, const void* pos_pool, const void* page_map,
    const void* qpos, void* out, void* scratch, int B, int H, int L, int R,
    int n_pp, int P, float scale, int n_split, int split_keys, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || n_pp <= 0 || P <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(L, R, q_lat, q_rope, lat_pool, rope_pool,
                                  pos_pool, page_map, qpos, out, scratch, B,
                                  H, n_pp, P, scale, n_split, split_keys, st);
  if (dtype == kFloat32)
    return by_dims<float>(L, R, q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                          page_map, qpos, out, scratch, B, H, n_pp, P, scale,
                          n_split, split_keys, st);
  return cudaErrorInvalidValue;
}
