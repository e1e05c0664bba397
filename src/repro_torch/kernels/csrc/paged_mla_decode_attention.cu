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
// null page: it takes every discarded write, so its rows are dead.
//
// What bounds it on the H100: at the serving shape (B 4, clocks ~1088,
// L 512, R 64, bf16) the live rows are ~5 MB (~1.5 us at 3.35 TB/s) and the
// work 2*B*H*rows*(L+R+L) ~ 1.2 GFLOP (~1.2 us on the tensor cores): near
// balanced. This kernel runs its products as scalar float32 FMAs on the
// CUDA cores (67 TFLOP/s at most: >= ~18 us), so the FMA issue rate and the
// warp reductions bound it.
//
// Design (the float32 body of decode_common.cuh, without its split of S,
// with the 128 heads of a slot in place of the G heads of a KV head):
//  * grid (H / HB, B): a block owns HB = 4 query heads of one slot; their
//    q_lat / q_rope slices sit in registers (lane l holds latent dims
//    [l*L/32, (l+1)*L/32) and rope dims [l*R/32, ...)), so every latent +
//    rope row a warp loads is scored against all HB heads and then, as the
//    value, accumulated into all HB heads' outputs. The H/HB blocks of a
//    slot read the same rows; the first brings them from HBM, the others
//    find them in the 50 MB L2 (blockIdx.x is the head group, so the blocks
//    of one slot are scheduled together);
//  * each of the 8 warps walks every 8th pair of logical keys through
//    page_map[b, s / P], row s % P; a key is live iff its map entry is
//    > 0 && 0 <= pos <= t. Rows of the null page are never loaded (they
//    take 0), masked scores take the finite -1e30, the warps' (m, l, acc)
//    states merge in shared memory and the finalize divides by
//    max(l, 1e-30), so a free slot comes out finite;
//  * the dims are template parameters: (L, R) = (512, 64) for deepseek-v2
//    and (16, 8) for the small test stacks; float32 and bfloat16.
// What holds it back: scalar FMAs and a 5-step shuffle reduction per
// (head, key) instead of mma.sync/wgmma over a tile of keys, and the
// dependent page-id load at the head of every key pair.
#include "common.cuh"

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
      if (page > 0 && lat_live) {
        load_row<T, LPL>(lat_pool + pr * L + dl, lr[c]);
      } else {
#pragma unroll
        for (int j = 0; j < LPL; ++j) lr[c][j] = 0.f;
      }
      if (page > 0 && rope_live) {
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
cudaError_t launch(const void* ql, const void* qr, const void* lat,
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

template <typename T>
cudaError_t by_dims(int L, int R, const void* ql, const void* qr,
                    const void* lat, const void* rope, const void* pos,
                    const void* pm, const void* qpos, void* out, int B, int H,
                    int n_pp, int P, float scale, cudaStream_t st) {
  if (L == 512 && R == 64)
    return launch<T, 512, 64>(ql, qr, lat, rope, pos, pm, qpos, out, B, H,
                              n_pp, P, scale, st);
  if (L == 16 && R == 8)
    return launch<T, 16, 8>(ql, qr, lat, rope, pos, pm, qpos, out, B, H,
                            n_pp, P, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_lat (B, H, L); q_rope (B, H, R); lat_pool (n_pages, P, L); rope_pool
// (n_pages, P, R); pos_pool (n_pages, P) int32; page_map (B, n_pp) int32 of
// ids in [0, n_pages); qpos (B,) int32; out (B, H, L). All contiguous,
// 16-byte aligned; H a multiple of 4. Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_paged_mla_decode_attention(
    const void* q_lat, const void* q_rope, const void* lat_pool,
    const void* rope_pool, const void* pos_pool, const void* page_map,
    const void* qpos, void* out, int B, int H, int L, int R, int n_pp, int P,
    float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || H % HB || n_pp <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_dims<__nv_bfloat16>(L, R, q_lat, q_rope, lat_pool, rope_pool,
                                  pos_pool, page_map, qpos, out, B, H, n_pp,
                                  P, scale, st);
  if (dtype == kFloat32)
    return by_dims<float>(L, R, q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                          page_map, qpos, out, B, H, n_pp, P, scale, st);
  return cudaErrorInvalidValue;
}
