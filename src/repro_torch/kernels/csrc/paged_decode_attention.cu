// One-token GQA attention over paged KV pools, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/decode_attention.py::paged_decode_attention (Pallas, grid
// (B, Hkv, n_pp) with the page map scalar-prefetched into the K/V index
// maps, one page per sequential grid step, online softmax in VMEM scratch).
//
// Pools are (n_pages, P, Hkv, dh); slot b's logical row s lives in page
// page_map[b, s / P], row s % P. Page 0 is the null page: it takes every
// discarded write, so its contents are garbage and its rows are dead.
//
// What bounds it on the H100: the pool read. A call streams the K and V
// rows of the pages the slots map (B * n_pp * P rows of Hkv*dh at most) for
// ~4*G flops per element, far below the card's flop/byte balance, so the
// least time is those bytes over 3.35 TB/s.
//
// Design (decode_attention.cu with the key walk through the page map):
//  * grid (B, Hkv, G/GB): one block per (slot, KV head, group of GB query
//    heads) — all G of them up to G*DH = 1024, else 1024/DH — as in the
//    dense kernel; the heads of a block share every row read;
//  * each of the 8 warps walks every 8th chunk of 8 logical keys (4 at DH
//    256), in the dense kernel's order, so over the same logical rows the
//    paged read adds the same terms in the same order as the dense read;
//  * a key is live iff page_map entry > 0 && pos >= 0 && pos <= t
//    (&& pos > t - window); rows of the null page are never loaded (their
//    K/V take 0), masked scores take the finite -1e30, the warps' states
//    merge in shared memory and the finalize divides by max(l, 1e-30).
// What holds it back: B*Hkv*G/GB blocks (32 at qwen3's serving batch, 16 at
// recurrentgemma's) on 132 SMs — splitting S across blocks is later work —
// and a dependent load (page id, then row) at the head of every chunk.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kWarps = 8;

// Query heads a block keeps: all G of its KV head while their float32
// accumulators stay within 1024 per lane group (32 KB of shared memory for
// the warp merge), else 1024/DH of them; each block then takes one group
// of GB heads (grid z = G/GB). Every instantiation of G*DH <= 1024 has one
// group, as before.
template <int G, int DH>
__host__ __device__ constexpr int heads_per_block() {
  return G * DH <= 1024 ? G : 1024 / DH;
}

// Keys a warp loads before it scores them: 8, or 4 at DH 256, where 8
// would hold 128 K/V floats a lane in registers.
template <int DH>
__host__ __device__ constexpr int chunk_keys() { return DH >= 256 ? 4 : 8; }

template <typename T, int G, int DH>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ kpool,
                              const T* __restrict__ vpool,
                              const int* __restrict__ pospool,
                              const int* __restrict__ page_map,
                              const int* __restrict__ qpos,
                              T* __restrict__ out, int n_pp, int P, int Hkv,
                              int window, float scale) {
  constexpr int PL = (DH + 31) / 32;  // head dims per lane
  constexpr int GB = heads_per_block<G, DH>();
  constexpr int kChunk = chunk_keys<DH>();
  const int b = blockIdx.x, hk = blockIdx.y;
  const int h0 = hk * G + blockIdx.z * GB;   // first query head of the block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = Hkv * G;
  const int S = n_pp * P;            // logical rows of a slot
  const int d0 = lane * PL;
  const bool lane_live = d0 < DH;    // dh < 32 leaves lanes idle

  float qr[GB][PL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane_live) {
      load_f32<T, PL>(q + ((size_t)b * H + (size_t)h0 + g) * DH + d0,
                      qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < PL; ++j) qr[g][j] = 0.f;
    }
  }
  const int t = qpos[b];
  const size_t row = (size_t)Hkv * DH;     // stride between pool rows
  const T* kb = kpool + (size_t)hk * DH + d0;
  const T* vb = vpool + (size_t)hk * DH + d0;
  const int* pmb = page_map + (size_t)b * n_pp;

  float m[GB], l[GB], acc[GB][PL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) acc[g][j] = 0.f;
  }

  for (int base = warp * kChunk; base < S; base += kWarps * kChunk) {
    float kr[kChunk][PL], vr[kChunk][PL];
    bool in_range[kChunk], live[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int s = base + c;
      in_range[c] = s < S;
      const int page = in_range[c] ? pmb[s / P] : 0;
      const size_t pr = (size_t)page * P + s % P;   // pool row
      const int ps = page > 0 ? pospool[pr] : -1;
      live[c] = ps >= 0 && ps <= t && (window <= 0 || ps > t - window);
      if (page > 0 && lane_live) {
        load_f32<T, PL>(kb + pr * row, kr[c]);
        load_f32<T, PL>(vb + pr * row, vr[c]);
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
        sc[c] = live[c] ? dot * scale : kNegInf;
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

  // merge the warps' partial (m, l, acc) states
  __shared__ float sm_m[kWarps][GB], sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][DH];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (lane_live) {
#pragma unroll
      for (int j = 0; j < PL; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GB * DH; i += blockDim.x) {
    const int g = i / DH, d = i % DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    out[((size_t)b * H + (size_t)h0 + g) * DH + d] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, const void* pm, const void* qpos,
                   void* out, int B, int n_pp, int P, int Hkv, int window,
                   float scale, cudaStream_t stream) {
  dim3 grid(B, Hkv, G / heads_per_block<G, DH>());
  paged_decode_attention_kernel<T, G, DH><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(pm), static_cast<const int*>(qpos),
      static_cast<T*>(out), n_pp, P, Hkv, window, scale);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t by_dh(int DH, const void* q, const void* k, const void* v,
                  const void* pos, const void* pm, const void* qpos,
                  void* out, int B, int n_pp, int P, int Hkv, int window,
                  float scale, cudaStream_t st) {
  switch (DH) {
    case 16: return launch<T, G, 16>(q, k, v, pos, pm, qpos, out, B, n_pp, P,
                                     Hkv, window, scale, st);
    case 32: return launch<T, G, 32>(q, k, v, pos, pm, qpos, out, B, n_pp, P,
                                     Hkv, window, scale, st);
    case 64: return launch<T, G, 64>(q, k, v, pos, pm, qpos, out, B, n_pp, P,
                                     Hkv, window, scale, st);
    case 128: return launch<T, G, 128>(q, k, v, pos, pm, qpos, out, B, n_pp,
                                       P, Hkv, window, scale, st);
    case 256: return launch<T, G, 256>(q, k, v, pos, pm, qpos, out, B, n_pp,
                                       P, Hkv, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_g(int G, int DH, const void* q, const void* k, const void* v,
                 const void* pos, const void* pm, const void* qpos,
                 void* out, int B, int n_pp, int P, int Hkv, int window,
                 float scale, cudaStream_t st) {
  switch (G) {
    case 1: return by_dh<T, 1>(DH, q, k, v, pos, pm, qpos, out, B, n_pp, P,
                               Hkv, window, scale, st);
    case 2: return by_dh<T, 2>(DH, q, k, v, pos, pm, qpos, out, B, n_pp, P,
                               Hkv, window, scale, st);
    case 4: return by_dh<T, 4>(DH, q, k, v, pos, pm, qpos, out, B, n_pp, P,
                               Hkv, window, scale, st);
    case 8: return by_dh<T, 8>(DH, q, k, v, pos, pm, qpos, out, B, n_pp, P,
                               Hkv, window, scale, st);
    case 16: return by_dh<T, 16>(DH, q, k, v, pos, pm, qpos, out, B, n_pp, P,
                                 Hkv, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, dh); k, v pools (n_pages, P, Hkv, dh); pos pool (n_pages, P)
// int32; page_map (B, n_pp) int32 of ids in [0, n_pages); qpos (B,) int32;
// out (B, H, dh). All contiguous, 16-byte aligned. window <= 0: none.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* pos,
    const void* page_map, const void* qpos, void* out, int B, int n_pp,
    int P, int H, int Hkv, int DH, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || n_pp <= 0 || P <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (dtype == kBFloat16)
    return by_g<__nv_bfloat16>(G, DH, q, k, v, pos, page_map, qpos, out, B,
                               n_pp, P, Hkv, window, scale, st);
  if (dtype == kFloat32)
    return by_g<float>(G, DH, q, k, v, pos, page_map, qpos, out, B, n_pp, P,
                       Hkv, window, scale, st);
  return cudaErrorInvalidValue;
}
