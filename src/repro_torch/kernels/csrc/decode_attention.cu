// One-token GQA attention over dense ring KV caches, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (Pallas, grid (B, Hkv, k_blocks) with the k axis sequential and the online
// softmax carried in VMEM scratch across grid steps).
//
// What bounds it on the H100: the cache read. Each call streams the whole K
// and V cache once (B*S*Hkv*dh*2 elements) and does ~4*G flops per element,
// far below the card's 295 flop/byte balance point, so the least time is the
// bytes over 3.35 TB/s.
//
// Design:
//  * grid (B, Hkv, G/GB): one block per (slot, KV head) keeps the G query
//    heads of that KV head together, so a KV row is read once for all G
//    heads and KV is never broadcast — up to G*DH = 1024; past that (MQA at
//    G 16, dh 256: recurrentgemma) each block keeps GB = 1024/DH of them
//    (4 heads, 64 float32 registers of q and acc a lane, 32 KB of shared
//    memory for the merge) and the G/GB blocks of a KV head share its rows
//    through L2;
//  * the TPU's sequential k-grid becomes a loop inside the block: each of the
//    8 warps walks every 8th chunk of kChunk keys (8; 4 at DH 256), keeping
//    its own running
//    max, denominator and accumulator in float32 registers; a lane owns dh/32
//    head dims, and a key's score is a warp shuffle reduction;
//  * a chunk's kChunk K and V rows are loaded before any is used, so each
//    warp keeps that many row loads in flight;
//  * the mask is the absolute-position lane: a key is live iff
//    pos >= 0 && pos <= t (&& pos > t - window); masked scores take the
//    finite -1e30, so an inactive slot (all pos == -1) comes out finite, the
//    uniform average of V, as in the reference;
//  * the warps' partial softmax states merge through shared memory and the
//    finalize divides by max(l, 1e-30).
//
// What holds it back: B*Hkv*G/GB blocks (32 at qwen3's serving batch of 4;
// 16 for recurrentgemma's single KV head at B 4) leave most of the 132 SMs
// idle; splitting S across blocks (flash-decoding) is the next step.
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
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ qpos, T* __restrict__ out,
                        int S, int Hkv, int window, float scale) {
  constexpr int P = (DH + 31) / 32;  // head dims per lane
  constexpr int GB = heads_per_block<G, DH>();
  constexpr int kChunk = chunk_keys<DH>();
  const int b = blockIdx.x, hk = blockIdx.y;
  const int h0 = hk * G + blockIdx.z * GB;   // first query head of the block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = Hkv * G;
  const int d0 = lane * P;
  const bool lane_live = d0 < DH;    // dh < 32 leaves lanes idle

  float qr[GB][P];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane_live) {
      load_f32<T, P>(q + ((size_t)b * H + (size_t)h0 + g) * DH + d0,
                     qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) qr[g][j] = 0.f;
    }
  }
  const int t = qpos[b];
  const size_t row = (size_t)Hkv * DH;     // stride between cache rows
  const T* kb = k + ((size_t)b * S * Hkv + hk) * DH + d0;
  const T* vb = v + ((size_t)b * S * Hkv + hk) * DH + d0;
  const int* pb = pos + (size_t)b * S;

  float m[GB], l[GB], acc[GB][P];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) acc[g][j] = 0.f;
  }

  for (int base = warp * kChunk; base < S; base += kWarps * kChunk) {
    float kr[kChunk][P], vr[kChunk][P];
    bool in_range[kChunk], live[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int s = base + c;
      in_range[c] = s < S;
      const int ps = in_range[c] ? pb[s] : -1;
      live[c] = in_range[c] && ps >= 0 && ps <= t &&
                (window <= 0 || ps > t - window);
      if (in_range[c] && lane_live) {
        load_f32<T, P>(kb + (size_t)s * row, kr[c]);
        load_f32<T, P>(vb + (size_t)s * row, vr[c]);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) kr[c][j] = vr[c][j] = 0.f;
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
        for (int j = 0; j < P; ++j) part += qr[g][j] * kr[c][j];
        const float dot = warp_sum(part);
        sc[c] = live[c] ? dot * scale : kNegInf;
        if (in_range[c]) cm = fmaxf(cm, sc[c]);
      }
      const float corr = expf(m[g] - cm);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = in_range[c] ? expf(sc[c] - cm) : 0.f;
        psum += p;
#pragma unroll
        for (int j = 0; j < P; ++j) acc[g][j] += p * vr[c][j];
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
      for (int j = 0; j < P; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
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
                   const void* pos, const void* qpos, void* out, int B, int S,
                   int Hkv, int window, float scale, cudaStream_t stream) {
  dim3 grid(B, Hkv, G / heads_per_block<G, DH>());
  decode_attention_kernel<T, G, DH><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(qpos), static_cast<T*>(out), S, Hkv, window,
      scale);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t by_dh(int DH, const void* q, const void* k, const void* v,
                  const void* pos, const void* qpos, void* out, int B, int S,
                  int Hkv, int window, float scale, cudaStream_t st) {
  switch (DH) {
    case 16: return launch<T, G, 16>(q, k, v, pos, qpos, out, B, S, Hkv,
                                     window, scale, st);
    case 32: return launch<T, G, 32>(q, k, v, pos, qpos, out, B, S, Hkv,
                                     window, scale, st);
    case 64: return launch<T, G, 64>(q, k, v, pos, qpos, out, B, S, Hkv,
                                     window, scale, st);
    case 128: return launch<T, G, 128>(q, k, v, pos, qpos, out, B, S, Hkv,
                                       window, scale, st);
    case 256: return launch<T, G, 256>(q, k, v, pos, qpos, out, B, S, Hkv,
                                       window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_g(int G, int DH, const void* q, const void* k, const void* v,
                 const void* pos, const void* qpos, void* out, int B, int S,
                 int Hkv, int window, float scale, cudaStream_t st) {
  switch (G) {
    case 1: return by_dh<T, 1>(DH, q, k, v, pos, qpos, out, B, S, Hkv,
                               window, scale, st);
    case 2: return by_dh<T, 2>(DH, q, k, v, pos, qpos, out, B, S, Hkv,
                               window, scale, st);
    case 4: return by_dh<T, 4>(DH, q, k, v, pos, qpos, out, B, S, Hkv,
                               window, scale, st);
    case 8: return by_dh<T, 8>(DH, q, k, v, pos, qpos, out, B, S, Hkv,
                               window, scale, st);
    case 16: return by_dh<T, 16>(DH, q, k, v, pos, qpos, out, B, S, Hkv,
                                 window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, dh); k, v (B, S, Hkv, dh); pos (B, S) int32; qpos (B,) int32;
// out (B, H, dh). All contiguous, 16-byte aligned. window <= 0: none.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* qpos, void* out, int B,
                                      int S, int H, int Hkv, int DH,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (dtype == kBFloat16)
    return by_g<__nv_bfloat16>(G, DH, q, k, v, pos, qpos, out, B, S, Hkv,
                               window, scale, st);
  if (dtype == kFloat32)
    return by_g<float>(G, DH, q, k, v, pos, qpos, out, B, S, Hkv, window,
                       scale, st);
  return cudaErrorInvalidValue;
}
