// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t (the RG-LRU core of
// recurrentgemma's prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lru_scan.py::lru_scan (Pallas, grid
// (B, D/128, S/256) with the sequence axis innermost and sequential, the
// running state carried in VMEM scratch across sequence blocks).
//
// What bounds it on the H100: the bytes. A call reads a and x once and
// writes h once (3*B*S*D elements) for 2 flops per element, so its least
// time is those bytes over 3.35 TB/s: ~0.030 ms at the outer serving shape
// (1, 2040, 4096) in float32. The chain's arithmetic alone, one product
// and one sum a step (~8 cycles), would take ~9 us for 2040 steps.
//
// Design (lru_plan in kernels/lru_scan.py chooses the launch):
//  * one warp owns a chain: 32 consecutive channels of one batch row, so a
//    step's row is 128 bytes in float32 (64 in bf16); lane i walks channel
//    d0 + i from h0 (or 0) in order, the TPU kernel's order;
//  * every SM gets work: at B 1 and D 4096 the grid is 128 blocks of one
//    chain-warp on the 132 SMs (the old grid, 64 blocks of 64 threads,
//    left 68 idle); with more chains than SMs a block holds up to 8
//    chain-warps (B 4: 128 blocks of 4), each with its own ring;
//  * a and x reach the chain through a ring of 3 stages in dynamic shared
//    memory, a stage T steps of both (32 KB a warp at B 1: T = 128 in
//    float32, 256 in bf16), filled by 16-byte cp.async.cg copies in commit
//    groups two stages ahead of the steps, so 64 KB are in flight on every
//    SM; a lane's copies of a stage are a constant apart (Feed), so the
//    one warp spends few instructions on them (the first cut computed each
//    address: 0.047 ms at the outer shape, against 0.038 with Feed;
//    tools/lru_plan_reading.py found three 32 KB stages faster than more
//    or shorter ones);
//  * the product and the sum round separately (__fmul_rn, __fadd_rn: no FMA
//    contraction), as the plain version's two operations do, so in float32
//    the kernel equals the plain version bit for bit, and a scan of [0, S)
//    equals a scan of [0, k) then [k, S) from its last state; h_t is stored
//    in x's dtype straight to global memory, 128 (64) bytes a warp a step,
//    coalesced; the carry stays float32;
//  * the edge path (D not a multiple of 32, or a or x not 16-byte aligned)
//    keeps the same grid with plain loads: each lane loads its own channel
//    kU steps ahead into registers, and lanes past D return. It rounds as
//    the ring path does.
//
// What still holds it back: one warp an SM issues every copy, step and
// store of its chain, ~30 cycles a step, so bf16 (half the bytes) takes
// about float32's time; below 128 chains (B 1 at D < 4096) SMs sit idle.
//
// The backward (lru_scan_bwd_kernel, float32 only) replaces no TPU kernel:
// the reference differentiates its associative scan (repro/kernels/
// ref.py::lru_scan) with XLA. It is the same recurrence run from the end,
// on the forward's layout (a chain-warp a chain, the same plan for three
// streams: a, the cotangent g and h shifted by one step), and is bound by
// its bytes too: a, g, h read and dx, da written, ~84 MB at the training
// shape (8, 128, 4096), ~0.025 ms at 3.35 TB/s.
#include <atomic>

#include "common.cuh"
#include "mma.cuh"

using namespace repro_torch;

namespace {

constexpr int kChain = 32;       // channels a chain-warp
constexpr int kMaxWarps = 8;     // chain-warps a block
constexpr int kMaxStages = 8;    // cp_async_wait_n's reach
constexpr int kMaxSmem = 232448; // 227 KB, a block's most on the H100
constexpr int kU = 16;           // edge path: steps loaded ahead

// wait until at most n of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// A chain-warp's copies of N streams into its ring: lane i moves the
// 16-byte piece i % kRow of the rows i / kRow, i / kRow + kPass, ... of a
// stage, so a pass of the warp covers kPass whole rows and every address is
// the last one plus a constant (no per-copy index arithmetic: one warp
// issues all). Row t of a stage holds step t of each stream (the forward's
// a and x), the last stream's step t + kShift (the backward's h_{t-1} at
// kShift -1); a step outside [0, S) is zero-filled and never read.
template <typename T, int N, int kShift = 0>
struct Feed {
  static constexpr int kPer = 16 / sizeof(T);      // elements a copy
  static constexpr int kRow = kChain / kPer;       // copies a step's row
  static constexpr int kPass = 32 / kRow;          // rows a pass
  static constexpr int kPassBytes = kPass * kChain * sizeof(T);
  const T* src[N];     // this lane's piece of step 0 of its chain
  const T* zero;       // a valid address for the zero-filled rows
  size_t D;
  uint32_t ring;       // this lane's piece of row 0 of slot 0 (stream 0)
  uint32_t slot_bytes, tile_bytes;
  int S, r0, steps;

  // the steps [t0, t0 + steps) into `slot` as one commit group (an empty
  // one for a stage outside [0, S), so every lane always has stages-1
  // groups ahead)
  __device__ __forceinline__ void issue(int t0, int slot) const {
    if (t0 < S && t0 + steps > 0) {
      const size_t pass = (size_t)kPass * D;
      const uint32_t da = ring + slot * slot_bytes;
      const int passes = steps / kPass;
      if (t0 + kShift >= 0 && t0 + steps <= S) {
        const T* gp[N];
#pragma unroll
        for (int j = 0; j < N; ++j)
          gp[j] = src[j] +
                  (ptrdiff_t)(t0 + (j == N - 1 ? kShift : 0)) * (ptrdiff_t)D;
#pragma unroll 4
        for (int p = 0; p < passes; ++p) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            cp_async_16(da + j * tile_bytes + p * kPassBytes, gp[j], true);
            gp[j] += pass;
          }
        }
      } else {
        // a stage that crosses 0 or S
        for (int p = 0; p < passes; ++p) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const int rel = t0 + p * kPass + (j == N - 1 ? kShift : 0);
            const bool in = rel + r0 >= 0 && rel + r0 < S;
            cp_async_16(da + j * tile_bytes + p * kPassBytes,
                        in ? src[j] + (ptrdiff_t)rel * (ptrdiff_t)D : zero,
                        in);
          }
        }
      }
    }
    cp_async_commit();
  }
};

template <typename T, bool kEdge>
__global__ void __launch_bounds__(kMaxWarps * 32)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                const float* __restrict__ h0, T* __restrict__ h, int B,
                int S, int D, int stages, int steps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_row = (D + kChain - 1) / kChain;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= (long long)B * per_row) return;     // the whole warp
  const int b = (int)(chain / per_row);
  const int d0 = (int)(chain % per_row) * kChain;
  const int d = d0 + lane;
  const size_t row0 = (size_t)b * S * D;

  if constexpr (kEdge) {
    if (d >= D) return;
    const T* ab = a + row0 + d;
    const T* xb = x + row0 + d;
    T* hb = h + row0 + d;
    float st = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
    // raw elements, converted where used: a chunk's loads are all issued
    // before the first is waited on
    T ra[kU], rx[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (u < S) {
        ra[u] = ab[(size_t)u * D];
        rx[u] = xb[(size_t)u * D];
      }
    }
    for (int t0 = 0; t0 < S; t0 += kU) {
      T na[kU], nx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + kU + u;
        if (t < S) {
          na[u] = ab[(size_t)t * D];
          nx[u] = xb[(size_t)t * D];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u;
        if (t < S) {
          st = __fadd_rn(__fmul_rn(to_f32(ra[u]), st), to_f32(rx[u]));
          hb[(size_t)t * D] = from_f32<T>(st);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ra[u] = na[u];
        rx[u] = nx[u];
      }
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using F = Feed<T, 2>;
    const int r0 = lane / F::kRow;
    const size_t piece =
        row0 + (size_t)r0 * D + d0 + (lane % F::kRow) * F::kPer;
    T* ring = reinterpret_cast<T*>(smem_raw) +
              (size_t)warp * stages * 2 * steps * kChain;
    const F feed{{a + piece, x + piece}, a, (size_t)D,
                 smem_addr(ring + r0 * kChain + (lane % F::kRow) * F::kPer),
                 (uint32_t)(2 * steps * kChain * sizeof(T)),
                 (uint32_t)(steps * kChain * sizeof(T)), S, r0, steps};
    float st = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
    const int n_stages = (S + steps - 1) / steps;
    for (int k = 0; k < stages - 1; ++k) feed.issue(k * steps, k);
    int slot = 0, next = stages - 1;       // stage k's slot, k+stages-1's
    for (int k = 0; k < n_stages; ++k) {
      // every lane is done with the slot of stage k-1 before it refills
      __syncwarp();
      feed.issue((k + stages - 1) * steps, next);
      cp_async_wait_n(stages - 1);           // stage k has landed
      __syncwarp();                          // ... for every lane's copies
      const T* sa = ring + (size_t)slot * 2 * steps * kChain + lane;
      const T* sx = sa + steps * kChain;
      const int t0 = k * steps;
      const int n = min(steps, S - t0);
      T* hp = h + row0 + (size_t)t0 * D + d;
#pragma unroll 16
      for (int u = 0; u < n; ++u) {
        st = __fadd_rn(__fmul_rn(to_f32(sa[u * kChain]), st),
                       to_f32(sx[u * kChain]));
        hp[(size_t)u * D] = from_f32<T>(st);
      }
      slot = slot + 1 == stages ? 0 : slot + 1;
      next = next + 1 == stages ? 0 : next + 1;
    }
    cp_async_wait<0>();
  }
}

// The gradient of the recurrence, one chain-warp a chain as the forward,
// walking S from the end (float32 only: the RG-LRU trains on a float32
// scan): with g the cotangent of h,
//   c_t = g_t + a_{t+1} c_{t+1}   (c_S = 0),   dx_t = c_t,
//   da_t = c_t h_{t-1}            (h_{-1} = h0, or 0),   dh0 = a_0 c_0.
// The ring holds a, g and h shifted by one step (row t: h_{t-1}), filled
// from the end; the product and the sum round separately as the plain
// version's do, so kernel and plain agree bit for bit. dx and da are
// written in the same pass, coalesced; dh0 only where h0 was given.
template <bool kEdge>
__global__ void __launch_bounds__(kMaxWarps * 32)
lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ g,
                    const float* __restrict__ h, const float* __restrict__ h0,
                    float* __restrict__ dx, float* __restrict__ da,
                    float* __restrict__ dh0, int B, int S, int D, int stages,
                    int steps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_row = (D + kChain - 1) / kChain;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= (long long)B * per_row) return;     // the whole warp
  const int b = (int)(chain / per_row);
  const int d0 = (int)(chain % per_row) * kChain;
  const int d = d0 + lane;
  const size_t row0 = (size_t)b * S * D;
  if (kEdge && d >= D) return;
  const float hm1 = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  float* xp = dx + row0 + d;
  float* ap = da + row0 + d;
  float c = 0.f, an = 0.f;              // c_{t+1} and a_{t+1}

  if constexpr (kEdge) {
    const float* ab = a + row0 + d;
    const float* gb = g + row0 + d;
    const float* hb = h + row0 + d;
    // kU steps loaded ahead, from the end
    float ra[kU], rg[kU], rh[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = S - 1 - u;
      if (t >= 0) {
        ra[u] = ab[(size_t)t * D];
        rg[u] = gb[(size_t)t * D];
        rh[u] = t > 0 ? hb[(size_t)(t - 1) * D] : hm1;
      }
    }
    for (int t0 = S - 1; t0 >= 0; t0 -= kU) {
      float na[kU], ng[kU], nh[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 - kU - u;
        if (t >= 0) {
          na[u] = ab[(size_t)t * D];
          ng[u] = gb[(size_t)t * D];
          nh[u] = t > 0 ? hb[(size_t)(t - 1) * D] : hm1;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 - u;
        if (t >= 0) {
          c = __fadd_rn(__fmul_rn(an, c), rg[u]);
          xp[(size_t)t * D] = c;
          ap[(size_t)t * D] = __fmul_rn(c, rh[u]);
          an = ra[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ra[u] = na[u];
        rg[u] = ng[u];
        rh[u] = nh[u];
      }
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using F = Feed<float, 3, -1>;
    const int r0 = lane / F::kRow;
    const size_t piece =
        row0 + (size_t)r0 * D + d0 + (lane % F::kRow) * F::kPer;
    float* ring = reinterpret_cast<float*>(smem_raw) +
                  (size_t)warp * stages * 3 * steps * kChain;
    const F feed{{a + piece, g + piece, h + piece}, a, (size_t)D,
                 smem_addr(ring + r0 * kChain + (lane % F::kRow) * F::kPer),
                 (uint32_t)(3 * steps * kChain * sizeof(float)),
                 (uint32_t)(steps * kChain * sizeof(float)), S, r0, steps};
    const int n_stages = (S + steps - 1) / steps;
    // stage k: steps [S - (k+1) steps, S - k steps), walked downwards
    for (int k = 0; k < stages - 1; ++k) feed.issue(S - (k + 1) * steps, k);
    int slot = 0, next = stages - 1;       // stage k's slot, k+stages-1's
    for (int k = 0; k < n_stages; ++k) {
      // every lane is done with the slot of stage k-1 before it refills
      __syncwarp();
      feed.issue(S - (k + stages) * steps, next);
      cp_async_wait_n(stages - 1);           // stage k has landed
      __syncwarp();                          // ... for every lane's copies
      const float* sa = ring + (size_t)slot * 3 * steps * kChain + lane;
      const float* sg = sa + steps * kChain;
      const float* sh = sg + steps * kChain;
      const int t0 = S - (k + 1) * steps;
      const int lo = max(0, -t0);            // rows before step 0: none
#pragma unroll 16
      for (int u = steps - 1; u >= lo; --u) {
        const int t = t0 + u;
        const float hp = t > 0 ? sh[u * kChain] : hm1;
        c = __fadd_rn(__fmul_rn(an, c), sg[u * kChain]);
        xp[(size_t)t * D] = c;
        ap[(size_t)t * D] = __fmul_rn(c, hp);
        an = sa[u * kChain];
      }
      slot = slot + 1 == stages ? 0 : slot + 1;
      next = next + 1 == stages ? 0 : next + 1;
    }
    cp_async_wait<0>();
  }
  if (dh0 != nullptr) dh0[(size_t)b * D + d] = __fmul_rn(an, c);
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* h,
                   int B, int S, int D, int warps, int stages, int steps,
                   bool edge, cudaStream_t stream) {
  const long long chains = (long long)B * ((D + kChain - 1) / kChain);
  const long long blocks = (chains + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* ta = static_cast<const T*>(a);
  const T* tx = static_cast<const T*>(x);
  const float* th0 = static_cast<const float*>(h0);
  T* th = static_cast<T*>(h);
  if (edge) {
    lru_scan_kernel<T, true><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        ta, tx, th0, th, B, S, D, 0, 0);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)warps * stages * 2 * steps * kChain * sizeof(T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  cudaError_t e = set_smem_once(done, lru_scan_kernel<T, false>, kMaxSmem);
  if (e != cudaSuccess) return e;
  lru_scan_kernel<T, false><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      ta, tx, th0, th, B, S, D, stages, steps);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* a, const float* g, const float* h,
                       const float* h0, float* dx, float* da, float* dh0,
                       int B, int S, int D, int warps, int stages, int steps,
                       bool edge, cudaStream_t stream) {
  const long long chains = (long long)B * ((D + kChain - 1) / kChain);
  const long long blocks = (chains + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (edge) {
    lru_scan_bwd_kernel<true><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        a, g, h, h0, dx, da, dh0, B, S, D, 0, 0);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)warps * stages * 3 * steps * kChain *
                      sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  cudaError_t e = set_smem_once(done, lru_scan_bwd_kernel<false>, kMaxSmem);
  if (e != cudaSuccess) return e;
  lru_scan_bwd_kernel<false><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      a, g, h, h0, dx, da, dh0, B, S, D, stages, steps);
  return cudaGetLastError();
}

}  // namespace

// a, x, h (B, S, D) of one dtype; h0 (B, D) float32 or null (zeros). All
// contiguous. warps, stages, steps, edge: lru_plan's (stages and steps are
// not read on the edge path). The ring path needs D % 32 == 0, a and x
// 16-byte aligned and steps a multiple of 8. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_lru_scan(const void* a, const void* x, const void* h0,
                              void* h, int B, int S, int D, int warps,
                              int stages, int steps, int edge, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  if (!edge && (D % kChain || stages < 2 || stages > kMaxStages ||
                steps < 8 || steps % 8 ||
                reinterpret_cast<uintptr_t>(a) % 16 ||
                reinterpret_cast<uintptr_t>(x) % 16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(a, x, h0, h, B, S, D, warps, stages, steps,
                                 edge != 0, st);
  if (dtype == kFloat32)
    return launch<float>(a, x, h0, h, B, S, D, warps, stages, steps,
                         edge != 0, st);
  return cudaErrorInvalidValue;
}

// The backward: a, g (the cotangent of h), h (the forward's), dx, da (B, S,
// D) float32; h0 and dh0 (B, D) float32, both null or both given. All
// contiguous. warps, stages, steps, edge: lru_plan's for three streams
// (a, g, h); the ring path needs D % 32 == 0, a, g and h 16-byte aligned
// and steps a multiple of 8. Returns the launch's cudaError_t.
extern "C" int repro_lru_scan_bwd(const void* a, const void* g,
                                  const void* h, const void* h0, void* dx,
                                  void* da, void* dh0, int B, int S, int D,
                                  int warps, int stages, int steps, int edge,
                                  void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || warps < 1 || warps > kMaxWarps ||
      (h0 == nullptr) != (dh0 == nullptr))
    return cudaErrorInvalidValue;
  if (!edge && (D % kChain || stages < 2 || stages > kMaxStages ||
                steps < 8 || steps % 8 ||
                (reinterpret_cast<uintptr_t>(a) |
                 reinterpret_cast<uintptr_t>(g) |
                 reinterpret_cast<uintptr_t>(h)) % 16))
    return cudaErrorInvalidValue;
  return launch_bwd(static_cast<const float*>(a),
                    static_cast<const float*>(g),
                    static_cast<const float*>(h),
                    static_cast<const float*>(h0), static_cast<float*>(dx),
                    static_cast<float*>(da), static_cast<float*>(dh0), B, S,
                    D, warps, stages, steps, edge != 0,
                    static_cast<cudaStream_t>(stream));
}
