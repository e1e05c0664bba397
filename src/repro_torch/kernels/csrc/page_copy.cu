// Batched in-place page copy (the device half of copy-on-write), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/page_copy.py::copy_pages (Pallas,
// grid (n,) over the pair table, scalar-prefetched src/dst ids in the index
// maps, the pool aliased input to output so untouched pages never move).
//
// pool[dst[i]] = pool[src[i]] for every pair i of one pool leaf, bit for
// bit. Pairs with src == dst (the (0, 0) null-page padding) are skipped.
// The page allocator guarantees that no pair's dst is another pair's src
// (COW destinations are freshly allocated pages), so the pairs are
// independent and one launch is race-free.
//
// What bounds it on the H100: the bytes, one read and one write of each
// copied page (32 KB per page of a bf16 (16, 8, 128) K or V pool), so a
// step's few pairs are far below a microsecond of traffic and the launch
// itself dominates.
//
// Design: grid (n): one block of 256 threads per pair copies the page's row
// with 16-byte vector loads and stores when the row size allows it (bytes
// one at a time otherwise). Page ids outside [0, n_pages) are skipped: the
// wrapper's caller validates them on the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
copy_pages_kernel(char* __restrict__ pool, const int* __restrict__ srcs,
                  const int* __restrict__ dsts, int n_pages,
                  long long row_bytes) {
  const int s = srcs[blockIdx.x], d = dsts[blockIdx.x];
  if (s == d || s < 0 || d < 0 || s >= n_pages || d >= n_pages) return;
  const char* src = pool + (size_t)s * row_bytes;
  char* dst = pool + (size_t)d * row_bytes;
  if (row_bytes % 16 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += kThreads)
      d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += kThreads)
      dst[i] = src[i];
  }
}

}  // namespace

// pool (n_pages, ...) contiguous, 16-byte aligned, any dtype; row_bytes the
// bytes of one page; srcs, dsts (n,) int32. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_copy_pages(void* pool, const void* srcs,
                                const void* dsts, int n, int n_pages,
                                long long row_bytes, void* stream) {
  if (n < 0 || n_pages <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  copy_pages_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), static_cast<const int*>(srcs),
      static_cast<const int*>(dsts), n_pages, row_bytes);
  return cudaGetLastError();
}
