// Batched in-place page copy (the device half of copy-on-write), for Hopper
// (sm_90a): one launch for every pool leaf of a COW flush.
//
// Replaces the TPU kernel repro/kernels/page_copy.py::copy_pages (Pallas,
// grid (n,) over the pair table, scalar-prefetched src/dst ids in the index
// maps, the pool aliased input to output so untouched pages never move).
// The reference applies a step's COW set to every attention pool of a
// cache group in one dispatch; here one launch covers the pools of both
// page tables.
//
// pool[dst] = pool[src] for every pair of every leaf, bit for bit. Pairs
// with src == dst (the (0, 0) null-page padding) and ids outside
// [0, n_pages) are skipped. The page allocator guarantees that no pair's
// dst is another pair's src (COW destinations are freshly allocated pages)
// and leaves are distinct tensors, so the blocks touch disjoint bytes: one
// launch is race-free whatever order its blocks run in.
//
// What bounds it on the H100: the bytes, one read and one write of each
// copied page (32 KB a page of a bf16 (16, 8, 128) K or V pool, 16 KB of an
// MLA latent pool, 2 KB of rope, 64 B of positions). A flush over qwen3's
// 28 layers (k, v, pos each) with 4 pairs a table moves ~14.7 MB, ~4.4 us
// at 3.35 TB/s; one launch a leaf spent ~2.5 us a launch on 84 launches.
//
// Design: the wrapper packs one int64 table on the host and uploads it in
// one copy: n_leaves records of (base pointer, row bytes, pages, offset and
// count of the leaf's pairs), then the concatenated (src, dst) pairs.
// Grid (most pairs of a leaf, n_leaves): block (p, l) copies pair p of leaf
// l, 256 threads moving the page's row in 16-byte vectors, four loads in
// flight a thread, where the leaf's base and row bytes are multiples of 16
// (bytes one at a time otherwise).
//
// What still holds it back: a block per pair, so a leaf with fewer pairs
// than the most leaves idle blocks, and a 64-byte pos row keeps four
// threads of 256 busy; the host still packs and uploads the table once a
// flush.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 5;   // base, row bytes, pages, pair offset, pairs

__global__ void __launch_bounds__(kThreads)
copy_pages_kernel(const long long* __restrict__ table, int n_leaves) {
  const long long* leaf = table + (size_t)blockIdx.y * kFields;
  if ((long long)blockIdx.x >= leaf[4]) return;
  char* base = reinterpret_cast<char*>(leaf[0]);
  const long long row = leaf[1], n_pages = leaf[2];
  const long long* pair =
      table + (size_t)n_leaves * kFields + 2 * (leaf[3] + blockIdx.x);
  const long long s = pair[0], d = pair[1];
  if (s == d || s < 0 || d < 0 || s >= n_pages || d >= n_pages) return;
  const char* src = base + s * row;
  char* dst = base + d * row;
  if ((reinterpret_cast<uintptr_t>(base) | (uintptr_t)row) % 16 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const long long n = row / 16;
    long long i = threadIdx.x;
    for (; i + 3 * kThreads < n; i += 4 * kThreads) {
      const uint4 v0 = s4[i], v1 = s4[i + kThreads],
                  v2 = s4[i + 2 * kThreads], v3 = s4[i + 3 * kThreads];
      d4[i] = v0;
      d4[i + kThreads] = v1;
      d4[i + 2 * kThreads] = v2;
      d4[i + 3 * kThreads] = v3;
    }
    for (; i < n; i += kThreads) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < row; i += kThreads) dst[i] = src[i];
  }
}

}  // namespace

// table: the wrapper's packed int64 table on the device (n_leaves records,
// then the pairs); max_pairs: the most pairs of a leaf. Returns the
// launch's cudaError_t (0 on success).
extern "C" int repro_copy_pages(const void* table, int n_leaves,
                                int max_pairs, void* stream) {
  if (n_leaves < 0 || n_leaves > 65535 || max_pairs < 0)
    return cudaErrorInvalidValue;
  if (n_leaves == 0 || max_pairs == 0) return cudaSuccess;
  copy_pages_kernel<<<dim3(max_pairs, n_leaves), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves);
  return cudaGetLastError();
}
