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
// Design: the dense read's body (decode_common.cuh) over PagedRows: the
// same split of the n_pp * P logical rows (the page size is not an input
// of the plan), the same key order and the same combine, so over the same
// logical rows the paged read adds the dense read's terms in its order and
// equals it bit for bit. A block reads its range's page ids and positions
// once, into shared memory, before its first K/V copy; a key is live iff
// its map entry is > 0 and 0 <= pos <= t (and pos > t - window). Rows
// reached through the null page are loaded and masked, as in the plain
// version's gathered view: a slot that sees no key averages V over all its
// logical rows, the null page's included.
//
// What holds it back: as the dense read — one 64-key tile a range at
// recurrentgemma's serving read, and the partials and combine launch of
// every call — plus the dependent page-id load at the head of each block.
#include "decode_common.cuh"

// q (B, H, dh); k, v pools (n_pages, P, Hkv, dh); pos pool (n_pages, P)
// int32; page_map (B, n_pp) int32 of ids in [0, n_pages); qpos (B,) int32;
// out (B, H, dh); scratch float32 of B * H * n_split * (dh + 2); n_split =
// ceil(n_pp * P / split_keys). All contiguous, 16-byte aligned. window
// <= 0: none. Returns the launches' cudaError_t (0 on success).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* pos,
    const void* page_map, const void* qpos, void* out, void* scratch, int B,
    int n_pp, int P, int H, int Hkv, int DH, int window, float scale,
    int n_split, int split_keys, int dtype, void* stream) {
  if (n_pp <= 0 || P <= 0) return cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, static_cast<const int*>(qpos), out,
                     static_cast<float*>(scratch), B, n_pp * P, H, Hkv,
                     window, n_split, split_keys, scale};
  return decode_dispatch(
      a, PagedRows{static_cast<const int*>(pos),
                   static_cast<const int*>(page_map), n_pp, P},
      DH, dtype, stream);
}
