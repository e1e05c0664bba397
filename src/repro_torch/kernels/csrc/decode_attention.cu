// One-token GQA attention over dense ring KV caches, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (Pallas, grid (B, Hkv, k_blocks) with the k axis sequential and the online
// softmax carried in VMEM scratch across grid steps).
//
// What bounds it on the H100: the cache read. Each call streams the K and V
// rows once (B*S*Hkv*dh*2 elements) for ~4*G flops per element, far below
// the card's 295 flop/byte balance point, so the least time is the bytes
// over 3.35 TB/s.
//
// Design: flash-decoding, the body shared with the paged read in
// decode_common.cuh over DenseRows (slot b's row s is cache row b*S + s).
// The TPU's sequential k-grid becomes n_split blocks a (slot, KV head),
// each running the online softmax over its range of keys into a float32
// partial, and a combine kernel that merges the partials in split order.
// bf16 runs both products on mma.sync with the block's G heads as one m16
// row tile; float32 keeps the scalar body.
//
// What holds it back: at recurrentgemma's serving read a range is one tile
// of 64 keys, so a block's K/V copies and its products do not overlap; and
// the partials (2 * B * H * n_split * (dh + 2) floats through the scratch)
// and the combine launch are paid on every call.
#include "decode_common.cuh"

// q (B, H, dh); k, v (B, S, Hkv, dh); pos (B, S) int32; qpos (B,) int32;
// out (B, H, dh); scratch float32 of B * H * n_split * (dh + 2); n_split =
// ceil(S / split_keys); lse float32 (B, H) or null: the read's natural
// log-sum-exp, written by the combine (a (slot, head) that sees no live
// key then reads out 0 and lse -inf). All contiguous, 16-byte aligned.
// window <= 0: none. Returns the launches' cudaError_t (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* qpos, void* out,
                                      void* scratch, void* lse, int B, int S,
                                      int H, int Hkv, int DH, int window,
                                      float scale, int n_split,
                                      int split_keys, int dtype,
                                      void* stream) {
  const DecodeArgs a{q, k, v, static_cast<const int*>(qpos), out,
                     static_cast<float*>(scratch), B, S, H, Hkv, window,
                     n_split, split_keys, scale, static_cast<float*>(lse)};
  return decode_dispatch(a, DenseRows{static_cast<const int*>(pos), S}, DH,
                         dtype, stream);
}
