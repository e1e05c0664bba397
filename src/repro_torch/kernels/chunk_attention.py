"""Chunked-prefill attention: C queries at absolute positions against
cache-plus-chunk keys at absolute positions.

Kernel: ``csrc/chunk_attention.cu`` (CUDA C++, sm_90a), which replaces the
TPU kernel ``repro/kernels/chunk_attention.py::chunk_attention``.

* Bound on the H100: at qwen3's serving chunk (q (1, 256, 16, 128) against
  Sk = 1088 ring + 256 chunk rows, 1024 of them live; the middle's
  (1, 128, 16, 128) against 768 + 128 frames) the live (query, key) pairs
  cost 4·H·dh flops each, ~1.9 GFLOP, against ~6 MB of q/k/v/o — about
  1.9 µs either way, bytes and operations balanced.
* Design (bfloat16, the serving dtype): flash attention on ``mma.sync``
  m16n8k16. A block's 64 rows are (query, head) pairs of one KV head — at
  qwen3's G 2, 32 queries × 2 heads — so each K/V tile is read once for
  all the heads that share it; each row's mask uses its query's position
  (``0 <= kp <= qp``, and ``kp > qp - window``). The key axis is split
  into ranges by :func:`chunk_split` (about two blocks an SM, from the
  shapes only); each range writes float32 partials that a second kernel
  merges in split order (no atomics: results repeat bit for bit). Ring
  rows carry no order, so instead of cutting tiles by index a block skips
  a 64-key tile no row of it can see (one position load and a warp vote;
  no copy, no product), which is bit-neutral for a row that sees a key; a
  block left with a row that sees no key at all walks its range again
  without skipping, so pad rows (``qp = -1``) still average V over every
  key, finite, as the reference does. float32 (the card-vs-CPU parity
  dtype) keeps the scalar body: grid ``(ceil(C/64), B*H)``, every key
  walked. Optional logit softcap before the mask.
* Held back by: each warp's tile is a chain with nothing to overlap its
  softmax; with the keys split, the partials' round trip and a second
  launch; the position mask on every tile.

``mla_chunk_attention`` is the absorbed-MLA chunk of deepseek-v2-style
stacks.

Kernel: ``csrc/mla_chunk_attention.cu`` (CUDA C++, sm_90a), which replaces
the TPU kernel ``repro/kernels/chunk_attention.py::mla_chunk_attention``.

* Bound on the H100: operations. At the serving chunk (C 256 against Sk
  1344, 1024 rows live, H 128, L 512, R 64) the live (query, key) pairs
  cost ``2·(L+R+L)`` flops per head, ~64 GFLOP (~63 µs on the tensor
  cores), against ~71 MB of q_lat, q_rope and out and ~1.2 MB of live
  latent rows (~22 µs at the memory rate).
* Design (bfloat16 at (512, 64)): MQA with G = 128 on ``mma.sync``. A
  block's 64 rows are 64 heads of one query, so they share one position
  and a 32-key latent|rope tile with no live key is skipped exactly (a
  pad query's block walks every tile). Q·Kᵀ over ``L+R`` columns gives
  both score terms; the value is the same tile's first ``L`` columns
  (``ldmatrix.trans``). O is 16 × 512 float32 a warp — too many registers
  — so 8 warps form two halves, each owning 256 output columns and the
  scores of 16 keys a tile; the halves meet through the row maxima and a
  bf16 P tile in shared memory (155,648 B: one block an SM). float32, and
  bfloat16 at the test stacks' (16, 8), keep the scalar body.
* Held back by: Q·Kᵀ reloads its Q and K fragments from shared memory at
  every k-step, so shared-memory reads set a tile's time; each block reads
  its query's live latent rows through L2.

The plain versions are ``ref.chunk_attention`` (re-exported here as
``plain``) and ``ref.mla_chunk_attention`` (``mla_plain``); a CPU tensor
takes them, a CUDA tensor launches the kernel or raises.
``chunk_attention.launches`` and ``mla_chunk_attention.launches`` count
wrapper calls that launched their kernels (a split ``chunk_attention``
launches the range kernel and its merge). :func:`chunk_walk` and
:func:`mla_chunk_walk` make the same launch with the bf16 body counting,
on the card, the key tiles each block skipped and walked again; they are
for measurement and are not counted.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import WAVE_BLOCKS

plain = ref.chunk_attention
mla_plain = ref.mla_chunk_attention

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# head widths the kernel is built for (80: h2o-danube-1.8b)
HEAD_DIMS = (16, 32, 64, 80, 128)

# the bf16 body's block: ROW_TILE (query, head) rows of one KV head, keys in
# tiles of KEY_TILE (a split's unit)
ROW_TILE = 64
KEY_TILE = 64


def chunk_split(b, c, sk, hkv, g):
    """``(n_split, keys_per_split)`` of a bf16 ``chunk_attention`` over ``b``
    slots of ``c`` queries, ``sk`` keys, ``hkv`` KV heads of ``g`` query
    heads each: range ``i`` takes keys ``[i·keys_per_split, min(sk,
    (i+1)·keys_per_split))``, whole 64-key tiles bar the last. The
    ``b·hkv·ceil(c·g/64)`` row blocks are multiplied by ``n_split`` up to
    at most ``WAVE_BLOCKS`` (two blocks on each of the H100's 132 SMs),
    when there are fewer; a function of the shapes only, so a chunk splits
    alike whatever its positions."""
    if min(b, c, sk, hkv, g) <= 0:
        raise ValueError(f"chunk_split: b={b}, c={c}, sk={sk}, hkv={hkv}, "
                         f"g={g}")
    blocks = b * hkv * -(-c * g // ROW_TILE)
    want = max(1, WAVE_BLOCKS // blocks)
    keys = -(-sk // want)
    keys = -(-keys // KEY_TILE) * KEY_TILE
    return -(-sk // keys), keys


def launch_plan(q, k):
    """``(n_split, keys_per_split, scratch shape or None)`` of
    ``chunk_attention`` on these tensors: bfloat16 splits the keys by
    :func:`chunk_split` and, split, takes a float32 scratch of the partials
    ``(B·C·H, n_split, dh)`` and their ``(m, l)`` ``(B·C·H, n_split, 2)``,
    flat; float32 walks all keys in one range."""
    b, c, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    if q.dtype != torch.bfloat16:
        return 1, -(-sk // KEY_TILE) * KEY_TILE, None
    n_split, keys = chunk_split(b, c, sk, hkv, h // hkv)
    return n_split, keys, ((b * c * h * n_split * (dh + 2),)
                           if n_split > 1 else None)


def _check_aligned(name, *tensors):
    """cp.async and the bf16 bodies' stores move 16 bytes: every base
    pointer and row (last-dim) stride must be a multiple of 16 bytes."""
    for t in tensors:
        if t.data_ptr() % 16 or t.shape[-1] * t.element_size() % 16:
            raise ValueError(f"{name}: a {tuple(t.shape)} {t.dtype} tensor "
                             f"at {t.data_ptr():#x} is not 16-byte aligned")


def _check_cuda(q, k, v, q_positions, k_positions):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,C,H,dh), (B,Sk,Hkv,dh)")
    b, c, h, dh = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if tuple(q_positions.shape) != (b, c):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != "
                         f"{(b, c)}")
    if tuple(k_positions.shape) != (b, sk):
        raise ValueError(f"k_positions {tuple(k_positions.shape)} != "
                         f"{(b, sk)}")
    if dh not in HEAD_DIMS:
        raise NotImplementedError(f"chunk_attention kernel takes dh in "
                                  f"{HEAD_DIMS}, got {dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunk_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    for name, t in (("q", q), ("k", k), ("v", v),
                    ("q_positions", q_positions),
                    ("k_positions", k_positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@_build.metered("chunk_attention")
def chunk_attention(q, k, v, q_positions, k_positions, *, window=None,
                    scale=None, logit_softcap=None):
    """q: (B, C, H, dh); k, v: (B, Sk, Hkv, dh) with H a multiple of Hkv;
    q_positions (B, C) and k_positions (B, Sk) int32 absolute positions,
    ``-1`` = empty. Returns (B, C, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k, v, q_positions, k_positions, window=window,
                     scale=scale, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_attention: unsupported device {q.device}")
    _build.refuse_grad("chunk_attention", q, k, v)
    _check_cuda(q, k, v, q_positions, k_positions)
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = _run_plan(q, k, v, q_positions, k_positions, launch_plan(q, k),
                    window=window, scale=scale, logit_softcap=logit_softcap)
    chunk_attention.launches += 1
    return out


chunk_attention.launches = 0


def chunk_walk(q, k, v, q_positions, k_positions, *, window=None,
               scale=None, logit_softcap=None):
    """One launch of the bf16 body, as :func:`chunk_attention` makes it,
    that also counts its walk on the card. Returns ``(out, walk)``:
    ``walk`` int32 ``(blocks, 3)``, each block's key tiles in its range,
    tiles it skipped and tiles it walked again. Not counted in
    ``launches``: a measurement, not the serving path."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"chunk_walk: the bf16 body on a CUDA device, got "
                         f"{q.dtype} on {q.device}")
    _check_cuda(q, k, v, q_positions, k_positions)
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    b, c, h, _ = q.shape
    hkv = k.shape[2]
    plan = launch_plan(q, k)
    blocks = -(-c * (h // hkv) // ROW_TILE) * b * hkv * plan[0]
    walk = torch.zeros((blocks, 3), dtype=torch.int32, device=q.device)
    out = _run_plan(q, k, v, q_positions, k_positions, plan, window=window,
                    scale=scale, logit_softcap=logit_softcap, walk=walk)
    return out, walk


def _run_plan(q, k, v, q_positions, k_positions, plan, *, window=None,
              scale=None, logit_softcap=None, walk=None):
    """One launch of the CUDA kernel (and its merge, split) on checked CUDA
    inputs and a given ``(n_split, keys_per_split, scratch shape)`` plan,
    :func:`launch_plan`'s in :func:`chunk_attention`; ``walk``, if given,
    takes the counts of :func:`chunk_walk`. Not counted in ``launches``."""
    b, c, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    n_split, keys, scratch_shape = plan
    scale = dh ** -0.5 if scale is None else float(scale)
    win = 0 if window is None else int(window)
    cap = 0.0 if not logit_softcap else float(logit_softcap)
    out = torch.empty_like(q)
    scratch = (torch.empty(scratch_shape, dtype=torch.float32,
                           device=q.device) if scratch_shape else None)
    if q.dtype == torch.bfloat16:
        _check_aligned("chunk_attention", q, k, v, out,
                       *([scratch] if scratch is not None else []))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().repro_chunk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        k_positions.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        walk.data_ptr() if walk is not None else None, b, c, sk, h, hkv, dh,
        win, scale, cap, n_split, keys,
        _build.DTYPE_CODES[_DTYPES[q.dtype]], stream)
    _build.check(rc, "chunk_attention")
    return out


# (L, R) latent and rope widths the MLA kernels are instantiated for:
# deepseek-v2's, and the small test stacks'
MLA_DIMS = ((512, 64), (16, 8))
# the widths of the bf16 tensor-core body (L + R a multiple of 16); the
# others run the scalar body in both dtypes
TENSOR_CORE_MLA_DIMS = (512, 64)
# the bf16 MLA body's block: MLA_HEAD_TILE heads of one query
MLA_HEAD_TILE = 64


def _check_mla_cuda(q_lat, q_rope, latent, rope, q_positions, k_positions,
                    out_dtype):
    if q_lat.dim() != 4 or q_rope.dim() != 4 or latent.dim() != 3 \
            or rope.dim() != 3:
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, latent "
                         f"{tuple(latent.shape)}, rope {tuple(rope.shape)}: "
                         f"want (B,C,H,L), (B,C,H,R), (B,Sk,L), (B,Sk,R)")
    b, c, h, lat_d = q_lat.shape
    r = q_rope.shape[-1]
    sk = latent.shape[1]
    if tuple(q_rope.shape[:3]) != (b, c, h) \
            or tuple(latent.shape) != (b, sk, lat_d) \
            or tuple(rope.shape) != (b, sk, r):
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, latent "
                         f"{tuple(latent.shape)}, rope {tuple(rope.shape)} "
                         f"do not match")
    if tuple(q_positions.shape) != (b, c):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != "
                         f"{(b, c)}")
    if tuple(k_positions.shape) != (b, sk):
        raise ValueError(f"k_positions {tuple(k_positions.shape)} != "
                         f"{(b, sk)}")
    if (lat_d, r) not in MLA_DIMS:
        raise NotImplementedError(f"mla_chunk_attention kernel takes (L, R) "
                                  f"in {MLA_DIMS}, got {(lat_d, r)}")
    dts = {q_lat.dtype, q_rope.dtype, latent.dtype, rope.dtype}
    if q_lat.dtype not in _DTYPES or len(dts) != 1:
        raise TypeError(f"mla_chunk_attention takes float32 or bfloat16 "
                        f"inputs of one dtype, got {sorted(map(str, dts))}")
    if out_dtype is not None and out_dtype != q_lat.dtype:
        raise TypeError(f"mla_chunk_attention kernel writes q_lat's dtype "
                        f"{q_lat.dtype}, asked for {out_dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope),
                    ("latent", latent), ("rope", rope),
                    ("q_positions", q_positions),
                    ("k_positions", k_positions)):
        if t.device != q_lat.device:
            raise ValueError(f"{name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@_build.metered("mla_chunk_attention")
def mla_chunk_attention(q_lat, q_rope, latent, rope, q_positions,
                        k_positions, *, scale, out_dtype=None):
    """q_lat: (B, C, H, L) (W_UK absorbed); q_rope: (B, C, H, R); latent:
    (B, Sk, L); rope: (B, Sk, R); q_positions (B, C) and k_positions
    (B, Sk) int32 absolute positions, ``-1`` = empty. Returns o_lat
    (B, C, H, L) in ``out_dtype`` (default q_lat's)."""
    if q_lat.device.type == "cpu":
        return mla_plain(q_lat, q_rope, latent, rope, q_positions,
                         k_positions, scale=scale, out_dtype=out_dtype)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_chunk_attention: unsupported device "
                         f"{q_lat.device}")
    _build.refuse_grad("mla_chunk_attention", q_lat, q_rope, latent, rope)
    _check_mla_cuda(q_lat, q_rope, latent, rope, q_positions, k_positions,
                    out_dtype)
    out = _mla_launch(q_lat, q_rope, latent, rope, q_positions, k_positions,
                      scale)
    mla_chunk_attention.launches += 1
    return out


mla_chunk_attention.launches = 0


def mla_chunk_walk(q_lat, q_rope, latent, rope, q_positions, k_positions, *,
                   scale):
    """One launch of the bf16 body at (512, 64), as
    :func:`mla_chunk_attention` makes it, that also counts its walk on the
    card. Returns ``(out, walk)``: ``walk`` int32 ``(blocks, 3)``, each
    block's key tiles, tiles it skipped and tiles it walked again. Not
    counted in ``launches``."""
    lat_d, r = q_lat.shape[-1], q_rope.shape[-1]
    if q_lat.device.type != "cuda" or q_lat.dtype != torch.bfloat16 \
            or (lat_d, r) != TENSOR_CORE_MLA_DIMS:
        raise ValueError(f"mla_chunk_walk: the bf16 body at "
                         f"{TENSOR_CORE_MLA_DIMS} on a CUDA device, got "
                         f"{q_lat.dtype} {(lat_d, r)} on {q_lat.device}")
    _check_mla_cuda(q_lat, q_rope, latent, rope, q_positions, k_positions,
                    None)
    b, c, h, _ = q_lat.shape
    blocks = -(-h // MLA_HEAD_TILE) * c * b
    walk = torch.zeros((blocks, 3), dtype=torch.int32, device=q_lat.device)
    out = _mla_launch(q_lat, q_rope, latent, rope, q_positions, k_positions,
                      scale, walk)
    return out, walk


def _mla_launch(q_lat, q_rope, latent, rope, q_positions, k_positions,
                scale, walk=None):
    """One launch of the MLA kernel on checked CUDA inputs; ``walk``, if
    given, takes the counts of :func:`mla_chunk_walk`."""
    b, c, h, lat_d = q_lat.shape
    r = q_rope.shape[-1]
    sk = latent.shape[1]
    out = torch.empty_like(q_lat)
    if q_lat.dtype == torch.bfloat16 and (lat_d, r) == TENSOR_CORE_MLA_DIMS:
        _check_aligned("mla_chunk_attention", q_lat, q_rope, latent, rope,
                       out)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    rc = _build.library().repro_mla_chunk_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), latent.data_ptr(),
        rope.data_ptr(), q_positions.data_ptr(), k_positions.data_ptr(),
        out.data_ptr(), walk.data_ptr() if walk is not None else None, b, c,
        sk, h, lat_d, r, float(scale),
        _build.DTYPE_CODES[_DTYPES[q_lat.dtype]], stream)
    _build.check(rc, "mla_chunk_attention")
    return out
