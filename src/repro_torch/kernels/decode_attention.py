"""Single-token decode attention against a dense ring KV cache, and
against paged KV pools.

Kernel: ``csrc/decode_attention.cu`` (CUDA C++, sm_90a; the body shared
with the paged read is ``csrc/decode_common.cuh``), which replaces the TPU
kernel ``repro/kernels/decode_attention.py::decode_attention``.

* Bound on the H100: the cache read. A call streams K and V once
  (``2*B*S*Hkv*dh`` elements) for ~4·G flops per element, so its least time
  is those bytes over the 3.35 TB/s memory rate.
* Design: flash-decoding. :func:`decode_split` cuts a slot's S rows into
  ``n_split`` ranges of ``keys_per_split`` (a multiple of 64) so that about
  two blocks an SM run (grid ``(B, Hkv·G/GB, n_split)``, GB the heads
  of a block: all G in bf16, in float32 the most that divide G within
  1024/dh); each block
  runs a float32 online softmax over its range and writes a partial
  ``(m, l, acc)`` per head to a float32 scratch (:func:`scratch_shape`),
  and a second kernel merges the partials in split order (no atomics). In
  bf16 a block holds the G ≤ 16 query heads of one KV head as the 16 rows
  of one ``mma.sync`` m16n8k16 tile: Q·Kᵀ and P·V run on the tensor cores
  over 64-key tiles that ``cp.async`` brings in (bf16 converted inside the
  product, never at the load). float32 keeps the scalar body (8 warps, a
  shuffle reduction per key and head) for the card-vs-CPU parity. The mask
  is the absolute-position lane (with the window test on a wrapped ring),
  ``-1`` marks an empty slot, and masked scores take the finite ``-1e30``
  — an inactive slot comes out finite, as in the reference.
* Held back by: a range of one 64-key tile at recurrentgemma's serving
  read (no overlap of a block's copies and products), and the partials
  and the combine launch that every call pays.
* ``return_lse=True`` (tensor-parallel serving, the KV sequence split over
  the model axis): the combine kernel also writes the merged log-sum-exp
  ``m + log l`` (B, H) float32 from the partials it already holds, and a
  (slot, head) that saw no live key reads out 0 and lse -inf, so a merge
  across shards (``ref.merge_partials``) weighs it 0. The same launches;
  without the flag the outputs are unchanged. Each rank reads its S/M
  rows, and ``decode_split`` plans them as any S: a shard that is not a
  multiple of 64 rows ends in a shorter last range, as a ring of that
  length would.

``paged_decode_attention`` is the same read over paged pools.

Kernel: ``csrc/paged_decode_attention.cu`` (CUDA C++, sm_90a), which
replaces the TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention``.

* Bound on the H100: the pool read — the K/V rows of the pages the slots
  map, once, over the 3.35 TB/s memory rate.
* Design: the dense read's body over ``page_map[b, s/P]``, row ``s % P`` of
  that page, with the same split of the ``n_pp·P`` logical rows (the page
  size is not an input of the plan), the same key order and the same
  combine: over the same logical rows it equals the dense read bit for
  bit. A block reads its range's page ids and positions once, before its
  first K/V copy. A key is live iff its map entry is ``> 0`` and ``0 <= pos
  <= t`` (and ``pos > t - window``); rows reached through the null page are
  loaded and masked, as in the plain version's gathered view, so a slot
  that sees no key averages V over them too.
* Held back by: as the dense read, plus the dependent page-id load at the
  head of each block.

``paged_mla_decode_attention`` is the absorbed-MLA read of deepseek-v2's
latent pools.

Kernel: ``csrc/paged_mla_decode_attention.cu`` (CUDA C++, sm_90a), which
replaces the TPU kernel
``repro/kernels/decode_attention.py::paged_mla_decode_attention``.

* Bound on the H100: near balanced at the serving read (B 4, clocks
  ~1056, H 128, L 512, R 64, bf16): ~5 MB of live latent + rope rows
  (~1.5 µs) against ~1.2 GFLOP (~1.2 µs on the tensor cores).
* Design, bf16 at (L, R) = (512, 64): flash-decoding on ``mma.sync``, the
  bf16 body of ``mla_chunk_attention`` for one query. :func:`mla_split`
  cuts a slot's ``n_pp·P`` logical rows (never a function of the page
  size) into ranges of a multiple of 32 keys so that the blocks — 64 heads
  of one slot over one range, one block an SM — fit one wave where they
  can (:func:`paged_mla_launch_plan`: 12 ranges of 96 at the outer read,
  96 blocks). A block reads its range's pool rows (``page_map[b, s/P]``,
  row ``s % P``) and live bits (map entry ``> 0`` and ``0 <= pos <= t``)
  once into shared memory, gathers 32-key latent|rope tiles through them
  into a 2-stage ``cp.async`` ring, skips tiles whose keys are all dead
  (bit-neutral for a block that sees a key; one that sees none walks its
  range again, so a slot that sees no key gets the plain version's
  average), and writes a float32 partial a head; the
  decode reads' combine kernel merges them in split order (no atomics).
  Any H: heads past a multiple of 64 are masked. float32 (the card-vs-CPU
  parity) and the test widths (16, 8) keep the scalar body: 4 heads of a
  slot a block (H a multiple of 4) walking all of S, a shuffle reduction
  per (head, key).
* Held back by: Q·Kᵀ's fragment reloads from shared memory, as in the
  chunk kernel (~20 µs for a block's 3 tiles at the outer read), one
  block an SM, and the partials (64 × 512 float32 a block) written and
  read back by the combine launch (~5 µs).

The dense MLA read (``ops.mla_decode_attention``) has no TPU kernel in the
reference ("reference path on every backend") and stays the plain version
``ref.mla_decode_attention`` on every device.

The plain versions are ``ref.decode_attention`` (re-exported here as
``plain``), ``ref.paged_decode_attention`` (``paged_plain``) and
``ref.paged_mla_decode_attention`` (``paged_mla_plain``); a CPU tensor
takes them, a CUDA tensor launches the kernel or raises.
``decode_attention.launches``, ``paged_decode_attention.launches`` and
``paged_mla_decode_attention.launches`` count wrapper calls that launched
their kernels (a split read launches its split and its combine kernel).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

plain = ref.decode_attention
paged_plain = ref.paged_decode_attention
paged_mla_plain = ref.paged_mla_decode_attention

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
HEAD_DIMS = (16, 32, 64, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
# (G, dh) pairs instantiated beyond GROUPS x HEAD_DIMS, each for the config
# that uses it: nemotron-4-15b (48/8 heads of 128), mistral-large-123b
# (96/8 of 128), h2o-danube-1.8b (32/8 of 80). Compile time grows with
# every pair, so no other is built.
CONFIG_SHAPES = ((6, 128), (12, 128), (4, 80))


def instantiated(g, dh):
    """Whether the decode reads' kernels are built for ``g`` query heads
    a KV head at head width ``dh``."""
    return (g in GROUPS and dh in HEAD_DIMS) or (g, dh) in CONFIG_SHAPES


# keys a split holds: a multiple of SPLIT_TILE (the bf16 body's key tile),
# at most MAX_SPLIT_KEYS (the kernels keep a range's rows in shared memory)
SPLIT_TILE = 64
MAX_SPLIT_KEYS = 512
# blocks a call aims at: two on each of the H100's 132 SMs
WAVE_BLOCKS = 264


def decode_split(b, s, hkv):
    """``(n_split, keys_per_split)`` of a decode read over ``s`` logical
    rows a slot, ``b`` slots and ``hkv`` KV heads: split ``i`` takes rows
    ``[i·keys_per_split, min(s, (i+1)·keys_per_split))``. About
    ``WAVE_BLOCKS`` blocks ``b·hkv·n_split``, in ranges of at least one
    64-key tile. A function of ``s`` and the head shape only — a dense ring
    and a paged map of the same rows (``s = n_pp·P``) split alike, whatever
    the page size."""
    if b <= 0 or s <= 0 or hkv <= 0:
        raise ValueError(f"decode_split: b={b}, s={s}, hkv={hkv}")
    want = -(-WAVE_BLOCKS // (b * hkv))
    keys = -(-s // want)
    keys = -(-keys // SPLIT_TILE) * SPLIT_TILE
    keys = min(keys, MAX_SPLIT_KEYS)
    return -(-s // keys), keys


def scratch_shape(b, h, dh, n_split):
    """Shape of the float32 scratch of a decode read: the partial
    accumulators ``(B, H, n_split, dh)``, then their ``(m, l)`` pairs
    ``(B, H, n_split, 2)``, flat."""
    return (b * h * n_split * (dh + 2),)


def launch_plan(q, k_cache):
    """``(n_split, keys_per_split, scratch shape)`` of ``decode_attention``
    on these shapes."""
    b, h, dh = q.shape
    _, s, hkv, _ = k_cache.shape
    n_split, keys = decode_split(b, s, hkv)
    return n_split, keys, scratch_shape(b, h, dh, n_split)


def paged_launch_plan(q, k_pool, page_map):
    """``(n_split, keys_per_split, scratch shape)`` of
    ``paged_decode_attention`` on these shapes: the dense plan of the
    ``n_pp·P`` logical rows."""
    b, h, dh = q.shape
    _, p_sz, hkv, _ = k_pool.shape
    n_split, keys = decode_split(b, page_map.shape[1] * p_sz, hkv)
    return n_split, keys, scratch_shape(b, h, dh, n_split)


def _check_cuda(q, k_cache, v_cache, cache_positions, q_position):
    b, h, dh = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != dh:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _, s, hkv, _ = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache {tuple(v_cache.shape)} != k_cache "
                         f"{tuple(k_cache.shape)}")
    if tuple(cache_positions.shape) != (b, s):
        raise ValueError(f"cache_positions {tuple(cache_positions.shape)} != "
                         f"{(b, s)}")
    if tuple(q_position.shape) != (b,):
        raise ValueError(f"q_position {tuple(q_position.shape)} != {(b,)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if cache_positions.dtype != torch.int32 or q_position.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if h % hkv or not instantiated(h // hkv, dh):
        raise NotImplementedError(
            f"decode_attention kernel takes G in {GROUPS} and dh in "
            f"{HEAD_DIMS}, or (G, dh) in {CONFIG_SHAPES}, got H={h} "
            f"Hkv={hkv} dh={dh}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_positions", cache_positions),
                    ("q_position", q_position)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@_build.metered("decode_attention")
def decode_attention(q, k_cache, v_cache, cache_positions, q_position, *,
                     window=None, scale=None, logit_softcap=None,
                     return_lse=False):
    """q: (B, H, dh); caches: (B, S, Hkv, dh); cache_positions: (B, S) int32;
    q_position: (B,) int32. Returns (B, H, dh) in q's dtype; with
    ``return_lse=True`` ``(out, lse)``, ``lse`` (B, H) float32 the natural
    log-sum-exp of the live scores that the combine kernel writes beside
    the output, and a (slot, head) with no live key reads out 0 and lse
    -inf (the partial read of one shard of a sequence-split cache,
    ``ref.merge_partials``). The launch is the same either way."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, cache_positions, q_position,
                     window=window, scale=scale, logit_softcap=logit_softcap,
                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if logit_softcap is not None:
        raise NotImplementedError("decode_attention kernel: logit_softcap is "
                                  "not ported yet; see ROADMAP.md")
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    _check_cuda(q, k_cache, v_cache, cache_positions, q_position)
    b, h, dh = q.shape
    _, s, hkv, _ = k_cache.shape
    scale = dh ** -0.5 if scale is None else float(scale)
    win = 0 if window is None else int(window)
    if window is not None and win <= 0:
        raise ValueError(f"window must be positive, got {window}")
    n_split, keys, shape = launch_plan(q, k_cache)
    out = torch.empty_like(q)
    scratch = torch.empty(shape, dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_positions.data_ptr(), q_position.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h,
        hkv, dh, win, scale, n_split, keys,
        _build.DTYPE_CODES[_DTYPES[q.dtype]], stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out if lse is None else (out, lse)


decode_attention.launches = 0


def _check_paged_cuda(q, k_pool, v_pool, pos_pool, page_map, q_position):
    b, h, dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape[3] != dh:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    n_pages, p_sz, hkv, _ = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if tuple(pos_pool.shape) != (n_pages, p_sz):
        raise ValueError(f"pos_pool {tuple(pos_pool.shape)} != "
                         f"{(n_pages, p_sz)}")
    if page_map.dim() != 2 or page_map.shape[0] != b:
        raise ValueError(f"page_map {tuple(page_map.shape)}: want (B={b}, "
                         f"n_pp)")
    if tuple(q_position.shape) != (b,):
        raise ValueError(f"q_position {tuple(q_position.shape)} != {(b,)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 "
                        f"q/pools of one dtype, got {q.dtype}/"
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if (pos_pool.dtype != torch.int32 or page_map.dtype != torch.int32
            or q_position.dtype != torch.int32):
        raise TypeError("positions and page_map must be int32")
    if h % hkv or not instantiated(h // hkv, dh):
        raise NotImplementedError(
            f"paged_decode_attention kernel takes G in {GROUPS} and dh in "
            f"{HEAD_DIMS}, or (G, dh) in {CONFIG_SHAPES}, got H={h} "
            f"Hkv={hkv} dh={dh}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("pos_pool", pos_pool), ("page_map", page_map),
                    ("q_position", q_position)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@_build.metered("paged_decode_attention")
def paged_decode_attention(q, k_pool, v_pool, pos_pool, page_map, q_position,
                           *, window=None, scale=None, logit_softcap=None):
    """q: (B, H, dh); pools: (n_pages, P, Hkv, dh); pos_pool: (n_pages, P)
    int32; page_map: (B, n_pp) int32 page ids in [0, n_pages), 0 = the
    null page; q_position: (B,) int32. Returns (B, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return paged_plain(q, k_pool, v_pool, pos_pool, page_map, q_position,
                           window=window, scale=scale,
                           logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if logit_softcap is not None:
        raise NotImplementedError("paged_decode_attention kernel: "
                                  "logit_softcap is not ported yet; see "
                                  "ROADMAP.md")
    _build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    _check_paged_cuda(q, k_pool, v_pool, pos_pool, page_map, q_position)
    b, h, dh = q.shape
    _, p_sz, hkv, _ = k_pool.shape
    n_pp = page_map.shape[1]
    scale = dh ** -0.5 if scale is None else float(scale)
    win = 0 if window is None else int(window)
    if window is not None and win <= 0:
        raise ValueError(f"window must be positive, got {window}")
    n_split, keys, shape = paged_launch_plan(q, k_pool, page_map)
    out = torch.empty_like(q)
    scratch = torch.empty(shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), page_map.data_ptr(), q_position.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, n_pp, p_sz, h, hkv, dh, win,
        scale, n_split, keys, _build.DTYPE_CODES[_DTYPES[q.dtype]], stream)
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# (L, R) latent and rope widths the MLA kernel is instantiated for:
# deepseek-v2's, and the small test stacks'
MLA_DIMS = ((512, 64), (16, 8))
# the bf16 body at (512, 64): heads of one slot a block (any H, masked)
MLA_HEADS_PER_BLOCK = 64
# the scalar body (float32, and the (16, 8) widths): H a multiple of this
MLA_SCALAR_HEADS = 4
# keys a range of the bf16 body: a multiple of MLA_KEY_TILE (its key
# tile), at most MLA_MAX_SPLIT_KEYS (their pool rows sit in shared memory)
MLA_KEY_TILE = 32
MLA_MAX_SPLIT_KEYS = 2048
# blocks a call aims at: one on each of the H100's 132 SMs (a block holds
# ~156 KB of shared memory)
MLA_WAVE_BLOCKS = 132


def mla_split(b, s, groups):
    """``(n_split, keys_per_split)`` of the bf16 paged MLA read over ``s``
    logical rows a slot, ``b`` slots and ``groups`` blocks of 64 heads:
    split ``i`` takes rows ``[i·keys_per_split,
    min(s, (i+1)·keys_per_split))``. The fewest 32-key tiles a range that
    keeps ``b·groups·n_split`` within ``MLA_WAVE_BLOCKS`` (one wave), then
    the fewest ranges of that length: a block's time follows its tiles,
    and every range adds a partial to the combine."""
    if b <= 0 or s <= 0 or groups <= 0:
        raise ValueError(f"mla_split: b={b}, s={s}, groups={groups}")
    most = max(1, MLA_WAVE_BLOCKS // (b * groups))
    keys = -(-s // most)
    keys = -(-keys // MLA_KEY_TILE) * MLA_KEY_TILE
    keys = min(keys, MLA_MAX_SPLIT_KEYS)
    return -(-s // keys), keys


def _mla_on_tensor_cores(dtype, lat_d, r):
    return dtype == torch.bfloat16 and (lat_d, r) == MLA_DIMS[0]


def paged_mla_launch_plan(q_lat, q_rope, pos_pool, page_map):
    """``(n_split, keys_per_split, scratch shape)`` of
    ``paged_mla_decode_attention`` on these shapes: bf16 at (512, 64)
    splits the ``n_pp·P`` logical rows by :func:`mla_split` over
    ``ceil(H/64)`` head groups, with a float32 scratch of partials
    (:func:`scratch_shape` at d_v = L); the scalar body walks them in one
    range and takes no scratch."""
    b, h, lat_d = q_lat.shape
    s = page_map.shape[1] * pos_pool.shape[1]
    if not _mla_on_tensor_cores(q_lat.dtype, lat_d, q_rope.shape[-1]):
        return 1, s, None
    n_split, keys = mla_split(b, s, -(-h // MLA_HEADS_PER_BLOCK))
    return n_split, keys, scratch_shape(b, h, lat_d, n_split)


def _check_paged_mla_cuda(q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                          page_map, q_position, out_dtype):
    if q_lat.dim() != 3 or q_rope.dim() != 3 or lat_pool.dim() != 3 \
            or rope_pool.dim() != 3:
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, lat_pool "
                         f"{tuple(lat_pool.shape)}, rope_pool "
                         f"{tuple(rope_pool.shape)}: want (B,H,L), (B,H,R), "
                         f"(n_pages,P,L), (n_pages,P,R)")
    b, h, lat_d = q_lat.shape
    r = q_rope.shape[-1]
    n_pages, p_sz = pos_pool.shape
    if tuple(q_rope.shape[:2]) != (b, h) \
            or tuple(lat_pool.shape) != (n_pages, p_sz, lat_d) \
            or tuple(rope_pool.shape) != (n_pages, p_sz, r):
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, lat_pool "
                         f"{tuple(lat_pool.shape)}, rope_pool "
                         f"{tuple(rope_pool.shape)}, pos_pool "
                         f"{tuple(pos_pool.shape)} do not match")
    if page_map.dim() != 2 or page_map.shape[0] != b:
        raise ValueError(f"page_map {tuple(page_map.shape)}: want (B={b}, "
                         f"n_pp)")
    if tuple(q_position.shape) != (b,):
        raise ValueError(f"q_position {tuple(q_position.shape)} != {(b,)}")
    if (lat_d, r) not in MLA_DIMS or (
            h % MLA_SCALAR_HEADS
            and not _mla_on_tensor_cores(q_lat.dtype, lat_d, r)):
        raise NotImplementedError(
            f"paged_mla_decode_attention kernel takes (L, R) in {MLA_DIMS}, "
            f"and H a multiple of {MLA_SCALAR_HEADS} but in bfloat16 at "
            f"{MLA_DIMS[0]}, got L={lat_d} R={r} H={h} {q_lat.dtype}")
    dts = {q_lat.dtype, q_rope.dtype, lat_pool.dtype, rope_pool.dtype}
    if q_lat.dtype not in _DTYPES or len(dts) != 1:
        raise TypeError(f"paged_mla_decode_attention takes float32 or "
                        f"bfloat16 inputs of one dtype, got "
                        f"{sorted(map(str, dts))}")
    if out_dtype is not None and out_dtype != q_lat.dtype:
        raise TypeError(f"paged_mla_decode_attention kernel writes q_lat's "
                        f"dtype {q_lat.dtype}, asked for {out_dtype}")
    if (pos_pool.dtype != torch.int32 or page_map.dtype != torch.int32
            or q_position.dtype != torch.int32):
        raise TypeError("positions and page_map must be int32")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope),
                    ("lat_pool", lat_pool), ("rope_pool", rope_pool),
                    ("pos_pool", pos_pool), ("page_map", page_map),
                    ("q_position", q_position)):
        if t.device != q_lat.device:
            raise ValueError(f"{name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@_build.metered("paged_mla_decode_attention")
def paged_mla_decode_attention(q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                               page_map, q_position, *, scale,
                               out_dtype=None):
    """q_lat: (B, H, L) (W_UK absorbed); q_rope: (B, H, R); pools:
    (n_pages, P, L), (n_pages, P, R) and (n_pages, P) int32 positions;
    page_map: (B, n_pp) int32 page ids in [0, n_pages), 0 = the null page;
    q_position: (B,) int32. Returns o_lat (B, H, L) in ``out_dtype``
    (default q_lat's)."""
    if q_lat.device.type == "cpu":
        return paged_mla_plain(q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                               page_map, q_position, scale=scale,
                               out_dtype=out_dtype)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_mla_decode_attention: unsupported device "
                         f"{q_lat.device}")
    _build.refuse_grad("paged_mla_decode_attention", q_lat, q_rope, lat_pool,
                       rope_pool)
    _check_paged_mla_cuda(q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                          page_map, q_position, out_dtype)
    b, h, lat_d = q_lat.shape
    r = q_rope.shape[-1]
    p_sz = pos_pool.shape[1]
    n_pp = page_map.shape[1]
    n_split, keys, shape = paged_mla_launch_plan(q_lat, q_rope, pos_pool,
                                                 page_map)
    out = torch.empty_like(q_lat)
    scratch = (None if shape is None else
               torch.empty(shape, dtype=torch.float32, device=q_lat.device))
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    rc = _build.library().repro_paged_mla_decode_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), lat_pool.data_ptr(),
        rope_pool.data_ptr(), pos_pool.data_ptr(), page_map.data_ptr(),
        q_position.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, h, lat_d, r,
        n_pp, p_sz, float(scale), n_split, keys,
        _build.DTYPE_CODES[_DTYPES[q_lat.dtype]], stream)
    _build.check(rc, "paged_mla_decode_attention")
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0
