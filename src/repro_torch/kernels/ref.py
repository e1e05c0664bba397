"""Plain PyTorch versions of the kernels this port runs — attention
(dense, chunked, paged, windowed; GQA and absorbed MLA), the page copy,
the RG-LRU scan and the STMC conv contraction — and the page gather (the
counterparts of ``repro.kernels.ref`` and of the reference path of
``repro.kernels.ops``).
The CPU path of every kernel wrapper is the function here, and
``chip_smoke.py`` holds each CUDA kernel against it on the card.

Conventions, as in the reference:
  q        : (B, Sq, H,  dh)
  k, v     : (B, Sk, Hkv, dh)   with H = Hkv * G (GQA groups)
  mask positions are *absolute token positions* so ring-buffer caches work;
  ``-1`` marks an empty cache slot. Masked scores take the finite
  ``NEG_INF``, never ``-inf``, so a row with no live key comes out finite.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos, k_pos, *, causal: bool, window, prefix_len: int):
    """(..., Sq, Sk) boolean allow-mask from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    allow = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=kp.device)
    if causal:
        allow = kp <= qp
        if prefix_len:
            allow = allow | (kp < prefix_len)
    if window is not None:
        allow = allow & (kp > qp - window)
    return allow & (kp >= 0)


def flash_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                    q_offset=0, scale=None, logit_softcap=None,
                    block_q=256, block_k=512):
    """Blocked online-softmax attention: the plain version of the
    ``flash_attention`` kernel, with the semantics of
    ``repro.kernels.ref.chunked_flash_attention`` and ``naive_attention``.
    ``q_offset`` is the absolute position of ``q[:, 0]``; keys sit at
    positions ``0..Sk-1``. K/V may carry fewer heads than q (GQA:
    q head ``h`` reads KV head ``h // G``). Key blocks that lie wholly past
    the causal diagonal of a query block are skipped, as the TPU kernel
    skips them; every other block goes through the same masked online
    softmax, so a row's result does not depend on the blocking."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    dev = q.device
    block_q = max(1, min(block_q, sq))
    block_k = max(1, min(block_k, sk))
    kf = k.float()
    vf = v.float()
    out = torch.empty((b, sq, hkv, g, dv), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qblk = q[:, q0:q1].reshape(b, q1 - q0, hkv, g, dh).float()
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        m = torch.full((b, hkv, g, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, q1 - q0), device=dev)
        acc = torch.zeros((b, hkv, g, q1 - q0, dv), device=dev)
        for k0 in range(0, sk, block_k):
            if causal and k0 > q_offset + q1 - 1 and not prefix_len:
                break                       # past the diagonal: no live key
            k1 = min(k0 + block_k, sk)
            k_pos = torch.arange(k0, k1, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kf[:, k0:k1]) * scale
            if logit_softcap:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            allow = _mask(q_pos, k_pos, causal=causal, window=window,
                          prefix_len=prefix_len)
            s = torch.where(allow, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k1])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def windowed_flash_attention(q, k, v, *, window: int, q_offset=0,
                             scale=None, logit_softcap=None, block_q=256):
    """Causal sliding-window attention (``repro.kernels.ref
    .windowed_flash_attention``, and ``chunked_flash_attention`` with a
    window no shorter than Sk): a masked softmax per block of ``block_q``
    queries over the key span they can see, ``[q_start - window + 1,
    q_end)``. Queries sit at ``q_offset + i``, keys at ``0..Sk-1``; a key is
    live iff ``q - window < k <= q``. No TPU kernel computes this: the
    reference runs it outside Pallas on every backend."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    dev = q.device
    out = torch.empty((b, sq, hkv, g, dv), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        k0 = min(max(q_offset + q0 - window + 1, 0), sk)
        k1 = min(max(q_offset + q1, k0), sk)
        qblk = q[:, q0:q1].reshape(b, q1 - q0, hkv, g, dh).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                         k[:, k0:k1].float()) * scale
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        allow = _mask(q_offset + torch.arange(q0, q1, device=dev),
                      torch.arange(k0, k1, device=dev), causal=True,
                      window=window, prefix_len=0)
        s = torch.where(allow, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v[:, k0:k1].float())
        out[:, q0:q1] = o
    return out.reshape(b, sq, h, dv).to(q.dtype)


def lru_scan(a, x, h0=None):
    """Diagonal linear recurrence ``h_t = a_t * h_{t-1} + x_t``
    (``repro.kernels.ref.lru_scan``, in the TPU kernel's sequential order):
    a, x (B, S, D), h0 (B, D) or None. The carry is float32, each step a
    product and then a sum. Returns (h_all (B, S, D) in x's dtype, h_last =
    h_all[:, -1])."""
    b, s, d = x.shape
    af, xf = a.float(), x.float()
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    out = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    for t in range(s):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out, out[:, -1]


def stmc_conv(window, w, b=None):
    """Streaming conv contraction ``(B, K, Cin) x (K, Cin, Cout) ->
    (B, Cout)`` as the TPU kernel computes it
    (``repro/kernels/stmc_conv.py``): window and weights in float32, one
    ``(B, K*Cin) x (K*Cin, Cout)`` product, the bias added in float32, the
    result cast to the window's dtype. In float32 this is
    ``repro.kernels.ref.stmc_conv``'s einsum plus the bias."""
    bsz, k, cin = window.shape
    y = torch.matmul(window.reshape(bsz, k * cin).float(),
                     w.reshape(k * cin, w.shape[-1]).float())
    if b is not None:
        y = y + b.float()
    return y.to(window.dtype)


def decode_attention(q, k_cache, v_cache, cache_positions, q_position, *,
                     window=None, scale=None, logit_softcap=None):
    """Single-token attention against a (possibly ring-buffer) KV cache
    (``repro.kernels.ref.decode_attention``).

    q: (B, H, dh); caches: (B, S, Hkv, dh); cache_positions: (B, S) absolute
    positions with -1 for empty slots; q_position: (B,) current position.
    A slot with no live key (all ``-1``) averages V uniformly — finite.
    """
    b, h, dh = q.shape
    _, s, hkv, _ = k_cache.shape
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, dh).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    qp = q_position[:, None]
    allow = (cache_positions >= 0) & (cache_positions <= qp)
    if window is not None:
        allow = allow & (cache_positions > qp - window)
    scores = torch.where(allow[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def chunk_attention(q, k, v, q_positions, k_positions, *, window=None,
                    scale=None, logit_softcap=None):
    """Chunked-prefill attention: ``repro.kernels.ref.naive_attention`` with
    absolute positions (the reference's ``ops.chunk_attention`` off the
    TPU).

    q: (B, C, H, dh) at ``q_positions`` (B, C); k, v: (B, Sk, Hkv, dh) at
    ``k_positions`` (B, Sk), ``-1`` marking an empty row. A key is live for
    a query iff ``0 <= kp <= qp`` (and ``kp > qp - window``); a query row
    with no live key (``qp = -1`` pad) averages V uniformly — finite."""
    b, c, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, c, hkv, g, dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    allow = _mask(q_positions, k_positions, causal=True, window=window,
                  prefix_len=0)                             # (B, C, Sk)
    scores = torch.where(allow[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, c, h, dv).to(q.dtype)


def gather_pages(pool, rows):
    """``(n_pages, P, ...)`` pool and ``(n,)`` page ids -> the contiguous
    logical view ``(n * P, ...)`` (``repro.kernels.ops.gather_pages``)."""
    n = rows.shape[0]
    return pool[rows.long()].reshape((n * pool.shape[1],) + pool.shape[2:])


def paged_decode_attention(q, k_pool, v_pool, pos_pool, page_map, q_position,
                           *, window=None, scale=None, logit_softcap=None):
    """One-token attention against paged KV pools
    (``repro.kernels.ops.paged_decode_attention`` off the TPU).

    Pools are ``(n_pages, P, Hkv, dh)`` with page 0 the null page;
    ``page_map`` (B, n_pp) int32 lists each slot's pages. The slot-major
    dense view is gathered, entries reached through a ``page_map`` entry
    that is not ``> 0`` read ``pos = -1``, and the dense
    :func:`decode_attention` runs on it — so the plain paged read is
    bit-exact against the plain dense read of the same logical rows."""
    b, n_pp = page_map.shape
    p_sz = pos_pool.shape[1]
    idx = page_map.long()
    k = k_pool[idx].reshape((b, n_pp * p_sz) + tuple(k_pool.shape[2:]))
    v = v_pool[idx].reshape((b, n_pp * p_sz) + tuple(v_pool.shape[2:]))
    pos = pos_pool[idx].reshape(b, n_pp * p_sz)
    live_page = torch.repeat_interleave(page_map > 0, p_sz, dim=1)
    pos = torch.where(live_page, pos, torch.full_like(pos, -1))
    return decode_attention(q, k, v, pos, q_position, window=window,
                            scale=scale, logit_softcap=logit_softcap)


def mla_chunk_attention(q_lat, q_rope, latent, rope, q_positions,
                        k_positions, *, scale, out_dtype=None):
    """Absorbed-matmul MLA chunk attention
    (``repro.kernels.ref.mla_chunk_attention``, its einsum order kept):
    scores over the latent cache directly (q already carries W_UK), the
    value product against the latent.

    q_lat: (B, C, H, L); q_rope: (B, C, H, R); latent: (B, Sk, L); rope:
    (B, Sk, R); positions absolute, ``-1`` = empty. A key is live iff
    ``0 <= kp <= qp``. Returns (B, C, H, L) in ``out_dtype`` (default
    q_lat's)."""
    scores = (torch.einsum("bshl,bkl->bhsk", q_lat.float(), latent.float())
              + torch.einsum("bshk,bek->bhse", q_rope.float(),
                             rope.float())) * scale
    allow = ((k_positions[:, None] >= 0)
             & (k_positions[:, None] <= q_positions[..., None]))
    scores = torch.where(allow[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhsk,bkl->bshl", probs, latent.float())
    return o_lat.to(out_dtype if out_dtype is not None else q_lat.dtype)


def mla_decode_attention(q_lat, q_rope, latent, rope, positions, q_position,
                         *, scale, out_dtype=None):
    """Single-token absorbed-matmul MLA attention against a dense latent
    cache (``repro.kernels.ref.mla_decode_attention``, same einsum order).

    q_lat: (B, H, L); q_rope: (B, H, R); latent: (B, S, L); rope: (B, S, R);
    positions: (B, S) absolute with -1 empties; q_position: (B,). Returns
    (B, H, L)."""
    scores = (torch.einsum("bhl,bsl->bhs", q_lat.float(), latent.float())
              + torch.einsum("bhk,bsk->bhs", q_rope.float(),
                             rope.float())) * scale
    allow = (positions >= 0) & (positions <= q_position[:, None])
    scores = torch.where(allow[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", probs, latent.float())
    return o_lat.to(out_dtype if out_dtype is not None else q_lat.dtype)


def paged_mla_decode_attention(q_lat, q_rope, lat_pool, rope_pool, pos_pool,
                               page_map, q_position, *, scale,
                               out_dtype=None):
    """Single-token absorbed MLA attention against paged latent pools
    (``repro.kernels.ops.paged_mla_decode_attention`` off the TPU).

    Pools are ``(n_pages, P, L)``, ``(n_pages, P, R)`` and ``(n_pages, P)``
    positions, page 0 the null page; ``page_map`` (B, n_pp) int32. The
    slot-major dense view is gathered, entries reached through a map entry
    that is not ``> 0`` read ``pos = -1``, and :func:`mla_decode_attention`
    runs on it — so the plain paged read is bit-exact against the plain
    dense read of the same logical rows."""
    b, n_pp = page_map.shape
    p_sz = pos_pool.shape[1]
    idx = page_map.long()
    lat = lat_pool[idx].reshape((b, n_pp * p_sz) + tuple(lat_pool.shape[2:]))
    rope = rope_pool[idx].reshape((b, n_pp * p_sz)
                                  + tuple(rope_pool.shape[2:]))
    pos = pos_pool[idx].reshape(b, n_pp * p_sz)
    live_page = torch.repeat_interleave(page_map > 0, p_sz, dim=1)
    pos = torch.where(live_page, pos, torch.full_like(pos, -1))
    return mla_decode_attention(q_lat, q_rope, lat, rope, pos, q_position,
                                scale=scale, out_dtype=out_dtype)


def copy_pages(pool, srcs, dsts):
    """``pool[dsts[i]] = pool[srcs[i]]`` for every pair, in place
    (``repro.kernels.ops.copy_pages``); ``(0, 0)`` padding pairs copy the
    null page onto itself. No pair's ``dst`` is another pair's ``src`` (COW
    destinations are fresh pages), so the order does not matter. Returns
    ``pool``."""
    pool[dsts.long()] = pool[srcs.long()]
    return pool
