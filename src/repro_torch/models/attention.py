"""GQA attention (port of the GQA part of ``repro.models.attention``):
parameters, the dense ring KV cache and the paged pools, full-sequence
attention with the prefill cache fill, chunked-prefill attention, and
one-token decode. The sequence mixing goes through
``repro_torch.kernels.ops``: the hand-written CUDA kernels on the card,
their plain versions on the CPU.

KV caches store absolute positions beside K/V (``-1`` = empty), so masking
is layout-independent and ring buffers work. Two physical layouts share
that logical contract:

* dense rings — ``(B, S, ...)`` per-slot tensors; and
* paged pools — ``(n_pages, page_size, ...)`` tensors shared by every
  serving slot, addressed through per-slot page lists
  (``repro_torch.engine.pages``). A slot's logical ring index
  ``l = t % s_log`` lives at row ``page_map[slot, l // page_size]``, offset
  ``l % page_size``. Page 0 is the null page: reads through it are masked
  and writes to it are discarded garbage.

Unlike the reference, which rebuilds its caches functionally, every write
here updates the cache tensors in place (``index_put_``). A dense decode
write can be limited to some batch rows (``commit``): the SOI middle commits
only for slots whose compression window is complete, so a mid-window slot's
ring row — which holds the frame it committed at its last phase-0 step — is
never overwritten. On pools the same effect comes from the page map: the
step hands mid-window slots a map of null pages (``engine.step``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import AttnCfg
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init, norm_apply


class Attention(nn.Module):
    """GQA weights (the reference's ``attn_init``) in its einsum layout:
    ``wq (d, H, dh)``, ``wk/wv (d, Hkv, dh)``, ``wo (H, dh, d)``;
    ``q_norm``/``k_norm`` are the per-head RMSNorm scales of qk_norm
    configs."""

    def __init__(self, cfg: AttnCfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        if cfg.kind != "gqa":
            raise NotImplementedError(
                f"attention kind {cfg.kind!r} is not ported yet; see "
                f"ROADMAP.md")
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
        self.wq = nn.Parameter(dense_init((d, h, dh), **kw))
        self.wk = nn.Parameter(dense_init((d, kv, dh), **kw))
        self.wv = nn.Parameter(dense_init((d, kv, dh), **kw))
        self.wo = nn.Parameter(dense_init((h, dh, d), scale=(h * dh) ** -0.5,
                                          **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(dh, device=device,
                                                   dtype=dtype))
            self.k_norm = nn.Parameter(torch.zeros(dh, device=device,
                                                   dtype=dtype))


def init_cache(cfg: AttnCfg, batch: int, max_len: int, dtype, device, *,
               window_cap: bool = True) -> dict:
    """Decode-time KV cache. Windowed attention gets a ring buffer."""
    s = max_len
    if window_cap and cfg.window is not None:
        s = min(max_len, cfg.window)
    shape = (batch, s, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, s), -1, dtype=torch.int32,
                              device=device)}


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """Geometry of the paged decode-cache pools (``repro.models.attention
    .PagedKV``). ``n_pages`` / ``n_pages_mid`` count pool rows *including*
    the reserved null page 0."""
    page_size: int
    n_pages: int              # outer (full-rate pre/post) pool rows
    n_pages_mid: int = 0      # SOI compressed-middle pool rows


def init_paged_cache(cfg: AttnCfg, page_size: int, n_pages: int, dtype,
                     device) -> dict:
    """Pooled decode cache: pages are shared across slots via a page map."""
    shape = (n_pages, page_size, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                              device=device)}


def _paged_cache_write(cache: dict, pages: torch.Tensor, t: torch.Tensor,
                       **entries) -> dict:
    """Write one token per slot at absolute position ``t`` ((B,) int32)
    through the per-slot page lists ``pages`` ((B, n_pp) int32), in place.
    Slots whose target entry is 0 write onto the null page, which every
    read masks."""
    p_sz = cache["pos"].shape[1]
    s_log = pages.shape[1] * p_sz
    rows = torch.arange(pages.shape[0], device=pages.device)
    l = (t % s_log).long()
    page = pages[rows, l // p_sz].long()
    off = l % p_sz
    for name, val in entries.items():
        cache[name][page, off] = val.to(cache[name].dtype)
    cache["pos"][page, off] = t.to(torch.int32)
    return cache


def paged_view(cache: dict, pages: torch.Tensor) -> dict:
    """A slot-major dense view (B, n_pp * page_size, ...) of the pools;
    entries reached through the null page read ``pos = -1``."""
    p_sz = cache["pos"].shape[1]
    b, n_pp = pages.shape
    idx = pages.long()
    out = {}
    for name, pool in cache.items():
        g = pool[idx]                                  # (B, n_pp, P, ...)
        out[name] = g.reshape((b, n_pp * p_sz) + tuple(g.shape[3:]))
    valid = torch.repeat_interleave(pages > 0, p_sz, dim=1)
    out["pos"] = torch.where(valid, out["pos"],
                             torch.full_like(out["pos"], -1))
    return out


def hydrate_cache_prefix(dense: dict, pool: dict, rows: torch.Tensor,
                         limit: int) -> dict:
    """Fill logical rows [0, ``limit``) of a batch-1 dense cache from the
    pools, in place (the prefix-cache prefill skip). ``rows`` holds the page
    ids of those rows (``limit`` is a whole number of pages); the copied
    rows are bit-identical to the pool contents, which is what makes a
    resumed prefill bit-exact against a cold one."""
    for name, d in dense.items():
        flat = kops.gather_pages(pool[name], rows)
        d[0, :limit] = flat[:limit].to(d.dtype)
    return dense


def _cache_write(cache: dict, t: torch.Tensor, *, commit=None,
                 **entries) -> dict:
    """Write one token per batch row at absolute position ``t`` ((B,) int32,
    per-slot clocks) into ring slot ``t % S``, in place. ``commit`` ((B,)
    bool) limits the write to its True rows: the others keep their old
    entry (K, V and position)."""
    s = cache["pos"].shape[1]
    rows = torch.arange(t.shape[0], device=t.device)
    slot = (t % s).long()
    for name, val in entries.items():
        val = val.to(cache[name].dtype)
        if commit is not None:
            val = torch.where(commit.view(-1, *([1] * (val.dim() - 1))), val,
                              cache[name][rows, slot])
        cache[name][rows, slot] = val
    pos = t.to(torch.int32)
    if commit is not None:
        pos = torch.where(commit, pos, cache["pos"][rows, slot])
    cache["pos"][rows, slot] = pos
    return cache


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 eps: float):
    """x (..., S, d) -> rotated q (..., S, H, dh), k and v
    (..., S, Hkv, dh)."""
    cfg = p.cfg
    d = x.shape[-1]
    lead = x.shape[:-1]
    q = torch.matmul(x, p.wq.reshape(d, -1)).reshape(*lead, cfg.n_heads,
                                                     cfg.head_dim)
    k = torch.matmul(x, p.wk.reshape(d, -1)).reshape(*lead, cfg.n_kv,
                                                     cfg.head_dim)
    v = torch.matmul(x, p.wv.reshape(d, -1)).reshape(*lead, cfg.n_kv,
                                                     cfg.head_dim)
    if cfg.qk_norm:
        q = norm_apply("rmsnorm", p.q_norm, q, eps=eps)
        k = norm_apply("rmsnorm", p.k_norm, k, eps=eps)
    if cfg.rope:
        q = apply_rope(q, positions, pct=cfg.rope_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, pct=cfg.rope_pct, theta=cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """(..., H, dh) @ wo -> (..., d)."""
    h, dh, d = p.wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], h * dh),
                        p.wo.reshape(h * dh, d))


# ---------------------------------------------------------------------------
# Full-sequence (prefill)
# ---------------------------------------------------------------------------

def attn_forward(p: Attention, x: torch.Tensor, *, positions: torch.Tensor,
                 norm_eps: float = 1e-6, fill_cache: dict | None = None,
                 fill_true_length: int | None = None):
    """Full-sequence causal attention over x (B, S, d). Returns (y, cache):
    cache is None unless ``fill_cache`` (a fresh decode cache) was passed.

    ``fill_true_length`` marks the real prompt length of a right-padded
    prefill: cache rows at positions beyond it stay empty (``pos`` = -1).
    The kernel reads K/V at Hkv heads, so the reference's GQA repeat of K/V
    is not made."""
    cfg = p.cfg
    q, k, v = _project_qkv(p, x, positions, norm_eps)
    out = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, window=cfg.window,
                               scale=cfg.softmax_scale,
                               logit_softcap=cfg.logit_softcap)
    y = _out_proj(p, out)
    cache = None
    if fill_cache is not None:
        cache = _bulk_fill(fill_cache, positions, fill_true_length, k=k, v=v)
    return y, cache


def _bulk_fill(cache: dict, positions: torch.Tensor,
               true_length: int | None = None, **entries) -> dict:
    """Prefill: write a from-position-0 sequence into the (possibly smaller
    ring) cache. A *gather*, not a scatter: ring slot ``l`` takes the newest
    real position ``p < true_length`` with ``p % s_cache == l``, so the
    padded fill of a prompt equals its unpadded fill at any pad amount; rows
    with no real position keep ``pos`` = -1 and zero K/V."""
    s_cache = cache["pos"].shape[1]
    s = positions.shape[-1]
    dev = cache["pos"].device
    tl = s if true_length is None else int(true_length)
    l = torch.arange(s_cache, device=dev)
    p = tl - 1 - torch.remainder(tl - 1 - l, s_cache)
    valid = p >= 0
    idx = p.clamp(0, s - 1)
    new = dict(cache)
    for name, val in entries.items():
        g = val.index_select(1, idx).to(cache[name].dtype)
        mask = valid.view(1, s_cache, *([1] * (g.dim() - 2)))
        new[name] = torch.where(mask, g, torch.zeros_like(g)).contiguous()
    pos_row = torch.where(valid, p, torch.full_like(p, -1)).to(torch.int32)
    new["pos"] = pos_row.expand(cache["pos"].shape).contiguous()
    return new


def _chunk_cache_merge(cache: dict, offset: int, end: int,
                       **entries) -> dict:
    """Merge one prefill chunk (positions [offset, offset + C)) into a ring
    cache already holding earlier chunks, in place.

    ``end`` = min(offset + C, true_length): chunk rows at or past it are pad
    and keep the cache's previous contents. As in the reference, ring slot
    ``l`` takes the newest position ``p < end`` with ``p % s_cache == l`` —
    from this chunk when ``p >= offset``. Those positions are the contiguous
    run [max(offset, end - s_cache), end), whose slots wrap the ring at most
    once, so the merge is at most two slice copies (host ints, no device
    read)."""
    s_cache = cache["pos"].shape[1]
    a = max(offset, end - s_cache)
    if end <= a:
        return cache                     # an all-pad chunk writes nothing
    dev = cache["pos"].device
    pos = torch.arange(a, end, dtype=torch.int32, device=dev)
    l0 = a % s_cache
    n1 = min(end - a, s_cache - l0)      # run rows before the ring wraps
    # (first ring slot, run rows, first row of the run) of each piece
    for lo, n, j in ((l0, n1, 0), (0, end - a - n1, n1)):
        if n <= 0:
            continue
        src = a - offset + j             # its row in the chunk
        for name, val in entries.items():
            cache[name][:, lo:lo + n] = val[:, src:src + n].to(
                cache[name].dtype)
        cache["pos"][:, lo:lo + n] = pos[j:j + n]
    return cache


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Chunked prefill (C tokens appended at a position offset)
# ---------------------------------------------------------------------------

def attn_chunk(p: Attention, x: torch.Tensor, cache: dict, offset: int,
               true_length: int, *, norm_eps: float = 1e-6):
    """Chunked-prefill attention: ``x`` (B, C, d) at absolute positions
    [offset, offset + C) attends to the cache (earlier chunks) plus itself
    (causally), then merges into the ring cache in place. Rows at positions
    >= ``true_length`` are pad: masked out of the keys and the merge.
    ``offset`` and ``true_length`` are host ints. Returns (y, cache)."""
    cfg = p.cfg
    b, c, _ = x.shape
    dev = x.device
    positions = torch.arange(offset, offset + c, dtype=torch.int32,
                             device=dev)
    q, k, v = _project_qkv(p, x, positions[None], norm_eps)
    k_all = torch.cat([cache["k"].to(k.dtype), k], dim=1)
    v_all = torch.cat([cache["v"].to(v.dtype), v], dim=1)
    new_pos = torch.where(positions < true_length, positions,
                          torch.full_like(positions, -1))
    kp = torch.cat([cache["pos"], new_pos.expand(b, c)], dim=1)
    qp = positions.expand(b, c).contiguous()
    out = kops.chunk_attention(q.contiguous(), k_all, v_all, qp, kp,
                               window=cfg.window, scale=cfg.softmax_scale,
                               logit_softcap=cfg.logit_softcap)
    y = _out_proj(p, out)
    end = min(offset + c, int(true_length))
    return y, _chunk_cache_merge(cache, offset, end, k=k, v=v)


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def attn_decode(p: Attention, x: torch.Tensor, cache: dict, t: torch.Tensor,
                *, norm_eps: float = 1e-6, commit=None, pages=None):
    """x: (B, d), one token per slot at absolute positions ``t`` (B,) int32.
    Writes the token's K/V into the cache in place and attends over it.
    Returns (y, cache).

    ``pages`` ((B, n_pp) int32) selects the paged-pool layout: the write and
    the read go through the per-slot page lists. Otherwise the dense ring
    is written (only the ``commit`` rows when given)."""
    cfg = p.cfg
    q, k, v = _project_qkv(p, x[:, None], t[:, None], norm_eps)
    q, k, v = q[:, 0].contiguous(), k[:, 0], v[:, 0]
    t32 = t.to(torch.int32)
    if pages is not None:
        cache = _paged_cache_write(cache, pages, t32, k=k, v=v)
        out = kops.paged_decode_attention(
            q, cache["k"], cache["v"], cache["pos"], pages, t32,
            window=cfg.window, scale=cfg.softmax_scale,
            logit_softcap=cfg.logit_softcap)
    else:
        cache = _cache_write(cache, t, commit=commit, k=k, v=v)
        out = kops.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                    t32, window=cfg.window,
                                    scale=cfg.softmax_scale,
                                    logit_softcap=cfg.logit_softcap)
    return _out_proj(p, out), cache
