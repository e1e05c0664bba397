"""GQA, MLA, bidirectional and cross attention (port of
``repro.models.attention``): parameters, the dense ring KV cache and the
paged pools, full-sequence attention with the prefill cache fill,
chunked-prefill attention, and one-token decode. The sequence mixing goes
through ``repro_torch.kernels.ops``: the hand-written CUDA kernels on the
card, their plain versions on the CPU.

The ``bidir`` kind (whisper's encoder) attends without a causal mask; the
``cross`` kind (whisper's decoder) reads K/V projected from the encoder
output: non-causal ``flash_attention`` over every frame in a prefill, and
in decode ``decode_attention`` over the slot's encoder K/V, whose
positions are ``0..F-1`` and whose query sits at ``1 << 30`` (every frame
visible), as the reference reads it. A prefix-LM prefill (paligemma)
passes ``prefix_len`` to ``ops.flash_attention``, which routes it to the
plain version on every device, as the reference does.

MLA (DeepSeek-V2 latent attention) caches one ``kv_lora``-wide latent and
one ``qk_rope``-wide rotated key per token (``latent``, ``rope``, ``pos``
leaves instead of ``k``, ``v``, ``pos``). The full-sequence path expands the
latent into per-head K/V and runs flash attention with d_qk = qk_nope +
qk_rope and d_v = v_head; the chunk and decode paths absorb W_UK into the
query and attend over the latent directly, its value product landing in
the latent space and leaving through W_UV.

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

Tensor parallelism (``layers.model_parallel``): q, k and v come out on the
rank's heads. Where the model axis has more ranks than KV heads (MQA's one,
say) the rules leave ``wk``/``wv`` replicated beside split query heads:
every rank projects every KV head and its query heads read the one they
share (``_local_kv``), as XLA's partitioner computes the reference's
replicated K/V. MLA runs its replicated down-projections whole on every
rank and its up-projections on the rank's heads.

Tensor-parallel serving (``launch.steps.make_serve_step`` on a mesh whose
model axis has M > 1 ranks): a dense ring holds every KV head (MLA: the
latent and rope lanes) over the rows ``decode_state_specs`` gives the rank
— ring slots ``[r S/M, (r+1) S/M)`` of rank r where M divides the ring
length S, else the whole ring. The step marks each such cache with
``KV_SHARD`` = (rank, M, split); ``attn_decode`` then gathers q (and k and
v where they are split) to all heads, writes the token on the rank that
holds ring slot ``t % S`` (every rank of a whole ring), reads all heads
over the rank's rows and — on a split ring — exchanges the partial reads
with their log-sum-exps so that each rank merges its own heads' M partials
in rank order (``kernels.ref.merge_partials``). The MLA read gathers
``q_lat`` and ``q_rope`` the same way; its token's latent and rotated key
are the same on every rank. A cross layer's read (``cross_decode``)
gathers q likewise over the encoder K/V, which a prefill leaves with
every KV head over the rank's 1/M of the frames (all of them where M does
not divide the frames).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import AttnCfg
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import act_from_model, act_to_model, \
    apply_rope, dense_init, model_group, model_rank, norm_apply, param, \
    seq_param, to_model

# key of a dense cache dict that a tensor-parallel serve step marks: (rank
# on the model axis, its size M, whether the ring's rows split over it)
KV_SHARD = "kv_shard"


class Attention(nn.Module):
    """Attention weights (the reference's ``attn_init``) in its einsum
    layout. GQA: ``wq (d, H, dh)``, ``wk/wv (d, Hkv, dh)``, ``wo (H, dh,
    d)``; ``q_norm``/``k_norm`` are the per-head RMSNorm scales of qk_norm
    configs. MLA: ``wdq (d, q_lora)``, ``q_norm (q_lora,)`` and ``wuq
    (q_lora, H, qk_nope + qk_rope)`` (or ``wq (d, H, qk_nope + qk_rope)``
    without q_lora), ``wdkv (d, kv_lora + qk_rope)``, ``kv_norm
    (kv_lora,)``, ``wuk (kv_lora, H, qk_nope)``, ``wuv (kv_lora, H,
    v_head)``, ``wo (H, v_head, d)``."""

    def __init__(self, cfg: AttnCfg, d: int, *, generator: torch.Generator,
                 device, dtype=torch.float32):
        super().__init__()
        if cfg.kind not in ("gqa", "mla", "bidir", "cross"):
            raise NotImplementedError(
                f"attention kind {cfg.kind!r} is not ported yet; see "
                f"ROADMAP.md")
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        if cfg.is_mla:
            self._init_mla(cfg, d, kw)
            return
        h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
        param(self, "wq", dense_init((d, h, dh), **kw),
              ("embed", "heads", "head_dim"))
        param(self, "wk", dense_init((d, kv, dh), **kw),
              ("embed", "kv_heads", "head_dim"))
        param(self, "wv", dense_init((d, kv, dh), **kw),
              ("embed", "kv_heads", "head_dim"))
        param(self, "wo", dense_init((h, dh, d), scale=(h * dh) ** -0.5,
                                     **kw), ("heads", "head_dim", "embed"))
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                param(self, name, torch.zeros(dh, device=device,
                                              dtype=dtype), ("embed_norm",))

    def _init_mla(self, cfg: AttnCfg, d: int, kw: dict):
        h = cfg.n_heads
        dq = cfg.qk_nope + cfg.qk_rope
        zeros = dict(device=kw["device"], dtype=kw["dtype"])
        lora_heads = ("lora", "heads", "head_dim")
        if cfg.q_lora:
            param(self, "wdq", dense_init((d, cfg.q_lora), **kw),
                  ("embed", "lora"))
            param(self, "q_norm", torch.zeros(cfg.q_lora, **zeros),
                  ("embed_norm",))
            param(self, "wuq", dense_init((cfg.q_lora, h, dq), **kw),
                  lora_heads)
        else:
            param(self, "wq", dense_init((d, h, dq), **kw),
                  ("embed", "heads", "head_dim"))
        param(self, "wdkv", dense_init((d, cfg.kv_lora + cfg.qk_rope), **kw),
              ("embed", "lora"))
        param(self, "kv_norm", torch.zeros(cfg.kv_lora, **zeros),
              ("embed_norm",))
        param(self, "wuk", dense_init((cfg.kv_lora, h, cfg.qk_nope), **kw),
              lora_heads)
        param(self, "wuv", dense_init((cfg.kv_lora, h, cfg.v_head), **kw),
              lora_heads)
        param(self, "wo", dense_init((h, cfg.v_head, d),
                                     scale=(h * cfg.v_head) ** -0.5, **kw),
              ("heads", "head_dim", "embed"))


def _leaf_shapes(cfg: AttnCfg) -> dict:
    """Per-token shape of each cache leaf besides ``pos``."""
    if cfg.is_mla:
        return {"latent": (cfg.kv_lora,), "rope": (cfg.qk_rope,)}
    return {"k": (cfg.n_kv, cfg.head_dim), "v": (cfg.n_kv, cfg.head_dim)}


def init_cache(cfg: AttnCfg, batch: int, max_len: int, dtype, device, *,
               window_cap: bool = True) -> dict:
    """Decode-time KV cache (MLA: the latent and rotated-key lanes).
    Windowed attention gets a ring buffer."""
    s = max_len
    if window_cap and cfg.window is not None:
        s = min(max_len, cfg.window)
    cache = {name: torch.zeros((batch, s) + shape, dtype=dtype,
                               device=device)
             for name, shape in _leaf_shapes(cfg).items()}
    cache["pos"] = torch.full((batch, s), -1, dtype=torch.int32,
                              device=device)
    return cache


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
    """Pooled decode cache: pages are shared across slots via a page map
    (MLA: latent and rotated-key pools)."""
    cache = {name: torch.zeros((n_pages, page_size) + shape, dtype=dtype,
                               device=device)
             for name, shape in _leaf_shapes(cfg).items()}
    cache["pos"] = torch.full((n_pages, page_size), -1, dtype=torch.int32,
                              device=device)
    return cache


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


def _cache_write(cache: dict, t: torch.Tensor, *, commit=None, shard=None,
                 **entries) -> dict:
    """Write one token per batch row at absolute position ``t`` ((B,) int32,
    per-slot clocks) into ring slot ``t % S``, in place. ``commit`` ((B,)
    bool) limits the write to its True rows: the others keep their old
    entry (K, V and position). ``shard`` = (r, M): the cache holds ring
    slots ``[r L, (r+1) L)`` of a ring of ``S = M L``, and a row writes
    only where its slot lies there."""
    s = cache["pos"].shape[1]
    rows = torch.arange(t.shape[0], device=t.device)
    if shard is not None:
        r, n = shard
        local = (t % (s * n)).long() - r * s
        own = (local >= 0) & (local < s)
        commit = own if commit is None else commit & own
        slot = local.clamp(0, s - 1)
    else:
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


def kv_replicated(p: Attention) -> bool:
    """Whether the rank holds every KV head beside a shard of the query
    heads: under ``layers.model_parallel`` over more ranks than KV heads
    the rules leave ``wk`` and ``wv`` whole."""
    return model_rank()[1] > 1 and p.wk.shape[1] == p.cfg.n_kv


def _local_kv(p: Attention, x: torch.Tensor) -> torch.Tensor:
    """x (..., Hkv, dh) -> the KV heads the rank's query heads read: x
    itself, or — every KV head on the rank (``kv_replicated``) — the heads
    ``j // G`` (G = H / Hkv) of its query heads ``[r H/M, (r+1) H/M)``."""
    if not kv_replicated(p):
        return x
    r, _ = model_rank()
    h_loc = p.wq.shape[1]
    g = p.cfg.n_heads // p.cfg.n_kv
    first, last = r * h_loc // g, ((r + 1) * h_loc - 1) // g
    return x[..., first:last + 1, :]


def project_kv(p: Attention, src: torch.Tensor):
    """src (..., S, d) -> k and v (..., S, Hkv, dh), unrotated and
    unnormed (a cross layer's encoder K/V). The head count is the
    weight's: a tensor-parallel shard's local heads, or every KV head where
    the rank holds them all — their weights then pass ``to_model``, so
    that each head's gradient sums over the ranks that read it."""
    d = src.shape[-1]
    lead = src.shape[:-1]
    wk, wv = p.wk, p.wv
    if kv_replicated(p):
        wk, wv = to_model(wk), to_model(wv)
    k = torch.matmul(src, wk.reshape(d, -1)).reshape(*lead, *wk.shape[1:])
    v = torch.matmul(src, wv.reshape(d, -1)).reshape(*lead, *wv.shape[1:])
    return k, v


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 eps: float, kv_x: torch.Tensor | None = None):
    """x (..., S, d) -> rotated q (..., S, H, dh), k and v
    (..., S, Hkv, dh) — projected from ``kv_x`` when given (cross
    attention, never rotated). Under ``layers.model_parallel`` H and Hkv
    are the shard's heads (Hkv every KV head where ``kv_replicated``):
    the replicated inputs pass ``to_model`` (x: ``act_to_model``, which
    gathers a sequence shard; ``kv_x`` once for every cross layer, in
    ``transformer.trunk``, so its gradient sums the layers' as an unsharded
    run does), and so do the per-head norm scales, which act on the local
    heads only."""
    cfg = p.cfg
    d = x.shape[-1]
    x = act_to_model(x)
    lead = x.shape[:-1]
    q = torch.matmul(x, p.wq.reshape(d, -1)).reshape(*lead,
                                                     *p.wq.shape[1:])
    k, v = project_kv(p, x if kv_x is None else kv_x)
    if cfg.qk_norm:
        q = norm_apply("rmsnorm", to_model(p.q_norm), q, eps=eps)
        k = norm_apply("rmsnorm", to_model(p.k_norm), k, eps=eps)
    if cfg.rope and cfg.kind != "cross":
        q = apply_rope(q, positions, pct=cfg.rope_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, pct=cfg.rope_pct, theta=cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """(..., H, dh) @ wo -> (..., d), summed over the model axis under
    ``layers.model_parallel`` (onto the rank's rows of a sequence shard:
    ``act_from_model``)."""
    h, dh, d = p.wo.shape
    return act_from_model(torch.matmul(out.reshape(*out.shape[:-2], h * dh),
                                       p.wo.reshape(h * dh, d)))


# ---------------------------------------------------------------------------
# Full-sequence (prefill)
# ---------------------------------------------------------------------------

def attn_forward(p: Attention, x: torch.Tensor, *, positions: torch.Tensor,
                 prefix_len: int = 0, norm_eps: float = 1e-6,
                 fill_cache: dict | None = None,
                 fill_true_length: int | None = None,
                 kv_x: torch.Tensor | None = None):
    """Full-sequence attention over x (B, S, d): causal, with the first
    ``prefix_len`` positions visible to every query (prefix-LM), or — the
    ``bidir`` and ``cross`` kinds — unmasked; a cross layer reads K/V from
    ``kv_x`` (the encoder output). Returns (y, cache): cache is None unless
    ``fill_cache`` (a fresh decode cache) was passed.

    ``fill_true_length`` marks the real prompt length of a right-padded
    prefill: cache rows at positions beyond it stay empty (``pos`` = -1).
    The kernel reads K/V at Hkv heads, so the reference's GQA repeat of K/V
    is not made."""
    cfg = p.cfg
    if cfg.is_mla:
        return _mla_forward(p, x, positions=positions, norm_eps=norm_eps,
                            fill_cache=fill_cache,
                            fill_true_length=fill_true_length)
    q, k, v = _project_qkv(p, x, positions, norm_eps, kv_x=kv_x)
    out = kops.flash_attention(q.contiguous(), _local_kv(p, k).contiguous(),
                               _local_kv(p, v).contiguous(),
                               causal=cfg.kind not in ("bidir", "cross"),
                               window=cfg.window, prefix_len=prefix_len,
                               scale=cfg.softmax_scale,
                               logit_softcap=cfg.logit_softcap)
    y = _out_proj(p, out)
    cache = None
    if fill_cache is not None:
        cache = _bulk_fill(fill_cache, positions, fill_true_length, k=k, v=v)
    return y, cache


def _mla_project(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 eps: float):
    """x (..., S, d) -> q_nope (..., S, H, qk_nope), rotated q_rope
    (..., S, H, qk_rope), the normed latent (..., S, kv_lora) and the
    rotated shared key lane k_rope (..., S, qk_rope). H is the weight's:
    under ``layers.model_parallel`` the shard's heads. The down-projections
    and their norms are replicated and run whole on every rank; what the
    split up-projections and heads consume — ``ql`` (x without q_lora),
    the latent and k_rope's lane before its rotation — passes
    ``act_to_model``, so every replicated parameter's gradient sums over
    the model axis. On a sequence shard the down-projections and their
    norms run on the rank's rows (``seq_param``: their gradients summed
    over the model axis) and ``act_to_model`` gathers what they give."""
    cfg = p.cfg
    d = x.shape[-1]
    if cfg.q_lora:
        ql = act_to_model(norm_apply("rmsnorm", seq_param(p.q_norm),
                                     torch.matmul(x, seq_param(p.wdq)),
                                     eps=eps))
        q = torch.matmul(ql, p.wuq.reshape(cfg.q_lora, -1))
        heads = p.wuq.shape[1]
    else:
        q = torch.matmul(act_to_model(x), p.wq.reshape(d, -1))
        heads = p.wq.shape[1]
    q = q.reshape(*q.shape[:-1], heads, cfg.qk_nope + cfg.qk_rope)
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
    dkv = torch.matmul(x, seq_param(p.wdkv))
    latent = act_to_model(norm_apply("rmsnorm", seq_param(p.kv_norm),
                                     dkv[..., :cfg.kv_lora], eps=eps))
    k_rope = apply_rope(act_to_model(dkv[..., cfg.kv_lora:]), positions,
                        theta=cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope


def _mla_scale(cfg: AttnCfg) -> float:
    return (cfg.qk_nope + cfg.qk_rope) ** -0.5


def _mla_forward(p: Attention, x: torch.Tensor, *, positions, norm_eps,
                 fill_cache, fill_true_length):
    """Full-sequence MLA: the latent expands into per-head keys
    ``[k_nope | k_rope]`` (qk_nope + qk_rope wide) and values (v_head
    wide), and flash attention runs with d_v != d_qk. The cache keeps the
    latent and k_rope."""
    cfg = p.cfg
    h = p.wuk.shape[1]
    q_nope, q_rope, latent, k_rope = _mla_project(p, x, positions, norm_eps)
    b, s, _ = latent.shape              # the whole sequence, gathered
    k_nope = torch.matmul(latent, p.wuk.reshape(cfg.kv_lora, -1)).reshape(
        b, s, h, cfg.qk_nope)
    v = torch.matmul(latent, p.wuv.reshape(cfg.kv_lora, -1)).reshape(
        b, s, h, cfg.v_head)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, cfg.qk_rope)],
                  dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = kops.flash_attention(qf.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True,
                               scale=_mla_scale(cfg))
    y = _out_proj(p, out)
    cache = None
    if fill_cache is not None:
        cache = _bulk_fill(fill_cache, positions, fill_true_length,
                           latent=latent, rope=k_rope)
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
    if cfg.is_mla:
        return _mla_chunk(p, x, cache, offset, positions, true_length,
                          norm_eps=norm_eps)
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


def _mla_chunk(p: Attention, x: torch.Tensor, cache: dict, offset: int,
               positions: torch.Tensor, true_length: int, *, norm_eps):
    """Absorbed-matmul MLA over cache + chunk latents (the C-query analogue
    of ``_mla_decode``): W_UK folds into the query, the scores and the value
    product run over the latent, W_UV maps the result back to the heads."""
    cfg = p.cfg
    b, c, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_project(p, x, positions[None],
                                                  norm_eps)
    lat_all = torch.cat([cache["latent"].to(latent.dtype), latent], dim=1)
    rope_all = torch.cat([cache["rope"].to(k_rope.dtype), k_rope], dim=1)
    new_pos = torch.where(positions < true_length, positions,
                          torch.full_like(positions, -1))
    kp = torch.cat([cache["pos"], new_pos.expand(b, c)], dim=1)
    qp = positions.expand(b, c).contiguous()
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p.wuk)
    o_lat = kops.mla_chunk_attention(q_lat.contiguous(), q_rope.contiguous(),
                                     lat_all, rope_all, qp, kp,
                                     scale=_mla_scale(cfg),
                                     out_dtype=x.dtype)
    out = torch.einsum("bshl,lhk->bshk", o_lat, p.wuv)
    end = min(offset + c, int(true_length))
    return _out_proj(p, out), _chunk_cache_merge(cache, offset, end,
                                                 latent=latent, rope=k_rope)


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def cross_decode(p: Attention, x: torch.Tensor, cross: dict):
    """A cross layer's one-token read, x (B, d) -> y (B, d): the decode
    read over the slot's encoder K/V ``cross["k"]``/``cross["v"]`` (B, F,
    Hkv, dh) at positions ``cross["pos"]`` (B, F) = 0..F-1, from a query
    at ``cross["q_pos"]`` (B,) = 1 << 30, so every frame is visible. All
    four are decode-state buffers that ``insert`` writes in place.

    A tensor-parallel serve step marks ``cross`` with ``KV_SHARD``: the
    K/V hold every KV head over the rank's frames (``pos`` its frames'
    positions), or every frame where the model axis does not divide them;
    q is gathered to all heads and the read merged as ``_sharded_decode``
    merges a ring's."""
    cfg = p.cfg
    d = x.shape[-1]
    q = torch.matmul(to_model(x), p.wq.reshape(d, -1)).reshape(
        x.shape[0], -1, cfg.head_dim).contiguous()
    kw = dict(scale=cfg.softmax_scale)
    if KV_SHARD not in cross:
        out = kops.decode_attention(q, cross["k"], cross["v"], cross["pos"],
                                    cross["q_pos"], **kw)
    else:
        r, _, split = cross[KV_SHARD]
        q_all = coll.all_gather_dim(q, 1, model_group()).contiguous()
        out = _read_all_heads(q_all, cross["k"], cross["v"], cross["pos"],
                              cross["q_pos"], r, q.shape[1], split, **kw)
    return _out_proj(p, out)


def attn_decode(p: Attention, x: torch.Tensor, cache: dict, t: torch.Tensor,
                *, norm_eps: float = 1e-6, commit=None, pages=None):
    """x: (B, d), one token per slot at absolute positions ``t`` (B,) int32.
    Writes the token's K/V into the cache in place and attends over it.
    Returns (y, cache).

    ``pages`` ((B, n_pp) int32) selects the paged-pool layout: the write and
    the read go through the per-slot page lists. Otherwise the dense ring
    is written (only the ``commit`` rows when given)."""
    cfg = p.cfg
    if cfg.is_mla:
        return _mla_decode(p, x, cache, t, norm_eps=norm_eps, commit=commit,
                           pages=pages)
    q, k, v = _project_qkv(p, x[:, None], t[:, None], norm_eps)
    q, k, v = q[:, 0].contiguous(), k[:, 0], v[:, 0]
    t32 = t.to(torch.int32)
    if pages is not None:
        cache = _paged_cache_write(cache, pages, t32, k=k, v=v)
        out = kops.paged_decode_attention(
            q, cache["k"], cache["v"], cache["pos"], pages, t32,
            window=cfg.window, scale=cfg.softmax_scale,
            logit_softcap=cfg.logit_softcap)
    elif KV_SHARD in cache:
        out = _sharded_decode(p, q, k, v, cache, t, commit=commit)
    else:
        cache = _cache_write(cache, t, commit=commit, k=k, v=v)
        out = kops.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                    t32, window=cfg.window,
                                    scale=cfg.softmax_scale,
                                    logit_softcap=cfg.logit_softcap)
    return _out_proj(p, out), cache


def _sharded_decode(p: Attention, q, k, v, cache: dict, t: torch.Tensor, *,
                    commit=None):
    """The dense read of a tensor-parallel serve step (see the module
    docstring): q (B, H/M, dh) of the rank's heads, k and v (B, Hkv/M,
    dh) of its KV heads, or (B, Hkv, dh) where it holds every KV head
    (``kv_replicated``); the cache holds every KV head. Returns the read
    of the rank's heads (B, H/M, dh)."""
    cfg = p.cfg
    r, n, split = cache[KV_SHARD]
    group = model_group()
    b, h_loc, dh = q.shape
    if kv_replicated(p):
        # k and v are whole on every rank: gather q only
        q_all = coll.all_gather_dim(q, 1, group).contiguous()
        k_all, v_all = k, v
    else:
        kv_loc = k.shape[1]
        # one gather: every rank's [q | k | v] heads, in rank order
        qkv = coll.all_gather_dim(torch.cat([q, k, v], dim=1), 1, group)
        qkv = qkv.reshape(b, n, h_loc + 2 * kv_loc, dh)
        q_all = qkv[:, :, :h_loc].reshape(b, n * h_loc, dh).contiguous()
        k_all = qkv[:, :, h_loc:h_loc + kv_loc].reshape(b, n * kv_loc, dh)
        v_all = qkv[:, :, h_loc + kv_loc:].reshape(b, n * kv_loc, dh)
    _cache_write(cache, t, commit=commit, shard=(r, n) if split else None,
                 k=k_all, v=v_all)
    return _read_all_heads(q_all, cache["k"], cache["v"], cache["pos"],
                           t.to(torch.int32), r, h_loc, split,
                           window=cfg.window, scale=cfg.softmax_scale,
                           logit_softcap=cfg.logit_softcap)


def _read_all_heads(q_all, k, v, pos, q_pos, r: int, h_loc: int,
                    split: bool, **kw):
    """``decode_attention`` of every head's query ``q_all`` (B, H, dh) over
    the rank's K/V rows, and the read of the rank's heads ``[r h_loc,
    (r+1) h_loc)`` (B, h_loc, dh): on rows split over the model axis each
    rank's partial reads are exchanged with their log-sum-exps and the
    rank's heads' partials merged in rank order; on whole rows the read
    of all heads is every rank's, and the rank keeps its own."""
    if not split:
        out = kops.decode_attention(q_all, k, v, pos, q_pos, **kw)
        return out[:, r * h_loc:(r + 1) * h_loc]
    dh = q_all.shape[-1]
    out, lse = kops.decode_attention(q_all, k, v, pos, q_pos,
                                     return_lse=True, **kw)
    parts = coll.exchange_partials(
        torch.cat([out.float(), lse[..., None]], dim=-1), model_group())
    return kops.merge_partials(parts[..., :dh], parts[..., dh]).to(
        q_all.dtype)


def _mla_decode(p: Attention, x: torch.Tensor, cache: dict, t: torch.Tensor,
                *, norm_eps, commit=None, pages=None):
    """Absorbed-matmul MLA decode: attention runs in the kv_lora-wide latent
    space; a token caches kv_lora + qk_rope numbers. The paged read is the
    ``paged_mla_decode_attention`` kernel; the dense read has no kernel in
    the reference and stays the plain ``mla_decode_attention`` (on a split
    ring, ``_sharded_mla_decode``)."""
    cfg = p.cfg
    q_nope, q_rope, latent, k_rope = _mla_project(p, x[:, None], t[:, None],
                                                  norm_eps)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0].contiguous()
    latent, k_rope = latent[:, 0], k_rope[:, 0]
    q_lat = torch.einsum("bhk,lhk->bhl", q_nope, p.wuk)
    t32 = t.to(torch.int32)
    scale = _mla_scale(cfg)
    if pages is not None:
        cache = _paged_cache_write(cache, pages, t32, latent=latent,
                                   rope=k_rope)
        o_lat = kops.paged_mla_decode_attention(
            q_lat.contiguous(), q_rope, cache["latent"], cache["rope"],
            cache["pos"], pages, t32, scale=scale, out_dtype=x.dtype)
    elif KV_SHARD in cache:
        o_lat = _sharded_mla_decode(q_lat, q_rope, latent, k_rope, cache, t,
                                    commit=commit, scale=scale,
                                    out_dtype=x.dtype)
    else:
        cache = _cache_write(cache, t, commit=commit, latent=latent,
                             rope=k_rope)
        o_lat = kops.mla_decode_attention(
            q_lat, q_rope, cache["latent"], cache["rope"], cache["pos"], t32,
            scale=scale, out_dtype=x.dtype)
    out = torch.einsum("bhl,lhk->bhk", o_lat, p.wuv)
    return _out_proj(p, out), cache


def _sharded_mla_decode(q_lat, q_rope, latent, k_rope, cache: dict,
                        t: torch.Tensor, *, commit, scale, out_dtype):
    """The dense MLA read of a tensor-parallel serve step: ``q_lat`` (B,
    H/M, kv_lora) and ``q_rope`` (B, H/M, qk_rope) of the rank's heads; the
    token's latent and k_rope, like the cache's lanes, are the same on
    every rank. Returns the read of the rank's heads (B, H/M, kv_lora) in
    ``out_dtype``."""
    r, n, split = cache[KV_SHARD]
    _cache_write(cache, t, commit=commit, shard=(r, n) if split else None,
                 latent=latent, rope=k_rope)
    t32 = t.to(torch.int32)
    lanes = (cache["latent"], cache["rope"], cache["pos"], t32)
    if not split:
        # a whole ring on every rank: the read of the rank's own heads
        return kops.mla_decode_attention(q_lat, q_rope, *lanes, scale=scale,
                                         out_dtype=out_dtype)
    group = model_group()
    lat = q_lat.shape[-1]
    # one gather: every rank's [q_lat | q_rope] heads, in rank order
    qs = coll.all_gather_dim(torch.cat([q_lat, q_rope], dim=-1), 1, group)
    out, lse = kops.mla_decode_attention(qs[..., :lat], qs[..., lat:],
                                         *lanes, scale=scale,
                                         out_dtype=torch.float32,
                                         return_lse=True)
    parts = coll.exchange_partials(torch.cat([out, lse[..., None]], dim=-1),
                                   group)
    return kops.merge_partials(parts[..., :lat], parts[..., lat]).to(
        out_dtype)
