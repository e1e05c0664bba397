"""Serving path (port of ``repro.models.decode``): decode-state construction
(dense rings or paged pools), bucketed and chunked prefill, the one-token
decode of a run of layers, and the plain (non-SOI) decode step. Blocks mix
the sequence with attention, the RG-LRU or an RWKV-6 time mix and
channels with an MLP, a MoE or the RWKV channel mix; MoE routing cannot
mask pad, a recurrence would carry it into its state and a prefix-LM
prefix lets every query see it, so such a config prefills at the exact
prompt length and refuses bucketed and chunked prefill
(``supports_masked_prefill``), as the reference does. An encoder-decoder
config (whisper) prefills with ``encoder_frames``: the encoder runs once
and every cross layer's K/V of its output go into the state; a prefix-LM
(paligemma) may prefill with ``prefix_embeds`` ahead of the tokens.

State layout: ``{"t": (B,) int32 per-slot clocks, ...}`` plus, for a plain
config, ``"segments"``: one cache dict per layer (``k``, ``v``, ``pos``;
MLA layers ``latent``, ``rope``, ``pos``; RG-LRU layers ``h`` (B, w)
float32 and ``conv`` (B, conv_width-1, w); RWKV layers ``rwkv_tm``
(``x_prev`` (B, d), ``S`` (B, h, dh, dh) float32) and ``rwkv_cm`` (B, d),
the reference's keys; recurrence states per slot in both layouts);
for an SOI config ``"pre"``, ``"mid"``, ``"post"`` (per-layer caches of the
three parts; the middle's hold ``soi_mid_len`` frames), the conv window
``"conv_buf"`` (B, stride-1, d) and the extrapolation queue ``"queue"``
(B, stride, d). The reference stacks a segment's caches on a leading layer
axis; here every layer owns its tensors. A paged state holds pools instead
of rings and ``"pages"``: ``{"outer": (B, n_pp), "mid": (B, n_pp_mid)}``
int32 page maps (the middle pages at its own, 1/stride, rate). An
encoder-decoder state adds ``"cross_kv"`` (one ``{"k", "v"}`` (B, F, Hkv,
dh) per layer, None for a layer without cross attention; per slot in both
layouts, as the reference keeps it), and the read's positions
``"cross_pos"`` (B, F) = 0..F-1 and query clocks ``"cross_q_pos"`` (B,)
= 1 << 30, fixed buffers a captured step reads.

Decode and chunked prefill update the caches in place (see
``models.attention``).

Inside ``layers.model_parallel`` over M > 1 ranks (tensor-parallel
serving, ``launch.steps``) the model runs on its local shards: the
embedding looks up a vocab-split table, the logits are gathered over the
model axis to the full vocabulary, and ``prefill`` hands its attention
caches back in ``launch.specs.decode_state_specs``' layout — every KV head
(an MLA layer's latent and rope lanes) on each rank over the rank's 1/M of
the ring's rows where M divides the ring's length, else the whole ring
(``_kv_to_serving_layout``); an RG-LRU layer's ``h`` and ``conv`` hold the
rank's w/M channels (``ff``), an RWKV layer's ``S`` the rank's h/M heads;
an encoder-decoder's cross K/V hold every KV head over the rank's 1/M of
the frames (``fill_cross_kv``). SOI's compress and fuse, the conv window,
the extrapolation queue, RWKV's ``x_prev`` and channel-mix state, the
cross read's positions and the clocks stay replicated over the model
axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelCfg
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rgm
from repro_torch.models import rwkv as rkm
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.transformer import (_dtype, _embed_tokens,
                                            _head_weights,
                                            block_norm, cast_params,
                                            channel_mix, embed_inputs,
                                            encode, final_norm, seq_forward,
                                            soi_compress,
                                            soi_extrapolate, soi_fuse,
                                            soi_partition, softcap_logits,
                                            split_blocks, whole_forward)
from repro_torch.models.layers import gather_seq, model_group, split_seq


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _layer_caches(blocks, batch: int, max_len: int, d: int, dt, device,
                  paged=None) -> list:
    """One cache dict per layer: an attention layer's ring (or, with
    ``paged`` = (page_size, n_pages), its pools), an RG-LRU or RWKV layer's
    per-slot recurrence state — per slot on paged engines too."""
    out = []
    for bp in blocks:
        b = bp.bcfg
        if b.rglru is not None:
            out.append(rgm.rglru_init_state(bp.rglru, batch, dt, device))
        elif b.rwkv is not None:
            out.append(rkm.init_decode_cache(b.rwkv, d, batch, dt, device))
        elif paged is not None:
            out.append(attn.init_paged_cache(b.attn, paged[0], paged[1], dt,
                                             device))
        else:
            out.append(attn.init_cache(b.attn, batch, max_len, dt, device))
    return out


def is_attn_cache(cache: dict) -> bool:
    """Whether a layer's cache holds attention rows (a ring or pools, with
    a ``pos`` lane) rather than a recurrence layer's per-slot state."""
    return "pos" in cache


CROSS_Q_POS = 1 << 30     # the cross read's query clock: every frame visible


def fill_cross_kv(params, enc_out) -> dict:
    """The cross-attention state of an encoder output (B, F, d): every
    layer's K/V (None for a layer without cross attention), the frames'
    positions 0..F-1 and the query clocks ``CROSS_Q_POS``. Under
    ``layers.model_parallel`` over M > 1 ranks the K/V take the serving
    layout of ``launch.specs.decode_state_specs``: every KV head over the
    rank's frames ``[r F/M, (r+1) F/M)``, or every frame where M does not
    divide F (``_rows_of_every_head``); the positions stay whole."""
    b, f, _ = enc_out.shape
    dev = enc_out.device
    group = model_group()
    n = 1 if group is None else dist.get_world_size(group)
    kv = []
    for bp in params.blocks:
        if bp.bcfg.cross_attn is None:
            kv.append(None)
            continue
        k, v = attn.project_kv(bp.cross, enc_out)
        if n > 1:
            k, v = _rows_of_every_head(bp.cross, k, v, group)
        kv.append({"k": k.contiguous(), "v": v.contiguous()})
    pos = torch.arange(f, dtype=torch.int32, device=dev)
    return {"cross_kv": kv,
            "cross_pos": pos[None].expand(b, f).contiguous(),
            "cross_q_pos": torch.full((b,), CROSS_Q_POS, dtype=torch.int32,
                                      device=dev)}


def cross_reads(state: dict):
    """Per layer, what a cross layer's decode read takes from ``state``
    (``{"k", "v", "pos", "q_pos"}``), or None without encoder state."""
    if "cross_kv" not in state:
        return None
    return [None if c is None else dict(c, pos=state["cross_pos"],
                                        q_pos=state["cross_q_pos"])
            for c in state["cross_kv"]]


def _attn_logical_len(segments, max_len: int) -> int:
    """Logical (ring) cache length shared by a cache group's attention
    layers: one page map serves a group only if every layer in it rings at
    the same length."""
    lens = set()
    for seg in segments:
        for b in seg.blocks:
            if b.attn is not None:
                lens.add(max_len if b.attn.window is None
                         else min(max_len, b.attn.window))
    if len(lens) > 1:
        raise NotImplementedError(
            f"paged KV needs a uniform ring length per cache group; got "
            f"window-capped lengths {sorted(lens)}")
    return lens.pop() if lens else 0


def paged_group_lens(cfg: ModelCfg, max_len: int) -> tuple:
    """(outer_len, mid_len): logical cache lengths of the full-rate (outer)
    and compressed-middle cache groups; 0 = the group has no attention."""
    if cfg.soi is None:
        return _attn_logical_len(cfg.segments, max_len), 0
    pre, mid, post = soi_partition(cfg)
    outer = _attn_logical_len(list(pre) + list(post), max_len)
    mid_l = _attn_logical_len(mid, soi_mid_len(max_len, cfg.soi.stride))
    return outer, mid_l


def soi_mid_len(max_len: int, stride: int) -> int:
    """Length of the compressed middle caches: ceil(max_len/stride)
    positions, rounded up to a multiple of 256 above 256 (the reference's
    shardable length; kept so both packages hold the same state)."""
    mid_len = -(-max_len // stride)
    return -(-mid_len // 256) * 256 if mid_len > 256 else mid_len


def init_decode_state(params, cfg: ModelCfg, batch: int, max_len: int, *,
                      enc_out=None, paged=None) -> dict:
    """Empty decode state with per-slot clocks ``t`` (B,), on the params'
    device; with ``enc_out`` (B, F, d) its cross-attention state
    (``fill_cross_kv``).

    ``paged`` (an ``attention.PagedKV``) swaps the per-slot ring caches for
    shared page pools plus per-slot page maps in ``state["pages"]`` (all
    null); the compressed middle gets its own, smaller, pool. Recurrence
    states and the encoder's cross K/V stay per slot."""
    dt = _dtype(cfg)
    dev = params.embed.device
    d = cfg.d_model
    state = {"t": torch.zeros(batch, dtype=torch.int32, device=dev)}
    po = pm = None
    if paged is not None:
        outer_len, mid_l = paged_group_lens(cfg, max_len)
        pages = {}
        for name, ln, n_pages in (("outer", outer_len, paged.n_pages),
                                  ("mid", mid_l, paged.n_pages_mid)):
            if not ln:
                continue
            if ln % paged.page_size:
                raise ValueError(f"page_size {paged.page_size} must divide "
                                 f"the {name} cache length {ln}")
            pages[name] = torch.zeros((batch, ln // paged.page_size),
                                      dtype=torch.int32, device=dev)
            if name == "outer":
                po = (paged.page_size, n_pages)
            else:
                pm = (paged.page_size, n_pages)
        state["pages"] = pages
    if enc_out is not None:
        state.update(fill_cross_kv(params, enc_out))
    if cfg.soi is None:
        state["segments"] = _layer_caches(params.blocks, batch, max_len, d,
                                          dt, dev, po)
        return state
    st = cfg.soi.stride
    pre, mid, post = split_blocks(params, cfg)
    state["pre"] = _layer_caches(pre, batch, max_len, d, dt, dev, po)
    state["mid"] = _layer_caches(mid, batch, soi_mid_len(max_len, st), d, dt,
                                 dev, pm)
    state["post"] = _layer_caches(post, batch, max_len, d, dt, dev, po)
    state["conv_buf"] = torch.zeros((batch, st - 1, d), dtype=dt, device=dev)
    state["queue"] = torch.zeros((batch, st, d), dtype=dt, device=dev)
    return state


# ---------------------------------------------------------------------------
# One-token block / segment decode
# ---------------------------------------------------------------------------

def _block_decode(bp, cfg: ModelCfg, x, cache, t, *, commit=None,
                  pages=None, cross=None):
    eps = cfg.norm_eps
    b = bp.bcfg
    h = block_norm(bp, 1, x, eps)
    if b.rwkv is not None:
        x = x + rkm.rwkv_time_mix_decode(bp.rwkv, h, cache["rwkv_tm"],
                                         commit=commit)
        return x + rkm.rwkv_channel_mix_decode(
            bp.rwkv, block_norm(bp, 2, x, eps), cache["rwkv_cm"],
            commit=commit)
    if b.rglru is not None:
        h = rgm.rglru_decode(bp.rglru, h, cache, commit=commit)
    else:
        h, _ = attn.attn_decode(bp.attn, h, cache, t, norm_eps=eps,
                                commit=commit, pages=pages)
    x = x + h
    if b.cross_attn is not None:
        x = x + attn.cross_decode(bp.cross, block_norm(bp, "x", x, eps),
                                  cross)
    h = block_norm(bp, 2, x, eps)
    return x + channel_mix(bp, h)


def _segment_decode(blocks, caches, cfg: ModelCfg, x, t, *, commit=None,
                    pages=None, cross=None):
    """One token through a run of layers; their caches update in place
    (dense rings and recurrence states: only the ``commit`` rows when
    given; pools: through the page map ``pages`` that every attention layer
    of the run shares). ``cross`` (``cross_reads``) feeds the cross layers.
    Returns x."""
    cross = cross or [None] * len(blocks)
    for bp, c, xc in zip(blocks, caches, cross):
        x = _block_decode(bp, cfg, x, c, t, commit=commit, pages=pages,
                          cross=xc)
    return x


def _embed_one(params, cfg: ModelCfg, token, t):
    """One token per slot (B,) at the clocks ``t`` (B,) -> (B, d); a
    learned position table adds the clocks' rows."""
    return _embed_tokens(params, cfg, token[:, None],
                         positions=t[:, None])[:, 0]


def _logits_one(params, cfg: ModelCfg, x):
    """Final norm + head; logits in float32, soft-capped where the config
    says so. A head whose vocab is split over the model axis gives the
    shard's columns, gathered to the full vocabulary in rank order."""
    h = final_norm(params, cfg, x)
    w = _head_weights(params)
    logits = torch.matmul(h, w).float()
    if w.shape[1] != cfg.vocab:
        logits = coll.all_gather_dim(logits, -1, model_group())
    return softcap_logits(cfg, logits)


def _rows_of_every_head(p, k, v, group):
    """K and V (B, S, Hkv/M, dh) of the rank's KV heads -> every KV head
    over the rank's rows [r S/M, (r+1) S/M) where the M ranks of
    ``group`` divide S, else over all S rows: one all-to-all of K and V
    together (an all-gather for whole rows). K/V of every KV head
    (``attention.kv_replicated``: the same on every rank) keep the rank's
    rows."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    b, s, kv_loc, dh = k.shape
    if attn.kv_replicated(p):
        if s % n:
            return k, v
        rows = slice(r * (s // n), (r + 1) * (s // n))
        return k[:, rows], v[:, rows]
    kv = torch.cat([k, v], dim=2)
    kv = (coll.all_gather_dim(kv, 2, group) if s % n
          else coll.heads_to_sequence(kv, group))
    kv = kv.reshape(b, kv.shape[1], n, 2, kv_loc, dh)
    return (kv[:, :, :, 0].reshape(b, -1, n * kv_loc, dh).contiguous(),
            kv[:, :, :, 1].reshape(b, -1, n * kv_loc, dh).contiguous())


def _kv_to_serving_layout(params, cfg: ModelCfg, state: dict,
                          group) -> dict:
    """A prefill's attention caches in the serving layout over the M ranks
    of ``group``, in place of the state's entries: where M divides the
    ring's S rows, ring rows [r S/M, (r+1) S/M) of every KV head; else the
    whole ring of every KV head. Caches filled on the rank's KV heads (B,
    S, Hkv/M, dh) take an all-to-all of K and V together (an all-gather
    for a whole ring); an MLA latent and rope ring, and K/V of every KV
    head (``attention.kv_replicated``), are the same on every rank and
    keep the rank's rows. ``pos`` is the same on every rank."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    parts = ({"segments": list(params.blocks)} if cfg.soi is None else
             dict(zip(("pre", "mid", "post"), split_blocks(params, cfg))))
    for name, blocks in parts.items():
        for bp, c in zip(blocks, state[name]):
            if not is_attn_cache(c):
                continue
            s = c["pos"].shape[1]
            if s % n == 0:
                rows = slice(r * (s // n), (r + 1) * (s // n))
                c["pos"] = c["pos"][:, rows].contiguous()
            if bp.bcfg.attn.is_mla:
                if s % n == 0:
                    for key in ("latent", "rope"):
                        c[key] = c[key][:, rows].contiguous()
                continue
            c["k"], c["v"] = (t.contiguous() for t in _rows_of_every_head(
                bp.attn, c["k"], c["v"], group))
    return state


# ---------------------------------------------------------------------------
# Standard decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(params, cfg: ModelCfg, state: dict, token, *, commit=None):
    """token: (B,) int. Returns (logits (B, V), state) with the caches
    written in place and the clocks ``state["t"]`` advanced in place.
    ``commit`` ((B,) bool) limits the dense ring and RG-LRU writes to its
    True rows (a pool's writes go where the page map sends them)."""
    if cfg.soi is not None:
        raise NotImplementedError(
            "decode_step does not run SOI configs: use "
            "repro_torch.engine.step.generate_step")
    params = cast_params(params, cfg)
    t = state["t"]
    pg = state["pages"].get("outer") if "pages" in state else None
    x = _embed_one(params, cfg, token, t)
    x = _segment_decode(params.blocks, state["segments"], cfg, x, t,
                        commit=commit, pages=pg, cross=cross_reads(state))
    t.add_(1)
    return _logits_one(params, cfg, x), state


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def supports_masked_prefill(cfg: ModelCfg) -> bool:
    """Whether ``prefill(..., true_length=...)`` covers this config: pad is
    kept out of real positions by causality, which prefix-LM and
    bidirectional attention, recurrences and MoE routing break."""
    if cfg.prefix_lm:
        return False
    for seg in cfg.segments:
        for b in seg.blocks:
            if b.rglru is not None or b.rwkv is not None or b.moe is not None:
                return False
            if b.attn is not None and b.attn.kind == "bidir":
                return False
    return True


def _last_real(x, tl):
    """(B, S, d) -> (B, d): the row of the last REAL position."""
    return x[:, -1] if tl is None else x[:, tl - 1]


@torch.no_grad()
def prefill(params, cfg: ModelCfg, tokens, *, prefix_embeds=None,
            encoder_frames=None, max_len: int | None = None,
            true_length: int | None = None):
    """Run the full-sequence path once, filling decode caches.

    Returns (last_logits (B, V), state) ready for a decode step at position
    S (or ``true_length``). SOI models stream the prompt through the
    *compressed* trunk: the pre layers fill full-rate caches, the strided
    conv compresses the prompt to ceil(S/stride) frames which fill the
    middle caches, and the extrapolated + fused stream fills the post
    caches; the conv window and extrapolation queue are left where
    token-by-token streaming would have left them.

    ``true_length`` (a host int) enables bucketed prefill: ``tokens`` is
    right-padded and only the first ``true_length`` positions are real. Cache
    fills, the conv window, the queue and the logits are read at the true
    length; phantom frames built from pad run through the middle but never
    enter its caches, so the result equals the unpadded prefill.

    ``prefix_embeds`` (B, P, d) go ahead of the token embeddings (the clock
    lands on P + S; the caches are still ``max_len`` or S long, as in the
    reference), and a prefix-LM config's first ``frontend_len`` positions
    attend bidirectionally. An encoder-decoder config needs
    ``encoder_frames`` (B, n_frames, d_enc): the encoder runs once and the
    state carries every cross layer's K/V of its output. SOI configs
    prefill decoder-only causal token stacks only, as in the reference.

    Under ``layers.sequence_parallel`` the blocks run on the rank's rows
    of the carry where the model axis divides its length (``trunk``'s
    layout), gathered whole around SOI's compress and fusion and before
    the last row; attention, the RG-LRU and a MoE gather the sequence, so
    the caches are the unsplit run's.
    """
    params = cast_params(params, cfg)
    b, s = tokens.shape
    if s == 0 and prefix_embeds is None:
        raise ValueError("prefill requires a non-empty prompt")
    tl = None
    if true_length is not None:
        if not supports_masked_prefill(cfg):
            raise NotImplementedError(
                f"config '{cfg.name}' cannot mask pad: prefill at the exact "
                f"prompt length instead")
        if prefix_embeds is not None:
            raise NotImplementedError(
                "true_length does not compose with prefix_embeds")
        tl = int(true_length)
        if not 0 < tl <= s:
            raise ValueError(f"true_length {tl} outside (0, {s}]")
    max_len = max_len or s
    enc_out = None
    if cfg.encoder is not None:
        if encoder_frames is None:
            raise ValueError(
                f"config '{cfg.name}' has an encoder: prefill needs "
                f"encoder_frames (B, {cfg.encoder.n_frames}, "
                f"{cfg.encoder.d_model})")
        enc_out = encode(params, cfg, encoder_frames)
    x, split = embed_inputs(params, cfg, tokens, prefix_embeds)
    s_all = s + (0 if prefix_embeds is None else prefix_embeds.shape[1])
    positions = torch.arange(s_all, device=x.device)[None]
    prefix_len = cfg.frontend_len if cfg.prefix_lm else 0

    if cfg.soi is None:
        state = {"t": torch.full((b,), s_all if tl is None else tl,
                                 dtype=torch.int32, device=x.device)}
        x, state["segments"] = seq_forward(
            params.blocks, cfg, x, split, positions=positions,
            prefix_len=prefix_len, enc_out=enc_out, collect_cache=True,
            batch=b, max_len=max_len, true_length=tl)
        if split:
            x = gather_seq(x)
        if enc_out is not None:
            state.update(fill_cross_kv(params, enc_out))
        return _prefill_out(params, cfg, _last_real(x, tl), state)

    if prefix_embeds is not None or enc_out is not None or cfg.prefix_lm:
        raise NotImplementedError(
            "SOI prefill supports decoder-only causal token stacks "
            "(no prefix embeds / encoder / prefix-LM)")
    state = {"t": torch.full((b,), s if tl is None else tl,
                             dtype=torch.int32, device=x.device)}
    soi = cfg.soi
    st = soi.stride
    pre, mid, post = split_blocks(params, cfg)
    x, state["pre"] = seq_forward(pre, cfg, x, split, positions=positions,
                                  collect_cache=True, batch=b,
                                  max_len=max_len, true_length=tl)
    skip = x = gather_seq(x) if split else x
    # conv window: the last stride-1 pre-trunk frames before the true length
    # (zero-padded for prompts shorter than the window)
    end = s if tl is None else tl
    padded = torch.nn.functional.pad(x, (0, 0, st - 1, 0))
    state["conv_buf"] = padded[:, end:end + st - 1].contiguous()

    xc = soi_compress(params, soi, x)
    cpos = torch.arange(xc.shape[1], device=x.device)[None]
    n_frames = None if tl is None else (tl + st - 1) // st
    xc, state["mid"] = whole_forward(
        mid, cfg, xc, positions=cpos, collect_cache=True, batch=b,
        max_len=soi_mid_len(max_len, st), true_length=n_frames)
    # extrapolation queue: stride copies of the last REAL middle frame
    last = xc[:, -1] if n_frames is None else xc[:, n_frames - 1]
    state["queue"] = last[:, None].expand(b, st, last.shape[-1]).contiguous()

    x = soi_fuse(params, soi_extrapolate(soi, xc, s), skip)
    x, state["post"] = seq_forward(post, cfg, split_seq(x) if split else x,
                                   split, positions=positions,
                                   collect_cache=True, batch=b,
                                   max_len=max_len, true_length=tl)
    if split:
        x = gather_seq(x)
    return _prefill_out(params, cfg, _last_real(x, tl), state)


def _prefill_out(params, cfg: ModelCfg, x_last, state: dict):
    """(logits, state) of a prefill: under ``model_parallel`` over more
    than one rank, the caches in the serving layout."""
    logits = _logits_one(params, cfg, x_last)
    group = model_group()
    if group is not None and dist.get_world_size(group) > 1:
        _kv_to_serving_layout(params, cfg, state, group)
    return logits, state


# ---------------------------------------------------------------------------
# Chunked prefill: one chunk program, looped on the host
# ---------------------------------------------------------------------------

def _block_chunk(bp, cfg: ModelCfg, x, cache, offset: int, true_length: int):
    """One block over a prefill chunk (B, C, d): attention appends to the
    ring cache at ``offset``; the MLP is per position."""
    eps = cfg.norm_eps
    h = block_norm(bp, 1, x, eps)
    h, _ = attn.attn_chunk(bp.attn, h, cache, offset, true_length,
                           norm_eps=eps)
    x = x + h
    h = block_norm(bp, 2, x, eps)
    return x + mlp_apply(bp.mlp, h)


def _segment_chunk(blocks, caches, cfg: ModelCfg, x, offset: int,
                   true_length: int):
    """Chunked-prefill analogue of ``_segment_decode``: C tokens wide."""
    for bp, c in zip(blocks, caches):
        x = _block_chunk(bp, cfg, x, c, offset, true_length)
    return x


@torch.no_grad()
def prefill_chunk(params, cfg: ModelCfg, state: dict, tokens, offset: int,
                  true_length: int):
    """Append one prefill chunk to the decode state's caches, in place.

    ``tokens``: (B, C) at absolute positions [offset, offset + C); the host
    loops it::

        state = init_decode_state(params, cfg, 1, max_len=L)
        for i in range(ceil(true_length / C)):
            logits, state = prefill_chunk(params, cfg, state,
                                          tokens[:, i*C:(i+1)*C], i*C, tl)

    Rows at positions >= ``true_length`` are pad: masked out of the cache
    merges, the SOI conv window and extrapolation queue, and the compressed
    middle's frames. Returns (logits, state): next-token logits read at
    position ``true_length - 1`` (meaningful for the chunk holding it). The
    clock lands on ``true_length``. ``offset`` and ``true_length`` are host
    ints, so no step of the chunk reads the device.

    SOI configs need ``C % stride == 0`` and chunk-aligned offsets, so a
    compression window never straddles a chunk: the conv carry
    (``state["conv_buf"]``) supplies the stride-1 frames of left context,
    as in the streaming step.
    """
    params = cast_params(params, cfg)
    b, c = tokens.shape
    if cfg.encoder is not None or cfg.prefix_lm:
        raise NotImplementedError(
            "chunked prefill supports decoder-only causal token stacks")
    if not supports_masked_prefill(cfg):
        raise NotImplementedError(
            f"config '{cfg.name}' cannot mask pad: chunked prefill would "
            f"leak pad tokens — prefill whole instead")
    offset, tl = int(offset), int(true_length)
    x = _embed_tokens(params, cfg, tokens, positions=torch.arange(
        offset, offset + c, device=tokens.device))
    state["t"] = torch.full((b,), tl, dtype=torch.int32, device=x.device)
    li = min(max(tl - 1 - offset, 0), c - 1)   # row of position tl - 1

    if cfg.soi is None:
        x = _segment_chunk(params.blocks, state["segments"], cfg, x, offset,
                           tl)
        return _logits_one(params, cfg, x[:, li]), state

    soi = cfg.soi
    st = soi.stride
    if c % st or offset % st:
        raise ValueError(f"SOI chunked prefill needs the chunk size {c} and "
                         f"the offset {offset} to be multiples of the "
                         f"stride {st}")
    pre, mid, post = split_blocks(params, cfg)
    d = x.shape[-1]
    x = _segment_chunk(pre, state["pre"], cfg, x, offset, tl)
    skip = x

    # compression across the chunk: the conv carry holds the stride-1
    # pre-trunk frames before the chunk, so the C/st windows tile the first
    # C rows of [carry; x]
    concatx = torch.cat([state["conv_buf"].to(x.dtype), x], dim=1)
    n_cf = c // st
    frames_in = concatx[:, :c].reshape(b, n_cf, st * d)
    xm = torch.matmul(frames_in,
                      params.soi_compress.to(x.dtype).reshape(st * d, d))
    j0 = offset // st
    n_true = (tl + st - 1) // st          # frames the true prompt completes
    xm = _segment_chunk(mid, state["mid"], cfg, xm, j0, n_true)

    # conv carry -> the last st-1 pre-trunk rows before the true length
    # (token a sits at row a - offset + st - 1 of the concat); an all-pad
    # chunk re-slices the carry unchanged
    start = min(max(tl - offset, 0), c)
    conv_buf = concatx[:, start:start + st - 1].to(state["conv_buf"].dtype)
    # fp reads the previous chunk's last frame: the queue carried in
    prev = state["queue"][:, :1].to(xm.dtype)
    if j0 < n_true:
        # queue: stride copies of the newest true frame of this chunk
        last = xm[:, min(max(n_true - 1 - j0, 0), n_cf - 1)]
        state["queue"] = last[:, None].expand(b, st, d).to(
            state["queue"].dtype).contiguous()
    state["conv_buf"] = conv_buf.contiguous()

    up = torch.repeat_interleave(xm, st, dim=1)
    if soi.mode == "fp":
        up = torch.cat([prev, up[:, :-1]], dim=1)
    x = soi_fuse(params, up, skip)
    x = _segment_chunk(post, state["post"], cfg, x, offset, tl)
    return _logits_one(params, cfg, x[:, li]), state
