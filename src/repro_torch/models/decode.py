"""Serving path, dense layout (port of ``repro.models.decode``): decode-state
construction, bucketed prefill, the one-token decode of a run of layers, and
the plain (non-SOI) decode step.

State layout: ``{"t": (B,) int32 per-slot clocks, ...}`` plus, for a plain
config, ``"segments"``: one cache dict (``k``, ``v``, ``pos``) per layer;
for an SOI config ``"pre"``, ``"mid"``, ``"post"`` (per-layer caches of the
three parts; the middle's hold ``soi_mid_len`` frames), the conv window
``"conv_buf"`` (B, stride-1, d) and the extrapolation queue ``"queue"``
(B, stride, d). The reference stacks a segment's caches on a leading layer
axis; here every layer owns its tensors.

Decode updates the caches in place (see ``models.attention``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention as attn
from repro_torch.models.layers import norm_apply
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.transformer import (_dtype, _embed_tokens,
                                            _head_weights, _segment_forward,
                                            cast_params, soi_compress,
                                            soi_extrapolate, soi_fuse,
                                            split_blocks)


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _layer_caches(blocks, batch: int, max_len: int, dt, device) -> list:
    return [attn.init_cache(bp.bcfg.attn, batch, max_len, dt, device)
            for bp in blocks]


def soi_mid_len(max_len: int, stride: int) -> int:
    """Length of the compressed middle caches: ceil(max_len/stride)
    positions, rounded up to a multiple of 256 above 256 (the reference's
    shardable length; kept so both packages hold the same state)."""
    mid_len = -(-max_len // stride)
    return -(-mid_len // 256) * 256 if mid_len > 256 else mid_len


def init_decode_state(params, cfg: ModelCfg, batch: int,
                      max_len: int) -> dict:
    """Empty decode state with per-slot clocks ``t`` (B,), on the params'
    device."""
    dt = _dtype(cfg)
    dev = params.embed.device
    d = cfg.d_model
    state = {"t": torch.zeros(batch, dtype=torch.int32, device=dev)}
    if cfg.soi is None:
        state["segments"] = _layer_caches(params.blocks, batch, max_len, dt,
                                          dev)
        return state
    st = cfg.soi.stride
    pre, mid, post = split_blocks(params, cfg)
    state["pre"] = _layer_caches(pre, batch, max_len, dt, dev)
    state["mid"] = _layer_caches(mid, batch, soi_mid_len(max_len, st), dt,
                                 dev)
    state["post"] = _layer_caches(post, batch, max_len, dt, dev)
    state["conv_buf"] = torch.zeros((batch, st - 1, d), dtype=dt, device=dev)
    state["queue"] = torch.zeros((batch, st, d), dtype=dt, device=dev)
    return state


# ---------------------------------------------------------------------------
# One-token block / segment decode
# ---------------------------------------------------------------------------

def _block_decode(bp, cfg: ModelCfg, x, cache, t, *, commit=None):
    eps = cfg.norm_eps
    h = norm_apply("rmsnorm", bp.ln1, x, eps=eps)
    h, _ = attn.attn_decode(bp.attn, h, cache, t, norm_eps=eps,
                            commit=commit)
    x = x + h
    h = norm_apply("rmsnorm", bp.ln2, x, eps=eps)
    return x + mlp_apply(bp.mlp, h)


def _segment_decode(blocks, caches, cfg: ModelCfg, x, t, *, commit=None):
    """One token through a run of layers; their caches update in place
    (only the ``commit`` rows when given). Returns x."""
    for bp, c in zip(blocks, caches):
        x = _block_decode(bp, cfg, x, c, t, commit=commit)
    return x


def _embed_one(params, cfg: ModelCfg, token):
    return _embed_tokens(params, cfg, token[:, None])[:, 0]


def _logits_one(params, cfg: ModelCfg, x):
    """Final norm + tied head; logits in float32."""
    h = norm_apply("rmsnorm", params.final_norm, x, eps=cfg.norm_eps)
    return torch.matmul(h, _head_weights(params)).float()


# ---------------------------------------------------------------------------
# Standard decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(params, cfg: ModelCfg, state: dict, token):
    """token: (B,) int. Returns (logits (B, V), state) with the caches
    written in place and a new clock tensor ``state["t"] + 1``."""
    if cfg.soi is not None:
        raise NotImplementedError(
            "decode_step does not run SOI configs: use "
            "repro_torch.engine.step.generate_step")
    params = cast_params(params, cfg)
    t = state["t"]
    x = _embed_one(params, cfg, token)
    x = _segment_decode(params.blocks, state["segments"], cfg, x, t)
    state["t"] = t + 1
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
def prefill(params, cfg: ModelCfg, tokens, *, max_len: int | None = None,
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
    """
    params = cast_params(params, cfg)
    b, s = tokens.shape
    if s == 0:
        raise ValueError("prefill requires a non-empty prompt")
    tl = None
    if true_length is not None:
        if not supports_masked_prefill(cfg):
            raise NotImplementedError(
                f"config '{cfg.name}' cannot mask pad: prefill at the exact "
                f"prompt length instead")
        tl = int(true_length)
        if not 0 < tl <= s:
            raise ValueError(f"true_length {tl} outside (0, {s}]")
    max_len = max_len or s
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)[None]
    state = {"t": torch.full((b,), s if tl is None else tl,
                             dtype=torch.int32, device=x.device)}

    if cfg.soi is None:
        x, state["segments"] = _segment_forward(
            params.blocks, cfg, x, positions=positions, collect_cache=True,
            batch=b, max_len=max_len, true_length=tl)
        return _logits_one(params, cfg, _last_real(x, tl)), state

    soi = cfg.soi
    st = soi.stride
    pre, mid, post = split_blocks(params, cfg)
    x, state["pre"] = _segment_forward(pre, cfg, x, positions=positions,
                                       collect_cache=True, batch=b,
                                       max_len=max_len, true_length=tl)
    skip = x
    # conv window: the last stride-1 pre-trunk frames before the true length
    # (zero-padded for prompts shorter than the window)
    end = s if tl is None else tl
    padded = torch.nn.functional.pad(x, (0, 0, st - 1, 0))
    state["conv_buf"] = padded[:, end:end + st - 1].contiguous()

    xc = soi_compress(params, soi, x)
    cpos = torch.arange(xc.shape[1], device=x.device)[None]
    n_frames = None if tl is None else (tl + st - 1) // st
    xc, state["mid"] = _segment_forward(
        mid, cfg, xc, positions=cpos, collect_cache=True, batch=b,
        max_len=soi_mid_len(max_len, st), true_length=n_frames)
    # extrapolation queue: stride copies of the last REAL middle frame
    last = xc[:, -1] if n_frames is None else xc[:, n_frames - 1]
    state["queue"] = last[:, None].expand(b, st, last.shape[-1]).contiguous()

    x = soi_fuse(params, soi_extrapolate(soi, xc, s), skip)
    x, state["post"] = _segment_forward(post, cfg, x, positions=positions,
                                        collect_cache=True, batch=b,
                                        max_len=max_len, true_length=tl)
    return _logits_one(params, cfg, _last_real(x, tl)), state
