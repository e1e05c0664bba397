"""The per-token serving step, dense layout (port of
``repro.engine.step.generate_step``).

For SOI configs the paper's phase schedule (recompute the compressed middle
only when ``t % stride == 0``) is resolved per slot from the clock vector
``state["t"]: (B,)``:

  * the pre/post layers and the conv window push run for every slot, every
    step;
  * the compressed middle runs only when at least one active slot's window
    is complete. The reference decides that inside its compiled program
    (``lax.cond(jnp.any(run_mid))``); in eager PyTorch a branch on a device
    tensor is a host sync every step, so the engine passes the predicate in
    as a Python bool (``run_mid_any``) computed from its host clocks;
  * middle cache writes and the extrapolation-queue update are masked per
    slot on the device, so slots that are mid-window keep their cached
    partial states while their neighbours recompute. On dense rings the
    cache write takes a per-row ``commit`` mask; on paged pools the step
    hands the middle the page map ``where(run_mid, mid_pages, 0)``
    (reference ``engine/step.py:176-188``), so a mid-window slot's write
    lands on the null page and its (discarded) read sees an empty cache.
    The reference's ``_select_mid_caches(paged=True)`` then selects by row
    only the leaves that are not attention pools — the RG-LRU layers'
    per-slot states — so the paged middle also takes the ``commit`` mask,
    which its attention layers ignore (their writes go through the page
    map) and its RG-LRU layers apply.

The step updates the decode state in place and returns it: the caches,
and the clocks ``t``, the extrapolation queue and the conv window, so a
captured step (``engine.contracts.CheckedGraph``) writes the tensors it
was captured with.

Two options serve self-speculative decoding (``engine.speculative``):
``draft=True`` is the reference's off-phase-forced step, and ``commit``
is the in-place form of the reference's ``_commit_masked``: the reference
selects old rows back after a functional step, the port masks the writes
themselves (pre/post caches, RG-LRU states, the conv window, the clock).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import decode as D
from repro_torch.models.transformer import cast_params, split_blocks


@torch.no_grad()
def step_metrics(t, active, stride: int):
    """The per-step telemetry vector (port of
    ``repro.engine.step.step_metrics``), from the clocks ``t`` (B,) the
    step starts from. Layout (int32, length ``stride + 2``, on ``t``'s
    device)::

        [occ_phase_0, ..., occ_phase_{stride-1}, mid_fired, n_active]

    ``occ_phase_p`` counts active slots whose clock sits at ``t % stride
    == p``; ``mid_fired`` is 1 iff some active slot sits at phase 0 (the
    step runs the compressed middle); ``n_active`` is the live-slot count.
    ``active`` None means every slot; ``stride=1`` for a config without
    SOI (one bucket, the "middle" fires whenever a slot is active).

    Six kernels on the card and no host read, so a captured step can
    compute it: the histogram is an ``index_add_`` into fixed zeros (not
    ``bincount``, which reads its size on the host), ``mid_fired`` the
    phase-0 bucket clamped to 1, ``n_active`` a sum, each written into
    its slot of the one output.
    """
    one = (torch.ones(t.shape[0], dtype=torch.int32, device=t.device)
           if active is None else active.to(torch.int32))
    out = torch.zeros(stride + 2, dtype=torch.int32, device=t.device)
    out[:stride].index_add_(0, t % stride, one)
    torch.clamp(out[:1], max=1, out=out[stride:stride + 1])
    torch.sum(one, 0, keepdim=True, dtype=torch.int32, out=out[stride + 1:])
    return out


@torch.no_grad()
def generate_step(params, cfg: ModelCfg, state: dict, tokens, *,
                  active=None, run_mid_any: bool | None = None,
                  draft: bool = False, commit=None):
    """Advance every slot one token. tokens: (B,) int; state["t"]: (B,).

    Returns (logits (B, V) float32, state). ``active`` ((B,) bool) marks
    occupied slots: inactive slots' clocks freeze and never trigger the
    middle. ``run_mid_any`` says whether some active slot sits at phase 0;
    when None it is read from the device (one host sync — tests only).

    ``draft=True`` forces every slot off-phase: the middle never runs, every
    position is served from the extrapolation queue, and neither the
    middle's caches nor the queue are written — the self-speculative draft
    schedule. A plain config has no middle: the flag is a no-op there.

    ``commit`` ((B,) bool) keeps the step's writes to its True rows: the
    pre/post dense rings and every RG-LRU state (pools: the caller hands a
    page map whose rejected rows are null), the conv window, and the clock,
    which advances under ``active & commit``, as does the middle's gate.
    None leaves the step as it is without the option.
    """
    if commit is not None:
        active = commit if active is None else active & commit
    if cfg.soi is None:
        logits, state = D.decode_step(params, cfg, state, tokens,
                                      commit=commit)
        if active is not None:
            # inactive slots' clocks stay where they were
            state["t"].sub_((~active).to(state["t"].dtype))
        return logits, state

    params = cast_params(params, cfg)
    st = cfg.soi.stride
    pre, mid, post = split_blocks(params, cfg)
    b = tokens.shape[0]
    t = state["t"]
    phase = t % st
    run_mid = phase == 0                  # (B,) this slot's window is done
    if active is not None:
        run_mid = run_mid & active
    if draft:
        run_mid = torch.zeros_like(run_mid)
        run_mid_any = False
    if run_mid_any is None:
        run_mid_any = bool(run_mid.any())

    pages = state.get("pages") or {}
    outer_pg = pages.get("outer")
    mid_pg = pages.get("mid")

    x = D._embed_one(params, cfg, tokens)
    x = D._segment_decode(pre, state["pre"], cfg, x, t, commit=commit,
                          pages=outer_pg)
    skip = x
    window = torch.cat([state["conv_buf"], x[:, None]], dim=1)  # (B, st, d)
    d = x.shape[-1]
    xc = torch.matmul(window.reshape(b, st * d),
                      params.soi_compress.to(x.dtype).reshape(st * d, d))
    if run_mid_any:
        # mid-window slots run the middle on a garbage window; only complete
        # windows commit their frame to the middle's caches
        if mid_pg is None:
            xm = D._segment_decode(mid, state["mid"], cfg, xc, t // st,
                                   commit=run_mid)
        else:
            mp = torch.where(run_mid[:, None], mid_pg,
                             torch.zeros_like(mid_pg))
            xm = D._segment_decode(mid, state["mid"], cfg, xc, t // st,
                                   commit=run_mid, pages=mp)
    else:
        xm = torch.zeros_like(xc)

    queue = state["queue"]
    rows = torch.arange(b, device=t.device)
    if cfg.soi.mode == "fp":
        # FP serves strictly-past data: the queue head, even on phase 0
        xu = queue[rows, phase.clamp(max=st - 1).long()]
    else:
        stale = queue[rows, (phase - 1).clamp(0, st - 1).long()]
        xu = torch.where(run_mid[:, None], xm, stale)
    if not draft:
        queue.copy_(torch.where(run_mid[:, None, None],
                                xm[:, None].expand(b, st, d), queue))
    conv = window[:, 1:]
    if commit is not None:
        conv = torch.where(commit[:, None, None], conv, state["conv_buf"])
    state["conv_buf"].copy_(conv)

    fused = torch.matmul(torch.cat([xu, skip], dim=-1),
                         params.soi_fuse.to(x.dtype))
    x = D._segment_decode(post, state["post"], cfg, fused, t, commit=commit,
                          pages=outer_pg)
    t.add_(1 if active is None else active.to(t.dtype))
    return D._logits_one(params, cfg, x), state
