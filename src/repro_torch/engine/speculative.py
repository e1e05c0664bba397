"""Self-speculative decoding (port of ``repro.engine.speculative``): SOI
off-phase steps draft, the true schedule verifies — up to ``K`` tokens
commit a window.

SOI's premise is that the middle's partial states are predictable enough to
extrapolate instead of recompute; that is the property a *draft model*
needs, so the model drafts for itself:

* **draft burst** — ``K-1`` off-phase-forced steps (``generate_step(...,
  draft=True)``): the compressed middle never runs, every position is
  served from the (stale) extrapolation queue;
* **verify window** — the draft-conditioned inputs ``[a_0, d_1, ...,
  d_{K-1}]`` replay through the true phase schedule. Token ``j``'s output
  ``v_j`` is the token the plain engine would have produced from the same
  inputs; a slot accepts the longest prefix where the draft's guess
  matches (``d_j == v_j``) plus the verifier's own token at the first
  mismatch, so each window commits ``n ∈ [1, K]`` tokens.

The reference carries the draft's cache writes in a copy of the state
inside its ``lax.scan`` and drops it. The port writes its decode state in
place (``models/decode.py``), so the burst is undone instead: before it,
``draft_rows`` gathers every row the K-1 draft steps will write — the
outer layers' ring rows (or the pool rows their page map reaches) at
positions ``t .. t+K-2``, the outer RG-LRU states, the clocks and the conv
window — and ``restore_rows`` scatters them back after it. A draft step
never runs the middle, so the middle's caches and the queue are never
touched. At qwen3-1.7b's serving shape (B 4, 14 outer layers of 8 × 128
bf16 K and V) that is 672 KiB of rows at K = 4, where a copy of the whole
decode state would be ~357 MiB.

The verify masks its writes itself, the in-place form of the reference's
``_commit_masked``: each iteration runs ``generate_step`` with ``active &
commit`` and the ``commit`` mask (rejected slots keep their ring rows,
RG-LRU states, conv window and clock), and on paged layouts with the outer
page map of rejected slots set to the null page (``_mask_outer_pages``).
``commit`` starts all True, not ``active``, so a window whose slots do not
speculate is bit for bit one plain step.

Why the verify replays the step instead of scoring all K positions through
the chunk kernel: only a step that is shape-identical to ``generate_step``
gives the plain engine's bits (the reference's docstring measures ~1e-6
in f32 from a batched scorer — enough to flip an argmax tie).

``run_mid`` (a K-tuple of bools) tells each verify iteration, as a Python
value, whether to run the middle — the engine computes it on the host; a
superset of the slots that reach phase 0 is exact, since a middle run with
no committing slot writes nothing but the null page. None reads it from
the device every iteration (a host sync — tests only).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.engine.contracts import state_leaves
from repro_torch.engine.step import generate_step
from repro_torch.models import decode as D


def _outer_caches(cfg: ModelCfg, state: dict) -> list:
    """The per-layer caches a draft step writes: every layer of a plain
    config, the pre and post layers of an SOI one."""
    if cfg.soi is None:
        return list(state["segments"])
    return list(state["pre"]) + list(state["post"])


@torch.no_grad()
def draft_rows(cfg: ModelCfg, state: dict, k: int) -> list:
    """Gather every row ``k - 1`` draft steps from ``state`` write:
    ``[(leaf, index, saved)]`` for ``restore_rows`` (``index`` None: the
    whole leaf). Attention caches give the rows at positions ``t .. t+k-2``
    of each slot — through the outer page map on pools, where an
    unbacked position reaches the null page, which is restored too."""
    t = state["t"]
    out = [(t, None, t.clone())]
    if cfg.soi is not None:
        out.append((state["conv_buf"], None, state["conv_buf"].clone()))
    n = k - 1
    if n < 1:
        return out
    b = t.shape[0]
    pos = t.long()[:, None] + torch.arange(n, device=t.device)   # (B, n)
    pages = (state.get("pages") or {}).get("outer")
    index = {}
    for c in _outer_caches(cfg, state):
        if not D.is_attn_cache(c):
            out += [(leaf, None, leaf.clone())
                    for _, leaf in state_leaves(c)]
            continue
        s = c["pos"].shape[1]          # ring length, or page size on pools
        if s not in index:
            if pages is None:
                rows = torch.arange(b, device=t.device)[:, None]
                index[s] = (rows.expand(b, n), pos % s)
            else:
                lg = pos % (pages.shape[1] * s)
                index[s] = (pages.gather(1, lg // s).long(), lg % s)
        ix = index[s]
        out += [(leaf, ix, leaf[ix]) for leaf in c.values()]
    return out


@torch.no_grad()
def restore_rows(saved: list):
    """Write ``draft_rows``' gathers back, in place. Several entries may
    name one row (the null page, a ring shorter than the burst): they hold
    the same gathered bytes."""
    for leaf, ix, val in saved:
        if ix is None:
            leaf.copy_(val)
        else:
            leaf.index_put_(ix, val)


@torch.no_grad()
def draft_burst(params, cfg: ModelCfg, state: dict, tokens, *, k: int,
                active):
    """Run ``k - 1`` off-phase-forced steps from ``tokens`` and return the
    draft tokens ``(B, k-1)`` int32. The burst writes the decode state in
    place and puts every row it wrote back before it returns: the caller's
    state is bit for bit what it was."""
    b = tokens.shape[0]
    if k <= 1:
        return torch.zeros((b, 0), dtype=torch.int32, device=tokens.device)
    saved = draft_rows(cfg, state, k)
    tok, drafts = tokens, []
    for _ in range(k - 1):
        logits, _ = generate_step(params, cfg, state, tok, active=active,
                                  draft=True)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        drafts.append(tok)
    restore_rows(saved)
    return torch.stack(drafts, dim=1)


def _mask_outer_pages(state: dict, commit) -> dict:
    """The state with the outer page map of rejected slots set to the null
    page, so their pre/post writes land on discarded memory (the middle's
    map is already gated by the step's ``run_mid``). A shallow copy: every
    cache leaf is the caller's."""
    pages = state.get("pages")
    if not pages or "outer" not in pages:
        return state
    outer = pages["outer"]
    masked = torch.where(commit[:, None], outer, torch.zeros_like(outer))
    return dict(state, pages=dict(pages, outer=masked))


@torch.no_grad()
def verify_commit(params, cfg: ModelCfg, state: dict, inputs, *, active,
                  spec, run_mid=None):
    """Replay the true phase schedule over ``inputs`` (B, k) — column 0 the
    real pending token, columns 1.. the draft's guesses — committing the
    longest matching prefix plus the verifier's correction token, in place.

    Returns ``(state, committed (B, k), n_acc (B,), next_tok (B,), logits
    (B, V))``: committed column j is valid iff ``j < n_acc``; ``next_tok``
    is the feedback token for the next window (the last committed token)
    and ``logits`` the distribution that produced it. Rejected iterations
    leave no trace in any leaf (pools: outside the null page). ``run_mid``:
    see the module docstring.

    Split out from ``speculative_window`` so tests can drive acceptance and
    rollback with arbitrary draft tokens.
    """
    b, k = inputs.shape
    dev = inputs.device
    active = torch.as_tensor(active, dtype=torch.bool, device=dev).expand(b)
    spec = torch.as_tensor(spec, dtype=torch.bool, device=dev).expand(b)
    inputs = inputs.to(torch.int32)
    # iteration j may continue into j+1 only if its output equals
    # inputs[:, j+1]; the last iteration has no continuation
    guesses = torch.cat([inputs[:, 1:],
                         torch.zeros((b, 1), dtype=torch.int32, device=dev)],
                        dim=1)
    commit = n_acc = next_tok = last_lg = None
    out = []
    for j in range(k):
        mid = (None if run_mid is None
               else bool(run_mid[j]))  # sync-ok: run_mid is the static host key tuple
        if j == 0:
            # commit starts all True (NOT ``active``): the first iteration
            # is exactly one plain step, unmasked writes of free slots
            # included, so a window degrades bit for bit to a plain step
            logits, _ = generate_step(params, cfg, state, inputs[:, 0],
                                      active=active, run_mid_any=mid)
            v = torch.argmax(logits, dim=-1).to(torch.int32)
            n_acc = active.to(torch.int32)
            next_tok, last_lg = v, logits
            out.append(v)
            commit = active & spec
        else:
            logits, _ = generate_step(params, cfg,
                                      _mask_outer_pages(state, commit),
                                      inputs[:, j], active=active,
                                      run_mid_any=mid, commit=commit)
            v = torch.argmax(logits, dim=-1).to(torch.int32)
            n_acc = n_acc + (active & commit).to(torch.int32)
            next_tok = torch.where(commit, v, next_tok)
            last_lg = torch.where(commit[:, None], logits, last_lg)
            out.append(torch.where(commit, v, torch.zeros_like(v)))
        commit = commit & (v == guesses[:, j])
    return state, torch.stack(out, dim=1), n_acc, next_tok, last_lg


@torch.no_grad()
def speculative_window(params, cfg: ModelCfg, state: dict, tokens, *,
                       k: int, active, spec, run_mid=None):
    """Advance every slot by up to ``k`` tokens: one draft burst, then the
    verify. ``tokens`` (B,) are the pending input tokens; ``active`` (B,)
    marks occupied slots; ``spec`` (B,) the slots allowed to speculate
    (the others commit exactly one token a window, so speculative and plain
    requests share a batch). Returns ``verify_commit``'s tuple. With
    ``spec`` all False the window is bit for bit one ``generate_step``."""
    if k < 1:
        raise ValueError(f"speculative window needs k >= 1, got {k}")
    active = torch.as_tensor(active, dtype=torch.bool,
                             device=tokens.device).expand(tokens.shape[0])
    drafts = draft_burst(params, cfg, state, tokens, k=k, active=active)
    inputs = torch.cat([tokens[:, None].to(torch.int32), drafts], dim=1)
    return verify_commit(params, cfg, state, inputs, active=active,
                         spec=spec, run_mid=run_mid)
