"""Synthetic multi-tenant load: Zipf prefixes, bursty arrivals, admission
(port of ``repro.obs.loadgen``).

Two halves:

* :func:`make_trace` — a reproducible request trace shaped like
  production prompt traffic: tenants drawn Zipf (a few tenants dominate,
  a long tail trickles), every request of a tenant sharing that tenant's
  fixed prompt prefix (the system-prompt shape the prefix cache exists
  for), random per-request suffixes, mixed generation lengths, and
  bursty Poisson arrivals (exponential gaps between bursts, geometric
  burst sizes). It draws from numpy's ``default_rng`` in the reference's
  order, so a seed gives the reference's requests.

* :func:`run_load` — drives a trace through serve-style admission on any
  engine with the ``prefill / insert / generate / free_slot /
  can_insert`` surface: requests wait for their arrival time, admission
  goes through ``can_insert`` (a request the page pool cannot back is
  deferred, not crashed), the decode loop drains results one step
  deferred (one ``convert_to_numpy`` a step), and spans and telemetry
  ride along. Time is a *virtual clock*: real ``perf_counter`` intervals
  while work is in flight, fast-forwarded across idle gaps — so a sparse
  trace replays at full speed while TTFT and queue wait still measure
  against true arrival times. Admission order therefore depends on how
  fast the host runs whenever arrivals land while work is in flight;
  with every arrival before the first admission (a very high burst rate)
  the schedule is the trace's alone.

This module does not import ``repro_torch.engine`` at module level: the
engine argument is duck-typed, and the engine's session layer reaches
back into ``repro_torch.obs``.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.obs.clock import now
from repro_torch.obs.registry import EngineTelemetry, MetricsRegistry
from repro_torch.obs.spans import Tracer


@dataclasses.dataclass(frozen=True)
class LoadRequest:
    """One synthetic request of the trace."""
    rid: int
    tenant: int
    arrival_s: float     # virtual arrival time from session start
    tokens: np.ndarray   # full prompt ids: tenant prefix + private suffix
    prefix_len: int      # leading tokens shared with the tenant's cohort
    gen_len: int         # total output tokens wanted (incl. first token)


def make_trace(n_requests: int, vocab: int, *, n_tenants: int = 8,
               zipf_a: float = 1.1, prefix_len: int = 32,
               suffix_lens=(8, 16), gen_lens=(8, 16),
               burst_rate_hz: float = 40.0, burst_mean: float = 3.0,
               seed: int = 0) -> list:
    """Reproducible multi-tenant trace, sorted by arrival time.

    ``suffix_lens`` / ``gen_lens`` are inclusive (lo, hi) ranges sampled
    uniformly per request. ``burst_rate_hz`` is the burst arrival rate
    (exponential inter-burst gaps); ``burst_mean`` the mean burst size
    (geometric). Tenant popularity is Zipf(``zipf_a``) over tenant rank.
    """
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(0, vocab, (n_tenants, prefix_len),
                            dtype=np.int32)
    weights = 1.0 / np.arange(1, n_tenants + 1) ** zipf_a
    weights /= weights.sum()

    arrivals: list = []
    t = 0.0
    while len(arrivals) < n_requests:
        t += rng.exponential(1.0 / burst_rate_hz)
        burst = int(rng.geometric(1.0 / max(burst_mean, 1.0)))
        arrivals.extend([t] * burst)
    arrivals = arrivals[:n_requests]

    reqs = []
    for rid, arrival in enumerate(arrivals):
        tenant = int(rng.choice(n_tenants, p=weights))
        s_lo, s_hi = suffix_lens
        g_lo, g_hi = gen_lens
        suffix = rng.integers(0, vocab, int(rng.integers(s_lo, s_hi + 1)),
                              dtype=np.int32)
        reqs.append(LoadRequest(
            rid=rid, tenant=tenant, arrival_s=float(arrival),
            tokens=np.concatenate([prefixes[tenant], suffix]),
            prefix_len=prefix_len,
            gen_len=int(rng.integers(g_lo, g_hi + 1))))
    return reqs


@dataclasses.dataclass
class LoadResult:
    """What one :func:`run_load` session produced."""
    summary: dict                      # flat BENCH-shaped scalars
    tracer: Tracer                     # per-request spans
    telemetry: EngineTelemetry | None  # device-metrics accumulator


def _engine_stride(engine) -> int:
    cfg = getattr(engine, "cfg", None)
    soi = getattr(cfg, "soi", None)
    return int(soi.stride) if soi is not None else 1


def run_load(engine, params, requests, *, tracer: Tracer | None = None,
             telemetry: EngineTelemetry | None = None,
             registry: MetricsRegistry | None = None,
             phase_align=False, max_steps: int = 100_000) -> LoadResult:
    """Serve ``requests`` (a :func:`make_trace` list) through ``engine``.

    ``telemetry`` defaults to a fresh :class:`EngineTelemetry` at the
    engine's SOI stride (feed an engine built with ``telemetry=True`` for
    the device-side phase/occupancy metrics; without it only host-side
    stats are collected). The tracer runs on the virtual clock (epoch
    0.0), so exported trace timestamps line up with the trace's arrival
    times.

    ``phase_align`` turns on phase-aligned admission: an insert whose slot
    would land off the batch's SOI phase class is deferred until the batch
    phase comes around to it (``engine.can_insert(..., phase_align=...)``;
    ``True`` = worst-case stride - 1 steps, an int = tighter SLO bound).
    Phase deferrals are counted separately (``phase_deferred``) from pool
    deferrals and add at most stride - 1 decode steps of queue wait.
    """
    if registry is None:
        registry = MetricsRegistry()
    if telemetry is None:
        telemetry = EngineTelemetry(_engine_stride(engine),
                                    registry=registry)
    if tracer is None:
        tracer = Tracer(t0=0.0)
    state = engine.init_decode_state(params)

    t0_real = now()
    offset = 0.0        # virtual seconds fast-forwarded across idle gaps

    def clock() -> float:
        return now() - t0_real + offset

    queue = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
    waiting: deque = deque()
    free_slots = deque(range(engine.max_concurrent_decodes))
    active: dict = {}    # slot -> {"req", "tr", "out"}
    pending = None       # (ResultTokens, {slot: rid at dispatch})
    steps = deferred = phase_deferred = 0
    phase_streak = 0     # consecutive phase deferrals of the head request
    decoded_tokens = 0
    stride = _engine_stride(engine)

    def drain(pend, state):
        nonlocal decoded_tokens
        res, snapshot = pend
        # ONE batched explicit device->host copy per step, one step
        # deferred so it overlapped the dispatched step's device compute
        res = res.convert_to_numpy()
        telemetry.observe_result(res)
        t = clock()
        for slot, rid in snapshot.items():
            ent = active.get(slot)
            if ent is None or ent["req"].rid != rid:
                continue      # freed (and maybe reused) since dispatch
            req, tr = ent["req"], ent["tr"]
            if len(ent["out"]) >= req.gen_len:
                continue
            sd = res.get_result_at_slot(slot)
            n = 1 if sd.accepted is None else int(sd.accepted[0])
            room = req.gen_len - len(ent["out"])
            take = [int(x) for x in sd.tokens[:min(n, room)]]
            ent["out"].extend(take)
            decoded_tokens += len(take)
            tr.mark_decode(len(take), t=t)
            if len(ent["out"]) >= req.gen_len:
                tr.mark_done(t=t)
                state = engine.free_slot(state, slot)
                del active[slot]
                free_slots.append(slot)
        return state

    while queue or waiting or active:
        if steps >= max_steps:
            raise RuntimeError(
                f"load harness exceeded max_steps={max_steps} with "
                f"{len(queue) + len(waiting) + len(active)} requests "
                f"unfinished — deadlocked admission (pool too small for "
                f"a single request?) or a runaway trace")
        t = clock()
        while queue and queue[0].arrival_s <= t:
            req = queue.popleft()
            tr = tracer.request(req.rid, tenant=req.tenant,
                                t_queued=req.arrival_s)
            waiting.append((req, tr))
        if not active and not waiting:
            # idle: nothing in flight and the next request is in the
            # future — fast-forward the virtual clock to its arrival
            offset += queue[0].arrival_s - t
            continue

        while waiting and free_slots:
            req, tr = waiting[0]
            slot = free_slots[0]
            if not engine.can_insert(len(req.tokens), slot):
                deferred += 1
                break       # head-of-line: pool pressure defers admission
            if (phase_align and phase_streak < 2 * stride
                    and not engine.can_insert(
                        len(req.tokens), slot, phase_align=phase_align)):
                # the pool can back it but the slot would land off the
                # batch phase: wait for the phase to come around (each
                # per-token decode step closes the gap by one, so this
                # self-resolves within stride - 1 steps). The streak cap
                # is drift insurance: speculative windows advance clocks
                # by variable accepted counts and can hop OVER the
                # alignment point — after 2*stride consecutive misses the
                # request admits misaligned rather than starve
                phase_deferred += 1
                phase_streak += 1
                break
            phase_streak = 0
            waiting.popleft()
            free_slots.popleft()
            tr.mark_prefill_start(len(req.tokens), t=clock())
            hits0 = engine.prefix_cache_stats["hits"] \
                if getattr(engine, "prefix_cache_enabled", False) else 0
            prefix = engine.prefill(params, req.tokens)
            hit = (engine.prefix_cache_stats["hits"] > hits0
                   if getattr(engine, "prefix_cache_enabled", False)
                   else False)
            skipped = (prefix.cache_meta or {}).get("hit", 0)
            tr.mark_prefill_end(cache_hit=hit, tokens_skipped=skipped,
                                t=clock())
            state = engine.insert(prefix, state, slot)
            t_ins = clock()
            tr.mark_inserted(t=t_ins)
            # the first token is a prefill product, read once per request
            # off the decode clock (not a per-step sync)
            first = int(prefix.first_token[0])  # sync-ok: once per request
            tr.mark_first_token(t=t_ins)
            if req.gen_len <= 1:
                # the prefill-produced first token already satisfies the
                # request: never enters the decode loop
                tr.mark_done(t=t_ins)
                state = engine.free_slot(state, slot)
                free_slots.append(slot)
            else:
                active[slot] = {"req": req, "tr": tr, "out": [first]}

        if not active:
            if not waiting:
                continue
            # every waiting request is deferred and no slot is draining:
            # only completions can unblock, and there are none in flight
            raise RuntimeError(
                "admission deadlock: requests deferred by can_insert with "
                "no active slots to free — size the page pools for at "
                "least one full request")

        state, result = engine.generate(params, state)
        steps += 1
        snapshot = {slot: ent["req"].rid for slot, ent in active.items()}
        if pending is not None:
            state = drain(pending, state)
        pending = (result, snapshot)
    if pending is not None:
        state = drain(pending, state)

    elapsed = max(now() - t0_real, 1e-9)
    telemetry.snapshot_engine(engine)
    summary = dict(tracer.summary())
    summary.update({
        "steps": steps,
        "deferred_admissions": deferred,
        "phase_deferred": phase_deferred,
        "elapsed_s": elapsed,
        "tok_s": decoded_tokens / elapsed,
    })
    for k, v in telemetry.phase_coherence().items():
        summary[f"phase_{k}"] = v
    if getattr(engine, "prefix_cache_enabled", False):
        summary["hit_rate"] = engine.prefix_cache_stats["hit_rate"]
    return LoadResult(summary=summary, tracer=tracer, telemetry=telemetry)
