"""Request-span tracing: the lifecycle of one request, timestamped (port
of ``repro.obs.spans``).

A request moves ``queued → prefill (cache hit or cold) → insert →
first token → per-window decode commits → done``; :class:`RequestTrace`
records each transition with the shared monotonic clock
(``repro_torch.obs.clock.now``) and derives the serving latencies from them:

* **queue wait** — ``prefill_start - queued`` (admission + head-of-line);
* **TTFT** — ``first_token - queued`` (time to first token; in this
  engine the first token is produced by prefill, so TTFT covers queue
  wait + prefill, including any prefix-cache skip);
* **TPOT** — ``(last_commit - first_token) / decode_tokens`` (mean time
  per decode-produced output token; the prefill-produced first token is
  excluded, matching the serving tail line's decode-rate convention).

:class:`Tracer` owns the request traces plus the session epoch ``t0``
every exported timestamp is relative to, and summarizes percentiles over
completed requests (always 0.0 on an empty/idle session — never NaN).
``repro_torch.obs.tracefile`` renders the same traces as Chrome-trace JSON for
Perfetto.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.clock import now
from repro_torch.obs.registry import percentile


@dataclasses.dataclass
class DecodeMark:
    """One generate-step (or speculative-window) commit for a request."""
    t: float            # clock at the commit (drain time)
    tokens: int         # tokens committed this window (1 for per-token)


class RequestTrace:
    """Timestamps of one request's lifecycle; marks may be skipped (a
    deferred request has no prefill marks yet) but never reordered."""

    def __init__(self, rid, tenant=None, t_queued: float | None = None):
        self.rid = rid
        self.tenant = tenant
        self.queued = now() if t_queued is None else t_queued
        self.prefill_start: float | None = None
        self.prefill_end: float | None = None
        self.cache_hit = False
        self.tokens_skipped = 0
        self.prompt_tokens = 0
        self.inserted: float | None = None
        self.first_token: float | None = None
        self.done: float | None = None
        self.decode_marks: list = []

    # -- lifecycle marks ---------------------------------------------------

    def mark_prefill_start(self, prompt_tokens: int, t=None):
        self.prefill_start = now() if t is None else t
        self.prompt_tokens = int(prompt_tokens)

    def mark_prefill_end(self, *, cache_hit: bool = False,
                         tokens_skipped: int = 0, t=None):
        self.prefill_end = now() if t is None else t
        self.cache_hit = bool(cache_hit)
        self.tokens_skipped = int(tokens_skipped)

    def mark_inserted(self, t=None):
        self.inserted = now() if t is None else t

    def mark_first_token(self, t=None):
        # in this engine prefill produces the first token, so serve loops
        # usually mark this together with insert; kept separate for
        # engines whose first token comes off the first decode step
        self.first_token = now() if t is None else t

    def mark_decode(self, tokens: int, t=None):
        self.decode_marks.append(DecodeMark(now() if t is None else t,
                                            int(tokens)))

    def mark_done(self, t=None):
        self.done = now() if t is None else t

    # -- derived latencies -------------------------------------------------

    @property
    def decode_tokens(self) -> int:
        return sum(m.tokens for m in self.decode_marks)

    @property
    def queue_wait_s(self) -> float | None:
        if self.prefill_start is None:
            return None
        return self.prefill_start - self.queued

    @property
    def ttft_s(self) -> float | None:
        if self.first_token is None:
            return None
        return self.first_token - self.queued

    @property
    def tpot_s(self) -> float | None:
        """Mean seconds per decode-produced token; None before the first
        decode commit."""
        if self.first_token is None or not self.decode_marks:
            return None
        span = self.decode_marks[-1].t - self.first_token
        return span / max(self.decode_tokens, 1)


class Tracer:
    """Session-level collector of :class:`RequestTrace` objects.

    ``t0`` is the epoch exported timestamps are relative to; pass an
    explicit one (e.g. 0.0) to run the tracer on a virtual clock — the
    load harness stamps marks with virtual arrival-faithful times so the
    exported timeline matches the trace's arrival process without the
    harness ever sleeping through idle gaps.
    """

    def __init__(self, t0: float | None = None):
        self.t0 = now() if t0 is None else float(t0)
        self._traces: dict = {}

    def request(self, rid, tenant=None,
                t_queued: float | None = None) -> RequestTrace:
        if rid in self._traces:
            raise ValueError(f"request id {rid!r} already traced")
        tr = self._traces[rid] = RequestTrace(rid, tenant=tenant,
                                              t_queued=t_queued)
        return tr

    def get(self, rid) -> RequestTrace:
        return self._traces[rid]

    @property
    def traces(self) -> list:
        return list(self._traces.values())

    def summary(self) -> dict:
        """Flat percentile summary over requests (BENCH-shaped scalars).
        Requests still in flight contribute the marks they have; an empty
        session reports all-zeros."""
        trs = self.traces
        ttft = [t.ttft_s for t in trs if t.ttft_s is not None]
        tpot = [t.tpot_s for t in trs if t.tpot_s is not None]
        waits = [t.queue_wait_s for t in trs if t.queue_wait_s is not None]
        done = [t for t in trs if t.done is not None]
        return {
            "requests": len(trs),
            "completed": len(done),
            "cache_hits": sum(1 for t in trs if t.cache_hit),
            "tokens_skipped": sum(t.tokens_skipped for t in trs),
            "decode_tokens": sum(t.decode_tokens for t in trs),
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p99_s": percentile(ttft, 99),
            "tpot_p50_s": percentile(tpot, 50),
            "tpot_p99_s": percentile(tpot, 99),
            "queue_wait_p50_s": percentile(waits, 50),
            "queue_wait_p99_s": percentile(waits, 99),
        }
