"""Export span traces as Chrome-trace JSON (Perfetto) + flat metrics JSON
(port of ``repro.obs.tracefile``).

``chrome_trace`` renders a :class:`repro_torch.obs.spans.Tracer` in the Trace
Event Format every Chromium-family viewer reads: open
https://ui.perfetto.dev and drop the file in (or ``chrome://tracing``).
One track (``tid``) per request; the lifecycle phases become complete
("X") slices — ``queued``, ``prefill`` (with cache-hit/tokens-skipped
args), ``decode`` — and every decode commit an instant ("i") event
carrying its token count, so accept-rate bursts are visible on the
timeline. Timestamps are microseconds relative to the tracer's epoch.

``write_metrics`` writes the companion flat JSON: the registry snapshot
(``MetricsRegistry.as_dict``) merged with the tracer's percentile
summary — the machine-readable half a dashboard or bench diff consumes.
"""

from __future__ import annotations

import json
import pathlib


def _us(t0: float, t: float) -> float:
    return (t - t0) * 1e6


def chrome_trace(tracer) -> dict:
    """Trace Event Format document for ``tracer``'s requests."""
    events = []
    t0 = tracer.t0
    for tid, tr in enumerate(tracer.traces, start=1):
        name = f"req {tr.rid}" + ("" if tr.tenant is None
                                  else f" (tenant {tr.tenant})")
        meta = {"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                "args": {"name": name}}
        events.append(meta)

        def slice_(label, start, end, args=None):
            if start is None or end is None:
                return
            events.append({"ph": "X", "pid": 1, "tid": tid, "name": label,
                           "ts": _us(t0, start),
                           "dur": max(_us(t0, end) - _us(t0, start), 0.0),
                           "args": args or {}})

        slice_("queued", tr.queued, tr.prefill_start)
        slice_("prefill", tr.prefill_start, tr.prefill_end,
               {"prompt_tokens": tr.prompt_tokens,
                "cache_hit": tr.cache_hit,
                "tokens_skipped": tr.tokens_skipped})
        decode_end = (tr.done if tr.done is not None
                      else (tr.decode_marks[-1].t if tr.decode_marks
                            else None))
        slice_("decode", tr.inserted, decode_end,
               {"decode_tokens": tr.decode_tokens})
        for m in tr.decode_marks:
            events.append({"ph": "i", "pid": 1, "tid": tid, "name": "commit",
                           "ts": _us(t0, m.t), "s": "t",
                           "args": {"tokens": m.tokens}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(tracer, path) -> None:
    """Write the Perfetto-openable Chrome-trace JSON."""
    path = pathlib.Path(path)
    with open(path, "w") as fh:
        json.dump(chrome_trace(tracer), fh, indent=1)
        fh.write("\n")


def write_metrics(path, registry=None, tracer=None, extra=None) -> None:
    """Write the flat metrics JSON: registry snapshot + tracer summary
    (+ ``extra`` scalars), keys namespaced so the sources can't collide."""
    doc: dict = {}
    if registry is not None:
        doc.update(registry.as_dict())
    if tracer is not None:
        doc.update({f"trace.{k}": v for k, v in tracer.summary().items()})
    if extra:
        doc.update(extra)
    path = pathlib.Path(path)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
