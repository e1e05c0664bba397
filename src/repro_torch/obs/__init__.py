"""``repro_torch.obs`` — serving observability: metrics, spans, load
harness (port of ``repro.obs``, which it does not import).

* :mod:`repro_torch.obs.clock` — the one monotonic clock (``now`` =
  ``time.perf_counter``) every span, serving loop and session shares;
* :mod:`repro_torch.obs.registry` — typed counters, gauges and histograms
  (:class:`MetricsRegistry`) plus :class:`EngineTelemetry`, the reader of
  the engine's per-step device metrics vector. The vector (phase
  occupancy over ``t % stride``, whether the middle ran, the active-slot
  count) is computed inside the captured step, from the clocks before the
  step writes them, as one more output of the step's CUDA graph; it is
  copied to the host behind the same event as the step's tokens and
  drained in the same ``host_get``. A speculative window samples it once,
  from the clocks before the window, inside the window's graph, and
  drains it with the window's own result rows. Telemetry therefore adds
  no device->host transfer and no host sync, and telemetry-off engines
  capture the graphs they captured before;
* :mod:`repro_torch.obs.spans` / :mod:`repro_torch.obs.tracefile` —
  per-request lifecycle spans (queued → prefill → insert → first
  token → decode → done) with TTFT / TPOT / queue-wait percentiles, exported as
  Chrome-trace JSON for Perfetto plus a flat metrics JSON;
* :mod:`repro_torch.obs.loadgen` — the synthetic multi-tenant load
  harness (Zipf-shared prefixes, bursty Poisson arrivals).

Metric names and units, the span schema and the deferred-drain rule are
the reference's (``docs/OBSERVABILITY.md``); the metrics JSON of the port
lacks only the reference's three compile gauges (see ``registry``).
"""

from repro_torch.obs.clock import now
from repro_torch.obs.registry import (Counter, EngineTelemetry, Gauge,
                                      Histogram, MetricsRegistry, percentile)
from repro_torch.obs.spans import RequestTrace, Tracer
from repro_torch.obs.tracefile import chrome_trace, write_metrics, write_trace
from repro_torch.obs.loadgen import (LoadRequest, LoadResult, make_trace,
                                     run_load)

__all__ = [
    "Counter", "EngineTelemetry", "Gauge", "Histogram", "LoadRequest",
    "LoadResult", "MetricsRegistry", "RequestTrace", "Tracer",
    "chrome_trace", "make_trace", "now", "percentile", "run_load",
    "write_metrics", "write_trace",
]
