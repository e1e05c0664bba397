"""Typed metrics registry and the deferred-drain engine telemetry reader
(port of ``repro.obs.registry``).

Two layers:

* :class:`MetricsRegistry` — host-side counters, gauges and histograms
  with stable dotted names (``engine.steps``, ``session.pushes``).
  ``as_dict()`` flattens everything to finite scalars, so a registry
  snapshot can land in a metrics JSON unmodified.

* :class:`EngineTelemetry` — the consumer of the engine's *device-side*
  per-step metrics vector. The phase-occupancy histogram over
  ``t % stride``, whether the middle ran and the active-slot count are
  computed inside the captured step (``repro_torch.engine.step
  .step_metrics``, an output of the step's CUDA graph), ride back on
  ``ResultTokens.metrics``, and reach the host only through the serving
  loop's ONE deferred drain a step (``ResultTokens.convert_to_numpy`` →
  ``contracts.host_get``: the metrics vector is copied behind the same
  event as the tokens). ``observe_result`` therefore REFUSES tensors, on
  the CPU or the card: an undrained result here would add a blocking
  device->host copy to the decode loop.

Differences from the reference: the port's engine has no
``prefill_compiles`` / ``spec_compiles`` / ``hydrate_compiles`` (its
prefill runs eagerly, and its graph captures are
``CheckedGraph.stats()``), so ``snapshot_engine`` leaves those three
gauges out, through the reference's own ``getattr(..., None)``.

Everything here is numpy and Python: nothing that can transfer.
"""

from __future__ import annotations

import numpy as np


def percentile(values, p: float) -> float:
    """p-th percentile as a float; 0.0 on an empty sample (an idle engine
    reports zeros, never NaN)."""
    vals = [float(v) for v in values]
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals, np.float64), p))


class Counter:
    """Monotonically increasing count (events, tokens, cache hits)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Last-observed value (pool free pages, rates)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Sample collector summarized as count/mean/p50/p99 (latencies,
    accepted-per-window). Keeps raw samples: serving sessions are short
    enough that bucketing would only lose the tail."""

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.samples: list = []

    def observe(self, v):
        self.samples.append(float(v))

    def summary(self) -> dict:
        n = len(self.samples)
        return {
            "count": n,
            "mean": float(np.mean(self.samples)) if n else 0.0,
            "p50": percentile(self.samples, 50),
            "p99": percentile(self.samples, 99),
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting a name returns the existing metric; requesting it as a
    different kind raises (two call sites sharing one name with different
    meanings is how dashboards lie).
    """

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def as_dict(self) -> dict:
        """Flatten to finite scalars: counters and gauges keep their name,
        histograms expand to ``name.count/.mean/.p50/.p99``."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                v = m.value
                out[name] = int(v) if isinstance(v, (bool, int)) else float(v)
        return out


def _require_numpy(arr, what: str):
    if arr is None:
        return None
    if not isinstance(arr, np.ndarray):
        raise TypeError(
            f"EngineTelemetry needs DRAINED {what} (host numpy), got "
            f"{type(arr).__name__}: call ResultTokens.convert_to_numpy() "
            f"on the *previous* step's result after dispatching the next "
            f"step — reading device values here would add a blocking "
            f"per-step host sync")
    return arr


class EngineTelemetry:
    """Accumulates the engine's per-step device metrics vector.

    The vector layout (``repro_torch.engine.step.step_metrics``) for a
    config with SOI stride ``s`` (``s = 1`` without SOI)::

        [occ_phase_0, ..., occ_phase_{s-1}, mid_fired, n_active]

    ``occ_phase_p`` counts active slots whose pre-step clock sits at
    ``t % s == p``, ``mid_fired`` is 1 iff the compressed middle ran this
    step, and ``n_active`` is the live-slot count. An *off-phase* step
    (``mid_fired == 0`` with ``n_active > 0``) is the step the paper's
    schedule saves: the middle was skipped for the whole batch.
    ``off_phase_rate_by_occupancy`` reports that skip rate per occupancy
    level, the scoreboard of phase-aligned admission.
    """

    def __init__(self, stride: int, registry: MetricsRegistry | None = None):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.stride = int(stride)
        self.registry = registry if registry is not None else MetricsRegistry()
        # per-occupancy-level step/off-phase counts: {n_active: [steps, off]}
        self._by_occ: dict = {}
        # phase coherence over active steps: how clustered the batch sits
        # on the t % stride circle (modal-bucket slot fraction)
        self._coh_steps = 0
        self._coh_full = 0
        self._coh_modal = 0.0
        reg = self.registry
        # the per-step counters, resolved once: observe_result runs every
        # decode step
        self._coh_counter = reg.counter("engine.phase_coherent_steps")
        self._c_steps = reg.counter("engine.steps")
        self._c_occ = [reg.counter(f"engine.phase_occupancy.p{p}")
                       for p in range(self.stride)]
        self._c_mid = reg.counter("engine.mid_fired_steps")
        self._c_off = reg.counter("engine.off_phase_steps")

    # -- per-step ----------------------------------------------------------

    def observe_result(self, result) -> None:
        """Fold one DRAINED ``ResultTokens`` into the counters. A result
        without a metrics vector (telemetry-off engine) contributes only
        its speculative accepted counts, if any."""
        reg = self.registry
        met = _require_numpy(getattr(result, "metrics", None), "metrics")
        if met is not None:
            s = self.stride
            if met.shape[-1] != s + 2:
                raise ValueError(
                    f"metrics vector has {met.shape[-1]} entries, expected "
                    f"stride {s} + 2 — telemetry stride mismatch")
            occ = [int(x) for x in met[:s]]
            mid_fired = int(met[s])
            n_active = int(met[s + 1])
            self._c_steps.inc()
            for c, n in zip(self._c_occ, occ):
                c.inc(n)
            if mid_fired:
                self._c_mid.inc()
            elif n_active > 0:
                self._c_off.inc()
            if n_active > 0:
                steps_off = self._by_occ.setdefault(n_active, [0, 0])
                steps_off[0] += 1
                steps_off[1] += 0 if mid_fired else 1
                # coherent: every active slot in ONE t % stride bucket, the
                # state phase-aligned admission keeps; such a batch pays
                # the middle once a stride
                self._coh_steps += 1
                modal = max(occ)
                self._coh_modal += modal / n_active
                if modal == n_active:
                    self._coh_full += 1
                    self._coh_counter.inc()
        if result.accepted_idx is not None:
            data = _require_numpy(result.data, "result data")
            lo, hi = result.accepted_idx
            vlo, vhi = result.valid_idx
            acc = data[:, lo:hi][data[:, vlo:vhi] > 0]
            for a in acc:
                reg.histogram("engine.spec_accepted_per_window").observe(
                    int(a))

    def off_phase_rate_by_occupancy(self) -> dict:
        """{n_active: fraction of that occupancy level's steps whose
        middle was skipped}. Empty until the first active step."""
        return {occ: (off / steps if steps else 0.0)
                for occ, (steps, off) in sorted(self._by_occ.items())}

    def phase_coherence(self) -> dict:
        """How clustered the batch sat on the ``t % stride`` circle, over
        active steps: ``coherent_step_rate`` is the fraction of steps with
        every active slot in one phase bucket; ``modal_fraction_mean`` the
        mean share of active slots in the step's most-populated bucket
        (1.0 = aligned, ~1/stride = scattered). Zeros before the first
        active step."""
        if not self._coh_steps:
            return {"coherent_step_rate": 0.0, "modal_fraction_mean": 0.0}
        return {"coherent_step_rate": self._coh_full / self._coh_steps,
                "modal_fraction_mean": self._coh_modal / self._coh_steps}

    # -- between steps (host-side state, no device access) -----------------

    def snapshot_engine(self, engine) -> None:
        """Re-register the engine's host-side stats as gauges: compile
        counters (where the engine has them; the port's has none),
        prefix-cache counters, speculative accept stats, page-pool
        residency, and the sanctioned-drain call count. Reads only host
        ints the engine already tracks — safe at any point of the serving
        loop."""
        reg = self.registry
        for attr in ("prefill_compiles", "spec_compiles", "hydrate_compiles"):
            v = getattr(engine, attr, None)
            if v is not None:
                reg.gauge(f"engine.{attr}").set(v)
        pc = getattr(engine, "prefix_cache_stats", None)
        if isinstance(pc, dict):
            for k, v in pc.items():
                reg.gauge(f"engine.prefix_cache.{k}").set(v)
        spec_fn = getattr(engine, "spec_accept_stats", None)
        if callable(spec_fn):
            sp = spec_fn()
            if sp.get("speculate") is not None:
                for k in ("windows", "committed", "accept_rate",
                          "tokens_per_window", "draft_candidates",
                          "draft_accepted"):
                    reg.gauge(f"engine.spec.{k}").set(sp[k])
        pools_fn = getattr(engine, "pool_stats", None)
        if callable(pools_fn):
            for group, st in pools_fn().items():
                for k, v in st.items():
                    reg.gauge(f"engine.pages.{group}.{k}").set(v)
        # lazy: the engine package's session imports ``obs``
        from repro_torch.engine import contracts
        reg.gauge("engine.sanctioned_drains").set(contracts.drain_count())
