"""The one clock every span, serving loop and session shares (port of
``repro.obs.clock``; the port keeps its own copy).

Interval timing goes through :func:`now`, a thin alias for
``time.perf_counter``, never ``time.time``: wall-clock time is not
monotonic (NTP slews and steps it), so a TTFT measured with it can come
out negative exactly when the machine is busiest. ``perf_counter`` is
monotonic and its zero is arbitrary, which is all interval arithmetic
needs; spans and the serving loop sharing it share one timebase.

``now()`` returns seconds as a float. It is host-only and touches no
tensor: safe inside decode loops.
"""

from __future__ import annotations

import time

now = time.perf_counter
