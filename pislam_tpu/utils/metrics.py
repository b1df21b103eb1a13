"""Structured per-frame metrics for the streaming/SLAM drivers.

The reference's observability is one std::cout of milliseconds + feature
count at the end of the demo (demo.cpp:113-114) and doc-comment throughput
notes. A long-running SLAM service needs structured, machine-readable
telemetry instead: this module provides a dependency-free metrics registry
(counters, gauges, wall-clock stage timers) that the drivers update every
frame and flush as JSON lines -- the same one-line-JSON convention bench.py
and the tools already use, so downstream log processing is uniform.

Host wall-clock timers measure the *driver* loop (Python orchestration +
dispatch + any host readbacks), so they include dispatch latency and host
waits; device-side per-stage truth comes from a profiler trace
(utils/profiling.py, tools/trace_top_ops.py) -- these timers are for production
observability (rates, stalls, regressions), not kernel attribution.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable, Optional


class Metrics:
    """Counters + gauges + stage timers with JSON-line emission.

    counters accumulate (events since last emit); gauges hold the latest
    value; timers accumulate per-stage wall seconds and call counts between
    emits. ``emit`` writes one JSON line to the sink and resets counters
    and timers (gauges persist: they describe current state, e.g. map
    size).
    """

    def __init__(self, sink: Optional[Callable[[str], None]] = None):
        self._sink = sink if sink is not None else _stdout_sink
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, list] = {}  # name -> [total_s, calls]
        self._t0 = time.perf_counter()

    def count(self, name: str, n: float = 1):
        self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float):
        self._gauges[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            tot = self._timers.setdefault(name, [0.0, 0])
            tot[0] += dt
            tot[1] += 1

    def snapshot(self) -> dict:
        """Current values as a flat dict (does not reset)."""
        out = {f"count.{k}": v for k, v in self._counters.items()}
        out.update({f"gauge.{k}": v for k, v in self._gauges.items()})
        for k, (tot, n) in self._timers.items():
            out[f"time_ms.{k}"] = round(tot * 1e3, 3)
            out[f"calls.{k}"] = n
        out["uptime_s"] = round(time.perf_counter() - self._t0, 3)
        return out

    def emit(self, **extra):
        """Write one JSON line (snapshot + extra) and reset counters/timers."""
        rec = self.snapshot()
        rec.update(extra)
        self._sink(json.dumps(rec, sort_keys=True))
        self._counters.clear()
        self._timers.clear()
        return rec


def _stdout_sink(line: str):
    print(line, flush=True)


class NullMetrics(Metrics):
    """No-op drop-in: zero overhead when observability is off."""

    def __init__(self):  # noqa: D401 - no sink
        pass

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    @contextmanager
    def timer(self, name):
        yield

    def snapshot(self):
        return {}

    def emit(self, **extra):
        return {}
