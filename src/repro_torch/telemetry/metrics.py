"""A minimal in-process metrics registry: counters, gauges, and windowed
histograms. Stdlib only, one lock per registry, every operation O(1) — the
whole point is that it can sit inside the service/report and engine/step
hot paths without moving the throughput needle (see
``benchmarks/telemetry_benches.py``: instrumented vs uninstrumented engine
env-steps/s must stay within ~2%).

Metrics are created on first use (``registry.counter("service.requeues")``)
and read as one JSON-able ``snapshot()`` — the payload of the ``stats``
wire verb and the schema the trace simulator emits. ``NULL_REGISTRY`` is
the no-op twin: every hot path takes a registry argument, so a caller that
wants literally zero overhead passes the null one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional


class Counter:
    """Monotonic event count."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written level (occupancy, open connections, a rate)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += delta


class WindowedHistogram:
    """Cumulative count/total plus a bounded ring of recent observations —
    percentiles are over the window (the live view a dashboard wants), the
    count/total pair is forever (so rates and means survive the window)."""

    __slots__ = ("count", "total", "window", "_lock")

    def __init__(self, lock: threading.Lock, window: int = 512):
        self.count = 0
        self.total = 0.0
        self.window: deque = deque(maxlen=window)
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.window.append(v)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the window; None when empty."""
        with self._lock:
            data = sorted(self.window)
        if not data:
            return None
        i = min(len(data) - 1, max(0, int(q * len(data))))
        return data[i]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            data = sorted(self.window)
            count, total = self.count, self.total
        out: Dict[str, Any] = {"count": count, "total": round(total, 6)}
        if data:
            rank = lambda q: data[min(len(data) - 1, int(q * len(data)))]
            out.update(p50=round(rank(0.50), 6), p90=round(rank(0.90), 6),
                       p99=round(rank(0.99), 6), max=round(data[-1], 6),
                       mean=round(sum(data) / len(data), 6))
        return out


class MetricsRegistry:
    """Thread-safe name -> metric store. Metric mutation shares one lock
    (uncontended CPython lock ops are ~100ns — invisible next to a jitted
    train step or a socket round-trip); creation is get-or-create so call
    sites never pre-declare."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, WindowedHistogram] = {}
        self.created = time.time()
        self._created_mono = time.monotonic()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(self._lock))
        return g

    def histogram(self, name: str, window: int = 512) -> WindowedHistogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, WindowedHistogram(self._lock, window))
        return h

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able view of everything — the ``stats`` verb payload."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "t": time.time(),
            "uptime_s": round(time.monotonic() - self._created_mono, 3),
            "counters": {k: v.value for k, v in sorted(counters.items())},
            "gauges": {k: round(v.value, 6)
                       for k, v in sorted(gauges.items())},
            "histograms": {k: v.snapshot()
                           for k, v in sorted(hists.items())},
        }


class _NullMetric:
    __slots__ = ()

    def inc(self, n: int = 1) -> None: ...
    def set(self, v: float) -> None: ...
    def add(self, delta: float) -> None: ...
    def observe(self, v: float) -> None: ...
    def quantile(self, q: float) -> None: return None
    def snapshot(self) -> dict: return {"count": 0, "total": 0.0}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The zero-overhead registry: same surface, every operation a no-op.
    Pass as ``metrics=NULL_REGISTRY`` to uninstrument a hot path entirely
    (the telemetry-overhead bench's baseline arm)."""

    created = 0.0

    def counter(self, name: str) -> _NullMetric: return _NULL_METRIC
    def gauge(self, name: str) -> _NullMetric: return _NULL_METRIC
    def histogram(self, name: str, window: int = 512) -> _NullMetric:
        return _NULL_METRIC
    def snapshot(self) -> Dict[str, Any]:
        return {"t": 0.0, "uptime_s": 0.0, "counters": {}, "gauges": {},
                "histograms": {}}


NULL_REGISTRY = NullRegistry()


# ---------------------------------------------------------------------------
# the metric vocabulary (docs/telemetry.md must name every entry —
# enforced by tests/test_docs.py, like the wire-protocol surface)
# ---------------------------------------------------------------------------
METRIC_SCHEMA: Dict[str, str] = {
    # -- core/service.py (the verdict pipeline) -----------------------------
    "service.acquire_s": "histogram — acquire_trial latency (seconds)",
    "service.report_s": "histogram — report_verdict latency (seconds)",
    "service.verdicts.continue": "counter — CONTINUE verdicts delivered",
    "service.verdicts.stop": "counter — STOP verdicts (eviction/terminal)",
    "service.verdicts.park": "counter — first-time parks at a rung barrier",
    "service.verdicts.demote": "counter — rung-cohort demotions",
    "service.verdicts.clone": "counter — PBT clone verdicts",
    "service.cohort_wait_s": ("histogram — park-to-resolution wait per "
                              "cohort member (service clock)"),
    "service.requeues": "counter — configs re-issued after a dead worker",
    "service.env_steps": "counter — env transitions reported by workers",
    # -- distributed/server.py (the wire) -----------------------------------
    "server.rpc_s.<verb>": ("histogram per verb (acquire, report, ...) — "
                            "request service time; .count is the request "
                            "count"),
    "server.errors": "counter — requests answered with `error`",
    "server.connections.opened": "counter — TCP connections accepted",
    "server.connections.closed": "counter — TCP connections torn down",
    "server.connections.open": "gauge — currently open connections",
    "server.lease_reaps": "counter — leases expired by the reaper",
    "server.batch_reports": ("counter — individual reports carried by "
                             "report_batch frames"),
    "server.compactions": "counter — journal snapshot compactions performed",
    "server.searches.open": "gauge — tenant searches currently attached",
    # -- population/engine.py (the device) ----------------------------------
    "engine.env_steps": "counter — active-lane env transitions",
    "engine.updates": "counter — per-slot train-step executions",
    "engine.env_steps_s": "gauge — aggregate env-steps/s since engine start",
    "engine.step_s": "histogram — wall seconds per engine loop iteration",
    "engine.compile_s": ("histogram — host seconds of a bucket's first step "
                         "at its slot count (kernel library, cuBLAS and "
                         "allocator warm-up)"),
    "engine.phase_env_steps_s": ("histogram — per-trial env-steps/s over "
                                 "each reported phase"),
    "engine.park_stall_s": ("histogram — seconds a slot sat parked at the "
                            "rung barrier"),
    "engine.park_polls": "counter — barrier verdict polls sent",
    "engine.clones": "counter — device-side PBT slot copies executed",
    "engine.speculative_leases": ("counter — leases acquired by "
                                  "speculative rung-0 refill"),
    "engine.slots_active": "gauge — slots currently training",
    "engine.slots_occupied": "gauge — slots owned (active + parked)",
}
