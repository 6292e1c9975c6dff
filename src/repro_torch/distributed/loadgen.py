"""Synthetic-worker load generator for the metaopt server (port of
``repro/distributed/loadgen.py``, copied whole).

Two tiers, one stats shape:

* ``run_load`` — the *smoke* tier: real sockets against a live
  ``MetaoptServer``. N synthetic host threads each lease ``slots`` trials
  and drive them through every phase, reporting either one
  ``report_batch`` frame per generation (``batched=True``) or one classic
  ``report`` round-trip per trial — the batched-vs-per-trial comparison
  ``chip_smoke.py`` phase 13c prints.
* ``run_sim_load`` — the *scale* tier: ``replay_trace`` drives the REAL
  ``OptimizationService``/``RungBarrier`` with a 1000-host synthetic
  trace on a simulated clock, so "thousands of workers" runs in seconds
  of real time; reports/sec here is *service throughput* (events handled
  per real second), p99 is the service-side verdict latency.

Latency accounting in the smoke tier is per *report*: a batch frame's
round-trip time is attributed to every report it carried (that IS each
report's wall-clock wait), so batched p99 can exceed per-trial p99 while
reports/sec — the number that decides how many hosts one server feeds —
is an order of magnitude higher.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.distributed.client import Pending, ServiceClient


@dataclass
class LoadStats:
    """One load run's results (the BENCH row shape)."""
    hosts: int
    slots: int
    phases: int
    batched: bool
    reports: int = 0
    acquired: int = 0
    wall_s: float = 0.0
    reports_per_s: float = 0.0
    p50_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    errors: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_row(self) -> Dict[str, Any]:
        row = {"hosts": self.hosts, "slots": self.slots,
               "phases": self.phases, "batched": self.batched,
               "reports": self.reports, "acquired": self.acquired,
               "wall_s": round(self.wall_s, 4),
               "reports_per_s": round(self.reports_per_s, 1),
               "p50_ms": (round(self.p50_ms, 3)
                          if self.p50_ms is not None else None),
               "p99_ms": (round(self.p99_ms, 3)
                          if self.p99_ms is not None else None),
               "errors": self.errors}
        row.update(self.extra)
        return row


def _quantile_ms(lat_s: List[float], q: float) -> Optional[float]:
    if not lat_s:
        return None
    data = sorted(lat_s)
    return data[min(len(data) - 1, int(q * len(data)))] * 1e3


def run_load(host: str, port: int, *, hosts: int, slots: int,
             phases: int = 0, batched: bool = True,
             search: Optional[str] = None, work_s: float = 0.0,
             timeout: float = 60.0) -> LoadStats:
    """Drive a live server with ``hosts`` synthetic population hosts of
    ``slots`` trials each. Sized so one acquire round fills every host
    (pair with a ``RandomSearchPolicy(n_trials=hosts*slots, ...)`` search
    — no early stopping, every trial runs all phases); ``work_s`` sleeps
    between generations to emulate training time."""
    lat_lock = threading.Lock()
    all_lat: List[float] = []
    totals = {"reports": 0, "acquired": 0, "errors": 0}

    def _host(hidx: int) -> None:
        lat: List[float] = []
        reports = errors = acquired = 0
        try:
            c = ServiceClient(host, port, timeout=timeout, search=search)
        except OSError:
            with lat_lock:
                totals["errors"] += 1
            return
        try:
            trials = c.acquire_batch(node=hidx, slots=slots)
            for _ in range(200):            # bounded Pending re-poll
                if not isinstance(trials, Pending):
                    break
                time.sleep(min(trials.retry_after, 0.05))
                trials = c.acquire_batch(node=hidx, slots=slots)
            if not trials or isinstance(trials, Pending):
                return
            n_phases = trials[0].n_phases
            live = {t.trial_id for t in trials}
            acquired = len(live)
            for phase in range(n_phases):
                if not live:
                    break
                if work_s:
                    time.sleep(work_s)
                if batched:
                    entries = [{"trial_id": tid, "phase": phase,
                                "metric": float(phase + (tid % 7))}
                               for tid in sorted(live)]
                    t0 = time.perf_counter()
                    replies = c.report_batch(entries, node=hidx)
                    dt = time.perf_counter() - t0
                    # every report in the frame waited this round-trip
                    lat.extend([dt] * len(entries))
                    reports += len(entries)
                    for entry, rep in zip(entries, replies):
                        if rep == "stop":
                            live.discard(entry["trial_id"])
                else:
                    for tid in sorted(live):
                        t0 = time.perf_counter()
                        rep = c.report(tid, phase,
                                       float(phase + (tid % 7)), node=hidx)
                        lat.append(time.perf_counter() - t0)
                        reports += 1
                        if rep == "stop":
                            live.discard(tid)
        except Exception:  # noqa: BLE001 — a dead host is data, not a crash
            errors += 1
        finally:
            c.close()
            with lat_lock:
                all_lat.extend(lat)
                totals["reports"] += reports
                totals["acquired"] += acquired
                totals["errors"] += errors

    threads = [threading.Thread(target=_host, args=(h,), daemon=True)
               for h in range(hosts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    stats = LoadStats(hosts=hosts, slots=slots, phases=phases,
                      batched=batched,
                      reports=totals["reports"],
                      acquired=totals["acquired"], wall_s=wall,
                      reports_per_s=totals["reports"] / wall if wall else 0.0,
                      p50_ms=_quantile_ms(all_lat, 0.50),
                      p99_ms=_quantile_ms(all_lat, 0.99),
                      errors=totals["errors"])
    return stats


def run_sim_load(n_hosts: int = 1000, n_trials: int = 2000,
                 n_phases: int = 4, seed: int = 0,
                 journal=None) -> LoadStats:
    """The scale tier: a ``replay_trace`` run (event-driven simulated
    clock, real service + barrier) measured in real wall seconds.
    ``reports_per_s`` is service events handled per real second;
    ``p50/p99`` come from the service's own ``service.report_s``
    latency histogram (real perf_counter seconds per verdict)."""
    from repro_torch.core.hypertrick import RandomSearchPolicy
    from repro_torch.core.search_space import LogUniform, SearchSpace
    from repro_torch.core.simulator import ToyWorkload
    from repro_torch.telemetry.trace import replay_trace, synthetic_trace

    space = SearchSpace({"x": LogUniform(0.01, 100.0)})
    policy = RandomSearchPolicy(space, n_trials, n_phases, seed=seed)
    hosts = synthetic_trace(n_hosts, seed=seed)
    t0 = time.perf_counter()
    res = replay_trace(policy, ToyWorkload(seed=seed), hosts,
                       seed=seed, journal=journal)
    wall = time.perf_counter() - t0
    rep_h = res.metrics["histograms"].get("service.report_s", {})
    n_reports = int(rep_h.get("count", 0))
    stats = LoadStats(hosts=n_hosts, slots=0, phases=n_phases,
                      batched=False, reports=n_reports,
                      acquired=len(res.service.db.trials), wall_s=wall,
                      reports_per_s=n_reports / wall if wall else 0.0,
                      p50_ms=(rep_h.get("p50", 0.0) or 0.0) * 1e3,
                      p99_ms=(rep_h.get("p99", 0.0) or 0.0) * 1e3)
    stats.extra["sim_span_s"] = round(res.makespan, 1)
    stats.extra["tier"] = "sim"
    return stats
