"""Synthetic cluster traces driven through the REAL scheduler stack (port
of ``repro/telemetry/trace.py``, copied whole: the same draws, events and
journal bytes from the same seeds).

``core.simulator`` reimplements each policy's scheduling to draw the
paper's figures. This layer does the opposite: an event-driven sim of N
hosts (heterogeneous speeds, optional mid-run failures, per-trial leases
and a reaper) whose every decision comes from a real
``core.service.OptimizationService`` — the real ``core.scheduler``
verdict pipeline and the real ``RungBarrier`` park/resolve mechanism, on
a simulated clock. A 1000-host trace therefore regression-tests barrier
patience, entrant-capacity sizing, and reaper-shrink at a scale no CI box
can run with processes, and emits the SAME
``telemetry.metrics.METRIC_SCHEMA`` metrics (``service.*`` from the service
itself, ``server.lease_reaps`` from the simulated reaper) plus, optionally,
the same journal events a live server writes (``distributed.journal``
replays them, and ``export``, ``critical_path``, ``tailer`` and
``dashboard`` read them).

The workload is duck-typed (``unit_cost(wid, hparams, rng)`` /
``metric_at(wid, hparams, cum, rng)``) — any ``core.simulator`` workload
fits, without this module importing it.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler import Decision
from repro_torch.core.service import OptimizationService, TrialStatus
from repro_torch.telemetry.metrics import MetricsRegistry

# synthetic env transitions per workload resource unit: makes the trace
# emit plausible `service.env_steps` / journal `env_steps` values
ENV_STEPS_PER_UNIT = 1000


@dataclass(frozen=True)
class HostSpec:
    """One simulated host: relative speed, and an optional death time
    (the host silently stops — never reports again — and its leases are
    reaped ``lease_ttl`` later, exactly like a real silent worker)."""
    host: int
    speed: float = 1.0
    fail_at: Optional[float] = None


def synthetic_trace(n_hosts: int, *, seed: int = 0,
                    speed_spread: float = 0.3, fail_frac: float = 0.0,
                    fail_horizon: float = 300.0) -> List[HostSpec]:
    """A reproducible host fleet: speeds uniform in ``1 ± speed_spread``,
    a ``fail_frac`` fraction dying at uniform times in ``[0, fail_horizon)``."""
    rng = np.random.default_rng(seed)
    n_fail = int(round(fail_frac * n_hosts))
    fail_ids = (set(rng.choice(n_hosts, size=n_fail, replace=False).tolist())
                if n_fail else set())
    return [HostSpec(h,
                     float(rng.uniform(1.0 - speed_spread,
                                       1.0 + speed_spread)),
                     float(rng.uniform(0.0, fail_horizon))
                     if h in fail_ids else None)
            for h in range(n_hosts)]


@dataclass
class TraceResult:
    n_hosts: int
    makespan: float
    occupancy: float
    best_metric: Optional[float]
    n_trials: int
    rung_log: List[dict]
    metrics: Dict[str, Any]            # MetricsRegistry.snapshot()
    service: OptimizationService
    # (trial_id, host, phase, t_start, t_end, metric) per recorded report
    timeline: List[Tuple] = field(default_factory=list)

    def summary(self) -> dict:
        c = self.metrics.get("counters", {})
        return {"n_hosts": self.n_hosts, "n_trials": self.n_trials,
                "makespan": round(self.makespan, 2),
                "occupancy": round(self.occupancy, 4),
                "best": (round(self.best_metric, 3)
                         if self.best_metric is not None else None),
                "lease_reaps": c.get("server.lease_reaps", 0),
                "rungs": len(self.rung_log)}


def replay_trace(policy, workload, hosts: Sequence[HostSpec], *,
                 bracket_eta: Optional[int] = None, lease_ttl: float = 15.0,
                 seed: int = 0, metrics=None, journal=None,
                 entrant_patience: Optional[float] = None,
                 max_sim_s: float = 1e7) -> TraceResult:
    """Run ``policy`` over ``hosts`` against a real OptimizationService on
    a simulated clock. ``journal`` (anything with ``append(dict)``, e.g.
    ``distributed.journal.Journal``) additionally receives the standard
    event stream with simulated ``ts`` stamps, dashboard-ready.

    The simulated transport mirrors ``distributed.server`` semantics:
    leases renewed by activity (a live host heartbeats until its phase
    report lands), a reaper that crashes + requeues expired leases
    (incrementing ``server.lease_reaps``), parked hosts polling the
    barrier, and dead-host capacity withdrawn from the bracket's entry
    cohorts (the ``worker_exit`` path)."""
    metrics = metrics if metrics is not None else MetricsRegistry()
    now = [0.0]
    svc = OptimizationService(policy, clock=lambda: now[0],
                              bracket_eta=bracket_eta, metrics=metrics)
    rung_hint = 0 if svc.barrier is not None else None
    if svc.barrier is not None:
        budget = (getattr(policy, "n_trials", None)
                  or getattr(policy, "w0", None))
        cap = min(len(hosts), budget) if budget else len(hosts)
        svc.configure_bracket(
            expect_entrants=cap,
            entrant_patience=(entrant_patience if entrant_patience is not None
                              else 2.0 * lease_ttl))
    n_phases = svc.scheduler.n_phases
    rng = np.random.default_rng(seed + 999)
    poll_dt = max(lease_ttl / 3.0, 0.5)

    heap: List[tuple] = []
    seq = [0]
    leases: Dict[int, float] = {}      # trial_id -> expiry (sim time)
    dead: set = set()                  # host indices that failed
    busy = [0.0]
    timeline: List[Tuple] = []

    def push(t: float, kind: str, *payload) -> None:
        if t > max_sim_s:
            raise RuntimeError(
                f"trace exceeded max_sim_s={max_sim_s:g} — wedged barrier "
                "or runaway retry loop")
        heapq.heappush(heap, (t, seq[0], kind, payload))
        seq[0] += 1

    def jrnl(ev: dict) -> None:
        if journal is not None:
            journal.append(dict(ev, ts=round(now[0], 6)))

    def jspan(name: str, t_start: float, t_end: float, **args) -> None:
        """A `span` journal event with an explicit simulated start ts —
        the same event kind a journal-backed live server records, so the
        exporter / critical-path pass consume either interchangeably."""
        if journal is None or t_end < t_start:
            return
        ev = {"ev": "span", "name": name, "ts": round(t_start, 6),
              "dur": round(t_end - t_start, 6), "cat": "trial"}
        for k, v in args.items():
            if v is not None:
                ev[k] = v
        journal.append(ev)

    def jrnl_status(tid: int) -> None:
        rec = svc.db.trials[tid]
        jrnl({"ev": "status", "trial_id": tid, "status": rec.status.value,
              "t": rec.end_time})

    def drain() -> None:
        """Journal the withheld reports a barrier resolution just recorded
        (the server's ``_absorb_resolved``)."""
        for rep in svc.drain_resolved():
            ev = {"ev": "report", "trial_id": rep.trial_id,
                  "phase": rep.phase, "metric": rep.metric,
                  "t": rep.t_recorded}
            if rep.env_steps is not None:
                ev["env_steps"] = rep.env_steps
            jrnl(ev)
            jspan("trial.phase", rep.t_start, rep.t_end,
                  trial_id=rep.trial_id, phase=rep.phase, node=rep.node)
            if rep.decision is not Decision.CONTINUE:
                jrnl_status(rep.trial_id)

    def die(host: int, t_fail: float, tid: Optional[int]) -> None:
        """The host fails silently at ``t_fail``: its lease outlives it by
        ``lease_ttl`` (nobody renews), its capacity leaves the bracket's
        entry cohorts, and the reaper does the rest."""
        dead.add(host)
        svc.reduce_bracket_entrants(1)
        jrnl({"ev": "worker_exit", "node": host, "exit_code": 1})
        if tid is not None:
            leases[tid] = t_fail + lease_ttl
            push(t_fail + lease_ttl, "reap", tid)
        # a death-triggered entrant reduction can complete a waiting cohort
        drain()

    def try_acquire(host: int) -> None:
        if host in dead:
            return
        rec = svc.acquire_trial(node=host, rung=rung_hint)
        drain()                        # pre-enroll sweep may have resolved
        if rec is None:
            if leases:                 # a reclaim may still requeue work
                push(now[0] + max(lease_ttl / 2.0, 0.5), "retry", host)
            return
        ev = {"ev": "acquire", "trial_id": rec.trial_id,
              "hparams": rec.hparams, "node": host,
              "requeued": rec.requeued, "t": rec.start_time,
              "ctx": f"h{host}"}   # the simulated host IS the trace ctx
        if rec.bracket_id:
            ev["bracket"] = rec.bracket_id
        jrnl(ev)
        start_phase(host, rec, 0)

    def start_phase(host: int, rec, phase: int) -> None:
        spec = hosts[host]
        unit = float(workload.unit_cost(rec.trial_id, rec.hparams, rng))
        t_fin = now[0] + unit / spec.speed
        if spec.fail_at is not None and spec.fail_at < t_fin:
            busy[0] += max(0.0, spec.fail_at - now[0])
            die(host, spec.fail_at, rec.trial_id)
            return
        leases[rec.trial_id] = t_fin + lease_ttl   # heartbeats until then
        push(t_fin, "finish", host, rec, phase, now[0], unit)

    def after_verdict(host: int, rec, phase: int, verdict, t_start: float,
                      t_end: float, metric: float,
                      journal_status: bool) -> None:
        # ``journal_status`` False on the poll path: a barrier resolution
        # recorded the report AND journaled the terminal status already
        # (via drain) — mirroring the server, where a verdict poll's
        # answer journals nothing
        timeline.append((rec.trial_id, host, phase, t_start, t_end, metric))
        if verdict.decision is Decision.STOP or phase + 1 >= n_phases:
            leases.pop(rec.trial_id, None)
            if journal_status:
                jrnl_status(rec.trial_id)
            try_acquire(host)
        else:
            start_phase(host, rec, phase + 1)

    # -- event handlers -----------------------------------------------------
    def on_finish(host, rec, phase, t_start, unit) -> None:
        busy[0] += now[0] - t_start
        metric = float(workload.metric_at(rec.trial_id, rec.hparams,
                                          phase + 1, rng))
        steps = int(round(ENV_STEPS_PER_UNIT * unit))
        verdict = svc.report_verdict(rec.trial_id, phase, metric,
                                     t_start=t_start, t_end=now[0],
                                     env_steps=steps)
        if verdict.decision is Decision.PARKED:
            jrnl({"ev": "park", "trial_id": rec.trial_id, "phase": phase})
            drain()                    # this park may have completed a cohort
            spec = hosts[host]
            t_poll = now[0] + poll_dt
            if spec.fail_at is not None and spec.fail_at < t_poll:
                die(host, spec.fail_at, rec.trial_id)
                return
            leases[rec.trial_id] = t_poll + lease_ttl
            push(t_poll, "poll", host, rec, phase, metric, t_start, now[0],
                 steps)
            return
        jrnl({"ev": "report", "trial_id": rec.trial_id, "phase": phase,
              "metric": metric, "t": now[0], "env_steps": steps})
        jspan("trial.phase", t_start, now[0], trial_id=rec.trial_id,
              phase=phase, node=host)
        drain()
        after_verdict(host, rec, phase, verdict, t_start, now[0], metric,
                      journal_status=True)

    def on_poll(host, rec, phase, metric, t_start, t_end, steps) -> None:
        verdict = svc.report_verdict(rec.trial_id, phase, metric,
                                     t_start=t_start, t_end=t_end,
                                     env_steps=steps)
        drain()                        # resolution journals the reports
        if verdict.decision is Decision.PARKED:
            spec = hosts[host]
            t_poll = now[0] + poll_dt
            if spec.fail_at is not None and spec.fail_at < t_poll:
                die(host, spec.fail_at, rec.trial_id)
                return
            leases[rec.trial_id] = t_poll + lease_ttl
            push(t_poll, "poll", host, rec, phase, metric, t_start, t_end,
                 steps)
            return
        after_verdict(host, rec, phase, verdict, t_start, t_end, metric,
                      journal_status=False)

    def on_reap(tid: int) -> None:
        exp = leases.get(tid)
        if exp is None:
            return
        if exp > now[0]:               # renewed since — re-arm
            push(exp, "reap", tid)
            return
        del leases[tid]
        rec = svc.db.trials.get(tid)
        if rec is None or rec.status is not TrialStatus.RUNNING:
            return
        metrics.counter("server.lease_reaps").inc()
        svc.crash(tid)
        svc.requeue(rec.hparams, rec.bracket_id)
        jrnl_status(tid)
        ev = {"ev": "requeue", "hparams": rec.hparams}
        if rec.bracket_id:
            ev["bracket"] = rec.bracket_id
        jrnl(ev)
        drain()                        # reaper-shrink may resolve a cohort

    # -- run ----------------------------------------------------------------
    for h in range(len(hosts)):
        try_acquire(h)
    while heap:
        t, _, kind, payload = heapq.heappop(heap)
        now[0] = max(now[0], t)
        if kind == "finish":
            on_finish(*payload)
        elif kind == "poll":
            on_poll(*payload)
        elif kind == "reap":
            on_reap(*payload)
        elif kind == "retry":
            try_acquire(*payload)

    makespan = now[0]
    best = svc.db.best_trial()
    rung_log = list(svc.barrier.rung_log) if svc.barrier is not None else []
    occupancy = (busy[0] / (len(hosts) * makespan)) if makespan > 0 else 0.0
    return TraceResult(len(hosts), makespan, occupancy,
                       best.best_metric if best else None,
                       len(svc.db.trials), rung_log, metrics.snapshot(),
                       svc, timeline)
