"""Event-driven distributed-cluster simulator (paper Figs. 2, 3, 6, 8, 9;
port of ``repro/core/simulator.py``, copied whole: numpy only, no device).

Models a pool of (possibly heterogeneous) nodes executing metaoptimization
trials whose phase duration depends on the node speed AND on the
hyperparameters (the regime the paper targets: e.g. t_max changes GA3C's
cost per episode). Scheduling policies:

  * simulate_hypertrick          — async, no barriers, instant reallocation
  * simulate_successive_halving  — phase barriers; dynamic (workers migrate,
                                   needs preemption) or static (pinned)
  * simulate_grid                — no early stopping, static assignment
  * simulate_hyperband           — brackets as parallel SH instances sharing
                                   the node pool

All return a SimResult with the full timeline, makespan, occupancy,
measured completion rate, and best-trajectory (score vs wall time).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.completion import Bracket
from repro_torch.core.hypertrick import HyperTrick
from repro_torch.core.service import (Decision, OptimizationService, TrialStatus)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------
class Workload:
    """unit_cost: seconds per resource unit for this configuration (before
    dividing by node speed). metric_at: learning-curve value after cum
    resource units."""

    def unit_cost(self, wid: int, hparams: dict,
                  rng: np.random.Generator) -> float:
        raise NotImplementedError

    def metric_at(self, wid: int, hparams: dict, cum: float,
                  rng: np.random.Generator) -> float:
        raise NotImplementedError


class ToyWorkload(Workload):
    """Paper Fig. 2 toy problem: f(p) = a p + b, random a, b per worker;
    variable phase execution times."""

    def __init__(self, seed: int = 0, cost_spread: float = 0.6):
        self.rng = np.random.default_rng(seed)
        self.cost_spread = cost_spread
        self._a: Dict[int, float] = {}
        self._b: Dict[int, float] = {}
        self._c: Dict[int, float] = {}

    def _ensure(self, wid):
        if wid not in self._a:
            self._a[wid] = float(self.rng.uniform(1, 8))
            self._b[wid] = float(self.rng.uniform(0, 12))
            self._c[wid] = float(self.rng.uniform(1 - self.cost_spread,
                                                  1 + self.cost_spread))

    def unit_cost(self, wid, hparams, rng):
        self._ensure(wid)
        return self._c[wid] * float(rng.uniform(0.85, 1.15))

    def metric_at(self, wid, hparams, cum, rng):
        self._ensure(wid)
        return self._a[wid] * cum + self._b[wid]


class GA3CWorkload(Workload):
    """Parametric stand-in for GA3C-on-Atari learning curves, calibrated to
    the paper's observations: the final score depends on (lr, gamma, t_max)
    proximity to a game-specific optimum; cost per episode depends on t_max
    (frame-generation rate peaks at t_opt); curves for unstable configs
    (large lr) are noisy."""

    def __init__(self, seed: int = 0, lr_opt: float = 3e-4,
                 gamma_opt: float = 0.99, t_opt: float = 16.0,
                 plateau: float = 100.0, noise: float = 6.0,
                 tau: float = 3.0):
        self.seed = seed
        self.lr_opt, self.gamma_opt, self.t_opt = lr_opt, gamma_opt, t_opt
        self.plateau, self.noise, self.tau = plateau, noise, tau

    def _quality(self, hp) -> float:
        dl = (math.log10(hp["learning_rate"]) - math.log10(self.lr_opt)) / 1.2
        dg = (math.log10(1 - hp["gamma"]) - math.log10(1 - self.gamma_opt)) / 1.4
        dt = (math.log(hp["t_max"]) - math.log(self.t_opt)) / 2.0
        return math.exp(-(dl * dl + dg * dg + 0.3 * dt * dt))

    def unit_cost(self, wid, hp, rng):
        # episodes/sec peaks near t_opt (GPU batching vs update frequency)
        c = 1.0 + 0.8 * abs(math.log(hp["t_max"] / self.t_opt))
        return c * float(rng.uniform(0.9, 1.1))

    def metric_at(self, wid, hp, cum, rng):
        q = self._quality(hp)
        instab = max(0.0, math.log10(hp["learning_rate"]) + 2.5)  # lr > 3e-3
        level = self.plateau * q * (1 - math.exp(-cum / self.tau))
        noise = self.noise * (1 + 3 * instab) * float(rng.standard_normal())
        return level + noise


# ---------------------------------------------------------------------------
# result containers
# ---------------------------------------------------------------------------
@dataclass
class TimelineEntry:
    worker: int
    node: int
    phase: int            # resource-chunk index
    t_start: float
    t_end: float
    metric: float
    status: str           # 'ok' | 'killed' | 'completed'


@dataclass
class SimResult:
    name: str
    timeline: List[TimelineEntry]
    makespan: float
    n_nodes: int
    n_workers: int
    n_phases: int
    best_metric: float
    best_worker: int
    time_to_best: float
    total_work: float = 0.0

    @property
    def occupancy(self) -> float:
        busy = sum(e.t_end - e.t_start for e in self.timeline)
        return busy / (self.n_nodes * self.makespan) if self.makespan else 0.0

    @property
    def completion_rate(self) -> float:
        per_worker: Dict[int, int] = {}
        for e in self.timeline:
            per_worker[e.worker] = per_worker.get(e.worker, 0) + 1
        return (sum(per_worker.values())
                / (self.n_phases * max(len(per_worker), 1)))

    def best_curve(self) -> List[tuple]:
        """(wall_time, best_so_far) trajectory."""
        best = -math.inf
        out = []
        for e in sorted(self.timeline, key=lambda e: e.t_end):
            if e.metric > best:
                best = e.metric
                out.append((e.t_end, best))
        return out

    def summary(self) -> dict:
        return {"name": self.name, "makespan": round(self.makespan, 2),
                "occupancy": round(self.occupancy, 4),
                "alpha": round(self.completion_rate, 4),
                "best": round(self.best_metric, 2),
                "time_to_best": round(self.time_to_best, 2)}


def _finish(name, timeline, n_nodes, n_workers, n_phases) -> SimResult:
    makespan = max((e.t_end for e in timeline), default=0.0)
    best = max(timeline, key=lambda e: e.metric)
    # earliest time the final best metric was reached
    t_best = min(e.t_end for e in timeline if e.metric >= best.metric)
    return SimResult(name, timeline, makespan, n_nodes, n_workers, n_phases,
                     best.metric, best.worker, t_best)


# ---------------------------------------------------------------------------
# HyperTrick (async — uses the real OptimizationService + policy)
# ---------------------------------------------------------------------------
def simulate_hypertrick(workload: Workload, configs: Sequence[dict],
                        n_nodes: int, n_phases: int, eviction_rate: float,
                        seed: int = 0,
                        node_speeds: Optional[Sequence[float]] = None,
                        service_factory=None) -> SimResult:
    w0 = len(configs)
    speeds = list(node_speeds or [1.0] * n_nodes)
    rng = np.random.default_rng(seed + 999)
    clock = [0.0]
    from repro_torch.core.search_space import SearchSpace
    policy = HyperTrick(SearchSpace({}), w0, n_phases, eviction_rate,
                        seed=seed, configs=list(configs))
    svc = (service_factory or OptimizationService)(
        policy, clock=lambda: clock[0])

    timeline: List[TimelineEntry] = []
    heap: List[tuple] = []
    seqno = 0

    def start(node: int, t: float, rec, phase: int):
        nonlocal seqno
        dur = (workload.unit_cost(rec.trial_id, rec.hparams, rng)
               / speeds[node])
        heapq.heappush(heap, (t + dur, seqno, node, rec, phase))
        seqno += 1

    for node in range(n_nodes):
        rec = svc.acquire_trial(node)
        if rec is None:
            break
        start(node, 0.0, rec, 0)

    while heap:
        t, _, node, rec, phase = heapq.heappop(heap)
        clock[0] = t
        metric = workload.metric_at(rec.trial_id, rec.hparams, phase + 1, rng)
        decision = svc.report(rec.trial_id, phase, metric)
        done = phase + 1 >= n_phases
        status = ("completed" if done else
                  "killed" if decision == Decision.STOP else "ok")
        timeline.append(TimelineEntry(rec.trial_id, node, phase,
                                      t - 0.0, t, metric, status))
        # NOTE: t_start is reconstructed below; we log durations precisely
        if decision == Decision.CONTINUE and not done:
            start(node, t, rec, phase + 1)
        else:
            nxt = svc.acquire_trial(node)
            if nxt is not None:
                start(node, t, nxt, 0)

    # reconstruct t_start per node ordering
    by_node: Dict[int, List[TimelineEntry]] = {}
    for e in sorted(timeline, key=lambda e: e.t_end):
        prev = by_node.setdefault(e.node, [])
        e.t_start = prev[-1].t_end if prev else 0.0
        prev.append(e)
    res = _finish("hypertrick", timeline, n_nodes, len(configs), n_phases)
    res.db = svc.db  # type: ignore[attr-defined]
    return res


# ---------------------------------------------------------------------------
# Successive Halving (synchronous barriers)
# ---------------------------------------------------------------------------
def simulate_successive_halving(workload: Workload, configs: Sequence[dict],
                                n_nodes: int, n_phases: int,
                                evict_frac: float, seed: int = 0,
                                static: bool = False,
                                node_speeds: Optional[Sequence[float]] = None,
                                unit_per_phase: Optional[Sequence[float]] = None,
                                ) -> SimResult:
    """Dynamic: tasks list-scheduled onto free nodes each phase (requires
    preemption/migration in a real system). Static: workers pinned to nodes.
    Barrier between phases either way."""
    w0 = len(configs)
    speeds = list(node_speeds or [1.0] * n_nodes)
    rng = np.random.default_rng(seed + 999)
    timeline: List[TimelineEntry] = []
    survivors = list(range(w0))
    pinned = {w: w % n_nodes for w in survivors}
    units = list(unit_per_phase or [1.0] * n_phases)
    cum_res = {w: 0.0 for w in survivors}
    t_phase = 0.0

    for phase in range(n_phases):
        node_free = [t_phase] * n_nodes
        results = []
        order = sorted(survivors, key=lambda w: pinned[w]) if static \
            else list(survivors)
        for w in order:
            dur = (units[phase]
                   * workload.unit_cost(w, configs[w], rng))
            if static:
                node = pinned[w]
            else:
                node = int(np.argmin(node_free))
            dur /= speeds[node]
            t0 = node_free[node]
            node_free[node] = t0 + dur
            cum_res[w] += units[phase]
            metric = workload.metric_at(w, configs[w], cum_res[w], rng)
            results.append((w, node, t0, t0 + dur, metric))
        t_phase = max(node_free)  # the barrier
        keep = len(survivors) - int(round(evict_frac * len(survivors)))
        keep = max(keep, 1)
        ranked = sorted(results, key=lambda r: -r[4])
        kept_ids = {r[0] for r in ranked[:keep]}
        last = phase + 1 >= n_phases
        for w, node, t0, t1, metric in results:
            status = ("completed" if last and w in kept_ids else
                      "ok" if w in kept_ids else "killed")
            timeline.append(TimelineEntry(w, node, phase, t0, t1, metric,
                                          status))
        survivors = [w for w in survivors if w in kept_ids]
        if not survivors:
            break

    name = "sh_static" if static else "sh_dynamic"
    return _finish(name, timeline, n_nodes, w0, n_phases)


# ---------------------------------------------------------------------------
# Grid / random search (no early stopping, static assignment — Fig. 9)
# ---------------------------------------------------------------------------
def simulate_grid(workload: Workload, configs: Sequence[dict], n_nodes: int,
                  n_phases: int, seed: int = 0,
                  node_speeds: Optional[Sequence[float]] = None) -> SimResult:
    w0 = len(configs)
    speeds = list(node_speeds or [1.0] * n_nodes)
    rng = np.random.default_rng(seed + 999)
    timeline: List[TimelineEntry] = []
    node_free = [0.0] * n_nodes
    for w in range(w0):
        node = w % n_nodes
        t = node_free[node]
        for phase in range(n_phases):
            dur = workload.unit_cost(w, configs[w], rng) / speeds[node]
            metric = workload.metric_at(w, configs[w], phase + 1, rng)
            status = "completed" if phase + 1 >= n_phases else "ok"
            timeline.append(TimelineEntry(w, node, phase, t, t + dur, metric,
                                          status))
            t += dur
        node_free[node] = t
    return _finish("grid", timeline, n_nodes, w0, n_phases)


# ---------------------------------------------------------------------------
# Hyperband: brackets as parallel SH instances over a shared pool
# ---------------------------------------------------------------------------
def simulate_hyperband(workload: Workload, configs: Sequence[dict],
                       brackets: List[Bracket], n_nodes: int, seed: int = 0,
                       node_speeds: Optional[Sequence[float]] = None,
                       ) -> SimResult:
    """configs: concatenated per-bracket configurations (sum of n0 entries).
    Each bracket runs SH with its own (n_i, r_i) schedule; brackets share
    the node pool (the paper gives each bracket its own nodes: pass
    n_nodes = sum n0 to reproduce that)."""
    speeds = list(node_speeds or [1.0] * n_nodes)
    rng = np.random.default_rng(seed + 999)
    timeline: List[TimelineEntry] = []

    # assign each bracket a dedicated slice of nodes proportional to n0
    total_n0 = sum(b.n[0] for b in brackets)
    node_slices = []
    start = 0
    for b in brackets:
        cnt = max(1, round(n_nodes * b.n[0] / total_n0))
        node_slices.append(list(range(start, min(start + cnt, n_nodes))))
        start += cnt

    cfg_offset = 0
    for b, nodes in zip(brackets, node_slices):
        ids = list(range(cfg_offset, cfg_offset + b.n[0]))
        cfg_offset += b.n[0]
        survivors = list(ids)
        cum = {w: 0.0 for w in ids}
        t_phase = 0.0
        for i, (ni, ri) in enumerate(zip(b.n, b.r)):
            survivors = survivors[:ni]
            node_free = {nd: t_phase for nd in nodes}
            results = []
            # experiments restart from iteration 0 each SH round (paper
            # §5.2.4) -> they pay full r_i units of work
            for w in survivors:
                nd = min(node_free, key=node_free.get)
                dur = (ri * workload.unit_cost(w, configs[w], rng)
                       / speeds[nd])
                t0 = node_free[nd]
                node_free[nd] = t0 + dur
                cum[w] = ri  # restart: cumulative resource == r_i
                metric = workload.metric_at(w, configs[w], cum[w], rng)
                results.append((w, nd, t0, t0 + dur, metric))
            t_phase = max(node_free.values())
            last = i + 1 >= len(b.n)
            nxt = b.n[i + 1] if not last else 0
            ranked = sorted(results, key=lambda r: -r[4])
            kept = {r[0] for r in ranked[:nxt]} if not last else set()
            for w, nd, t0, t1, metric in results:
                status = ("completed" if last else
                          "ok" if w in kept else "killed")
                timeline.append(TimelineEntry(w, nd, i, t0, t1, metric,
                                              status))
            survivors = [r[0] for r in ranked if r[0] in kept]

    res = _finish("hyperband", timeline, n_nodes, cfg_offset,
                  max(len(b.n) for b in brackets))
    return res


# ---------------------------------------------------------------------------
# trace replay against the REAL scheduler stack
# ---------------------------------------------------------------------------
# The simulators above reimplement each policy's scheduling to draw the
# paper's figures. ``telemetry.trace`` drives synthetic host traces through
# the real OptimizationService + RungBarrier instead (same workload duck
# type), re-exported here so simulator users find both layers in one place.
from repro_torch.telemetry.trace import (HostSpec, TraceResult,  # noqa: E402,F401
                                         replay_trace, synthetic_trace)
