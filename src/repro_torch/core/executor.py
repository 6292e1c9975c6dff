"""The in-process thread backend of a search (port of
``repro/core/executor.py``: ``ExecRecord``, ``ExecResult`` and
``ThreadCluster``, copied whole).

* ThreadCluster — asynchronous policies (HyperTrick, random search): each
  node-thread pulls a configuration, runs phases of the REAL objective, and
  polls the optimization service after every phase. No barriers anywhere.
  A trial whose objective raises is marked crashed and its node goes on
  (paper §3.2's fault isolation): the exception is printed, not re-raised.

Not ported yet: ``SyncCluster`` (synchronized Successive Halving),
``ProcessCluster`` (OS-process workers over TCP, the journal) and
``PopulationCluster`` (the on-device population engine); ROADMAP queue 1
item 7 lists them.

Objectives have the signature  objective(hparams, phase, state) ->
(metric, state)  where state carries the live trainer across phases.
"""
from __future__ import annotations

import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.service import (AsyncPolicy, Decision,
                                      OptimizationService)


@dataclass
class ExecRecord:
    trial_id: int
    node: int
    phase: int
    t_start: float
    t_end: float
    metric: float


@dataclass
class ExecResult:
    service: OptimizationService
    records: List[ExecRecord]
    wall_time: float
    n_nodes: int
    # backends that can count device work report it (population engine)
    env_steps: Optional[int] = None
    # backend-specific summary fields (e.g. the population engine's rung
    # log and device count), merged into summary()
    extra: Optional[Dict] = None

    @property
    def occupancy(self) -> float:
        busy = sum(r.t_end - r.t_start for r in self.records)
        return busy / (self.n_nodes * self.wall_time) if self.wall_time else 0.0

    def summary(self) -> dict:
        s = self.service.db.summary()
        s.update(wall_time=round(self.wall_time, 2),
                 occupancy=round(self.occupancy, 3),
                 alpha=round(self.service.db.completion_rate(
                     self.service.policy.n_phases), 4))
        if self.extra:
            s.update(self.extra)
        return s


class ThreadCluster:
    def __init__(self, n_nodes: int, objective: Callable):
        self.n_nodes = n_nodes
        self.objective = objective

    def run(self, policy: AsyncPolicy) -> ExecResult:
        svc = OptimizationService(policy)
        records: List[ExecRecord] = []
        rec_lock = threading.Lock()
        t0 = time.monotonic()

        def node_loop(node: int):
            while True:
                trial = svc.acquire_trial(node)
                if trial is None:
                    return
                state = None
                for phase in range(policy.n_phases):
                    t_start = time.monotonic() - t0
                    try:
                        metric, state = self.objective(trial.hparams, phase,
                                                       state)
                    except Exception:
                        traceback.print_exc()
                        svc.crash(trial.trial_id)  # local effect only
                        break
                    t_end = time.monotonic() - t0
                    with rec_lock:
                        records.append(ExecRecord(trial.trial_id, node,
                                                  phase, t_start, t_end,
                                                  metric))
                    if svc.report(trial.trial_id, phase,
                                  metric) == Decision.STOP:
                        break

        with ThreadPoolExecutor(self.n_nodes) as pool:
            list(pool.map(node_loop, range(self.n_nodes)))
        clone_log = getattr(svc.scheduler, "clone_log", None)
        return ExecResult(svc, records, time.monotonic() - t0, self.n_nodes,
                          extra={"clones": len(clone_log)}
                          if clone_log else None)
