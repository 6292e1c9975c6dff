"""The in-process backends of a search (port of
``repro/core/executor.py``: ``ExecRecord``, ``ExecResult`` and
``ThreadCluster``, copied whole, and ``PopulationCluster``;
``ExecResult.updates`` is the port's).

* ThreadCluster — asynchronous policies (HyperTrick, random search): each
  node-thread pulls a configuration, runs phases of the REAL objective, and
  polls the optimization service after every phase. No barriers anywhere.
  A trial whose objective raises is marked crashed and its node goes on
  (paper §3.2's fault isolation): the exception is printed, not re-raised.
* PopulationCluster — the population engine (``population/engine.py``):
  every live trial trains at once on one device, from one host thread,
  against the same service and policy; GA3C or LM trials (``objective``),
  with PBT's clones copied slot to slot on the device.

Not ported yet: ``SyncCluster`` (synchronized Successive Halving) and
``ProcessCluster`` (OS-process workers over TCP, the journal); ROADMAP
queue 1 item 7 lists them.

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
from repro_torch.device import resolve_device


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
    # backends that can count device work report it (population engine;
    # the port's GA3C search: env transitions and updates of every trial)
    env_steps: Optional[int] = None
    updates: Optional[int] = None
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


class PopulationCluster:
    """The population backend: every live trial trains at once on one
    device (``repro_torch.population.engine``), driving the same
    ``OptimizationService`` and policy as every other backend. A "node" is
    a device slot: eviction masks the slot and the next configuration is
    hot-swapped in, so the paper's "stopped worker's node immediately
    acquires a fresh configuration" happens at slot granularity with zero
    process churn.

    ``objective`` selects the workload: None (default) is GA3C on ``game``
    with ``n_envs`` envs a trial; otherwise a ``PopulationObjective``
    (``population.objectives``, e.g. the LM objective built on ``device``).
    ``episodes_per_phase`` is the objective's unit a phase (GA3C: episodes;
    LM: updates). ``slots`` defaults to the policy's initial worker count
    W0 so the entire population is in flight from the first step.
    ``bracket_eta`` turns on successive-halving rungs: rung phases become
    generation barriers at which the bottom 1/eta of each cohort is demoted
    by mask and the freed slots are hot-swapped. Under PBT the summary
    counts the CLONE verdicts (``clones``) and those executed as slot
    copies on the device (``clones_on_device``). ``device`` is checked
    here, before any trial starts; ``devices > 1`` (slots sharded over
    several cards) is refused.
    """

    def __init__(self, slots: Optional[int] = None, *, game: str = "pong",
                 episodes_per_phase: int = 60, n_envs: int = 16,
                 max_updates: int = 2000, seed: int = 0, devices: int = 1,
                 bracket_eta: Optional[int] = None, objective=None, device="cuda"):
        if devices > 1:
            raise NotImplementedError(
                f"devices={devices}: slots sharded over several cards are not owed "
                "on one card (ROADMAP queue 1, not owed on one card)")
        self.slots = slots
        self.game = game
        self.objective = objective
        self.episodes_per_phase = episodes_per_phase
        self.n_envs = n_envs
        self.max_updates = max_updates
        self.seed = seed
        self.devices = devices
        self.bracket_eta = bracket_eta
        self.device = resolve_device(device)

    def run(self, policy: AsyncPolicy) -> ExecResult:
        from repro_torch.population.engine import LocalDriver, PopulationEngine
        slots = self.slots or getattr(policy, "w0", None) \
            or getattr(policy, "n_trials", None) or 8
        # the rung barrier lives in the service (core.service.RungBarrier):
        # the engine is a thin park/poll client of it
        svc = OptimizationService(policy, bracket_eta=self.bracket_eta)
        if svc.barrier is not None:
            # single host: the whole entry cohort enrolls in one admission
            # pass before anything can park
            budget = (getattr(policy, "n_trials", None)
                      or getattr(policy, "w0", None))
            svc.configure_bracket(expect_entrants=(
                min(slots, budget) if budget else slots))
        engine = PopulationEngine(
            self.game if self.objective is None else self.objective,
            max_slots=slots, n_envs=self.n_envs,
            episodes_per_phase=self.episodes_per_phase,
            max_updates=self.max_updates, seed=self.seed,
            bracket_eta=self.bracket_eta, device=self.device,
            # one registry per search: engine.* lands next to service.*
            metrics=svc.metrics)
        t0 = time.monotonic()
        rows = engine.run(LocalDriver(svc))
        wall = time.monotonic() - t0
        records = [ExecRecord(tid, slot, phase, ts, te, metric)
                   for tid, slot, phase, ts, te, metric in rows]
        extra: Dict = {"devices": self.devices}
        if svc.barrier is not None and svc.barrier.rung_log:
            from repro_torch.core.completion import demotion_alpha, demotion_bracket
            extra["rungs"] = svc.barrier.rung_log
            br = demotion_bracket(slots, self.bracket_eta,
                                  list(svc.barrier.rungs), policy.n_phases)
            extra["bracket"] = {"n": br.n, "r": br.r}
            extra["bracket_alpha"] = round(demotion_alpha(br), 4)
        if engine.speculated:
            extra["speculative_refills"] = engine.speculated
        clone_log = getattr(svc.scheduler, "clone_log", None)
        if clone_log:
            # clone verdicts issued against the ones executed as slot copies
            # on the device (a parent may have left its slot already)
            extra["clones"] = len(clone_log)
            extra["clones_on_device"] = engine.clones
        return ExecResult(svc, records, wall, slots, env_steps=engine.total_env_steps,
                          updates=engine.total_updates, extra=extra)
