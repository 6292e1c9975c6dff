"""The backends of a search (port of ``repro/core/executor.py``:
``ExecRecord``, ``ExecResult``, ``ThreadCluster``, ``SyncCluster`` and
``ProcessCluster``, copied whole, and ``PopulationCluster``;
``ExecResult.updates`` is the port's).

* ThreadCluster — asynchronous policies (HyperTrick, random search): each
  node-thread pulls a configuration, runs phases of the REAL objective, and
  polls the optimization service after every phase. No barriers anywhere.
  A trial whose objective raises is marked crashed and its node goes on
  (paper §3.2's fault isolation): the exception is printed, not re-raised.
* SyncCluster   — synchronized Successive Halving with real objectives,
  the paper's baseline: phase barriers; "preemption" is trivially the
  in-process trainer state being kept while the worker is paused (which is
  exactly the support HyperTrick does not need). No crash isolation: an
  objective's exception leaves ``run_sh``.
* ProcessCluster — real OS-process workers
  (``python -m repro_torch.distributed.worker``) talking to an in-launcher
  TCP server (``repro_torch.distributed``): the paper's actual deployment
  shape, with per-trial leases, crash reclamation, an optional durable
  journal and the server-side rung barrier (Hyperband, ``--bracket``).
  Each worker process trains its trials on the device its spec names:
  one at a time (a scalar worker), or with ``slots > 1`` up to that many at
  once in a population engine (``repro_torch.population.worker``).
* PopulationCluster — the population engine (``population/engine.py``):
  every live trial trains at once on one device, from one host thread,
  against the same service and policy; GA3C or LM trials (``objective``),
  with PBT's clones copied slot to slot on the device.

The search's other host modules sit beside these: the paper's cluster
simulator (``core/simulator.py``), the trace replay of N hosts through the
real service on a simulated clock (``telemetry/trace.py``) and the load
generator (``distributed/loadgen.py``), and the tools that read a search's
journal (``telemetry/`` ``export``, ``critical_path``, ``tailer`` and
``dashboard``).

Objectives have the signature  objective(hparams, phase, state) ->
(metric, state)  where state carries the live trainer across phases.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.service import (AsyncPolicy, Decision,
                                      OptimizationService, TrialStatus)


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


class SyncCluster:
    """Successive-Halving-style synchronized execution with real objectives."""

    def __init__(self, n_nodes: int, objective: Callable):
        self.n_nodes = n_nodes
        self.objective = objective

    def run_sh(self, configs: List[dict], n_phases: int,
               evict_frac: float) -> ExecResult:
        """Vanilla SH: barrier per phase, bottom evict_frac terminated."""
        from repro_torch.core.hypertrick import RandomSearchPolicy
        from repro_torch.core.search_space import SearchSpace
        policy = RandomSearchPolicy(SearchSpace({}), len(configs), n_phases,
                                    configs=configs)
        svc = OptimizationService(policy)
        trials = [svc.acquire_trial(i % self.n_nodes)
                  for i in range(len(configs))]
        states = {t.trial_id: None for t in trials}
        survivors = list(trials)
        records: List[ExecRecord] = []
        t0 = time.monotonic()

        for phase in range(n_phases):
            results = []

            def run_one(args):
                idx, trial = args
                t_start = time.monotonic() - t0
                metric, states[trial.trial_id] = self.objective(
                    trial.hparams, phase, states[trial.trial_id])
                t_end = time.monotonic() - t0
                return (trial, metric, idx % self.n_nodes, t_start, t_end)

            with ThreadPoolExecutor(self.n_nodes) as pool:
                results = list(pool.map(run_one, enumerate(survivors)))
            # barrier happened; report + evict bottom fraction
            for trial, metric, node, ts, te in results:
                svc.db.report(trial.trial_id, phase, metric,
                              time.monotonic() - t0)
                records.append(ExecRecord(trial.trial_id, node, phase, ts,
                                          te, metric))
            keep = max(1, len(survivors)
                       - int(round(evict_frac * len(survivors))))
            ranked = sorted(results, key=lambda r: -r[1])
            kept_ids = {r[0].trial_id for r in ranked[:keep]}
            now = time.monotonic() - t0
            for trial, *_ in results:
                last = phase + 1 >= n_phases
                if trial.trial_id not in kept_ids:
                    svc.db.set_status(trial.trial_id, TrialStatus.KILLED, now)
                elif last:
                    svc.db.set_status(trial.trial_id, TrialStatus.COMPLETED,
                                      now)
            survivors = [t for t in survivors if t.trial_id in kept_ids]
        return ExecResult(svc, records, time.monotonic() - t0, self.n_nodes)


class ProcessCluster:
    """Workers are real OS processes speaking the distributed protocol to a
    TCP server hosted by this launcher. ``objective_spec`` is a JSON-able
    dict resolved by ``repro_torch.distributed.worker.resolve_objective``
    on the worker side (e.g. ``{"kind": "rl", "game": "pong", "device":
    "cuda"}``, from ``worker.build_spec``), since closures do not cross
    process boundaries. Each worker resolves the spec's ``device`` (default
    ``cuda``) before it connects: without a card every worker exits
    non-zero, having leased nothing, and ``run`` raises.

    With ``journal_path`` set, every event is WAL-logged; ``resume=True``
    replays an existing journal first, so a restarted search continues with
    the same trial records (orphaned RUNNING trials are reclaimed).

    ``bracket_eta`` turns on the service-side successive-halving barrier
    (``core.service.RungBarrier``): ONE bracket spans every worker process
    — rung-phase reports park on the server, cohorts pool across hosts,
    and the bottom 1/eta of each pooled cohort is demoted. Workers are
    launched with ``--bracket`` so their acquires carry the rung hint.

    ``slots > 1`` (rl and lm specs): each worker process is a population
    engine leasing up to ``slots`` trials at once; bracket capacity and
    occupancy count ``n_nodes * slots``. Each prints its launch counters,
    env steps and updates in its closing line
    (``distributed.worker.parse_closing_line``).
    """

    def __init__(self, n_nodes: int, objective_spec: Dict,
                 lease_ttl: float = 15.0, heartbeat_interval: float = 1.0,
                 journal_path: Optional[str] = None, resume: bool = False,
                 host: str = "127.0.0.1", port: int = 0, slots: int = 1,
                 bracket_eta: Optional[int] = None,
                 worker_grace: Optional[float] = None):
        self.n_nodes = n_nodes
        self.objective_spec = dict(objective_spec)
        self.lease_ttl = lease_ttl
        self.heartbeat_interval = heartbeat_interval
        self.journal_path = journal_path
        self.resume = resume
        self.host = host
        self.port = port
        # slots > 1: each worker process is a multi-trial population engine
        # leasing up to this many trials at once (rl / lm objectives only)
        self.slots = slots
        self.bracket_eta = bracket_eta
        # do workers join the server-side rung barrier (--bracket)? Updated
        # in run() once the service exists: a first-class Scheduler
        # (Hyperband) declares its own brackets without bracket_eta
        self._workers_bracket = bracket_eta is not None
        # how long workers may linger once the service is drained (no
        # leases, no requeued configs) before the launcher presumes them
        # hung and kills them; None -> 3 lease TTLs (>= 30 s)
        self.worker_grace = (worker_grace if worker_grace is not None
                             else max(3.0 * lease_ttl, 30.0))

    def _worker_cmd(self, port: int, node: int) -> List[str]:
        cmd = [sys.executable, "-m", "repro_torch.distributed.worker",
               "--host", self.host, "--port", str(port),
               "--spec", json.dumps(self.objective_spec),
               "--node", str(node),
               "--heartbeat-interval", str(self.heartbeat_interval)]
        if self.slots > 1:
            cmd += ["--slots", str(self.slots)]
        if self._workers_bracket:
            cmd += ["--bracket"]
        return cmd

    def spawn_workers(self, port: int) -> List[subprocess.Popen]:
        """Launch one worker process per node against a running server."""
        import repro_torch
        # namespace package: locate the src dir from __path__, not __file__
        src_dir = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_dir + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return [subprocess.Popen(self._worker_cmd(port, i), env=env)
                for i in range(self.n_nodes)]

    def _await_workers(self, procs, server, svc,
                       journal=None) -> List[int]:
        """Wait for every worker, but bounded: once the service is drained
        (no live leases, no requeued configs waiting for a taker) a healthy
        worker exits within one acquire round-trip, so any process still
        alive ``worker_grace`` seconds later is presumed hung and killed —
        a single stuck worker cannot stall the launcher forever. Returns
        per-process exit codes."""
        drained_since: Optional[float] = None
        dead_nodes: set = set()
        while True:
            exited = {i for i, p in enumerate(procs) if p.poll() is not None}
            for i in exited - dead_nodes:
                # an exited worker's free capacity will never refill the
                # bracket: stop the entry cohort waiting for it
                svc.reduce_bracket_entrants(self.slots)
                if journal is not None:
                    # host churn, journaled WHEN it happened (the final
                    # exit-code summary knows the codes but not the time):
                    # the dashboard plots worker deaths from these. Replay
                    # skips unknown event kinds, so old tooling is
                    # unaffected.
                    journal.append({"ev": "worker_exit", "node": i,
                                    "exit_code": procs[i].poll()})
            dead_nodes = exited
            if len(exited) == len(procs):
                break
            # "drained" only makes sense once the search has started:
            # before the first acquire (workers still importing torch /
            # building kernels) there is nothing to be drained OF — svc.drained()
            # is False until the first trial exists
            busy = server.live_lease_count() > 0 or not svc.drained()
            now = time.monotonic()
            if busy:
                drained_since = None
            elif drained_since is None:
                drained_since = now
            elif now - drained_since > self.worker_grace:
                hung = [p for p in procs if p.poll() is None]
                warnings.warn(
                    f"killing {len(hung)} worker process(es) still alive "
                    f"{self.worker_grace:.0f}s after the service drained "
                    "(no leases, no requeued configs) — presumed hung")
                for p in hung:
                    p.kill()
                for p in hung:
                    p.wait()
                break
            time.sleep(0.1)
        return [p.wait() for p in procs]

    def run(self, policy: AsyncPolicy) -> ExecResult:
        from repro_torch.distributed.journal import Journal, replay_journal
        from repro_torch.distributed.server import MetaoptServer

        svc = OptimizationService(policy, bracket_eta=self.bracket_eta)
        # a first-class Scheduler (Hyperband) brings its own brackets:
        # workers must join the barrier even without bracket_eta
        self._workers_bracket = svc.barrier is not None
        # bracket entry cohorts are sized to real capacity: the first waits
        # for min(total worker slots, budget) enrollments (seeded via the
        # server's bracket_capacity below, split across brackets by the
        # scheduler), and a fully-parked cohort missing dead capacity
        # resolves after the patience window instead of wedging
        capacity = self.n_nodes * self.slots
        budget = (getattr(policy, "n_trials", None)
                  or getattr(policy, "w0", None))
        bracket_capacity = (min(capacity, budget) if budget else capacity) \
            if svc.barrier is not None else None
        journal = None
        if self.journal_path:
            if not self.resume and os.path.exists(self.journal_path):
                # a fresh (non-resume) search must not append to a previous
                # run's journal: trial ids would collide on a later --resume
                os.remove(self.journal_path)
            journal = Journal(self.journal_path)
            if self.resume:
                replay_journal(self.journal_path, svc, journal=journal)

        server = MetaoptServer(svc, self.host, self.port,
                               lease_ttl=self.lease_ttl, journal=journal,
                               bracket_capacity=bracket_capacity)
        server.start()
        t0 = time.monotonic()
        try:
            procs = self.spawn_workers(server.port)
            rcs = self._await_workers(procs, server, svc, journal=journal)
            wall = time.monotonic() - t0
        finally:
            server.stop()
            if journal is not None:
                journal.close()
        if not server.report_log and all(rc != 0 for rc in rcs):
            raise RuntimeError(
                f"all {self.n_nodes} workers failed (exit codes {rcs}) "
                "before reporting anything — check the objective spec and "
                "worker environment")
        extra: Dict = {}
        failed = {node: rc for node, rc in enumerate(rcs) if rc != 0}
        if failed:
            # a PARTIAL failure must not be silent: the search completed on
            # the surviving workers, but the caller should know
            warnings.warn(f"{len(failed)}/{self.n_nodes} worker "
                          f"process(es) exited nonzero: {failed}")
            extra["worker_exit_codes"] = rcs
        if svc.barrier is not None and svc.barrier.rung_log:
            extra["rungs"] = svc.barrier.rung_log
        clone_log = getattr(svc.scheduler, "clone_log", None)
        if clone_log:
            extra["clones"] = len(clone_log)
        records = [ExecRecord(tid, node if node is not None else -1, phase,
                              ts, te, metric)
                   for tid, node, phase, ts, te, metric in server.report_log]
        # capacity for occupancy accounting: slots trials fit in each worker
        return ExecResult(svc, records, wall, self.n_nodes * self.slots,
                          extra=extra or None)


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
        from repro_torch.device import resolve_device
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
