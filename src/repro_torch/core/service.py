"""The hyperparameter-optimization service (the MagLev analogue).

A thread-safe service backed by a central knowledge database. Workers
(threads or simulated nodes) acquire trials, report a metric at the end of
each phase, and are told whether to continue — exactly the worker protocol
of paper §3.1/§3.2. The metaoptimizer is pluggable two ways:

* a classic ``AsyncPolicy`` (HyperTrick, random search, ASHA, ...) — the
  service wraps it in a ``core.scheduler.PolicyScheduler`` (or a
  ``BracketScheduler`` when ``bracket_eta`` is given, reproducing the
  PR-4 single-bracket barrier);
* a first-class ``core.scheduler.Scheduler`` (Hyperband, PBT) passed
  directly — the service dispatches on the ``Verdict``s it returns and
  builds a ``RungBarrier`` over whatever ``(bracket_id, rung)`` cohorts
  the scheduler declares.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.scheduler import (BracketScheduler, Decision,
                                  PolicyScheduler, Scheduler, Verdict,
                                  VerdictKind)
from repro_torch.telemetry.metrics import MetricsRegistry

import enum


class TrialStatus(enum.Enum):
    RUNNING = "running"
    COMPLETED = "completed"     # ran all phases
    KILLED = "killed"           # evicted by the policy
    CRASHED = "crashed"         # worker failure (local effect only, §3.2)


@dataclass
class TrialRecord:
    trial_id: int
    hparams: Dict[str, Any]
    status: TrialStatus = TrialStatus.RUNNING
    node: Optional[int] = None
    # config re-issued after a reclaimed lease (did not consume policy budget)
    requeued: bool = False
    # which scheduler bracket the trial belongs to (Hyperband runs several
    # concurrently; single-bracket and bracketless searches use 0)
    bracket_id: int = 0
    # per-phase: (metric, wall_time_reported)
    reports: List[tuple] = field(default_factory=list)
    start_time: float = 0.0
    end_time: Optional[float] = None

    @property
    def phases_completed(self) -> int:
        return len(self.reports)

    @property
    def last_metric(self) -> Optional[float]:
        return self.reports[-1][0] if self.reports else None

    @property
    def best_metric(self) -> Optional[float]:
        return max(r[0] for r in self.reports) if self.reports else None


class KnowledgeDB:
    """Central store of trials, configurations, and reported metrics."""

    def __init__(self):
        self._lock = threading.RLock()
        self.trials: Dict[int, TrialRecord] = {}
        # phase -> list of metrics in report order (the stats WSM quantiles use)
        self.phase_metrics: Dict[int, List[float]] = {}

    def add_trial(self, rec: TrialRecord):
        with self._lock:
            self.trials[rec.trial_id] = rec

    def report(self, trial_id: int, phase: int, metric: float,
               now: float) -> int:
        """Record a phase-end report; returns the number of reports already
        filed for this phase *before* this one."""
        with self._lock:
            rec = self.trials[trial_id]
            assert rec.phases_completed == phase, (
                f"trial {trial_id} reported phase {phase} but has "
                f"{rec.phases_completed} reports")
            prior = len(self.phase_metrics.get(phase, []))
            self.phase_metrics.setdefault(phase, []).append(metric)
            rec.reports.append((metric, now))
            return prior

    def metrics_for_phase(self, phase: int) -> List[float]:
        with self._lock:
            return list(self.phase_metrics.get(phase, []))

    def set_status(self, trial_id: int, status: TrialStatus,
                   now: Optional[float] = None):
        with self._lock:
            rec = self.trials[trial_id]
            rec.status = status
            if status != TrialStatus.RUNNING:
                rec.end_time = now

    def best_trial(self) -> Optional[TrialRecord]:
        with self._lock:
            # crashed trials never count: their metrics come from a worker
            # that subsequently failed, so they are not selectable outcomes
            done = [t for t in self.trials.values()
                    if t.reports and t.status is not TrialStatus.CRASHED]
            if not done:
                return None
            return max(done, key=lambda t: t.best_metric)

    def replay(self, events: Iterable[dict]) -> int:
        """Apply journaled acquire/report/status events (see
        ``distributed.journal``) to rebuild the DB after a restart."""
        with self._lock:
            n = 0
            for ev in events:
                kind = ev.get("ev")
                if kind == "acquire":
                    rec = TrialRecord(ev["trial_id"], ev["hparams"],
                                      node=ev.get("node"),
                                      requeued=ev.get("requeued", False),
                                      bracket_id=ev.get("bracket", 0),
                                      start_time=ev.get("t") or 0.0)
                    self.trials[rec.trial_id] = rec
                elif kind == "report":
                    rec = self.trials[ev["trial_id"]]
                    self.phase_metrics.setdefault(
                        ev["phase"], []).append(ev["metric"])
                    rec.reports.append((ev["metric"], ev.get("t")))
                elif kind == "status":
                    rec = self.trials[ev["trial_id"]]
                    rec.status = TrialStatus(ev["status"])
                    if rec.status is not TrialStatus.RUNNING:
                        rec.end_time = ev.get("t")
                elif kind == "perturb":
                    # a PBT clone verdict changed the trial's live hparams
                    self.trials[ev["trial_id"]].hparams = ev["hparams"]
                else:
                    continue
                n += 1
            return n

    def completion_rate(self, n_phases: int) -> float:
        """Measured worker completion rate alpha (paper §5.2.3)."""
        with self._lock:
            total = sum(t.phases_completed for t in self.trials.values())
            return total / (n_phases * max(len(self.trials), 1))

    def summary(self) -> dict:
        with self._lock:
            by_status: Dict[str, int] = {}
            for t in self.trials.values():
                by_status[t.status.value] = by_status.get(t.status.value, 0) + 1
            best = self.best_trial()
            return {
                "n_trials": len(self.trials),
                "by_status": by_status,
                "best_metric": best.best_metric if best else None,
                "best_hparams": best.hparams if best else None,
            }


@dataclass
class ParkedReport:
    """A rung-phase report withheld at the generation barrier: the metric
    and worker-side timestamps are held here (NOT in the knowledge DB) until
    the trial's rung cohort is complete, then recorded and answered with a
    promote/demote decision."""
    trial_id: int
    phase: int
    metric: float
    t_start: float = 0.0
    t_end: float = 0.0
    node: Optional[int] = None
    # env transitions the phase consumed (engine workers report it; scalar
    # workers leave it None) — carried through the barrier so the journal
    # entry written at resolution matches a non-parked report's
    env_steps: Optional[int] = None
    # service-clock time the report parked (telemetry: cohort wait)
    t_parked: float = 0.0
    # set at resolution: the decision delivered to the worker's next poll,
    # and the service-clock time the report was recorded to the DB
    decision: Optional[Decision] = None
    t_recorded: Optional[float] = None


class RungBarrier:
    """The shared-population generation barrier for rung schedulers — pure
    *mechanism*: parking, cohort membership, and entry-cohort sizing. The
    *policy* (which phases are rungs, who gets demoted) lives in the
    ``Scheduler`` that declared the brackets.

    Cohorts are keyed by ``(bracket_id, rung)``: full Hyperband runs its
    brackets concurrently through one barrier, each resolving
    independently; the single-bracket schedulers simply use bracket 0
    everywhere. Trials opt in via the ``rung`` acquire hint. An enrolled
    trial is always *heading* to its bracket's next rung phase; when it
    reports at that phase the report parks here instead of landing in the
    DB, and the cohort resolves once all its members are parked — so one
    bracket spans any number of hosts, with the cohort sized by rung-aware
    ACQUIRE rather than by any single engine's slot count. A member that
    dies (crash, lease reaped) is discarded and the cohort *shrinks*, so a
    dead host can never wedge the barrier; its withheld report is dropped
    and its configuration requeues as usual.

    Not thread-safe on its own: every mutation happens under the owning
    ``OptimizationService``'s lock.
    """

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler
        self.n_phases = scheduler.n_phases
        # bracket_id -> ascending rung phases (final phase never a rung)
        self.brackets: Dict[int, Tuple[int, ...]] = {
            b: tuple(r) for b, r in scheduler.brackets.items() if r}
        self._heading: Dict[int, Tuple[int, int]] = {}  # tid->(bracket,rung)
        # park (insertion) order is the cohort's tie-break base order
        self._parked: Dict[int, ParkedReport] = {}
        self._verdicts: Dict[int, Verdict] = {}  # resolved, not yet polled
        self._resolved_queue: List[ParkedReport] = []
        self.rung_log: List[dict] = []
        # -- entry-cohort sizing (rung-aware acquire) -----------------------
        # how many MORE entrants each bracket's entry cohort should wait
        # for before it may resolve: the launcher seeds it with the initial
        # capacity (min(total slots, budget), split across brackets by the
        # scheduler), each resolution adds the capacity it freed, every
        # hinted grant consumes one, and a spent budget collapses it — so
        # the entry cohort is sized to the freed capacity actually being
        # refilled across every host, and a host that parks early cannot
        # strand the others outside the bracket
        self.pending_entrants: Dict[int, int] = {b: 0 for b in self.brackets}
        self._entrants_closed = False      # budget spent: no more, ever
        # safety valve for capacity that died before refilling (its worker
        # crashed between freeing a slot and acquiring): a fully-parked
        # entry cohort still resolves after this many seconds even with
        # entrants outstanding. None = wait forever (single-host engines,
        # where enrollment is same-loop and can never stall).
        self.entrant_patience: Optional[float] = None
        self._all_parked_since: Dict[Tuple[int, int], float] = {}

    @property
    def rungs(self) -> Tuple[int, ...]:
        """Bracket 0's rung phases (the whole schedule for single-bracket
        schedulers — kept for launcher summaries and back-compat)."""
        return self.brackets.get(0, ())

    # -- entry-cohort sizing ------------------------------------------------
    def expect_entrants(self, n: int, bracket_id: int = 0) -> None:
        if bracket_id in self.brackets:
            self.pending_entrants[bracket_id] = max(
                self.pending_entrants[bracket_id], n)

    def reduce_entrants(self, n: int) -> None:
        """Capacity that will never refill (its worker process exited):
        stop waiting for it — in every bracket, since the dead slots could
        have refilled any of them. Over-reduction is safe: cohorts resolve
        slightly smaller, never wedge."""
        for b in self.pending_entrants:
            self.pending_entrants[b] = max(0, self.pending_entrants[b] - n)

    def no_more_entrants(self) -> None:
        """The scheduler budget is spent: nobody else is ever joining."""
        self._entrants_closed = True
        for b in self.pending_entrants:
            self.pending_entrants[b] = 0

    # -- membership ---------------------------------------------------------
    def _next_rung(self, bracket_id: int,
                   phases_completed: int) -> Optional[int]:
        for p in self.brackets.get(bracket_id, ()):
            if p >= phases_completed:
                return p
        return None

    def enroll(self, trial_id: int, bracket_id: int = 0) -> None:
        """A fresh trial (phases_completed == 0) joins its bracket, heading
        to that bracket's first rung, and consumes one of the bracket's
        expected entrants. Trials acquired WITHOUT the rung hint are never
        enrolled: their rung-phase reports resolve immediately, so scalar
        workers predating the barrier can share the server without wedging
        a cohort. Brackets with no rungs (Hyperband's s=0) never park."""
        rung = self._next_rung(bracket_id, 0)
        if rung is not None:
            self._heading[trial_id] = (bracket_id, rung)
            self.pending_entrants[bracket_id] = max(
                0, self.pending_entrants[bracket_id] - 1)

    def tracks(self, trial_id: int) -> bool:
        return trial_id in self._heading or trial_id in self._verdicts

    def heading_key(self, trial_id: int) -> Optional[Tuple[int, int]]:
        """The (bracket_id, rung) cohort the trial is heading to."""
        return self._heading.get(trial_id)

    def heading_rung(self, trial_id: int) -> Optional[int]:
        key = self._heading.get(trial_id)
        return key[1] if key is not None else None

    def is_parked(self, trial_id: int) -> bool:
        return trial_id in self._parked

    def members(self, bracket_id: int, rung: int) -> List[int]:
        return [t for t, key in self._heading.items()
                if key == (bracket_id, rung)]

    def cohort_keys(self) -> List[Tuple[int, int]]:
        """Every (bracket_id, rung) cohort with at least one member."""
        return sorted(set(self._heading.values()))

    def cohort_ready(self, bracket_id: int, rung: int, now: float) -> bool:
        """May the cohort at ``(bracket_id, rung)`` resolve? Every member
        must be parked; a bracket's ENTRY rung additionally waits for the
        bracket's expected entrants (freed capacity still refilling on
        other hosts), up to ``entrant_patience`` seconds after the last
        member parked."""
        ms = self.members(bracket_id, rung)
        if not ms or not all(t in self._parked for t in ms):
            self._all_parked_since.pop((bracket_id, rung), None)
            return False
        entry = self.brackets.get(bracket_id, (None,))[0]
        if (rung != entry
                or self.pending_entrants.get(bracket_id, 0) <= 0):
            return True
        since = self._all_parked_since.setdefault((bracket_id, rung), now)
        return (self.entrant_patience is not None
                and now - since >= self.entrant_patience)

    def park(self, rep: ParkedReport) -> None:
        key = self._heading.get(rep.trial_id)
        assert key is not None and key[1] == rep.phase, (
            rep.trial_id, rep.phase, key)
        self._parked[rep.trial_id] = rep

    def take_verdict(self, trial_id: int) -> Optional[Verdict]:
        return self._verdicts.pop(trial_id, None)

    def discard(self, trial_id: int) -> Optional[Tuple[int, int]]:
        """Drop a dead member (crash / reaped lease / policy kill): its
        withheld report — if any — is dropped, and the (bracket, rung) it
        was heading to is returned so the caller can re-check that cohort
        (the shrink may have completed it)."""
        key = self._heading.pop(trial_id, None)
        self._parked.pop(trial_id, None)
        self._verdicts.pop(trial_id, None)
        return key

    def drain_resolved(self) -> List[ParkedReport]:
        """Reports recorded by resolutions since the last drain, in each
        cohort's park order — the transport layer journals/logs them."""
        out, self._resolved_queue = self._resolved_queue, []
        return out


class AsyncPolicy:
    """A metaoptimization policy for asynchronous execution. Subclasses:
    HyperTrick, RandomSearchPolicy. (New-style metaoptimizers subclass
    ``core.scheduler.Scheduler`` instead and own the whole lifecycle.)"""

    n_phases: int = 1

    def bind(self, db: KnowledgeDB):
        self.db = db

    def next_hparams(self) -> Optional[Dict[str, Any]]:
        """Next configuration to explore, or None when the budget is spent."""
        raise NotImplementedError

    def on_report(self, trial_id: int, phase: int, metric: float,
                  prior_reports: int) -> Decision:
        raise NotImplementedError

    def note_replayed_trial(self, hparams: Dict[str, Any],
                            requeued: bool = False):
        """A trial issued by a previous incarnation of the service (journal
        replay). Budget-accounting subclasses override this."""


class OptimizationService:
    """Thread-safe facade the workers talk to (report / acquire / query).

    ``policy`` may be a classic ``AsyncPolicy`` (wrapped in a
    ``PolicyScheduler``, or a ``BracketScheduler`` when ``bracket_eta`` is
    given) or a first-class ``Scheduler`` used as-is. Every lifecycle
    decision flows through ONE verdict pipeline: the scheduler's
    ``Verdict`` is applied here (statuses, clone hparam swaps, barrier
    bookkeeping) and mapped to the transport ``Decision`` for workers."""

    def __init__(self, policy, clock=time.monotonic,
                 bracket_eta: Optional[int] = None, metrics=None):
        self.db = KnowledgeDB()
        # telemetry: latencies in real seconds (time.perf_counter — the cost
        # of the code, even under a simulated ``clock``), waits in service-
        # clock seconds (domain time — meaningful in trace replay too).
        # Pass ``telemetry.NULL_REGISTRY`` to opt out entirely.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if isinstance(policy, Scheduler):
            assert bracket_eta is None, (
                "a Scheduler declares its own brackets; bracket_eta only "
                "wraps classic AsyncPolicy instances")
            self.scheduler: Scheduler = policy
        elif bracket_eta is not None:
            self.scheduler = BracketScheduler(policy, bracket_eta)
        else:
            self.scheduler = PolicyScheduler(policy)
        self.scheduler.bind(self.db)
        # the object summaries/launchers introspect (n_phases, w0, ...):
        # the original policy when wrapped, the scheduler itself otherwise
        self.policy = policy
        self.clock = clock
        self._lock = threading.RLock()
        self._next_id = 0
        # configs reclaimed from dead workers, re-issued before new draws:
        # (hparams, bracket_id) so a Hyperband config rejoins its bracket
        self._requeue: deque = deque()
        # rung schedulers: the generation barrier lives in the SERVICE, so
        # one bracket spans any number of hosts (every transport — the
        # in-process LocalDriver or the TCP server — speaks the same
        # park/resolve interface)
        self.barrier: Optional[RungBarrier] = (
            RungBarrier(self.scheduler) if self.scheduler.brackets else None)

    def requeue(self, hparams: Dict[str, Any], bracket_id: int = 0):
        """Re-issue a configuration whose worker died (lease expired): the
        budget slot goes back to the pool without charging the policy."""
        with self._lock:
            self._requeue.append((hparams, bracket_id))
            self.metrics.counter("service.requeues").inc()

    def acquire_trial(self, node: Optional[int] = None,
                      rung: Optional[int] = None) -> Optional[TrialRecord]:
        """``rung`` is the rung-aware acquire hint: the caller is refilling
        freed bracket capacity, so the granted trial is enrolled in the
        barrier immediately — the entry cohort is sized at grant time,
        before any park, and cannot resolve under an in-flight member.
        Without the hint the trial never parks (plain asynchronous search,
        or a bracket-unaware worker sharing the server).

        Acquire-ordering tweak (speculative rung-0 refill): any cohort
        that is READY right now resolves *before* the new trial enrolls,
        so a speculative entrant — acquired by an engine whose own cohort
        is still parked awaiting its verdict polls — always lands in the
        NEXT generation instead of wedging or inflating a completed one."""
        t0 = time.perf_counter()
        try:
            return self._acquire_trial(node, rung)
        finally:
            self.metrics.histogram("service.acquire_s").observe(
                time.perf_counter() - t0)

    def _acquire_trial(self, node: Optional[int],
                       rung: Optional[int]) -> Optional[TrialRecord]:
        with self._lock:
            requeued = False
            bracket_id = 0
            if self._requeue:
                hp, bracket_id = self._requeue.popleft()
                requeued = True
            else:
                spec = self.scheduler.spawn()
                hp = spec.hparams if spec is not None else None
                bracket_id = spec.bracket_id if spec is not None else 0
            if hp is None:
                if self.barrier is not None and rung is not None:
                    # a bracket participant asked and the budget is spent:
                    # the entry cohorts stop waiting for anyone else (any
                    # cohort they gated may now be resolvable on next poll)
                    self.barrier.no_more_entrants()
                return None
            if self.barrier is not None and rung is not None:
                self._resolve_ready_cohorts()
            rec = TrialRecord(self._next_id, hp, node=node, requeued=requeued,
                              bracket_id=bracket_id,
                              start_time=self.clock())
            self._next_id += 1
            self.db.add_trial(rec)
            if self.barrier is not None and rung is not None:
                self.barrier.enroll(rec.trial_id, bracket_id)
            return rec

    def report(self, trial_id: int, phase: int, metric: float,
               t_start: float = 0.0, t_end: float = 0.0,
               node: Optional[int] = None,
               env_steps: Optional[int] = None) -> Decision:
        """The transport-level decision for a report (continue / stop /
        parked) — ``report_verdict`` narrowed for callers that do not
        execute clone verdicts."""
        return self.report_verdict(trial_id, phase, metric, t_start=t_start,
                                   t_end=t_end, node=node,
                                   env_steps=env_steps).decision

    def report_verdict(self, trial_id: int, phase: int, metric: float,
                       t_start: float = 0.0, t_end: float = 0.0,
                       node: Optional[int] = None,
                       env_steps: Optional[int] = None) -> Verdict:
        """The full verdict pipeline: park/poll bookkeeping for enrolled
        trials, then the scheduler's verdict applied to the knowledge DB —
        including PBT clone verdicts, whose perturbed hyperparameters are
        swapped into the live trial record here (the in-process thread
        cluster picks them up by reference; the server forwards
        ``clone_from``/``perturb`` on the wire).

        ``env_steps`` is telemetry only: how many env transitions the
        phase consumed. It never influences a verdict."""
        t0 = time.perf_counter()
        try:
            return self._report_verdict(trial_id, phase, metric, t_start,
                                        t_end, node, env_steps)
        finally:
            self.metrics.histogram("service.report_s").observe(
                time.perf_counter() - t0)

    def _report_verdict(self, trial_id: int, phase: int, metric: float,
                        t_start: float, t_end: float, node: Optional[int],
                        env_steps: Optional[int]) -> Verdict:
        with self._lock:
            b = self.barrier
            if b is not None and b.tracks(trial_id):
                verdict = b.take_verdict(trial_id)
                if verdict is not None:
                    # a poll after resolution: the report was recorded (and
                    # the cohort ranked) when the barrier resolved — just
                    # deliver the verdict
                    return verdict
                key = b.heading_key(trial_id)
                if key is not None and key[1] == phase:
                    if not b.is_parked(trial_id):
                        b.park(ParkedReport(trial_id, phase, metric,
                                            t_start, t_end, node,
                                            env_steps=env_steps,
                                            t_parked=self.clock()))
                        self.metrics.counter("service.verdicts.park").inc()
                    # the readiness check runs on PARKS and on POLLS: polls
                    # are what pick up late entrant-closures (budget spent
                    # on another connection) and the patience timeout.
                    # Even the parker that completed the cohort is answered
                    # "parked": every member learns its verdict on its next
                    # poll, so a host's verdicts arrive in its own stable
                    # slot order (deterministic records/ranking).
                    if b.cohort_ready(key[0], phase, self.clock()):
                        self._resolve_rung(key[0], phase)
                    return Verdict.PARK
            now = self.clock()
            prior = self.db.report(trial_id, phase, metric, now)
            if env_steps:
                self.metrics.counter("service.env_steps").inc(env_steps)
            verdict = self.scheduler.on_report(trial_id, phase, metric,
                                               prior)
            if phase >= self.scheduler.n_phases - 1:
                self._untrack(trial_id)
                self.db.set_status(trial_id, TrialStatus.COMPLETED, now)
                self.metrics.counter("service.verdicts.stop").inc()
                return Verdict.STOP
            self.metrics.counter(
                "service.verdicts." + verdict.kind.value).inc()
            if verdict.kind in (VerdictKind.STOP, VerdictKind.DEMOTE):
                self._untrack(trial_id)
                self.db.set_status(trial_id, TrialStatus.KILLED, now)
            elif verdict.kind is VerdictKind.CLONE:
                # the trial continues as a clone: its live configuration
                # becomes the perturbed one (state copy is the worker's
                # side — device-side in the population engine)
                self.db.trials[trial_id].hparams = dict(verdict.perturb)
            return verdict

    def _resolve_ready_cohorts(self) -> None:
        """Resolve every cohort that is ready RIGHT NOW (all members
        parked, entrants satisfied or patience expired). Called before a
        rung-hinted grant enrolls, so speculative refills join the next
        generation — and as a sweep after barrier-shape events."""
        b = self.barrier
        now = self.clock()
        for bracket_id, rung in b.cohort_keys():
            if b.cohort_ready(bracket_id, rung, now):
                self._resolve_rung(bracket_id, rung)

    def _resolve_rung(self, bracket_id: int, rung: int) -> None:
        """The generation barrier: rank the complete ``(bracket_id, rung)``
        cohort and demote whomever the scheduler's ``resolve_cohort``
        names (bottom ``n // eta`` for the single-bracket barrier — with
        ASHA's small-cohort rule — keep-top-``1/eta`` for Hyperband),
        record every withheld report, and set each member's verdict for
        its next poll."""
        b = self.barrier
        # park order (dict insertion order) is the deterministic base order
        group = [b._parked.pop(t) for t in list(b._parked)
                 if b._heading.get(t) == (bracket_id, rung)]
        demoted_j = self.scheduler.resolve_cohort(
            bracket_id, rung, [r.metric for r in group])
        now = self.clock()
        wait_h = self.metrics.histogram("service.cohort_wait_s")
        demoted, promoted, stopped = [], [], []
        for j, rep in enumerate(group):
            prior = self.db.report(rep.trial_id, rep.phase, rep.metric, now)
            verdict = self.scheduler.on_report(rep.trial_id, rep.phase,
                                               rep.metric, prior)
            rep.t_recorded = now
            wait_h.observe(max(0.0, now - rep.t_parked))
            if rep.env_steps:
                self.metrics.counter("service.env_steps").inc(rep.env_steps)
            del b._heading[rep.trial_id]
            if j in demoted_j or verdict.kind in (VerdictKind.STOP,
                                                  VerdictKind.DEMOTE):
                # demotion, or a policy stop the barrier honors anyway —
                # logged apart so the rung accounting stays exact
                (demoted if j in demoted_j else stopped).append(rep.trial_id)
                self.db.set_status(rep.trial_id, TrialStatus.KILLED, now)
                rep.decision = Decision.STOP
                b._verdicts[rep.trial_id] = Verdict.DEMOTE \
                    if j in demoted_j else Verdict.STOP
                self.metrics.counter(
                    "service.verdicts.demote" if j in demoted_j
                    else "service.verdicts.stop").inc()
            else:
                promoted.append(rep.trial_id)
                self.metrics.counter("service.verdicts.continue").inc()
                rep.decision = Decision.CONTINUE
                nxt = b._next_rung(bracket_id, rep.phase + 1)
                if nxt is not None:
                    b._heading[rep.trial_id] = (bracket_id, nxt)
                b._verdicts[rep.trial_id] = Verdict.CONTINUE
            b._resolved_queue.append(rep)
        entry = {"phase": rung, "n": len(group),
                 "demoted": demoted, "promoted": promoted}
        if stopped:
            entry["stopped"] = stopped
        if len(b.brackets) > 1:
            # multi-bracket schedulers (Hyperband) tag each resolution;
            # single-bracket logs keep their entries without the tag
            entry["bracket"] = bracket_id
        b.rung_log.append(entry)
        b._all_parked_since.pop((bracket_id, rung), None)
        if not b._entrants_closed:
            # the capacity this resolution freed refills whatever the
            # scheduler spawns next: those brackets' entry cohorts wait
            # for the corresponding fresh enrollments
            freed = len(demoted) + len(stopped)
            for bb, n in self.scheduler.attribute_refill(freed).items():
                if bb in b.pending_entrants:
                    b.pending_entrants[bb] += n

    def _untrack(self, trial_id: int) -> None:
        """Remove a trial from the barrier (terminal status, crash, reaped
        lease) and resolve any cohort its departure completed — the
        reaper-shrink path that keeps a dead host from wedging a rung."""
        if self.barrier is None:
            return
        key = self.barrier.discard(trial_id)
        if key is not None and self.barrier.cohort_ready(key[0], key[1],
                                                         self.clock()):
            self._resolve_rung(key[0], key[1])

    def drain_resolved(self) -> List[ParkedReport]:
        """Barrier resolutions since the last call (empty without a
        barrier): the transport journals/logs these reports."""
        if self.barrier is None:
            return []
        with self._lock:
            return self.barrier.drain_resolved()

    def configure_bracket(self, expect_entrants: Optional[int] = None,
                          entrant_patience: Optional[float] = None) -> None:
        """Size the barrier's entry cohorts: ``expect_entrants`` is the
        total capacity the entry cohorts should wait for (typically
        min(total worker slots, budget)) — the scheduler splits it across
        its brackets (all of it on bracket 0 for single-bracket
        schedulers, fill-order shares for Hyperband);
        ``entrant_patience`` bounds that wait once a cohort is fully
        parked. No-op without a barrier."""
        if self.barrier is None:
            return
        with self._lock:
            if expect_entrants is not None:
                shares = self.scheduler.split_entry_capacity(expect_entrants)
                for bracket_id, share in shares.items():
                    self.barrier.expect_entrants(share, bracket_id)
            if entrant_patience is not None:
                self.barrier.entrant_patience = entrant_patience

    def reduce_bracket_entrants(self, n: int) -> None:
        """Bracket capacity that died (its worker exited): stop the entry
        cohorts waiting for it. No-op without a barrier."""
        if self.barrier is None:
            return
        with self._lock:
            self.barrier.reduce_entrants(n)

    def drained(self) -> bool:
        """True once the search has started AND no requeued configuration
        is waiting for a taker — the launcher-side half of the "everything
        that can finish has finished" check (live leases are the server's
        half)."""
        with self._lock:
            return bool(self.db.trials) and not self._requeue

    def crash(self, trial_id: int):
        """Worker failure: strictly local effect (paper §3.2)."""
        with self._lock:
            self._untrack(trial_id)
            self.db.set_status(trial_id, TrialStatus.CRASHED, self.clock())

    def stop_trial(self, trial_id: int):
        """Executor-driven eviction (a client-side ``demote`` report):
        mark a RUNNING trial KILLED — same terminal status a policy STOP
        decision produces, but decided outside ``on_report``."""
        with self._lock:
            rec = self.db.trials[trial_id]
            if rec.status is TrialStatus.RUNNING:
                self._untrack(trial_id)
                self.db.set_status(trial_id, TrialStatus.KILLED,
                                   self.clock())

    def state_snapshot(self) -> dict:
        """A JSON-able snapshot of the replayable service state: trials,
        phase-metric lists, id counter, requeue queue. This is exactly what
        ``replay`` reconstructs from a full journal — ``Journal.compact``
        writes it as one ``snapshot`` event so restart replay is O(live
        trials) instead of O(history). Barrier state is deliberately
        absent: replay never parks (withheld reports are only journaled at
        resolution), so both paths leave the barrier freshly built."""
        with self._lock:
            trials = []
            for tid in sorted(self.db.trials):
                rec = self.db.trials[tid]
                t: Dict[str, Any] = {
                    "trial_id": rec.trial_id, "hparams": rec.hparams,
                    "status": rec.status.value,
                    "reports": [[m, tt] for m, tt in rec.reports],
                    "start_time": rec.start_time}
                if rec.node is not None:
                    t["node"] = rec.node
                if rec.requeued:
                    t["requeued"] = True
                if rec.bracket_id:
                    t["bracket"] = rec.bracket_id
                if rec.end_time is not None:
                    t["end_time"] = rec.end_time
                trials.append(t)
            return {
                "v": 1,
                "next_id": self._next_id,
                "requeue": [[hp, b] for hp, b in self._requeue],
                "trials": trials,
                # JSON keys are strings; restore converts back to int
                "phase_metrics": {str(p): list(ms) for p, ms
                                  in sorted(self.db.phase_metrics.items())},
            }

    def _restore_snapshot(self, state: dict) -> List[tuple]:
        """Rebuild db / scheduler accounting / id counter from a
        ``state_snapshot`` dict; returns the snapshot's requeue entries as
        ``(hparams, bracket_id)`` tuples (the caller seeds its pending
        list with them, ahead of any tail-event requeues). Trials are
        restored in id order — every scheduler's
        ``note_replayed_trial`` only counts (HyperTrick/random budgets,
        Hyperband fill order), so id order reproduces the original
        acquire-order accounting exactly."""
        for t in state.get("trials", []):
            rec = TrialRecord(t["trial_id"], t["hparams"],
                              status=TrialStatus(t["status"]),
                              node=t.get("node"),
                              requeued=t.get("requeued", False),
                              bracket_id=t.get("bracket", 0),
                              reports=[tuple(r) for r in
                                       t.get("reports", [])],
                              start_time=t.get("start_time", 0.0),
                              end_time=t.get("end_time"))
            self.db.trials[rec.trial_id] = rec
            self.scheduler.note_replayed_trial(rec.hparams, rec.requeued)
        for p, ms in state.get("phase_metrics", {}).items():
            self.db.phase_metrics[int(p)] = list(ms)
        self._next_id = max(self._next_id, int(state.get("next_id", 0)))
        return [(hp, b) for hp, b in state.get("requeue", [])]

    def replay(self, events: List[dict],
               reclaim_running: bool = True) -> List[TrialRecord]:
        """Rebuild full service state (db, id counter, scheduler budget
        accounting, requeue queue) from journaled events — the service-level
        counterpart of ``KnowledgeDB.replay``. Returns the records that were
        RUNNING at death and got reclaimed (marked CRASHED + requeued).

        A compacted journal starts with a ``snapshot`` event: state is
        restored from the newest snapshot and only the events after it are
        applied — O(live trials + tail), not O(history)."""
        snap_i = None
        for i, ev in enumerate(events):
            if ev.get("ev") == "snapshot":
                snap_i = i
        pending = []              # requeued (hparams, bracket) not re-acquired
        if snap_i is not None:
            with self._lock:
                pending = self._restore_snapshot(events[snap_i]["state"])
            events = events[snap_i + 1:]
        self.db.replay(events)
        for ev in events:
            kind = ev.get("ev")
            if kind == "requeue":
                pending.append((ev["hparams"], ev.get("bracket", 0)))
            elif kind == "acquire":
                if ev.get("requeued"):
                    for i, (hp, _) in enumerate(pending):
                        if hp == ev["hparams"]:
                            del pending[i]
                            break
                self.scheduler.note_replayed_trial(ev["hparams"],
                                                   ev.get("requeued", False))
        reclaimed: List[TrialRecord] = []
        with self._lock:
            ids = [ev["trial_id"] for ev in events if "trial_id" in ev]
            self._next_id = max(self._next_id, max(ids, default=-1) + 1)
            self._requeue.extend(pending)
            if reclaim_running:
                for rec in self.db.trials.values():
                    if rec.status is TrialStatus.RUNNING:
                        rec.status = TrialStatus.CRASHED
                        self._requeue.append((rec.hparams, rec.bracket_id))
                        reclaimed.append(rec)
        return reclaimed
