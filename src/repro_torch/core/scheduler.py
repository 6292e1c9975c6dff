"""The unified trial-lifecycle Scheduler: ONE verdict pipeline for every
metaoptimizer in the repo.

The paper frames HyperTrick as one point in a family of population
metaoptimizers that trade exploration for compute efficiency on a
distributed system. Before this module, each family member was wired
through a different layer: HyperTrick/ASHA decided in ``AsyncPolicy
.on_report``, successive-halving demotion math lived in ``core.asha``,
parking lived in ``core.service.RungBarrier``, and the population engine
hot-swapped on raw decision strings. A ``Scheduler`` owns the whole
lifecycle instead:

* ``spawn()``                 -> the next configuration (plus which
                                 *bracket* it joins and that bracket's
                                 rung schedule);
* ``on_report(...)``          -> a ``Verdict``: continue / stop / demote /
                                 clone_from+perturb (parking is produced
                                 by the service's barrier for enrolled
                                 trials at their declared rungs);
* ``resolve_cohort(...)``     -> which members of a complete rung cohort
                                 are demoted (barrier schedulers only).

``OptimizationService`` and ``MetaoptServer`` dispatch on verdicts; every
transport (thread cluster, TCP server, on-device population engine) sees
the same vocabulary. Adding a metaoptimizer is now one subclass:
``HyperbandScheduler`` (multiple concurrent brackets, cohorts keyed by
``(bracket_id, rung)``) and ``PBTScheduler`` (exploit/explore via CLONE
verdicts, executed device-side by the population engine) are both below —
compare Elfwing et al. (1702.07490) and SEARL (2009.01555) for why
copy-and-perturb populations matter for deep RL.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.search_space import SearchSpace, perturb_hparams


class Decision(enum.Enum):
    """The transport-level decision a worker receives for a report (the
    wire's ``report_ok.decision``). ``Verdict`` is the richer scheduler-
    level value; ``Verdict.decision`` maps onto this."""
    CONTINUE = "continue"
    STOP = "stop"
    # rung barrier (bracket mode): the report is withheld server-side until
    # the trial's rung cohort is complete — keep the slot parked, keep the
    # lease alive, and poll by re-sending the identical report
    PARKED = "parked"


class VerdictKind(enum.Enum):
    CONTINUE = "continue"
    STOP = "stop"          # policy eviction / terminal phase
    PARK = "park"          # withheld at the rung barrier (poll to resolve)
    DEMOTE = "demote"      # killed by a rung cohort's ranking
    CLONE = "clone"        # PBT exploit/explore: copy a parent, perturb


@dataclass(frozen=True)
class Verdict:
    """What happens to a trial after a report. ``CLONE`` carries the parent
    trial to copy learner state from (``clone_from``) and the perturbed
    hyperparameters the trial continues with (``perturb``)."""
    kind: VerdictKind
    clone_from: Optional[int] = None
    perturb: Optional[Dict[str, Any]] = None

    @property
    def decision(self) -> Decision:
        """The wire decision: CLONE rides a ``"continue"`` (plus the
        ``clone_from``/``perturb`` response fields); DEMOTE is a
        ``"stop"`` like any other kill."""
        return _DECISION_OF[self.kind]


_DECISION_OF = {
    VerdictKind.CONTINUE: Decision.CONTINUE,
    VerdictKind.CLONE: Decision.CONTINUE,
    VerdictKind.PARK: Decision.PARKED,
    VerdictKind.STOP: Decision.STOP,
    VerdictKind.DEMOTE: Decision.STOP,
}

# the four argument-less verdicts are singletons
Verdict.CONTINUE = Verdict(VerdictKind.CONTINUE)
Verdict.STOP = Verdict(VerdictKind.STOP)
Verdict.PARK = Verdict(VerdictKind.PARK)
Verdict.DEMOTE = Verdict(VerdictKind.DEMOTE)


def verdict_of(decision: Decision) -> Verdict:
    """Lift a legacy ``AsyncPolicy`` decision into the verdict vocabulary."""
    return {Decision.CONTINUE: Verdict.CONTINUE,
            Decision.STOP: Verdict.STOP,
            Decision.PARKED: Verdict.PARK}[decision]


class ReportReply(str):
    """A report decision as the worker-side string (``"continue"`` /
    ``"stop"`` / ``"parked"`` — compares equal to plain strings, so every
    caller written before verdicts keeps working) carrying the optional CLONE payload
    as attributes. Built by ``ServiceClient.report`` from the wire fields
    and by ``LocalDriver`` from the in-process ``Verdict``."""
    clone_from: Optional[int]
    perturb: Optional[Dict[str, Any]]

    def __new__(cls, decision: str, clone_from: Optional[int] = None,
                perturb: Optional[Dict[str, Any]] = None):
        self = super().__new__(cls, decision)
        self.clone_from = clone_from
        self.perturb = perturb
        return self


@dataclass(frozen=True)
class SpawnSpec:
    """One spawned trial: its configuration and the bracket it joins.
    ``bracket_id`` keys the service barrier's cohorts — two trials park
    together only when their ``(bracket_id, rung)`` match."""
    hparams: Dict[str, Any]
    bracket_id: int = 0


class Scheduler:
    """Owns the whole trial lifecycle. ``brackets`` maps each bracket_id to
    its tuple of rung phases; an empty mapping means the scheduler never
    parks anything (purely asynchronous search). Subclasses implement
    ``spawn`` and ``on_report``; barrier schedulers also implement
    ``resolve_cohort``."""

    n_phases: int = 1
    # bracket_id -> tuple of rung phase indices (ascending, final phase
    # excluded). The service builds its RungBarrier from this.
    brackets: Dict[int, Tuple[int, ...]] = {}

    def bind(self, db) -> None:
        self.db = db

    def spawn(self) -> Optional[SpawnSpec]:
        """The next configuration to explore, or None when the budget is
        spent."""
        raise NotImplementedError

    def on_report(self, trial_id: int, phase: int, metric: float,
                  prior_reports: int) -> Verdict:
        raise NotImplementedError

    def resolve_cohort(self, bracket_id: int, rung: int,
                       metrics: List[float]) -> Set[int]:
        """Indices (into the cohort's park order) of the members demoted at
        this rung. Only called for brackets declared in ``brackets``."""
        return set()

    def split_entry_capacity(self, capacity: int) -> Dict[int, int]:
        """How many entrants each bracket's ENTRY cohort should wait for,
        given ``capacity`` total worker slots. Single-bracket schedulers
        put all of it on bracket 0; Hyperband splits it in fill order."""
        return {b: capacity for b in list(self.brackets)[:1]}

    def attribute_refill(self, freed: int) -> Dict[int, int]:
        """``freed`` slots just opened at a rung resolution: which
        brackets' entry cohorts should wait for the refills the freed
        capacity will acquire next?"""
        return {b: freed for b in list(self.brackets)[:1]}

    def note_replayed_trial(self, hparams: Dict[str, Any],
                            requeued: bool = False) -> None:
        """A trial issued by a previous incarnation of the service (journal
        replay). Budget-accounting subclasses override this."""


class PolicyScheduler(Scheduler):
    """A classic ``AsyncPolicy`` (HyperTrick, random search, ASHA, the
    evolutionary variant) as a Scheduler: spawn delegates to
    ``next_hparams``, reports map Decision -> Verdict, nothing ever parks."""

    brackets: Dict[int, Tuple[int, ...]] = {}

    def __init__(self, policy):
        self.policy = policy
        self.n_phases = policy.n_phases

    def bind(self, db) -> None:
        self.db = db
        self.policy.bind(db)

    def spawn(self) -> Optional[SpawnSpec]:
        hp = self.policy.next_hparams()
        return SpawnSpec(hp) if hp is not None else None

    def on_report(self, trial_id, phase, metric, prior_reports) -> Verdict:
        return verdict_of(self.policy.on_report(trial_id, phase, metric,
                                                prior_reports))

    def note_replayed_trial(self, hparams, requeued: bool = False) -> None:
        self.policy.note_replayed_trial(hparams, requeued)


class BracketScheduler(PolicyScheduler):
    """The PR-4 ``--bracket`` semantics as a Scheduler: ONE successive-
    halving bracket (id 0) whose rung phases park at the service barrier
    and demote the bottom ``n // eta`` of each pooled cohort (ASHA's
    small-cohort rule included). The wrapped policy is the sampler and may
    still evict between rungs."""

    def __init__(self, policy, eta: int):
        from repro_torch.core.asha import rung_phases  # scheduler<-asha cycle
        super().__init__(policy)
        assert eta >= 2, eta
        self.eta = eta
        rungs = tuple(p for p in rung_phases(policy.n_phases, eta)
                      if p < policy.n_phases - 1)
        self.brackets = {0: rungs}

    def resolve_cohort(self, bracket_id, rung, metrics) -> Set[int]:
        from repro_torch.core.asha import demote_indices  # scheduler<-asha cycle
        return demote_indices(metrics, self.eta)


class HyperbandScheduler(Scheduler):
    """Full Hyperband (Li et al. 2016) as one Scheduler: every bracket of
    the ``(eta, R)`` construction runs CONCURRENTLY against the shared
    worker pool. Bracket ``s`` spawns its ``n0_s`` configurations (fill
    order: most-aggressive bracket first), runs rungs at phase indices
    ``r_i - 1``, and the service barrier keys each cohort by
    ``(bracket_id, rung)`` — so two brackets' cohorts at the same phase
    resolve independently. Demotion is classic SH: keep the top
    ``max(1, n // eta)`` of each cohort (ranking rule shared with the
    single-bracket barrier via ``core.asha.bottom_indices``)."""

    def __init__(self, space: SearchSpace, n_phases: int, eta: int = 3,
                 seed: int = 0, plan=None):
        from repro_torch.core.completion import hyperband_brackets
        assert eta >= 2, eta
        self.space = space
        self.n_phases = n_phases                 # R, in phases
        self.eta = eta
        self.rng = np.random.default_rng(seed)
        self.plan = list(plan) if plan is not None \
            else hyperband_brackets(eta, n_phases)
        self.brackets = {}
        self._quota: List[int] = []              # configs per bracket
        for b, br in enumerate(self.plan):
            rungs = tuple(sorted({r - 1 for r in br.r[:-1]
                                  if 0 < r < n_phases}))
            if rungs:
                self.brackets[b] = rungs
            self._quota.append(br.n[0])
        self.n_trials = sum(self._quota)         # budget, for capacity math
        self._spawned = [0] * len(self.plan)

    def spawn(self) -> Optional[SpawnSpec]:
        for b, quota in enumerate(self._quota):
            if self._spawned[b] < quota:
                self._spawned[b] += 1
                return SpawnSpec(self.space.sample(self.rng), bracket_id=b)
        return None

    def on_report(self, trial_id, phase, metric, prior_reports) -> Verdict:
        return Verdict.CONTINUE                  # all decisions are rungs'

    def resolve_cohort(self, bracket_id, rung, metrics) -> Set[int]:
        from repro_torch.core.asha import bottom_indices  # scheduler<-asha cycle
        keep = max(1, len(metrics) // self.eta)
        return bottom_indices(metrics, len(metrics) - keep)

    def split_entry_capacity(self, capacity: int) -> Dict[int, int]:
        # sequential fill: bracket b's entrants start arriving only after
        # the earlier brackets' quotas are granted
        out, offset = {}, 0
        for b, quota in enumerate(self._quota):
            share = max(0, min(quota, capacity - offset))
            offset += quota
            if b in self.brackets and share:
                out[b] = share
        return out

    def attribute_refill(self, freed: int) -> Dict[int, int]:
        # freed capacity acquires the next unspawned configurations, which
        # belong to whichever brackets still have quota in fill order —
        # rungless brackets consume their share of the freed capacity too
        # (their spawns have no entry cohort to wait for)
        out: Dict[int, int] = {}
        for b, quota in enumerate(self._quota):
            if freed <= 0:
                break
            take = min(max(0, quota - self._spawned[b]), freed)
            if take and b in self.brackets:
                out[b] = take
            freed -= take
        return out

    def note_replayed_trial(self, hparams, requeued: bool = False) -> None:
        if requeued:
            return
        for b, quota in enumerate(self._quota):
            if self._spawned[b] < quota:
                self._spawned[b] += 1
                return


class PBTScheduler(Scheduler):
    """Population Based Training as a Scheduler: a fixed population runs
    every phase; a member whose phase metric falls in the bottom
    ``exploit_frac`` quantile of that phase's reports receives a CLONE
    verdict — copy the learner state of a uniformly-drawn top
    ``top_frac`` member and continue with a perturbed copy of its
    hyperparameters (``search_space.perturb_hparams``). On the on-device
    population engine the copy is a device-side slot-to-slot transfer
    (weights never leave the device); scalar workers adopt the perturbed
    hyperparameters and keep their own learner state (weights never cross
    hosts). ``frozen`` hyperparameters (structural: ``t_max``) are never
    perturbed, so a cloned trial stays in its engine bucket.

    Purely asynchronous — no barrier, no parking: the exploit decision
    uses whatever metrics have been reported for the phase so far, the
    same knowledge-DB-quantile shape as HyperTrick's WSM rule.
    """

    brackets: Dict[int, Tuple[int, ...]] = {}

    def __init__(self, space: SearchSpace, population: int, n_phases: int,
                 seed: int = 0, exploit_frac: float = 0.25,
                 top_frac: float = 0.25, min_reports: Optional[int] = None,
                 frozen: Sequence[str] = ("t_max",)):
        assert 0 < exploit_frac < 1 and 0 < top_frac <= 1
        self.space = space
        self.population = population
        self.n_trials = population               # budget, for capacity math
        self.n_phases = n_phases
        self.rng = np.random.default_rng(seed)
        self.exploit_frac = exploit_frac
        self.top_frac = top_frac
        self.min_reports = (min_reports if min_reports is not None
                            else max(2, population // 2))
        self.frozen = tuple(frozen)
        self._launched = 0
        # (trial_id, clone_from, phase) per CLONE verdict issued
        self.clone_log: List[Tuple[int, int, int]] = []

    def spawn(self) -> Optional[SpawnSpec]:
        if self._launched >= self.population:
            return None
        self._launched += 1
        return SpawnSpec(self.space.sample(self.rng))

    def on_report(self, trial_id, phase, metric, prior_reports) -> Verdict:
        if phase >= self.n_phases - 1:
            return Verdict.CONTINUE              # final phase: completes
        stats = self.db.metrics_for_phase(phase)
        if len(stats) < self.min_reports:
            return Verdict.CONTINUE
        cut = float(np.quantile(np.asarray(stats, np.float32),
                                self.exploit_frac))
        if metric > cut:
            return Verdict.CONTINUE
        parent = self._pick_parent(trial_id, phase)
        if parent is None:
            return Verdict.CONTINUE
        child = self.db.trials[trial_id]
        hp = perturb_hparams(self.space, parent.hparams, self.rng,
                             frozen=self.frozen)
        for name in self.frozen:                 # child keeps its structure
            if name in child.hparams:
                hp[name] = child.hparams[name]
        self.clone_log.append((trial_id, parent.trial_id, phase))
        return Verdict(VerdictKind.CLONE, clone_from=parent.trial_id,
                       perturb=hp)

    def note_replayed_trial(self, hparams, requeued: bool = False) -> None:
        if not requeued:
            self._launched += 1

    def _pick_parent(self, trial_id: int, phase: int):
        """A uniform draw from the top ``top_frac`` of the members that
        have reported this phase (crashed trials excluded — their learner
        state is gone)."""
        from repro_torch.core.service import TrialStatus  # scheduler<-service
        peers = [t for t in self.db.trials.values()
                 if t.trial_id != trial_id and t.phases_completed > phase
                 and t.status is not TrialStatus.CRASHED]
        if not peers:
            return None
        peers.sort(key=lambda t: -t.reports[phase][0])
        top = peers[: max(1, int(math.ceil(self.top_frac * len(peers))))]
        return top[int(self.rng.integers(len(top)))]
