"""ASHA — asynchronous Successive Halving (Li et al. 2018), the partial
mitigation the paper cites for SH's synchronization problem (§2). Included
as a beyond-paper baseline: like HyperTrick it never blocks, but it uses
rung-based promotion (top 1/eta of the reports at each rung so far,
continuation variant) instead of the DCM/WSM early-worker rule.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core.search_space import SearchSpace
from repro_torch.core.service import AsyncPolicy, Decision


def rung_phases(n_phases: int, eta: int) -> list:
    """Rung placement shared by ASHA and the bracket barrier's
    successive-halving mode: rungs at phase indices eta^0-1, eta^1-1, ...
    (the final phase completes unconditionally and is never a rung)."""
    return sorted({min(eta ** i, n_phases) - 1
                   for i in range(0, 1 + max(1, int(
                       math.log(max(n_phases, 1), eta)) + 1))})


def rung_demotions(n: int, eta: int) -> int:
    """How many of an ``n``-trial rung cohort are demoted: the bottom
    ``n // eta``, EXCEPT that a cohort smaller than eta carries too little
    evidence to demote anyone (ASHA's "not enough evidence" rule, made
    explicit — ``n // eta`` happens to be 0 there too, but relying on the
    floor silently was how small-cohort demotion degraded to a no-op).
    Shared by the service-side ``RungBarrier``, so single-host and
    multi-host brackets agree by construction."""
    assert eta >= 2, eta
    if n < eta:
        return 0
    return n // eta


def bottom_indices(metrics: list, k: int) -> set:
    """Indices (into ``metrics``'s order — the cohort's park order) of the
    bottom ``k`` members: ONE stable ascending argsort over float32
    metrics (matching the on-device ranking dtype), ties broken by
    position. The single ranking rule every rung scheduler shares — the
    bottom-1/eta barrier and Hyperband's keep-top-1/eta both slice it."""
    order = np.argsort(np.asarray(metrics, np.float32), kind="stable")
    return set(order[:max(0, k)].tolist())


def demote_indices(metrics: list, eta: int) -> set:
    """The members a bottom-1/eta rung barrier demotes: the bottom
    ``rung_demotions`` of the stable ranking."""
    return bottom_indices(metrics, rung_demotions(len(metrics), eta))


class ASHA(AsyncPolicy):
    def __init__(self, space: SearchSpace, n_trials: int, n_phases: int,
                 eta: int = 3, seed: int = 0, configs: Optional[list] = None):
        self.space = space
        self.n_trials = n_trials
        self.n_phases = n_phases
        self.eta = eta
        self.rng = np.random.default_rng(seed)
        self._configs = list(configs) if configs is not None else None
        self._launched = 0
        # report counts gate promotion at each rung
        self.rungs = rung_phases(n_phases, eta)

    def next_hparams(self):
        if self._launched >= self.n_trials:
            return None
        self._launched += 1
        if self._configs is not None:
            return self._configs[self._launched - 1]
        return self.space.sample(self.rng)

    def on_report(self, trial_id, phase, metric, prior_reports) -> Decision:
        if phase not in self.rungs or phase >= self.n_phases - 1:
            return Decision.CONTINUE
        stats = self.db.metrics_for_phase(phase)
        if len(stats) < self.eta:            # not enough evidence yet
            return Decision.CONTINUE
        cut = float(np.quantile(np.asarray(stats), 1.0 - 1.0 / self.eta))
        return Decision.CONTINUE if metric >= cut else Decision.STOP
