"""HyperTrick (paper §3.2, Algorithm 1).

Each trial runs N_p phases. Per phase p the policy starts in Data Collection
Mode: the first W_p^DCM = W0 (1-sqrt(r)) (1-r)^p reporters continue
unconditionally. After that it is in Worker Selection Mode: a reporter whose
metric falls in the lower sqrt(r) quantile of the metrics reported for that
phase is terminated. Under a stationary metric process this yields
E[W_p] = W0 (1-r)^p (Eq. 1; proof by induction in the paper — mirrored by a
hypothesis test in tests/test_hypertrick_math.py).

No synchronization, no preemption: a worker that is stopped frees its node,
which immediately acquires a fresh configuration.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.search_space import SearchSpace
from repro_torch.core.service import AsyncPolicy, Decision


def expected_workers(w0: int, r: float, p: int) -> float:
    """Eq. (1): E[W_p] = W0 (1-r)^p."""
    return w0 * (1 - r) ** p


def dcm_threshold(w0: int, r: float, p: int) -> float:
    """Eq. (2): W_p^DCM = W0 (1-sqrt(r)) (1-r)^p."""
    return w0 * (1 - math.sqrt(r)) * (1 - r) ** p


class BudgetedPolicy(AsyncPolicy):
    """Shared accounting for policies that launch a fixed number of
    configurations tracked in ``_launched``."""

    _launched: int = 0

    def note_replayed_trial(self, hparams, requeued: bool = False):
        if not requeued:
            self._launched += 1


class HyperTrick(BudgetedPolicy):
    def __init__(self, space: SearchSpace, w0: int, n_phases: int,
                 eviction_rate: float, seed: int = 0,
                 configs: Optional[list] = None):
        """configs: optional pre-drawn configurations (e.g. to compare against
        Hyperband on the *same* 46 configurations, paper §5.2.4)."""
        assert 0 < eviction_rate < 1
        self.space = space
        self.w0 = w0
        self.n_phases = n_phases
        self.r = eviction_rate
        self.rng = np.random.default_rng(seed)
        self._configs = list(configs) if configs is not None else None
        if self._configs is not None:
            assert len(self._configs) == w0
        self._launched = 0

    # -- parallel-search part: W0 total configurations ---------------------
    def next_hparams(self) -> Optional[Dict[str, Any]]:
        if self._launched >= self.w0:
            return None
        self._launched += 1
        if self._configs is not None:
            return self._configs[self._launched - 1]
        return self.space.sample(self.rng)

    # -- the HyperTrick rule ------------------------------------------------
    def on_report(self, trial_id: int, phase: int, metric: float,
                  prior_reports: int) -> Decision:
        if prior_reports < dcm_threshold(self.w0, self.r, phase):
            return Decision.CONTINUE          # Data Collection Mode
        # Worker Selection Mode: lower sqrt(r) quantile of this phase's stats
        stats = self.db.metrics_for_phase(phase)
        cut = float(np.quantile(np.asarray(stats), math.sqrt(self.r)))
        return Decision.STOP if metric < cut else Decision.CONTINUE


class RandomSearchPolicy(BudgetedPolicy):
    """Parallel random search, no early stopping (alpha = 100%)."""

    def __init__(self, space: SearchSpace, n_trials: int, n_phases: int,
                 seed: int = 0, configs: Optional[list] = None):
        self.space = space
        self.n_trials = n_trials
        self.n_phases = n_phases
        self.rng = np.random.default_rng(seed)
        self._configs = list(configs) if configs is not None else None
        if self._configs is not None:
            assert len(self._configs) == n_trials, (
                f"got {len(self._configs)} configs for {n_trials} trials — "
                "same-configs comparisons (§5.2.4) require exactly one "
                "config per trial")
        self._launched = 0

    def next_hparams(self):
        if self._launched >= self.n_trials:
            return None
        self._launched += 1
        if self._configs is not None:
            return self._configs[self._launched - 1]
        return self.space.sample(self.rng)

    def on_report(self, trial_id, phase, metric, prior_reports) -> Decision:
        return Decision.CONTINUE
