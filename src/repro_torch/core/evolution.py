"""Evolutionary HyperTrick — the extension the paper proposes in §6:
"the additional resources released by HyperTrick may be employed to further
improve the metaoptimization process, for instance ... by mixing the
hyperparameters of fast learners, or reinitializing terminated agents with
new sets of promising hyperparameters."

Same DCM/WSM eviction rule as HyperTrick; the difference is ``next_hparams``:
after a warmup fraction of fresh samples, freed nodes restart from a MUTATED
copy of a top-quartile configuration (PBT-style explore) instead of a fresh
random sample.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.hypertrick import HyperTrick
from repro_torch.core.search_space import SearchSpace, perturb_hparams


class EvolutionaryHyperTrick(HyperTrick):
    def __init__(self, space: SearchSpace, w0: int, n_phases: int,
                 eviction_rate: float, seed: int = 0,
                 warmup_frac: float = 0.5, mutate_prob: float = 0.8):
        super().__init__(space, w0, n_phases, eviction_rate, seed=seed)
        self.warmup = max(1, int(warmup_frac * w0))
        self.mutate_prob = mutate_prob

    def _mutate(self, hp: dict) -> dict:
        # the same per-parameter perturbation the PBT scheduler applies to
        # mid-flight clones — here it seeds a freed node's restart
        return perturb_hparams(self.space, hp, self.rng)

    def next_hparams(self) -> Optional[dict]:
        if self._launched >= self.w0:
            return None
        self._launched += 1
        if self._launched <= self.warmup \
                or self.rng.uniform() > self.mutate_prob:
            return self.space.sample(self.rng)
        # exploit: mutate a top-quartile configuration from the DB
        done = [t for t in self.db.trials.values() if t.reports]
        if not done:
            return self.space.sample(self.rng)
        done.sort(key=lambda t: -(t.best_metric or -math.inf))
        top = done[: max(1, len(done) // 4)]
        parent = top[int(self.rng.integers(len(top)))]
        return self._mutate(parent.hparams)
