"""Hyperparameter search spaces (paper §5.1).

The paper samples: learning rate ~ log-uniform over [1e-5, 1e-2];
t_max ~ quantized log-uniform over [2, 100] (integer step 1);
gamma ~ categorical over {0.9, 0.95, 0.99, 0.995, 0.999, 0.9995, 0.9999}.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np


class Param:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def grid(self, n: int) -> list:
        raise NotImplementedError


@dataclass(frozen=True)
class LogUniform(Param):
    lo: float
    hi: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(math.log(self.lo), math.log(self.hi))))

    def grid(self, n):
        return list(np.exp(np.linspace(math.log(self.lo), math.log(self.hi),
                                       n)))


@dataclass(frozen=True)
class QLogUniform(Param):
    """Quantized log-uniform (integers)."""
    lo: int
    hi: int
    q: int = 1

    def sample(self, rng):
        v = np.exp(rng.uniform(math.log(self.lo), math.log(self.hi)))
        return int(round(v / self.q) * self.q)

    def grid(self, n):
        vs = np.exp(np.linspace(math.log(self.lo), math.log(self.hi), n))
        return sorted({int(round(v / self.q) * self.q) for v in vs})


@dataclass(frozen=True)
class Uniform(Param):
    lo: float
    hi: float

    def sample(self, rng):
        return float(rng.uniform(self.lo, self.hi))

    def grid(self, n):
        return list(np.linspace(self.lo, self.hi, n))


@dataclass(frozen=True)
class Categorical(Param):
    values: tuple

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    def grid(self, n):
        return list(self.values)


class SearchSpace:
    def __init__(self, params: Dict[str, Param]):
        self.params = dict(params)

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        return {k: p.sample(rng) for k, p in self.params.items()}

    def sample_n(self, n: int, seed: int = 0) -> list[Dict[str, Any]]:
        rng = np.random.default_rng(seed)
        return [self.sample(rng) for _ in range(n)]


def perturb_hparams(space: SearchSpace, hparams: Dict[str, Any],
                    rng: np.random.Generator,
                    frozen: Sequence[str] = ()) -> Dict[str, Any]:
    """PBT-style explore: a mutated copy of ``hparams``, each parameter
    nudged within its own bounds/type. Continuous log-scale values scale by
    one of {0.5, 0.8, 1.25, 2.0}; categoricals step to a neighbour; uniform
    values jitter by 20% of the range. ``frozen`` names are copied through
    untouched — the population engine freezes *structural* hyperparameters
    (``t_max``) so a perturbed trial never has to migrate buckets. Shared
    by ``EvolutionaryHyperTrick`` (restart-time mutation) and
    ``PBTScheduler`` (mid-flight clone+perturb)."""
    out = dict(hparams)
    for name, param in space.params.items():
        if name in frozen or name not in out:
            continue
        v = out[name]
        if isinstance(param, LogUniform):
            out[name] = float(np.clip(
                v * rng.choice([0.5, 0.8, 1.25, 2.0]), param.lo, param.hi))
        elif isinstance(param, QLogUniform):
            out[name] = int(np.clip(
                round(v * rng.choice([0.5, 0.8, 1.25, 2.0])),
                param.lo, param.hi))
        elif isinstance(param, Categorical):
            vals = list(param.values)
            i = vals.index(v) if v in vals else 0
            j = int(np.clip(i + rng.choice([-1, 0, 1]), 0, len(vals) - 1))
            out[name] = vals[j]
        elif isinstance(param, Uniform):
            span = 0.2 * (param.hi - param.lo)
            out[name] = float(np.clip(v + rng.uniform(-span, span),
                                      param.lo, param.hi))
    return out


def paper_rl_space() -> SearchSpace:
    """The exact space of paper §5.1."""
    return SearchSpace({
        "learning_rate": LogUniform(1e-5, 1e-2),
        "t_max": QLogUniform(2, 100, 1),
        "gamma": Categorical((0.9, 0.95, 0.99, 0.995, 0.999, 0.9995, 0.9999)),
    })


def lm_space() -> SearchSpace:
    """Metaoptimizing the LM objectives from the architecture zoo: the
    hyperparameters deliberately include cost-affecting ones (microbatch),
    the regime where HyperTrick beats synchronized Successive Halving."""
    return SearchSpace({
        "learning_rate": LogUniform(1e-5, 1e-2),
        "loss_chunk": Categorical((256, 512, 1024)),
        "grad_clip": Categorical((0.5, 1.0, 2.0)),
        "warmup_steps": QLogUniform(1, 50, 1),
    })
