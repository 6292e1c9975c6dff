"""The synthetic objective of ``repro/distributed/worker.py``, copied (numpy
only). The worker agent and its objective registry are ROADMAP queue 1
item 7c.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np


def make_synthetic_objective(sleep: float = 0.0, noise: float = 0.0,
                             seed: int = 0,
                             crash_above: Optional[float] = None) -> Callable:
    """Planted-optimum objective over hparam ``x`` (optimum at x=1), with a
    learning curve that rises with phases — cheap enough for tests and
    protocol-overhead benchmarks. ``crash_above`` makes configs with
    x > crash_above raise, to exercise the crash path."""
    rng = np.random.default_rng(seed)

    def objective(hparams, phase, state):
        x = float(hparams.get("x", 1.0))
        if crash_above is not None and x > crash_above:
            raise RuntimeError(f"synthetic crash at x={x}")
        if sleep:
            time.sleep(sleep)
        quality = -abs(math.log(x))
        metric = quality * (1 + 0.1 * phase)
        if noise:
            metric += float(rng.normal(0.0, noise))
        return metric, state

    return objective
