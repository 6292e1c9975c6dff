"""Worker completion rate alpha (paper §5.2.3, Eqs. 8-9) and the Hyperband
bracket arithmetic of Table 2."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List


def min_alpha(r: float, n_phases: int) -> float:
    """Eq. (8): min[alpha] = (1-sqrt(r)) [1-(1-r)^Np] / (r Np)."""
    return (1 - math.sqrt(r)) * (1 - (1 - r) ** n_phases) / (r * n_phases)


def expected_alpha(r: float, n_phases: int) -> float:
    """Eq. (9): E[alpha] = [1-(1-r)^Np] / (r Np). Also the exact completion
    rate of vanilla Successive Halving with the same r."""
    return (1 - (1 - r) ** n_phases) / (r * n_phases)


def solve_r_for_alpha(target_alpha: float, n_phases: int,
                      tol: float = 1e-10) -> float:
    """Invert Eq. (9) for r (paper §5.2.4: alpha=32.61%, Np=27 -> r=10.82%)."""
    lo, hi = 1e-9, 1 - 1e-9
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if expected_alpha(mid, n_phases) > target_alpha:
            lo = mid   # E[alpha] decreases in r
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Hyperband brackets
# ---------------------------------------------------------------------------
@dataclass
class Bracket:
    s: int
    n: List[int]       # configurations per SH round
    r: List[int]       # resource per configuration per round

    @property
    def alpha(self) -> float:
        """alpha_s = sum_i(n_i r_i) / (n_0 R)."""
        total = sum(ni * ri for ni, ri in zip(self.n, self.r))
        return total / (self.n[0] * self.r[-1] * 1.0) if self.n else 0.0

    @property
    def work(self) -> int:
        return sum(ni * ri for ni, ri in zip(self.n, self.r))


def hyperband_brackets(eta: int, big_r: int) -> List[Bracket]:
    """Standard Li et al. (2016) bracket construction."""
    s_max = int(math.floor(math.log(big_r, eta)))
    out = []
    for s in range(s_max, -1, -1):
        n0 = int(math.ceil((s_max + 1) / (s + 1) * eta ** s))
        r0 = big_r * eta ** (-s)
        n = [max(1, int(n0 * eta ** (-i))) for i in range(s + 1)]
        r = [int(r0 * eta ** i) for i in range(s + 1)]
        out.append(Bracket(s, n, r))
    return out


def paper_brackets() -> List[Bracket]:
    """The exact bracket table of paper Table 2 (eta=3, R=27): n0 per bracket
    {27, 9, 6, 4} — note the paper's s=2 bracket uses n0=9 where the standard
    construction gives 12; we reproduce the paper's table verbatim."""
    return [
        Bracket(3, [27, 9, 3, 1], [1, 3, 9, 27]),
        Bracket(2, [9, 3, 1], [3, 9, 27]),
        Bracket(1, [6, 2], [9, 27]),
        Bracket(0, [4], [27]),
    ]


def demotion_bracket(n0: int, eta: int, rungs: List[int],
                     n_phases: int) -> Bracket:
    """The bracket realized by the population engine's demote-bottom-1/eta
    rungs: starting from ``n0`` slots, each rung at phase index ``p`` frees
    the bottom ``n_i // eta`` and refills them with fresh configurations, so
    the *cohort* shrinks by ``n_i // eta`` per rung. ``r`` is phases-per-rung
    (phase index + 1), with the full ``n_phases`` as the final resource —
    the same (n, r) accounting as ``hyperband_brackets`` so ``.alpha``
    compares directly against Table 2."""
    n = [n0]
    for _ in rungs:
        n.append(max(1, n[-1] - n[-1] // eta))
    r = [p + 1 for p in rungs] + [n_phases]
    return Bracket(s=len(rungs), n=n, r=r)


def demotion_alpha(bracket: Bracket) -> float:
    """Expected completion rate of a *continuation* demotion bracket: the
    engine never restarts a survivor, so each round's incremental work is
    n_i (r_i - r_{i-1}) phases — unlike ``Bracket.alpha``, which uses the
    paper's restart accounting where r_i is paid in full per round."""
    work, prev = 0, 0
    for ni, ri in zip(bracket.n, bracket.r):
        work += ni * (ri - prev)
        prev = ri
    return work / (bracket.n[0] * bracket.r[-1]) if bracket.n else 0.0


def hyperband_alpha(brackets: List[Bracket]) -> float:
    """Total alpha = sum_s work_s / sum_s (n_{0,s} R)."""
    work = sum(b.work for b in brackets)
    denom = sum(b.n[0] * b.r[-1] for b in brackets)
    return work / denom
