"""The paper's cluster simulator, port against reference on the CPU:
``simulate_hypertrick``, ``simulate_successive_halving`` (dynamic and
static), ``simulate_grid`` and ``simulate_hyperband`` (``core/simulator.py``)
at the reference tests' arguments (tests/test_core_service.py:53-124), each
package with its own workloads, policy and ``OptimizationService``.

The simulator is numpy and the standard library: both packages run the same
float64 operations in the same order from the same seeds (a workload's own
generator drawn the first time a worker is seen, one ``seed + 999``
generator for costs and metrics, one heap with a ``seqno`` tie-break). So
the tolerance is exact: every ``TimelineEntry`` field, ``summary()``,
``best_curve()``, ``completion_rate`` and, for HyperTrick, every trial's
status, reports and best metric in the service it drove are equal. Below,
the reference's six invariant tests run on the port alone.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.core import completion as ref_completion
from repro.core import search_space as ref_space
from repro.core import simulator as ref_simulator
from repro_torch.core import completion, search_space, simulator
from repro_torch.core.completion import (expected_alpha, hyperband_alpha, paper_brackets,
                                         solve_r_for_alpha)
from repro_torch.core.search_space import paper_rl_space
from repro_torch.core.simulator import (GA3CWorkload, ToyWorkload, simulate_grid,
                                        simulate_hyperband, simulate_hypertrick,
                                        simulate_successive_halving)

REF = types.SimpleNamespace(sim=ref_simulator, space=ref_space, completion=ref_completion)
PORT = types.SimpleNamespace(sim=simulator, space=search_space, completion=completion)


def _cfgs(n):
    return [{"id": i} for i in range(n)]


# name -> run(pkg, seed): each simulator at the arguments of the reference's
# tests (test_grid_alpha_100, test_sh_completion_matches_eq9,
# test_hypertrick_sim_runs_all_configs, test_static_sh_not_faster_than_dynamic,
# test_grid_slowest_on_average, test_hypertrick_beats_hyperband_in_paper_regime)
def _grid_12(p, seed):
    return p.sim.simulate_grid(p.sim.ToyWorkload(seed), _cfgs(12), 4, 3, seed=seed)


def _sh_64(p, seed):
    return p.sim.simulate_successive_halving(p.sim.ToyWorkload(seed), _cfgs(64), 8, 4, 0.25,
                                             seed=seed)


def _ht_16(p, seed):
    return p.sim.simulate_hypertrick(p.sim.ToyWorkload(seed), _cfgs(16), 6, 4, 0.25, seed=seed)


def _sh_16(static):
    def run(p, seed):
        return p.sim.simulate_successive_halving(
            p.sim.ToyWorkload(seed, cost_spread=0.6), _cfgs(16), 6, 4, 0.25, seed=seed,
            static=static)
    return run


def _grid_16(p, seed):
    return p.sim.simulate_grid(p.sim.ToyWorkload(seed), _cfgs(16), 6, 4, seed=seed)


def _table3(p, seed):
    return p.space.paper_rl_space().sample_n(46, seed=seed)


def _hyperband_46(p, seed):
    return p.sim.simulate_hyperband(p.sim.GA3CWorkload(seed=seed), _table3(p, seed),
                                    p.completion.paper_brackets(), n_nodes=46, seed=seed)


def _ht_46(p, seed):
    c = p.completion
    r = c.solve_r_for_alpha(c.hyperband_alpha(c.paper_brackets()), 27)
    return p.sim.simulate_hypertrick(p.sim.GA3CWorkload(seed=seed), _table3(p, seed), 46, 27,
                                     r, seed=seed)


RUNS = {"grid_12": (_grid_12, [0]), "sh_dynamic_64": (_sh_64, [3]),
        "sh_dynamic_16": (_sh_16(False), range(8)), "sh_static_16": (_sh_16(True), range(8)),
        "grid_16": (_grid_16, range(8)), "hypertrick_16": (_ht_16, range(8)),
        "hyperband_46": (_hyperband_46, range(5)), "hypertrick_46": (_ht_46, range(5))}
CASES = [(name, seed) for name, (_, seeds) in RUNS.items() for seed in seeds]


def _trials(db):
    return {tid: (r.status.value, r.hparams, list(r.reports), r.best_metric, r.requeued,
                  r.start_time, r.end_time)
            for tid, r in db.trials.items()}


def _same_result(ours, ref):
    assert [dataclasses.astuple(e) for e in ours.timeline] == [
        dataclasses.astuple(e) for e in ref.timeline]
    for f in dataclasses.fields(ref):
        if f.name != "timeline":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.summary() == ref.summary()
    assert ours.best_curve() == ref.best_curve()
    assert ours.completion_rate == ref.completion_rate
    assert ours.occupancy == ref.occupancy
    assert hasattr(ours, "db") == hasattr(ref, "db")
    if hasattr(ref, "db"):
        assert _trials(ours.db) == _trials(ref.db)
        assert ours.db.summary() == ref.db.summary()


@pytest.mark.parametrize("name,seed", CASES, ids=[f"{n}-seed{s}" for n, s in CASES])
def test_simulator_equals_the_reference(name, seed):
    run = RUNS[name][0]
    ours, ref = run(PORT, seed), run(REF, seed)
    assert ours.timeline, "an empty timeline compares nothing"
    _same_result(ours, ref)


@pytest.mark.parametrize("seed", range(5))
def test_table3_configurations_are_the_reference_draws(seed):
    assert _table3(PORT, seed) == _table3(REF, seed)
    assert [(b.n, b.r) for b in paper_brackets()] == [
        (b.n, b.r) for b in ref_completion.paper_brackets()]


@pytest.mark.parametrize("workload", ["toy", "ga3c"])
def test_workloads_draw_as_the_reference(workload):
    """The duck-typed workloads the trace and the simulator share: the same
    costs and metrics from the same generators, in the same call order."""
    cfgs = _table3(PORT, 0)
    make = {"toy": lambda p: p.sim.ToyWorkload(5, cost_spread=0.4),
            "ga3c": lambda p: p.sim.GA3CWorkload(seed=2, noise=3.0)}[workload]
    out = {}
    for name, p in (("port", PORT), ("ref", REF)):
        wl, rng = make(p), np.random.default_rng(7)
        out[name] = [(wl.unit_cost(w, cfgs[w], rng), wl.metric_at(w, cfgs[w], ph + 1.5, rng))
                     for ph in range(3) for w in (3, 0, 3, 11, 45)]
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# the reference's simulator invariants (tests/test_core_service.py:53-124),
# on the port alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["grid", "sh_dynamic", "sh_static", "hypertrick"])
def test_occupancy_at_most_one(policy):
    run = {"grid": lambda: simulate_grid(ToyWorkload(0), _cfgs(12), 4, 3, seed=0),
           "sh_dynamic": lambda: simulate_successive_halving(ToyWorkload(0), _cfgs(12), 4, 3,
                                                             0.25, seed=0),
           "sh_static": lambda: simulate_successive_halving(ToyWorkload(0), _cfgs(12), 4, 3,
                                                            0.25, seed=0, static=True),
           "hypertrick": lambda: simulate_hypertrick(ToyWorkload(0), _cfgs(12), 4, 3, 0.25,
                                                     seed=0)}[policy]
    r = run()
    assert r.name == policy
    assert 0 < r.occupancy <= 1.0 + 1e-9


def test_grid_alpha_100():
    r = simulate_grid(ToyWorkload(0), _cfgs(12), 4, 3, seed=0)
    assert r.completion_rate == pytest.approx(1.0)
    assert r.occupancy <= 1.0 + 1e-9


def test_sh_completion_matches_eq9():
    r = simulate_successive_halving(ToyWorkload(3), _cfgs(64), 8, 4, 0.25, seed=3)
    assert r.completion_rate == pytest.approx(expected_alpha(0.25, 4), rel=0.06)


def test_hypertrick_sim_runs_all_configs():
    res = simulate_hypertrick(ToyWorkload(1), _cfgs(16), 6, 4, 0.25, seed=1)
    assert {e.worker for e in res.timeline} == set(range(16))
    assert res.makespan > 0 and 0 < res.occupancy <= 1
    assert len(res.db.trials) == 16


def test_static_sh_not_faster_than_dynamic():
    mk_s, mk_d = [], []
    for seed in range(8):
        mk_d.append(_sh_16(False)(PORT, seed).makespan)
        mk_s.append(_sh_16(True)(PORT, seed).makespan)
    assert np.mean(mk_s) >= np.mean(mk_d)


def test_grid_slowest_on_average():
    mk_g = [_grid_16(PORT, seed).makespan for seed in range(8)]
    mk_h = [_ht_16(PORT, seed).makespan for seed in range(8)]
    assert np.mean(mk_g) > np.mean(mk_h)


def test_hypertrick_beats_hyperband_in_paper_regime():
    """Table 3 regime: same 46 configs, hyperparameter-dependent costs."""
    brackets = paper_brackets()
    r = solve_r_for_alpha(hyperband_alpha(brackets), 27)
    space = paper_rl_space()
    mk_ht, mk_hb, oc_ht, oc_hb = [], [], [], []
    for seed in range(5):
        cfgs = space.sample_n(46, seed=seed)
        wl = GA3CWorkload(seed=seed)
        hb = simulate_hyperband(wl, cfgs, brackets, n_nodes=46, seed=seed)
        ht = simulate_hypertrick(wl, cfgs, 46, 27, r, seed=seed)
        mk_ht.append(ht.makespan)
        mk_hb.append(hb.makespan)
        oc_ht.append(ht.occupancy)
        oc_hb.append(hb.occupancy)
    assert np.mean(mk_ht) < np.mean(mk_hb)
    assert np.mean(oc_ht) > np.mean(oc_hb)
