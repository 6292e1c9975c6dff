"""The paper's baselines, port against reference on the CPU: ``SyncCluster``'s
synchronous Successive Halving (``core/executor.py``) and
``EvolutionaryHyperTrick`` (``core/evolution.py``).

Both are numpy copies of the reference's (only the imports changed), so the
same configurations and objective give the same records, statuses and
summaries: survivors counted with Python's ``round`` (a half rounds to the
even neighbour), ranked by a stable sort (tied metrics keep their order),
and a parent ranked by ``best_metric or -inf`` (a best metric of exactly
0.0 ranks last). The reference's own tests of both run here on the port;
the yi-9b LM objective holds ``run_sh`` against the reference's within the
Trainer's limit, and on the port alone ``run_sh`` trains each (configuration,
phase) as ``ThreadCluster`` does, which is what the card's smoke holds.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import evolution as ref_evolution  # noqa: E402
from repro.core import executor as ref_executor  # noqa: E402
from repro.core import hypertrick as ref_hypertrick  # noqa: E402
from repro.core import search_space as ref_space  # noqa: E402
from repro.core import service as ref_service  # noqa: E402
from repro_torch.core import evolution, executor, hypertrick, search_space, service  # noqa: E402
from repro_torch.core.evolution import EvolutionaryHyperTrick  # noqa: E402
from repro_torch.core.executor import SyncCluster, ThreadCluster  # noqa: E402
from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy  # noqa: E402
from repro_torch.core.scheduler import PolicyScheduler, VerdictKind  # noqa: E402
from repro_torch.core.search_space import (Categorical, LogUniform, QLogUniform,  # noqa: E402
                                           SearchSpace, lm_space, paper_rl_space)
from repro_torch.core.service import Decision, OptimizationService, TrialStatus  # noqa: E402

# the Trainer's losses (AdamW, reduced models): tests/test_torch_train.py
TRAINER_LOSS_ATOL = 1e-4

REF = types.SimpleNamespace(space=ref_space, ht=ref_hypertrick, evo=ref_evolution,
                            service=ref_service, executor=ref_executor)
PORT = types.SimpleNamespace(space=search_space, ht=hypertrick, evo=evolution,
                             service=service, executor=executor)

SPACE = SearchSpace({"lr": LogUniform(1e-5, 1e-1),
                     "t": QLogUniform(2, 64, 1),
                     "g": Categorical((0.9, 0.99, 0.999))})


def _x_space(pkg):
    return pkg.space.SearchSpace({"x": pkg.space.LogUniform(0.01, 100.0)})


def _sh_objective(hp, phase, state):
    # tests/test_executor.py's objective
    return -abs(np.log(hp["x"])) * (1 + 0.1 * phase), state


def _tied_objective(hp, phase, state):
    # two values only: most ranks are decided by the stable sort
    return float(int(hp["x"] * 7 + phase) % 2), state


def _stateful_objective(hp, phase, state):
    # carries a running sum across phases, as a live trainer does
    state = (state or 0.0) + math.sin(3.0 * hp["x"]) + 0.05 * phase
    return state, state


def _evo_objective(hp, phase, state):
    # tests/test_extensions.py's objective
    q = -abs(np.log10(hp["lr"]) - np.log10(1e-3))
    return q * (1 + 0.2 * phase), state


def _zero_objective(hp, phase, state):
    # metrics of exactly 0.0 for the best half of the learning rates: ranked
    # as -inf by ``best_metric or -math.inf``
    q = -abs(np.log10(hp["lr"]) - np.log10(1e-3))
    return (0.0 if q > -1.0 else q * (1 + 0.2 * phase)), state


def _sh_run(pkg, objective, n_configs, n_phases, evict, n_nodes, seed=0):
    configs = _x_space(pkg).sample_n(n_configs, seed=seed)
    res = pkg.executor.SyncCluster(n_nodes, objective).run_sh(configs, n_phases, evict)
    return (res, *_sh_facts(res))


def _sh_facts(res):
    records = [(r.trial_id, r.node, r.phase, r.metric) for r in res.records]
    trials = {t.trial_id: (t.hparams, t.status.value, t.node, [m for m, _ in t.reports])
              for t in res.service.db.trials.values()}
    summary = {k: v for k, v in res.summary().items() if k not in ("wall_time", "occupancy")}
    return records, trials, summary


def _survivors(n, n_phases, evict):
    """Trials run at each phase under Python's round, as ``run_sh`` counts."""
    out = []
    for _ in range(n_phases):
        out.append(n)
        n = max(1, n - int(round(evict * n)))
    return out


# ---------------------------------------------------------------------------
# the reference's tests of SyncCluster and EvolutionaryHyperTrick, on the port
# ---------------------------------------------------------------------------
def test_sync_cluster_eviction_counts():
    cluster = SyncCluster(4, _sh_objective)
    configs = [{"x": float(x)} for x in np.logspace(-1.5, 1.5, 8)]
    res = cluster.run_sh(configs, n_phases=3, evict_frac=0.5)
    db = res.service.db
    assert len(db.trials) == 8
    # survivors per phase: 8 -> 4 -> 2 -> keep max(1, 2-1) = 1
    assert len(res.records) == 8 + 4 + 2
    by_status = db.summary()["by_status"]
    assert by_status == {"killed": 7, "completed": 1}
    # the survivor is the planted optimum's nearest config
    best = db.best_trial()
    assert best.status is TrialStatus.COMPLETED
    assert abs(np.log(best.hparams["x"])) == min(
        abs(np.log(c["x"])) for c in configs)


def test_warmup_spawns_are_fresh_samples():
    """The first ``warmup`` configurations are independent draws — the
    exploit path must not engage before any evidence exists."""
    policy = EvolutionaryHyperTrick(SPACE, w0=8, n_phases=2,
                                    eviction_rate=0.25, seed=0,
                                    warmup_frac=0.5, mutate_prob=1.0)
    twin = np.random.default_rng(0)
    svc = OptimizationService(policy)
    assert isinstance(svc.scheduler, PolicyScheduler)
    for _ in range(policy.warmup):
        rec = svc.acquire_trial()
        assert rec.hparams == SPACE.sample(twin)  # same seed, same draws


def test_post_warmup_spawns_mutate_a_top_quartile_parent():
    """After warmup (mutate_prob=1) every spawn derives from a top-quartile
    reported trial: each hyperparameter is within one mutation step of the
    parent's value."""
    policy = EvolutionaryHyperTrick(SPACE, w0=9, n_phases=2,
                                    eviction_rate=0.25, seed=3,
                                    warmup_frac=1 / 3, mutate_prob=1.0)
    svc = OptimizationService(policy)
    warm = [svc.acquire_trial() for _ in range(policy.warmup)]
    for i, rec in enumerate(warm):
        assert svc.report(rec.trial_id, 0, float(i)) is Decision.CONTINUE
    # top quartile of 3 reported trials = max(1, 3 // 4) = the single best
    parent = warm[-1]
    child = svc.acquire_trial()
    assert child.hparams["lr"] / parent.hparams["lr"] in \
        (0.5, 0.8, 1.0, 1.25, 2.0) or child.hparams["lr"] in (1e-5, 1e-1)
    gs = list(SPACE.params["g"].values)
    assert abs(gs.index(child.hparams["g"]) - gs.index(parent.hparams["g"])) \
        <= 1
    assert 2 <= child.hparams["t"] <= 64


def test_budget_and_eviction_through_the_verdict_pipeline():
    """The full lifecycle over the service: w0 spawns total (mutants
    included), DCM/WSM evictions arrive as STOP verdicts, and the budget
    exhausts to None."""
    policy = EvolutionaryHyperTrick(SPACE, w0=12, n_phases=3,
                                    eviction_rate=0.4, seed=1,
                                    warmup_frac=0.5, mutate_prob=0.8)
    svc = OptimizationService(policy)
    rng = np.random.default_rng(7)
    live, spawned, kinds = [], 0, set()
    while True:
        rec = svc.acquire_trial()
        if rec is None:
            break
        spawned += 1
        metric = float(rng.normal())
        for phase in range(policy.n_phases):
            v = svc.report_verdict(rec.trial_id, phase, metric)
            kinds.add(v.kind)
            if v.kind is VerdictKind.STOP:
                break
        live.append(rec)
    assert spawned == 12 and svc.acquire_trial() is None
    statuses = [t.status for t in svc.db.trials.values()]
    assert statuses.count(TrialStatus.KILLED) > 0      # WSM evicted some
    assert statuses.count(TrialStatus.COMPLETED) > 0   # others finished
    assert TrialStatus.RUNNING not in statuses
    assert kinds <= {VerdictKind.CONTINUE, VerdictKind.STOP}


def test_mutation_falls_back_to_fresh_sample_without_reports():
    """Post-warmup with an empty knowledge DB (nothing reported yet) the
    exploit path degrades to fresh sampling instead of crashing."""
    policy = EvolutionaryHyperTrick(SPACE, w0=4, n_phases=2,
                                    eviction_rate=0.25, seed=5,
                                    warmup_frac=0.25, mutate_prob=1.0)
    svc = OptimizationService(policy)
    recs = [svc.acquire_trial() for _ in range(4)]    # nobody reported
    assert all(r is not None for r in recs)
    for r in recs:
        for k, p in SPACE.params.items():
            v = r.hparams[k]
            assert (v in p.values) if isinstance(p, Categorical) \
                else p.lo <= v <= p.hi


def test_evolutionary_hypertrick_exploits_parents():
    policy = EvolutionaryHyperTrick(SPACE, w0=30, n_phases=3,
                                    eviction_rate=0.25, seed=0,
                                    warmup_frac=0.4, mutate_prob=1.0)
    res = ThreadCluster(3, _evo_objective).run(policy)
    s = res.summary()
    assert s["n_trials"] == 30
    # post-warmup samples cluster around good lr: the mean |log lr - (-3)|
    # of the last third of launched trials beats the first third's
    trials = sorted(res.service.db.trials.values(), key=lambda t: t.trial_id)
    d = [abs(np.log10(t.hparams["lr"]) + 3) for t in trials]
    third = len(d) // 3
    assert np.mean(d[-third:]) < np.mean(d[:third]) + 1e-9


def test_evolution_mutation_respects_bounds():
    policy = EvolutionaryHyperTrick(SPACE, w0=5, n_phases=2,
                                    eviction_rate=0.25, seed=1)
    hp = {"lr": 1e-5, "t": 2, "g": 0.9}
    for _ in range(50):
        m = policy._mutate(hp)
        assert 1e-5 <= m["lr"] <= 1e-1
        assert 2 <= m["t"] <= 64 and isinstance(m["t"], int)
        assert m["g"] in (0.9, 0.99, 0.999)
        hp = m


# ---------------------------------------------------------------------------
# SyncCluster against the reference's
# ---------------------------------------------------------------------------
SH_CASES = [(6, 0.25), (10, 0.25), (14, 0.25), (3, 0.5), (5, 0.5), (7, 0.0)]


@pytest.mark.parametrize("n_nodes", [1, 2, 4])
@pytest.mark.parametrize("n_configs,evict", SH_CASES)
def test_sync_cluster_matches_reference(n_configs, evict, n_nodes):
    """Records (trial, node, phase, metric) in order, each trial's
    hyperparameters, status, node and reports, and the summary but for the
    clocks; the trials a phase ran follow Python's round."""
    n_phases = 4
    res, *ours = _sh_run(PORT, _sh_objective, n_configs, n_phases, evict, n_nodes)
    _, *ref = _sh_run(REF, _sh_objective, n_configs, n_phases, evict, n_nodes)
    assert ours == ref
    per_phase = [sum(r.phase == p for r in res.records) for p in range(n_phases)]
    assert per_phase == _survivors(n_configs, n_phases, evict)
    assert all(r.node == i % n_nodes for p in range(n_phases)
               for i, r in enumerate(x for x in res.records if x.phase == p))
    assert res.n_nodes == n_nodes and 0.0 < res.occupancy <= 1.0 + 1e-9


@pytest.mark.parametrize("objective", [_tied_objective, _stateful_objective],
                         ids=["tied", "stateful"])
@pytest.mark.parametrize("n_nodes", [1, 3])
def test_sync_cluster_tied_and_stateful_metrics_match_reference(objective, n_nodes):
    res, *ours = _sh_run(PORT, objective, 11, 4, 0.3, n_nodes, seed=5)
    _, *ref = _sh_run(REF, objective, 11, 4, 0.3, n_nodes, seed=5)
    assert ours == ref
    if objective is _tied_objective:
        # ties are common, so the stable sort decided some ranks
        phase0 = [r.metric for r in res.records if r.phase == 0]
        assert len(set(phase0)) < len(phase0)


def test_sync_cluster_keeps_the_first_survivors_on_a_tie():
    """Every metric equal: the stable sort keeps each phase's first
    ``keep`` survivors in their order (a quicksort ranking would not);
    10, 8 and 6 survivors at 0.25 keep 8, 6 and 4 (round(2.5) == 2,
    round(1.5) == 2)."""
    configs = [{"x": float(i)} for i in range(10)]
    res = SyncCluster(2, lambda hp, phase, st: (0.0, st)).run_sh(configs, 3, 0.25)
    assert [[r.trial_id for r in res.records if r.phase == p] for p in range(3)] == [
        list(range(10)), list(range(8)), list(range(6))]
    assert {i: t.status.value for i, t in res.service.db.trials.items()} == {
        **{i: "completed" for i in range(4)}, **{i: "killed" for i in range(4, 10)}}


@pytest.mark.parametrize("n_phases,per_phase,by_status,alpha", [
    (5, [12, 9, 7, 5, 4], {"killed": 9, "completed": 3}, 0.6167),
    (3, [12, 9, 7], {"killed": 7, "completed": 5}, 0.7778)])
def test_sync_cluster_smoke_counts_match_reference(n_phases, per_phase, by_status, alpha):
    """12 configurations at evict 0.25 over 5 and 3 phases: the counts the
    card's smoke holds in its Successive Halving runs."""
    for pkg in (PORT, REF):
        res, records, trials, summary = _sh_run(pkg, _sh_objective, 12, n_phases, 0.25, 4)
        assert [sum(r[2] == p for r in records) for p in range(n_phases)] == per_phase
        assert summary["by_status"] == by_status and summary["alpha"] == alpha
        assert len(records) == sum(per_phase)


def test_sync_cluster_raises_as_the_reference_does():
    """No crash isolation in ``run_sh``: an objective's exception leaves
    it, of the same type in both packages."""
    def objective(hp, phase, state):
        if phase == 1 and hp["x"] > 1.0:
            raise FloatingPointError("a trial fails at phase 1")
        return -abs(np.log(hp["x"])), state

    configs = [{"x": 0.5}, {"x": 2.0}, {"x": 0.9}, {"x": 3.0}]
    raised = []
    for pkg in (PORT, REF):
        with pytest.raises(Exception) as info:
            pkg.executor.SyncCluster(2, objective).run_sh(configs, 3, 0.0)
        raised.append(type(info.value))
    assert raised == [FloatingPointError, FloatingPointError]


# ---------------------------------------------------------------------------
# EvolutionaryHyperTrick against the reference's
# ---------------------------------------------------------------------------
def _evo_run(pkg, objective, seed, warmup_frac, mutate_prob, w0=16):
    space = pkg.space.SearchSpace({"lr": pkg.space.LogUniform(1e-5, 1e-1),
                                   "t": pkg.space.QLogUniform(2, 64, 1),
                                   "g": pkg.space.Categorical((0.9, 0.99, 0.999))})
    policy = pkg.evo.EvolutionaryHyperTrick(space, w0, 3, 0.25, seed=seed,
                                            warmup_frac=warmup_frac, mutate_prob=mutate_prob)
    parents = []
    mutate = policy._mutate

    def recording(hp):
        parents.append(dict(hp))
        return mutate(hp)

    policy._mutate = recording
    res = pkg.executor.ThreadCluster(1, objective).run(policy)
    records, trials, summary = _sh_facts(res)
    return res, parents, records, trials, summary


@pytest.mark.parametrize("objective", [_evo_objective, _zero_objective], ids=["plain", "zeros"])
@pytest.mark.parametrize("mutate_prob", [0.5, 1.0])
@pytest.mark.parametrize("warmup_frac", [0.25, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evolution_matches_reference(seed, warmup_frac, mutate_prob, objective):
    """ThreadCluster(1): the same hyperparameters, parents, statuses, reports
    and summary but for the clocks."""
    _, *ours = _evo_run(PORT, objective, seed, warmup_frac, mutate_prob)
    _, *ref = _evo_run(REF, objective, seed, warmup_frac, mutate_prob)
    assert ours == ref
    parents = ours[0]
    if mutate_prob == 1.0:
        assert parents, "no child was mutated"


def test_evolution_ranks_a_zero_best_metric_last():
    """``-(t.best_metric or -math.inf)``: a trial whose best metric is
    exactly 0.0 sorts behind one at -1.0, so the -1.0 trial is the parent."""
    for pkg in (PORT, REF):
        space = pkg.space.SearchSpace({"lr": pkg.space.LogUniform(1e-5, 1e-1)})
        policy = pkg.evo.EvolutionaryHyperTrick(space, 3, 2, 0.25, seed=0,
                                                warmup_frac=2 / 3, mutate_prob=1.0)
        svc = pkg.service.OptimizationService(policy)
        zero, low = svc.acquire_trial(), svc.acquire_trial()
        svc.report(zero.trial_id, 0, 0.0)
        svc.report(low.trial_id, 0, -1.0)
        seen = []
        mutate = policy._mutate
        policy._mutate = lambda hp: seen.append(hp) or mutate(hp)
        assert svc.acquire_trial() is not None
        assert seen == [low.hparams]


@pytest.mark.parametrize("space", [lm_space, paper_rl_space], ids=["lm", "rl"])
def test_evolution_warmup_draws_are_hypertricks(space):
    """At the smoke's settings (w0 12, warmup 6) the first 6 configurations
    equal HyperTrick's at the same seed: ``rng.uniform()`` is drawn only
    after the warmup."""
    evo = OptimizationService(EvolutionaryHyperTrick(space(), 12, 3, 0.25, seed=0))
    ht = OptimizationService(HyperTrick(space(), 12, 3, 0.25, seed=0))
    assert evo.policy.warmup == 6
    assert [evo.acquire_trial().hparams for _ in range(6)] == [
        ht.acquire_trial().hparams for _ in range(6)]


# ---------------------------------------------------------------------------
# the slice as a whole: Successive Halving over real trials
# ---------------------------------------------------------------------------
def test_sync_cluster_lm_matches_reference(monkeypatch):
    """SyncCluster(2) over the yi-9b reduced LM objective at 3 steps a
    phase, batch 2 x 16: 4 configurations of lm_space, 2 phases, evict 0.5;
    every port trial starts from the reference trial's seed-0 weights."""
    import jax
    from repro.configs.registry import get_config as ref_get_config
    from repro.train import trainer as ref_trainer
    from repro_torch.configs.registry import get_config
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train import trainer as port_trainer

    arch, kw = "yi-9b", dict(steps_per_phase=3, batch=2, seq=16)
    configs = lm_space().sample_n(4, seed=0)
    assert configs == ref_space.lm_space().sample_n(4, seed=0)

    def run(pkg, objective):
        return pkg.executor.SyncCluster(2, objective).run_sh(configs, 2, 0.5)

    ref = run(REF, ref_trainer.make_lm_objective(arch, **kw))
    jcfg = ref_get_config(arch).reduced()
    weights = jax.tree.map(np.asarray, ref_trainer.Trainer(
        jcfg, ref_trainer.TrainConfig(), kw["batch"], kw["seq"], seed=0).params)
    cfg = get_config(arch).reduced()

    class FromReference(port_trainer.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.params = params_from_numpy(weights, cfg, device="cpu")
            self.opt_state = init_opt_state(self.tc, self.params)

    monkeypatch.setattr(port_trainer, "Trainer", FromReference)
    ours = run(PORT, port_trainer.make_lm_objective(arch, device="cpu", **kw))

    def trials(res):
        return {t.trial_id: (t.hparams, t.node, len(t.reports))
                for t in res.service.db.trials.values()}

    assert trials(ours) == trials(ref)
    assert [(r.trial_id, r.node, r.phase) for r in ours.records] == [
        (r.trial_id, r.node, r.phase) for r in ref.records] and len(ours.records) == 6
    for o, r in zip(ours.records, ref.records):
        np.testing.assert_allclose(o.metric, r.metric, atol=TRAINER_LOSS_ATOL,
                                   err_msg=(o.trial_id, o.phase))
        assert math.isfinite(o.metric)
    # the survivors are the reference's: at these fixed configurations no two
    # metrics of one phase lie within the limit of each other, so the metrics'
    # tolerance cannot reorder the barrier's ranking
    gap = min(abs(a.metric - b.metric) for a in ref.records for b in ref.records
              if a.phase == b.phase and a.trial_id != b.trial_id)
    assert gap > 2 * TRAINER_LOSS_ATOL, gap
    assert {i: t.status for i, t in ours.service.db.trials.items()} == {
        i: TrialStatus(t.status.value) for i, t in ref.service.db.trials.items()}


def _objective(kind):
    from repro_torch.rl.ga3c import make_rl_objective
    from repro_torch.train.trainer import make_lm_objective
    if kind == "rl":
        return make_rl_objective("pong", 2, n_envs=2, seed=0, max_updates=64, device="cpu")
    return make_lm_objective("yi-9b", steps_per_phase=2, batch=2, seq=16, seed=0,
                             device="cpu")


@pytest.mark.parametrize("kind", ["rl", "lm"])
def test_sync_cluster_trains_as_the_thread_cluster_does(kind):
    """Port against port: every (configuration, phase) that ``run_sh`` on 2
    nodes trained has the metric ``ThreadCluster`` gives it on the same
    configurations (a random search, which stops no trial): a trial's
    numbers depend on its hyperparameters alone."""
    space = paper_rl_space() if kind == "rl" else lm_space()
    configs = space.sample_n(4, seed=0)
    sh = SyncCluster(2, _objective(kind)).run_sh(configs, 2, 0.5)
    policy = RandomSearchPolicy(SearchSpace({}), 4, 2, configs=configs)
    th = ThreadCluster(2, _objective(kind)).run(policy)

    def by_config(res):
        return {(repr(sorted(res.service.db.trials[r.trial_id].hparams.items())), r.phase):
                r.metric for r in res.records}

    got, want = by_config(sh), by_config(th)
    assert len(got) == 6 and len(want) == 8 and set(got) <= set(want)
    assert {k: want[k] for k in got} == got
    assert all(math.isfinite(m) for m in got.values())
