"""PBT, port against reference: the port's ``PBTScheduler`` through the
optimization service gives the reference's verdicts, parents and
perturbations (tests/test_scheduler.py's PBT cases, both sides driven by
the same reports); the population engine executes a CLONE verdict as a
slot-to-slot copy on the device (the learner, not the carry), within a
bucket and across buckets, for GA3C and LM trials; and PBT end to end on
the vectorized and thread backends, through the CLI."""
import json
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import scheduler as ref_scheduler  # noqa: E402
from repro.core import search_space as ref_space  # noqa: E402
from repro.core import service as ref_service  # noqa: E402
from repro.population import objectives as ref_objectives  # noqa: E402
from repro_torch.core import scheduler, search_space, service  # noqa: E402
from repro_torch.core.executor import PopulationCluster  # noqa: E402
from repro_torch.core.scheduler import PBTScheduler, ReportReply, VerdictKind  # noqa: E402
from repro_torch.core.service import Decision, OptimizationService, TrialStatus  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.population.engine import PopulationEngine, TrialLease  # noqa: E402
from repro_torch.population.objectives import spec_for  # noqa: E402
from repro_torch.population.objectives.lm import LMObjective  # noqa: E402
from test_torch_search import _reference_summary_keys  # noqa: E402


def _spaces(kind):
    """(reference space, port space) of a scenario."""
    def build(ss):
        if kind == "x":
            return ss.SearchSpace({"x": ss.LogUniform(0.01, 100.0)})
        if kind == "t_max":
            return ss.SearchSpace({"learning_rate": ss.LogUniform(1e-4, 1e-3),
                                   "t_max": ss.Categorical((4, 8))})
        if kind == "rl":
            return ss.SearchSpace({"learning_rate": ss.LogUniform(1e-4, 1e-3),
                                   "gamma": ss.Categorical((0.99, 0.995)),
                                   "t_max": ss.Categorical((4, 8))})
        return ss.SearchSpace({"learning_rate": ss.LogUniform(1e-4, 1e-3),
                               "loss_chunk": ss.Categorical((256, 1024))})
    return build(ref_space), build(search_space)


# the scenarios of tests/test_scheduler.py:173-270: (space, population,
# phases, scheduler keywords, the metric each member reports at phase 0)
SCENARIOS = {
    "clone_verdict_and_hparam_swap": ("x", 3, 3, dict(exploit_frac=0.5, top_frac=0.25,
                                                      min_reports=2), [3.0, 5.0, 1.0]),
    "frozen_keep_child_structure": ("t_max", 8, 2, dict(exploit_frac=0.9, min_reports=2,
                                                        frozen=("t_max",)), None),
    "frozen_from_objective_spec_ga3c": ("rl", 8, 2, dict(exploit_frac=0.9, min_reports=2,
                                                         frozen="rl"), None),
    "frozen_from_objective_spec_lm": ("lm", 8, 2, dict(exploit_frac=0.9, min_reports=2,
                                                       frozen="lm"), None),
}


def _drive(pkg_sched, pkg_service, space, population, phases, kw, metrics, spec):
    """Every member's reports through one side's service: (acquired
    hparams, [(kind, clone_from, perturb) a report], clone log, statuses,
    the hparams each record ends with)."""
    kw = dict(kw)
    if isinstance(kw.get("frozen"), str):
        kw["frozen"] = spec(kw["frozen"]).structural
    pbt = pkg_sched.PBTScheduler(space, population=population, n_phases=phases, seed=0, **kw)
    svc = pkg_service.OptimizationService(pbt)
    recs = [svc.acquire_trial() for _ in range(population)]
    acquired = [dict(r.hparams) for r in recs]
    verdicts = []
    for phase in range(phases):
        for i, r in enumerate(recs):
            m = metrics[i] if metrics is not None else float(i % 3)
            v = svc.report_verdict(r.trial_id, phase, m + phase)
            verdicts.append((v.kind.value, v.clone_from, v.perturb))
    statuses = [svc.db.trials[r.trial_id].status.value for r in recs]
    final = [dict(svc.db.trials[r.trial_id].hparams) for r in recs]
    return acquired, verdicts, list(pbt.clone_log), statuses, final


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pbt_verdicts_match_reference(name):
    """The same space, seed and reports on both sides: the same
    configurations, verdicts (kind, parent, perturbation), clone log,
    statuses and live hyperparameters."""
    kind, population, phases, kw, metrics = SCENARIOS[name]
    ref_sp, sp = _spaces(kind)
    ref = _drive(ref_scheduler, ref_service, ref_sp, population, phases, kw, metrics,
                 ref_objectives.spec_for)
    ours = _drive(scheduler, service, sp, population, phases, kw, metrics, spec_for)
    assert ours == ref
    acquired, verdicts, clone_log, statuses, final = ours
    assert clone_log and statuses == ["completed"] * population   # PBT never kills
    clones = [v for v in verdicts if v[0] == "clone"]
    assert len(clones) == len(clone_log) >= 1
    frozen = kw.get("frozen")
    if frozen:
        key = spec_for(frozen).structural[0] if isinstance(frozen, str) else frozen[0]
        by_trial = {t: acquired[t] for t in range(population)}
        for (child, _, _), (_, _, perturb) in zip(clone_log, clones):
            assert perturb[key] == by_trial[child][key]


def test_pbt_clone_verdict_and_hparam_swap():
    """tests/test_scheduler.py::test_pbt_clone_verdict_and_hparam_swap on
    the port."""
    pbt = PBTScheduler(_spaces("x")[1], population=3, n_phases=3, seed=0,
                       exploit_frac=0.5, top_frac=0.25, min_reports=2)
    svc = OptimizationService(pbt)
    t0, t1, t2 = (svc.acquire_trial() for _ in range(3))
    assert svc.report_verdict(t0.trial_id, 0, 3.0).kind is VerdictKind.CONTINUE
    assert svc.report_verdict(t1.trial_id, 0, 5.0).kind is VerdictKind.CONTINUE
    orig = dict(t2.hparams)
    v = svc.report_verdict(t2.trial_id, 0, 1.0)
    assert v.kind is VerdictKind.CLONE and v.clone_from == t1.trial_id
    assert v.perturb is not None and v.perturb != orig
    assert svc.db.trials[t2.trial_id].hparams == v.perturb
    assert pbt.clone_log == [(t2.trial_id, t1.trial_id, 0)]
    assert svc.report(t2.trial_id, 1, 1.0) is Decision.CONTINUE
    assert svc.report(t2.trial_id, 2, 1.0) is Decision.STOP
    assert svc.db.trials[t2.trial_id].status is TrialStatus.COMPLETED


# ---------------------------------------------------------------------------
# the clone on the engine (tests/test_scheduler.py:321)
# ---------------------------------------------------------------------------
def _ga3c_engine(hps, max_slots):
    engine = PopulationEngine("pong", max_slots=max_slots, n_envs=2, episodes_per_phase=10 ** 9,
                              max_updates=10 ** 9, seed=0, device="cpu")
    for i, hp in enumerate(hps):
        engine.admit(TrialLease(i, dict(hp)))
    return engine


def _lm_engine(hps):
    engine = PopulationEngine(LMObjective(batch=2, seq=8, device="cpu"), max_slots=len(hps),
                              episodes_per_phase=10 ** 9, max_updates=10 ** 9, seed=0,
                              device="cpu")
    for i, hp in enumerate(hps):
        engine.admit(TrialLease(i, dict(hp)))
    return engine


def _learner_rows(bucket, i):
    return [t[i].clone() for t in bucket.leaves[:bucket._n_learner]
            if isinstance(t, torch.Tensor)]


def _carry_rows(bucket, i):
    return [t[i].clone() if isinstance(t, torch.Tensor) else t[i]
            for t in bucket.leaves[bucket._n_learner:] if t is not None]


def _equal(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x is y
               for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("objective", ["rl", "lm"])
def test_on_device_clone_is_bit_identical(objective):
    """A CLONE verdict on the engine: the child's weights and optimizer
    state become the parent's bit for bit, its carry (envs or data
    counters, and its generator) stays its own, the perturbed
    hyperparameters are installed; an absent parent degrades to adopting
    them only."""
    if objective == "rl":
        hps = [{"learning_rate": 1e-3, "t_max": 4, "gamma": 0.99},
               {"learning_rate": 4e-4, "t_max": 4, "gamma": 0.995}]
        engine, key = _ga3c_engine(hps, 2), 4
        perturb = {"learning_rate": 5e-4, "t_max": 4, "gamma": 0.99}
    else:
        hps = [{"learning_rate": 1e-3, "loss_chunk": 256, "grad_clip": 1.0, "warmup_steps": 1},
               {"learning_rate": 4e-4, "loss_chunk": 1024, "grad_clip": 0.5, "warmup_steps": 5}]
        engine, key = _lm_engine(hps), 8
        perturb = {"learning_rate": 5e-4, "loss_chunk": 1024, "grad_clip": 2.0,
                   "warmup_steps": 3}
    bucket = engine.buckets[key]
    bucket.step()                        # optimizer state and carries that differ
    parent, child = _learner_rows(bucket, 0), _learner_rows(bucket, 1)
    assert not _equal(parent, child)     # different trial seeds, different weights
    carry = _carry_rows(bucket, 1)
    engine._exploit(bucket, 1, bucket.meta[1], ReportReply("continue", clone_from=0,
                                                           perturb=perturb))
    assert engine.clones == 1
    assert _equal(_learner_rows(bucket, 1), parent) and _equal(_learner_rows(bucket, 0), parent)
    assert _equal(_carry_rows(bucket, 1), carry)
    assert bucket.meta[1].hparams == perturb
    assert bucket.hyper["learning_rate"][1] == 5e-4
    if objective == "lm":
        assert (bucket.hyper["grad_clip"][1], bucket.hyper["warmup_steps"][1]) == (2.0, 3.0)
    # an absent parent: the hyperparameters only, no copy
    learner = _learner_rows(bucket, 1)
    engine._exploit(bucket, 1, bucket.meta[1], ReportReply(
        "continue", clone_from=99, perturb=dict(perturb, learning_rate=2e-4)))
    assert engine.clones == 1
    assert bucket.hyper["learning_rate"][1] == 2e-4
    assert _equal(_learner_rows(bucket, 1), learner)
    bucket.step()                        # the clone trains on under its new values
    assert not _equal(_learner_rows(bucket, 1), learner)


def test_clone_across_buckets():
    """The parent in another bucket (another t_max): its learner is copied
    into the child's slot all the same; the child stays in its bucket with
    its own rollout length and envs."""
    hps = [{"learning_rate": 1e-3, "t_max": 8, "gamma": 0.99},
           {"learning_rate": 4e-4, "t_max": 4, "gamma": 0.995},
           {"learning_rate": 2e-4, "t_max": 4, "gamma": 0.99}]
    engine = _ga3c_engine(hps, 3)
    src, dst = engine.buckets[8], engine.buckets[4]
    assert (src.capacity, dst.capacity) == (1, 2)
    src.step()
    dst.step()
    parent, other, carry = _learner_rows(src, 0), _learner_rows(dst, 1), _carry_rows(dst, 0)
    perturb = {"learning_rate": 7e-4, "t_max": 4, "gamma": 0.99}
    engine._exploit(dst, 0, dst.meta[0], ReportReply("continue", clone_from=0, perturb=perturb))
    assert engine.clones == 1
    assert _equal(_learner_rows(dst, 0), parent)
    assert _equal(_learner_rows(dst, 1), other) and _equal(_learner_rows(src, 0), parent)
    assert _equal(_carry_rows(dst, 0), carry)
    assert dst.hyper["learning_rate"][0] == 7e-4 and dst.meta[0].hparams == perturb
    dst.step()                           # both buckets step on
    src.step()


# ---------------------------------------------------------------------------
# end to end (tests/test_scheduler.py:362)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("objective", ["rl", "lm"])
def test_pbt_on_vectorized_backend_clones_end_to_end(objective):
    """A PBT run on the population engine copies at least one slot on the
    device, and the whole population completes (PBT never kills)."""
    if objective == "rl":
        space = search_space.SearchSpace({"learning_rate": search_space.LogUniform(1e-4, 1e-3),
                                          "t_max": search_space.Categorical((4,)),
                                          "gamma": search_space.Categorical((0.99,))})
        cluster = PopulationCluster(4, game="pong", episodes_per_phase=2, n_envs=2,
                                    max_updates=5, seed=0, device="cpu")
    else:
        space = search_space.lm_space()
        cluster = PopulationCluster(4, objective=LMObjective(batch=2, seq=8, device="cpu"),
                                    episodes_per_phase=2, seed=0, device="cpu")
    pbt = PBTScheduler(space, population=4, n_phases=3, seed=0, exploit_frac=0.9,
                       min_reports=2, frozen=spec_for(objective).structural)
    res = cluster.run(pbt)
    s = res.summary()
    assert s["n_trials"] == 4 and s["by_status"] == {"completed": 4}
    assert s["clones"] == len(pbt.clone_log) >= 1
    assert 1 <= s["clones_on_device"] <= s["clones"]


@pytest.mark.parametrize("argv", [
    ["--backend", "vectorized", "--scheduler", "pbt", "--workers", "4", "--phases", "3",
     "--episodes-per-phase", "2", "--n-envs", "2"],
    ["--backend", "vectorized", "--objective", "lm", "--scheduler", "pbt", "--workers", "4",
     "--phases", "3", "--steps-per-phase", "2"],
])
def test_tune_cli_pbt_vectorized_runs_on_the_cpu(argv, monkeypatch, capsys):
    keys = _reference_summary_keys(monkeypatch, capsys) | {"devices"}
    res = tune.main(["--device", "cpu", *argv])
    printed = json.loads(capsys.readouterr().out)
    assert isinstance(res.service.scheduler, PBTScheduler)
    assert set(printed) - {"clones", "clones_on_device"} == keys
    assert printed["by_status"] == {"completed": 4}
    clone_log = res.service.scheduler.clone_log
    assert printed.get("clones", 0) == len(clone_log)
    assert ("clones_on_device" in printed) == bool(clone_log)


def test_tune_cli_pbt_thread_backend_matches_reference(monkeypatch, capsys):
    """``--scheduler pbt`` on the thread backend over the synthetic
    objective against the reference's CLI: the same trials, verdicts and
    summary but for the clocks."""
    argv = ["--objective", "synthetic", "--scheduler", "pbt", "--workers", "6", "--nodes", "1",
            "--phases", "3", "--synthetic-sleep", "0"]
    from repro.launch import tune as ref_tune
    monkeypatch.setattr(sys, "argv", ["tune", *argv])
    ref_tune.main()
    ref = json.loads(capsys.readouterr().out)
    res = tune.main(["--device", "cpu", *argv])
    ours = json.loads(capsys.readouterr().out)
    assert isinstance(res.service.scheduler, PBTScheduler)
    clock = {"wall_time", "occupancy"}
    assert {k: v for k, v in ours.items() if k not in clock} == \
        {k: v for k, v in ref.items() if k not in clock}
    assert ours["clones"] == len(res.service.scheduler.clone_log) >= 1
    assert ours["by_status"] == {"completed": 6}


def test_population_checks_cli_runs_on_the_cpu():
    """``launch/population_checks.py``: a PBT run's clone counts, and 9c's
    bucket against lone trials (on the CPU the slots' weights and moments
    match their lone trials within the limit). The engine seeds each trial
    with ``trial_seed``, a salted ``str`` hash, so its draws change with
    the interpreter's hash seed: the command runs under a pinned one
    (``PYTHONHASHSEED=0``, chip_smoke.py's), on one intra-op thread as this
    file's process. Unpinned, 2 salts of 48 (40 and 47) put one of slot 2's
    852,736 weights outside the limit, 0.016 x its lr away (AdamW's step
    on a gradient near 0; the module's comment). That lies within 9c's own
    limits (``OUTLIERS`` weights, ``MAX_OVER_LR`` x lr), which a last run
    at a hash seed drawn anew each time holds."""
    import os
    import subprocess

    def run(*argv, hash_seed="0"):
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        env.pop("PYTHONHASHSEED", None)
        if hash_seed is not None:
            env["PYTHONHASHSEED"] = hash_seed
        ran = subprocess.run([sys.executable, "-m", "repro_torch.launch.population_checks",
                              *argv, "--seeds", "1", "--device", "cpu"],
                             capture_output=True, text=True, timeout=300, env=env)
        assert ran.returncode == 0, ran.stderr[-2000:]
        return [json.loads(line) for line in ran.stdout.strip().splitlines()]

    rows = run("pbt", "--objective", "lm")[:-1]
    assert rows[0]["by_status"] == {"completed": 4} and rows[0]["clones"] >= rows[0][
        "clones_on_device"]
    from repro_torch.launch import population_checks
    *rows, last = run("slots")
    assert len(rows) == len(population_checks.SLOT_HPARAMS)
    assert all(r["outside_limit"] == 0 and r["v_sum_rel_diff"] < 1e-4 for r in rows)
    assert last["max"]["outside_limit"] == 0 and last["seeds_failing"] == 0
    assert last["faults"] == []
    *rows, last = run("slots", hash_seed=None)
    assert len(rows) == len(population_checks.SLOT_HPARAMS)
    assert last["seeds_failing"] == 0 and last["faults"] == [], last


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "grok-1-314b"])
def test_population_checks_slots_take_a_mamba_or_moe_arch(arch, capsys):
    """``population_checks slots --arch``: 9c's bucket against lone trials
    over a reduced config with a mamba block (the scan's slot case) or a
    MoE block (gmm over slot x expert groups), within 9c's limits on the
    CPU."""
    from repro_torch.launch import population_checks
    rows = population_checks.main(["slots", "--seeds", "1", "--device", "cpu", "--arch", arch])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rows) == len(population_checks.SLOT_HPARAMS)
    assert {r["arch"] for r in rows} == {arch} and last["arch"] == arch
    assert last["seeds_failing"] == 0 and last["faults"] == [], last


@pytest.mark.parametrize("control", ["global_clip", "slot_mean"])
def test_slot_limits_fail_a_coupled_bucket(control):
    """9c's limits catch a bucket whose slots are tied together: a clip by
    the whole stack's norm, or a mean of the slots' losses, breaks the
    second moments' and the outliers' limits; a bucket of one is unchanged,
    so the lone trials still read as the uncoupled ones."""
    from repro_torch.launch import population_checks
    rows = population_checks.slot_rows(0, "cpu", control)
    faults = {f for r in rows for f in population_checks.slot_faults(r)}
    assert {"moments", "outliers"} <= faults, (control, rows)
