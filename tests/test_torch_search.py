"""The search, port against reference: search spaces, completion rates,
HyperTrick and random search through the optimization service, the thread
backend, the yi-9b LM search on the CPU and the tune CLI; and the kernel
ops' launch counters under threads.

The port's ``core`` and ``telemetry.metrics`` modules are numpy copies of
the reference's, so the same seeds give bit-identical configurations,
decisions and summaries; the LM trials' metrics agree within the
Trainer's limit."""
import json
import math
import sys
import threading
import time
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import completion as ref_completion  # noqa: E402
from repro.core import executor as ref_executor  # noqa: E402
from repro.core import hypertrick as ref_hypertrick  # noqa: E402
from repro.core import search_space as ref_space  # noqa: E402
from repro.core import service as ref_service  # noqa: E402
from repro_torch.core import completion, executor, hypertrick, search_space, service  # noqa: E402
from repro_torch.launch import tune  # noqa: E402

# the Trainer's losses (AdamW, reduced models): tests/test_torch_train.py
TRAINER_LOSS_ATOL = 1e-4

REF = types.SimpleNamespace(space=ref_space, completion=ref_completion, ht=ref_hypertrick,
                            service=ref_service, executor=ref_executor)
PORT = types.SimpleNamespace(space=search_space, completion=completion, ht=hypertrick,
                             service=service, executor=executor)


# ---------------------------------------------------------------------------
# search spaces and completion rates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("space", ["lm_space", "paper_rl_space"])
@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_sample_gives_the_reference_values(space, seed):
    ref = getattr(ref_space, space)().sample_n(20, seed=seed)
    ours = getattr(search_space, space)().sample_n(20, seed=seed)
    assert ours == ref
    assert [list(map(type, h.values())) for h in ours] == [
        list(map(type, h.values())) for h in ref]


@pytest.mark.parametrize("space", ["lm_space", "paper_rl_space"])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_perturb_hparams_gives_the_reference_values(space, seed):
    frozen = ("loss_chunk",) if space == "lm_space" else ("t_max",)

    def perturbed(pkg):
        sp = getattr(pkg, space)()
        rng = np.random.default_rng(seed + 1)
        return [pkg.perturb_hparams(sp, h, rng, frozen=f)
                for h in sp.sample_n(8, seed=seed) for f in ((), frozen)]

    assert perturbed(search_space) == perturbed(ref_space)


@pytest.mark.parametrize("r", [0.05, 0.1082, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("n_phases", [1, 3, 5, 27])
def test_completion_rates_match_reference(r, n_phases):
    assert completion.min_alpha(r, n_phases) == ref_completion.min_alpha(r, n_phases)
    assert completion.expected_alpha(r, n_phases) == ref_completion.expected_alpha(r, n_phases)
    assert hypertrick.dcm_threshold(12, r, n_phases) == ref_hypertrick.dcm_threshold(
        12, r, n_phases)
    assert hypertrick.expected_workers(12, r, n_phases) == ref_hypertrick.expected_workers(
        12, r, n_phases)


@pytest.mark.parametrize("eta,big_r", [(2, 4), (3, 9), (3, 27), (4, 64)])
def test_hyperband_brackets_match_reference(eta, big_r):
    ours = completion.hyperband_brackets(eta, big_r)
    ref = ref_completion.hyperband_brackets(eta, big_r)
    assert [(b.s, b.n, b.r, b.alpha, b.work) for b in ours] == [
        (b.s, b.n, b.r, b.alpha, b.work) for b in ref]
    assert completion.hyperband_alpha(ours) == ref_completion.hyperband_alpha(ref)


# ---------------------------------------------------------------------------
# the policies through the service, one scripted stream, no threads
# ---------------------------------------------------------------------------
def _scripted(pkg, kind, w0, r, n_phases, seed, stream, n_nodes=3, crash_p=0.0):
    """Acquires and reports of ``n_nodes`` simulated nodes interleaved in
    an order, with metrics and crashes drawn from one seeded numpy
    generator; returns every event, the summary and alpha."""
    space = pkg.space.lm_space()
    if kind == "hypertrick":
        policy = pkg.ht.HyperTrick(space, w0, n_phases, r, seed=seed)
    else:
        policy = pkg.ht.RandomSearchPolicy(space, w0, n_phases, seed=seed)
    svc = pkg.service.OptimizationService(policy)
    draw = np.random.default_rng(stream)
    nodes = {n: None for n in range(n_nodes)}     # node -> (trial, phase)
    events = []
    while nodes:
        node = int(draw.choice(sorted(nodes)))
        if nodes[node] is None:
            trial = svc.acquire_trial(node)
            if trial is None:
                del nodes[node]
                events.append(("done", node))
                continue
            nodes[node] = (trial, 0)
            events.append(("acquire", node, trial.trial_id, trial.hparams))
            continue
        trial, phase = nodes[node]
        if draw.random() < crash_p:
            svc.crash(trial.trial_id)
            nodes[node] = None
            events.append(("crash", trial.trial_id, phase))
            continue
        metric = float(-abs(np.log(trial.hparams["learning_rate"] / 1e-3))
                       + draw.normal(0.0, 0.5) + 0.1 * phase)
        decision = svc.report(trial.trial_id, phase, metric)
        events.append(("report", trial.trial_id, phase, metric, decision.name))
        nodes[node] = None if (decision.name == "STOP" or phase + 1 == n_phases) else (
            trial, phase + 1)
    return events, svc.db.summary(), svc.db.completion_rate(n_phases)


@pytest.mark.parametrize("kind", ["hypertrick", "random"])
@pytest.mark.parametrize("w0,r,n_phases,seed,stream,crash_p", [
    (12, 0.25, 5, 0, 0, 0.0),
    (20, 0.1082, 6, 3, 1, 0.0),
    (16, 0.5, 3, 5, 2, 0.05),
])
def test_policies_through_the_service_match_reference(kind, w0, r, n_phases, seed, stream,
                                                      crash_p):
    ours = _scripted(PORT, kind, w0, r, n_phases, seed, stream, crash_p=crash_p)
    ref = _scripted(REF, kind, w0, r, n_phases, seed, stream, crash_p=crash_p)
    assert ours == ref
    events, summary, _ = ours
    assert summary["n_trials"] == w0
    if kind == "hypertrick" and crash_p == 0.0:
        assert any(e[0] == "report" and e[4] == "STOP" and e[2] + 1 < n_phases
                   for e in events), "no early stop: the stream tests too little"


@given(w0=st.integers(1, 24), r=st.floats(0.05, 0.9), n_phases=st.integers(1, 6),
       seed=st.integers(0, 2 ** 16), stream=st.integers(0, 2 ** 16),
       n_nodes=st.integers(1, 5), kind=st.sampled_from(["hypertrick", "random"]))
@settings(max_examples=40, deadline=None)
def test_policies_match_reference_on_any_stream(w0, r, n_phases, seed, stream, n_nodes, kind):
    args = (kind, w0, r, n_phases, seed, stream, n_nodes, 0.05)
    assert _scripted(PORT, *args) == _scripted(REF, *args)


# ---------------------------------------------------------------------------
# the thread backend
# ---------------------------------------------------------------------------
def _toy(hp, phase, state):
    state = (state or 0) + 1
    return float(-abs(np.log(hp["learning_rate"] / 1e-3)) * (1 + 0.1 * phase) + 0.01 * state), \
        state


def _crashy(hp, phase, state):
    if hp["loss_chunk"] == 512 and phase == 1:
        raise RuntimeError("a trial fails after its first report")
    return _toy(hp, phase, state)


def _thread_run(pkg, objective, policy_kind, n_nodes=1, w0=10, n_phases=4):
    space = pkg.space.lm_space()
    if policy_kind == "hypertrick":
        policy = pkg.ht.HyperTrick(space, w0, n_phases, 0.25, seed=4)
    else:
        policy = pkg.ht.RandomSearchPolicy(space, w0, n_phases, seed=4)
    res = pkg.executor.ThreadCluster(n_nodes, objective).run(policy)
    records = [(r.trial_id, r.node, r.phase, r.metric) for r in res.records]
    trials = {t.trial_id: (t.hparams, t.status.value, [m for m, _ in t.reports], t.node)
              for t in res.service.db.trials.values()}
    summary = {k: v for k, v in res.summary().items() if k not in ("wall_time", "occupancy")}
    return res, records, trials, summary


@pytest.mark.parametrize("policy_kind", ["hypertrick", "random"])
def test_thread_cluster_one_node_matches_reference(policy_kind):
    res, *ours = _thread_run(PORT, _toy, policy_kind)
    _, *ref = _thread_run(REF, _toy, policy_kind)
    assert ours == ref
    assert set(res.summary()) == {"n_trials", "by_status", "best_metric", "best_hparams",
                                  "wall_time", "occupancy", "alpha"}
    assert 0.0 < res.occupancy <= 1.0 + 1e-9


def test_thread_cluster_isolates_a_crash_as_the_reference_does(capsys):
    res, *ours = _thread_run(PORT, _crashy, "random", n_nodes=1)
    _, *ref = _thread_run(REF, _crashy, "random", n_nodes=1)
    assert ours == ref
    by_status = ours[2]["by_status"]
    assert by_status.get("crashed", 0) >= 1 and by_status.get("completed", 0) >= 1
    assert "a trial fails after its first report" in capsys.readouterr().err
    assert res.service.db.best_trial().status is not service.TrialStatus.CRASHED


def test_thread_cluster_four_nodes_spends_the_budget():
    res, records, trials, summary = _thread_run(PORT, _toy, "hypertrick", n_nodes=4, w0=16)
    assert summary["n_trials"] == 16 and 0.0 < summary["alpha"] <= 1.0
    assert {r[1] for r in records} <= set(range(4))
    # every trial's hyperparameters are the reference's draws, in trial order
    ref = ref_space.lm_space()
    rng = np.random.default_rng(4)
    assert [trials[i][0] for i in range(16)] == [ref.sample(rng) for _ in range(16)]


# ---------------------------------------------------------------------------
# the slice as a whole: HyperTrick over yi-9b reduced LM trials
# ---------------------------------------------------------------------------
def test_lm_search_matches_reference(monkeypatch):
    """One node, HyperTrick(lm_space, w0 4, 2 phases, r 0.25, seed 0) over
    the yi-9b reduced LM objective at 3 steps a phase, batch 2 x 16: every
    port trial starts from the reference trial's seed-0 weights."""
    import jax
    from repro.configs.registry import get_config as ref_get_config
    from repro.train import trainer as ref_trainer
    from repro_torch.configs.registry import get_config
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train import trainer as port_trainer

    arch, kw = "yi-9b", dict(steps_per_phase=3, batch=2, seq=16)

    def run(pkg, objective):
        policy = pkg.ht.HyperTrick(pkg.space.lm_space(), 4, 2, 0.25, seed=0)
        return pkg.executor.ThreadCluster(1, objective).run(policy)

    ref = run(REF, ref_trainer.make_lm_objective(arch, **kw))
    # the reference draws every trial's weights from one key (seed 0)
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
        return {t.trial_id: (t.hparams, t.status.value, len(t.reports))
                for t in res.service.db.trials.values()}

    assert trials(ours) == trials(ref)
    assert len(trials(ours)) == 4 and "crashed" not in ours.summary()["by_status"]
    got = {t.trial_id: [m for m, _ in t.reports] for t in ours.service.db.trials.values()}
    want = {t.trial_id: [m for m, _ in t.reports] for t in ref.service.db.trials.values()}
    for tid in want:
        np.testing.assert_allclose(got[tid], want[tid], atol=TRAINER_LOSS_ATOL, err_msg=tid)
    assert [(r.trial_id, r.phase) for r in ours.records] == [
        (r.trial_id, r.phase) for r in ref.records]
    assert all(math.isfinite(m) for ms in got.values() for m in ms)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _reference_summary_keys(monkeypatch, capsys):
    """The keys the reference's CLI prints, from a short synthetic search."""
    from repro.launch import tune as ref_tune
    monkeypatch.setattr(sys, "argv", ["tune", "--objective", "synthetic", "--workers", "2",
                                      "--nodes", "1", "--phases", "1",
                                      "--synthetic-sleep", "0"])
    ref_tune.main()
    return set(json.loads(capsys.readouterr().out))


def test_tune_cli_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    keys = _reference_summary_keys(monkeypatch, capsys)
    out = tmp_path / "summary.json"
    res = tune.main(["--device", "cpu", "--workers", "3", "--nodes", "2", "--phases", "2",
                     "--steps-per-phase", "2", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == keys
    assert printed["n_trials"] == 3 and "crashed" not in printed["by_status"]
    assert printed["expected_alpha"] == completion.expected_alpha(0.25, 2)
    assert printed["min_alpha"] == completion.min_alpha(0.25, 2)
    assert json.loads(out.read_text()) == printed
    assert all(math.isfinite(r.metric) for r in res.records)


@pytest.mark.parametrize("argv,item", [
    (["--backend", "vectorized"], "7a-1"),
    (["--backend", "process"], "7c"),
    (["--backend", "server"], "7c"),
    (["--objective", "rl"], "7b"),
    (["--objective", "synthetic"], "7b"),
    (["--scheduler", "pbt"], "7a-2"),
    (["--scheduler", "hyperband"], "7a-2"),
    (["--bracket"], "7a-1"),
    (["--devices", "2"], "7a-1"),
    (["--journal", "j.jsonl"], "7c"),
    (["--resume"], "7c"),
])
def test_tune_cli_refuses_what_is_not_ported(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item} "):
        tune.main(["--device", "cpu", *argv])


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------
def _ops():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gmm import ops as gm
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.selective_scan import ops as ss
    return {
        "rmsnorm": (rms, "rmsnorm_cuda", rms.rmsnorm, ("out", "block"), 3),
        "flash_attention": (fa, "flash_attention_cuda", fa.flash_attention,
                            ("out", "fma"), 3),
        "gmm": (gm, "gmm_cuda", gm.gmm, ("out", "small"), 3),
        "selective_scan": (ss, "selective_scan_cuda", ss.selective_scan,
                           ("y", "hT", "prefill"), 7),
    }


class YieldingCount(int):
    """A count whose addition lets another thread run between the read and
    the write of ``op.launches += 1``, where CPython may switch threads
    (a free-threaded build, or a switch that happens to land there)."""

    def __add__(self, other):
        time.sleep(0)
        return YieldingCount(int(self) + other)


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "gmm", "selective_scan"])
def test_launch_counters_are_exact_under_threads(monkeypatch, name):
    """8 threads call the op's counting path many times each, through a
    ``*_cuda`` that reports a launch: not one count may be lost."""
    mod, attr, op, reply, n_args = _ops()[name]
    kind = reply[-1]
    monkeypatch.setattr(mod, attr, lambda *a, **k: reply)
    for counter in ("launches", f"launches_{kind}"):
        monkeypatch.setattr(op, counter, YieldingCount(getattr(op, counter)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as CPython will
    x = types.SimpleNamespace(device=torch.device("cuda"))
    args = (x,) + (None,) * (n_args - 1)
    before = (op.launches, getattr(op, f"launches_{kind}"))
    n_threads, calls = 8, 2000
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=60)
        for _ in range(calls):
            op(*args)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a thread did not finish"
    finally:
        sys.setswitchinterval(interval)
    moved = (op.launches - before[0], getattr(op, f"launches_{kind}") - before[1])
    assert moved == (n_threads * calls, n_threads * calls)


def test_count_launch_moves_nothing_for_no_launch_and_refuses_unknown_kernels():
    from repro_torch.kernels.counters import count_launch
    op = types.SimpleNamespace(launches=0, launches_block=0)
    count_launch(op, None)
    assert (op.launches, op.launches_block) == (0, 0)
    count_launch(op, "block")
    assert (op.launches, op.launches_block) == (1, 1)
    with pytest.raises(AttributeError):
        count_launch(op, "warp")
    assert op.launches == 1
