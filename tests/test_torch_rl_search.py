"""The GA3C search, port against reference on the CPU: GA3C learns, HyperTrick
over GA3C end to end, the tune CLI's ``rl`` and ``synthetic`` objectives,
the synthetic objective, the ``a3c-atari`` config, and the entry points that
must not start without a card.

The ports of ``tests/test_envs_rl.py::test_ga3c_trainer_boxing_learns`` and
``tests/test_system.py::test_e2e_hypertrick_on_ga3c`` keep their
assertions: torch cannot reproduce the reference's ``jax.random`` streams,
so a learning curve is held by its shape, not its values
(``tests/test_torch_rl.py`` holds the arithmetic on the reference's draws).
"""
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.distributed import worker as ref_worker  # noqa: E402
from repro.launch import tune as ref_tune  # noqa: E402
from repro_torch.configs.registry import get_config, list_archs  # noqa: E402
from repro_torch.core import service as search_service  # noqa: E402
from repro_torch.core.completion import expected_alpha, min_alpha  # noqa: E402
from repro_torch.core.executor import ThreadCluster  # noqa: E402
from repro_torch.core.hypertrick import HyperTrick  # noqa: E402
from repro_torch.core.search_space import (Categorical, LogUniform, QLogUniform,  # noqa: E402
                                           SearchSpace, paper_rl_space)
from repro_torch.distributed import worker  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.models.convert import a3c_params_from_numpy  # noqa: E402
from repro_torch.rl import ga3c, network  # noqa: E402
from repro_torch.rl.envs import minigames  # noqa: E402


# ---------------------------------------------------------------------------
# (g) GA3C learns, and HyperTrick tunes it
# ---------------------------------------------------------------------------
def test_ga3c_trainer_boxing_learns():
    tr = ga3c.GA3CTrainer("boxing", ga3c.GA3CHyperParams(learning_rate=1e-3, gamma=0.9,
                                                         t_max=8), n_envs=16, seed=0,
                          device="cpu")
    first = tr.run_episodes(24, max_updates=400)
    for _ in range(3):
        last = tr.run_episodes(24, max_updates=400)
    assert last > first            # dense-reward game improves quickly
    assert tr.episodes >= 4 * 24 and tr.env_steps == tr.updates * 8 * 16


def test_e2e_hypertrick_on_ga3c():
    """The paper's pipeline end to end: tune (lr, gamma, t_max) for GA3C on
    the boxing analogue. Verifies: all configs explored, per-phase stats
    kept, the measured alpha is sane."""
    space = SearchSpace({
        "learning_rate": LogUniform(1e-5, 1e-2),
        "t_max": QLogUniform(2, 32, 1),
        "gamma": Categorical((0.9, 0.99, 0.999)),
    })
    objective = ga3c.make_rl_objective("boxing", episodes_per_phase=12, n_envs=8,
                                       max_updates=250, device="cpu")
    policy = HyperTrick(space, w0=6, n_phases=3, eviction_rate=0.3, seed=0)
    res = ThreadCluster(2, objective).run(policy)
    s = res.summary()
    assert s["n_trials"] == 6
    assert s["best_metric"] is not None
    assert 0.3 <= s["alpha"] <= 1.0
    db = res.service.db
    assert 0 in db.phase_metrics and len(db.phase_metrics[0]) >= 4
    # one trainer a trial, each seeded by the reference's trial_seed
    assert len(objective.trainers) == 6
    assert sorted(t.gen.initial_seed() for t in objective.trainers) == sorted(
        ga3c.trial_seed(0, tr.hparams) for tr in db.trials.values())


# ---------------------------------------------------------------------------
# (h), (i) the CLI
# ---------------------------------------------------------------------------
def _reference_cli(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["tune", *argv])
    ref_tune.main()
    return json.loads(capsys.readouterr().out)


SYNTHETIC = ["--objective", "synthetic", "--nodes", "1", "--synthetic-sleep", "0"]


def test_tune_cli_rl_on_the_cpu(monkeypatch, capsys, tmp_path):
    keys = set(_reference_cli(monkeypatch, capsys, [*SYNTHETIC, "--workers", "2",
                                                    "--phases", "1"]))
    out = tmp_path / "summary.json"
    res = tune.main(["--device", "cpu", "--objective", "rl", "--game", "pacman",
                     "--workers", "3", "--nodes", "2", "--phases", "2",
                     "--episodes-per-phase", "4", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == keys
    assert printed["n_trials"] == 3 and "crashed" not in printed["by_status"]
    assert printed["expected_alpha"] == expected_alpha(0.25, 2)
    assert printed["min_alpha"] == min_alpha(0.25, 2)
    assert json.loads(out.read_text()) == printed
    assert all(math.isfinite(r.metric) for r in res.records)
    assert set(printed["best_hparams"]) == {"learning_rate", "t_max", "gamma"}
    assert res.updates > 0 and res.env_steps >= 16 * res.updates * 2


class _Stop(Exception):
    pass


def test_tune_cli_defaults_to_the_reference_search(monkeypatch):
    """No argument but the device: GA3C on pong, 12 workers on 4 node
    threads, 5 phases of 60 episodes, HyperTrick at r 0.25, seed 0."""
    seen = {}

    class Cluster:
        def __init__(self, n_nodes, objective):
            seen["cluster"] = (n_nodes, objective)

        def run(self, policy):
            seen["policy"] = policy
            raise _Stop

    monkeypatch.setattr(tune, "make_rl_objective",
                        lambda *a, **k: seen.setdefault("objective", (a, k)) and "objective")
    monkeypatch.setattr(tune, "ThreadCluster", Cluster)
    with pytest.raises(_Stop):
        tune.main(["--device", "cpu"])
    assert seen["objective"] == (("pong", 60), {"seed": 0, "device": "cpu"})
    assert seen["cluster"] == (4, "objective")
    p = seen["policy"]
    assert isinstance(p, HyperTrick) and (p.w0, p.n_phases, p.r) == (12, 5, 0.25)
    assert p.space.sample_n(5, seed=0) == paper_rl_space().sample_n(5, seed=0)


@pytest.mark.parametrize("argv", [
    ["--workers", "6", "--phases", "3"],
    ["--workers", "8", "--phases", "4", "--eviction-rate", "0.5", "--seed", "3"],
    ["--workers", "5", "--phases", "2", "--policy", "random", "--seed", "1"],
])
def test_tune_cli_synthetic_matches_reference(monkeypatch, capsys, argv):
    want = _reference_cli(monkeypatch, capsys, [*SYNTHETIC, *argv])
    tune.main(["--device", "cpu", *SYNTHETIC, *argv])
    got = json.loads(capsys.readouterr().out)
    for k in ("n_trials", "by_status", "best_metric", "best_hparams", "alpha",
              "expected_alpha", "min_alpha"):
        assert got[k] == want[k], k


def test_synthetic_space_is_the_reference_space():
    assert tune.synthetic_space().sample_n(20, seed=4) == ref_tune.synthetic_space().sample_n(
        20, seed=4)


@pytest.mark.parametrize("kw", [{}, {"noise": 0.3, "seed": 5}, {"crash_above": 2.0}])
def test_synthetic_objective_matches_reference(kw):
    ours, ref = worker.make_synthetic_objective(**kw), ref_worker.make_synthetic_objective(**kw)
    for x in (0.05, 0.7, 1.0, 1.9, 3.0, 40.0):
        for phase in range(3):
            if kw.get("crash_above") and x > kw["crash_above"]:
                with pytest.raises(RuntimeError, match="synthetic crash"):
                    ours({"x": x}, phase, None)
                continue
            assert ours({"x": x}, phase, "s") == ref({"x": x}, phase, "s")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_a3c_atari_config_is_the_reference_config():
    import dataclasses
    ours, ref = get_config("a3c-atari"), ref_get_config("a3c-atari")
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert "a3c-atari" in list_archs() and ours.family == "rl"


# ---------------------------------------------------------------------------
# no card: the RL entry points raise, the search before any trial runs
# ---------------------------------------------------------------------------
@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_rl_entry_points_raise_without_gpu(no_gpu):
    hp = ga3c.GA3CHyperParams()
    with pytest.raises(RuntimeError, match="cuda"):
        minigames.make_env("pong")
    with pytest.raises(RuntimeError, match="cuda"):
        ga3c.GA3CTrainer("pong", hp, n_envs=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ga3c.GA3CTrainer("pong", hp, n_envs=2, device="cpu", init_device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ga3c.make_rl_objective("pong", 1)({"learning_rate": 1e-3, "gamma": 0.9, "t_max": 2},
                                          0, None)
    tree = {k: np.zeros(s, np.float32) for k, s in network.param_shapes(
        network.A3CNetConfig()).items()}
    with pytest.raises(RuntimeError, match="cuda"):
        a3c_params_from_numpy(tree, network.A3CNetConfig())


@pytest.mark.parametrize("argv", [
    [],
    ["--objective", "rl", "--workers", "2", "--nodes", "1", "--phases", "1",
     "--episodes-per-phase", "1"],
    ["--objective", "synthetic", "--workers", "2", "--nodes", "1", "--phases", "1"],
], ids=["no argument", "rl", "synthetic"])
def test_tune_needs_a_card_before_any_rl_or_synthetic_trial(no_gpu, monkeypatch, argv):
    acquired = []
    real = search_service.OptimizationService.acquire_trial
    monkeypatch.setattr(search_service.OptimizationService, "acquire_trial",
                        lambda self, *a, **k: acquired.append(a) or real(self, *a, **k))
    with pytest.raises(RuntimeError, match="cuda"):
        tune.main(argv)
    assert acquired == []
