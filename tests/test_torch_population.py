"""The population engine, port against reference: a bucket's step against
the reference's ``_bucket_step`` on the reference's draws (plain, with the
gradient clip engaged, with a masked slot), a slot against the same trial
trained alone, and the port's counterparts of the reference's engine tests
(tests/test_population.py, test_population_sharded.py, test_bracket_barrier.py,
test_scheduler.py). PBT's clones: tests/test_torch_pbt.py.

As in tests/test_torch_rl.py, the port's rollouts take the draws the
reference's keys give, derived by that file's ``RefDraws`` helpers from each
slot's ``LoopState.rng``: states, actions, rewards, dones and episode
counters must then be equal, and weights and accumulators close (the
batched matmuls sum in another order than XLA's convolutions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.population import engine as ref_engine  # noqa: E402
from repro.population import objectives as ref_objectives  # noqa: E402
from repro.population.objectives.ga3c import GA3CObjective as RefGA3C  # noqa: E402
from repro.rl import a3c as ref_a3c  # noqa: E402
from repro_torch.core.executor import PopulationCluster  # noqa: E402
from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy  # noqa: E402
from repro_torch.core.search_space import (Categorical, LogUniform, SearchSpace,  # noqa: E402
                                           paper_rl_space)
from repro_torch.core.service import OptimizationService, TrialStatus  # noqa: E402
from repro_torch.models.convert import a3c_params_from_numpy  # noqa: E402
from repro_torch.optim.optimizers import init_opt_state  # noqa: E402
from repro_torch.population import objectives  # noqa: E402
from repro_torch.population.engine import LocalDriver, PopulationEngine, TrialLease  # noqa: E402
from repro_torch.population.objectives import ga3c as ga3c_objective  # noqa: E402
from repro_torch.rl import ga3c, network  # noqa: E402
from test_torch_rl import NET_ATOL, RefDraws, _loop_from_ref, _rollout_draws_of  # noqa: E402

HP = {"learning_rate": 3e-4, "gamma": 0.99, "t_max": 8}
T_MAX, N_ENVS = 4, 4
# two trials of one bucket, every traced value its own
SLOT_HP = [dict(learning_rate=3e-3, gamma=0.95, t_max=T_MAX, beta=0.02),
           dict(learning_rate=1e-3, gamma=0.99, t_max=T_MAX, beta=0.005)]
CLIP = 1e-3     # below every slot's gradient norm: each slot clips by its own


def _tiny_space(t_max=4):
    return SearchSpace({"learning_rate": LogUniform(1e-4, 1e-3),
                        "t_max": Categorical((t_max,)),
                        "gamma": Categorical((0.99,))})


def _engine(max_slots, n_envs=2, **kw):
    kw.setdefault("episodes_per_phase", 10 ** 9)
    kw.setdefault("max_updates", 10 ** 9)
    return PopulationEngine("pong", max_slots=max_slots, n_envs=n_envs, seed=0, device="cpu",
                            **kw)


def _slot(tensors, i):
    return {n: t[i].clone() for n, t in tensors.items()}


def _params(bucket):
    return bucket.learner[0]


def _max_delta(a, b):
    return max(float((a[n] - b[n]).abs().max()) for n in a)


class Recorder:
    """Wraps a function of the GA3C objective and keeps what it returned."""

    def __init__(self, monkeypatch, name):
        self.calls = []
        real = getattr(ga3c_objective, name)

        def wrapped(*a, **k):
            out = real(*a, **k)
            self.calls.append(out)
            return out
        monkeypatch.setattr(ga3c_objective, name, wrapped)


# ---------------------------------------------------------------------------
# a bucket's step against the reference's
# ---------------------------------------------------------------------------
def _ref_side(clip, masked):
    """The reference's two-slot bucket: its stacked state and its step."""
    obj = RefGA3C("pong", n_envs=N_ENVS)
    states = [obj.init_slot_state(jax.random.PRNGKey(7 + s), hp) for s, hp in enumerate(SLOT_HP)]
    learner, carry = (jax.tree.map(lambda *x: jnp.stack(x), *parts) for parts in zip(*states))
    hyper = tuple(jnp.asarray([obj.traced_values(hp)[k] for hp in SLOT_HP], jnp.float32)
                  for k in range(3))
    if clip:
        # _bucket_step caches by cache_key(), which leaves tc out: build the
        # clipped step afresh
        obj.tc = dataclasses.replace(obj.tc, grad_clip=CLIP)
        vstep = jax.jit(jax.vmap(obj.make_step(T_MAX, 2)))
        step = lambda lrn, car: vstep(lrn, car, *hyper)  # noqa: E731
    else:
        bstep = ref_engine._bucket_step(obj, T_MAX, 2)
        active = jnp.asarray([not masked, True])
        step = lambda lrn, car: bstep(lrn, car, *hyper, active)  # noqa: E731
    return learner, carry, step


@pytest.mark.parametrize("case", ["plain", "clipped", "masked"])
def test_bucket_step_matches_reference(case, monkeypatch):
    """Three updates of a two-slot bucket, each slot with its own lr,
    gamma and beta, on both sides from the same weights and env states."""
    clip, masked = case == "clipped", case == "masked"
    learner, carry, ref_step = _ref_side(clip, masked)
    ref_rollout = jax.jit(lambda p, lp: ref_a3c.rollout(RefGA3C("pong").env, p, lp, T_MAX))

    engine = _engine(2, n_envs=N_ENVS)
    if clip:
        engine.objective.tc = dataclasses.replace(engine.objective.tc, grad_clip=CLIP)
    engine._admit_grouped([TrialLease(s, dict(hp)) for s, hp in enumerate(SLOT_HP)], now=0.0)
    bucket = engine.buckets[T_MAX]
    assert bucket.capacity == 2
    cfg, env = engine.objective.net_cfg, engine.objective.env
    gens = bucket.carry[1]
    for s, hp in enumerate(SLOT_HP):
        tree = {n: np.asarray(v[s]) for n, v in learner[0].items()}
        net = a3c_params_from_numpy(tree, cfg, "cpu")
        loop = _loop_from_ref(jax.tree.map(lambda x: x[s], carry), env, N_ENVS)
        bucket.write_slot(s, bucket.meta[s], ({n: p.detach() for n, p in net.named_parameters()},
                                              init_opt_state(engine.objective.tc, net)),
                          (loop, gens[s]), engine.objective.traced_values(hp))
    if masked:
        bucket.park(0)
    frozen = [t[0].clone() if isinstance(t, torch.Tensor) else None for t in bucket.leaves]
    frozen_gen = gens[0].get_state()

    # each slot's draws, derived from its LoopState.rng by the reference's splits
    queue = {id(g): [] for g in gens}
    real_draws = ga3c_objective.rollout_draws

    def ref_draws(env_, gen, t_max, n_envs, device=None):
        real_draws(env_, gen, t_max, n_envs, device)     # the slot's own generator moves
        return queue[id(gen)].pop(0)
    monkeypatch.setattr(ga3c_objective, "rollout_draws", ref_draws)
    updates = Recorder(monkeypatch, "ga3c_update_slots")
    live = [s for s in range(2) if not (masked and s == 0)]

    draws = RefDraws.of("pong")
    for u in range(3):
        trajs = {}
        for s in live:
            queue[id(gens[s])].append(_rollout_draws_of(carry.rng[s], T_MAX, N_ENVS, 3, draws))
            trajs[s] = ref_rollout(jax.tree.map(lambda x: x[s], learner[0]),
                                   jax.tree.map(lambda x: x[s], carry))[0]
        learner, carry = ref_step(learner, carry)
        bucket.step()
        what = f"{case}, update {u}"
        traj = updates.calls[-1][0]
        assert traj.actions.shape == (len(live), T_MAX, N_ENVS)
        for j, s in enumerate(live):
            for f in ("actions", "rewards", "dones"):
                np.testing.assert_array_equal(getattr(traj, f)[j].numpy(),
                                              np.asarray(getattr(trajs[s], f)),
                                              err_msg=f"{what}: slot {s} {f}")
        loop = bucket.carry[0]
        for s in range(2):
            ref_loop = jax.tree.map(lambda x: x[s], carry)
            for name, a in zip(ref_loop.env_state._fields, ref_loop.env_state):
                np.testing.assert_array_equal(getattr(loop.env_state, name)[s].numpy(),
                                              np.asarray(a), err_msg=f"{what}: slot {s} {name}")
            for name in ("obs_stack", "ep_return", "finished_sum", "finished_n"):
                np.testing.assert_array_equal(getattr(loop, name)[s].numpy(),
                                              np.asarray(getattr(ref_loop, name)),
                                              err_msg=f"{what}: slot {s} {name}")
            params, opt = bucket.learner
            for name in params:
                want = np.asarray(learner[0][name][s])
                acc = np.asarray(learner[1].acc1[name][s])
                if name in network.LINEAR:
                    want, acc = want.T, acc.T
                np.testing.assert_allclose(params[name][s].numpy(), want, atol=NET_ATOL, rtol=0,
                                           err_msg=f"{what}: slot {s} {name}")
                np.testing.assert_allclose(opt.acc1[name][s].numpy(), acc, atol=NET_ATOL,
                                           rtol=0, err_msg=f"{what}: slot {s} acc {name}")
            # a slot's squared gradients summed over every weight: with the
            # clip engaged, CLIP^2 a step on both sides if each slot clips by
            # its own norm (each weight's share is below NET_ATOL)
            ours = sum(float(opt.acc1[n][s].double().sum()) for n in params)
            want = sum(float(np.asarray(learner[1].acc1[n][s], np.float64).sum())
                       for n in params)
            assert ours == pytest.approx(want, rel=1e-4), (what, s, ours, want)
    assert len(updates.calls) == 3
    if masked:
        for before, after in zip(frozen, bucket.leaves):
            if before is not None:
                assert torch.equal(after[0], before)
        assert torch.equal(gens[0].get_state(), frozen_gen)
        assert bucket.carry[1][0] is gens[0]


def test_slot_matches_the_same_trial_trained_alone(monkeypatch):
    """Slot s of a capacity-3 bucket against a lone ``GA3CTrainer`` of the
    same seed: the same draws, so the same actions, and weights within
    NET_ATOL after 3 updates."""
    hps = [dict(learning_rate=lr, gamma=g, t_max=T_MAX, beta=b)
           for lr, g, b in ((3e-3, 0.9, 0.01), (1e-3, 0.99, 0.03), (2e-3, 0.95, 0.0))]
    engine = _engine(3, n_envs=N_ENVS)
    engine._admit_grouped([TrialLease(i, hp) for i, hp in enumerate(hps)], now=0.0)
    bucket = engine.buckets[T_MAX]
    assert bucket.capacity == 3
    alone = [ga3c.GA3CTrainer("pong", ga3c.GA3CHyperParams(**hp), n_envs=N_ENVS,
                              seed=ga3c.trial_seed(0, hp), device="cpu") for hp in hps]
    updates = Recorder(monkeypatch, "ga3c_update_slots")
    for u in range(3):
        bucket.step()
        traj = updates.calls[-1][0]
        for s, tr in enumerate(alone):
            t_alone, _ = tr.step()
            for f in ("actions", "rewards", "dones"):
                assert torch.equal(getattr(traj, f)[s], getattr(t_alone, f)), (u, s, f)
    params = _params(bucket)
    for s, tr in enumerate(alone):
        for name, p in tr.net.named_parameters():
            np.testing.assert_allclose(params[name][s].numpy(), p.detach().numpy(),
                                       atol=NET_ATOL, rtol=0, err_msg=f"slot {s} {name}")
        np.testing.assert_array_equal(bucket.carry[0].finished_n[s].numpy(),
                                      tr.loop.finished_n.numpy())


# ---------------------------------------------------------------------------
# the reference's engine tests (tests/test_population.py)
# ---------------------------------------------------------------------------
def _one_trial_metrics(objective):
    policy = RandomSearchPolicy(SearchSpace({}), 1, 2, configs=[dict(HP)])
    engine = PopulationEngine(objective, max_slots=1, n_envs=4, episodes_per_phase=4,
                              max_updates=40, seed=0, device="cpu")
    records = engine.run(LocalDriver(OptimizationService(policy)))
    return [r[5] for r in sorted(records, key=lambda r: r[2])], engine


def test_single_slot_parity_bit_for_bit():
    """A population of one reproduces the thread backend's GA3CTrainer
    phase metrics exactly: the same seed, the trainer's own update."""
    objective = ga3c.make_rl_objective("pong", episodes_per_phase=4, n_envs=4, seed=0,
                                       max_updates=40, device="cpu")
    state, ref = None, []
    for phase in range(2):
        metric, state = objective(HP, phase, state)
        ref.append(metric)
    got, engine = _one_trial_metrics("pong")
    assert got == ref                      # bit-for-bit, not approx
    assert engine.total_updates == state.updates
    params = _params(engine.buckets[8])
    for name, p in state.net.named_parameters():
        assert torch.equal(params[name][0], p.detach()), name


def test_eviction_masks_slot_and_hotswap_reseeds():
    """An evicted slot's weights freeze (left out of the update) until the
    next configuration is hot-swapped into the freed slot."""
    engine = _engine(2)
    engine.admit(TrialLease(0, {"learning_rate": 1e-3, "t_max": 4, "gamma": 0.99}))
    engine.admit(TrialLease(1, {"learning_rate": 2e-3, "t_max": 4, "gamma": 0.995}))
    bucket = engine.buckets[4]
    assert bucket.capacity == 2 and bucket.n_active == 2

    bucket.step()
    frozen = _slot(_params(bucket), 0)
    bucket.release(0)                      # eviction = mask
    assert bucket.n_active == 1
    live = _slot(_params(bucket), 1)
    bucket.step()
    assert _max_delta(_slot(_params(bucket), 0), frozen) == 0   # masked slot did not train

    engine.admit(TrialLease(2, {"learning_rate": 5e-4, "t_max": 4, "gamma": 0.99}))
    assert bucket.n_active == 2 and bucket.meta[0].trial_id == 2
    reseeded = _slot(_params(bucket), 0)
    assert _max_delta(reseeded, frozen) > 0       # fresh init, not the old weights
    bucket.step()                                 # the swapped slot trains again
    assert _max_delta(_slot(_params(bucket), 0), reseeded) > 0
    assert _max_delta(_slot(_params(bucket), 1), live) > 0    # the live slot kept training


def test_tmax_bucketing_and_growth():
    """Distinct t_max values land in distinct buckets; same t_max shares a
    bucket, growing it as needed."""
    engine = _engine(3)
    engine._admit_grouped(
        [TrialLease(0, {"learning_rate": 1e-3, "t_max": 4, "gamma": 0.99}),
         TrialLease(1, {"learning_rate": 1e-3, "t_max": 8, "gamma": 0.99}),
         TrialLease(2, {"learning_rate": 2e-3, "t_max": 4, "gamma": 0.99})], now=0.0)
    assert sorted(engine.buckets) == [4, 8]
    assert engine.buckets[4].capacity == 2
    assert engine.buckets[8].capacity == 1
    assert engine.n_active == 3
    for bucket in engine.buckets.values():
        bucket.step()                      # both shapes run
    assert sorted(engine.active_trial_ids()) == [0, 1, 2]
    # growth: one bucket of one slot becomes a stack of two, padded
    bucket = engine.buckets[8]
    before = _slot(_params(bucket), 0)
    engine.admit(TrialLease(3, {"learning_rate": 1e-3, "t_max": 8, "gamma": 0.9}))
    assert bucket.capacity == 2 and bucket.n_active == 2
    assert _max_delta(_slot(_params(bucket), 0), before) == 0
    bucket.step()
    assert _max_delta(_slot(_params(bucket), 0), before) > 0
    assert bucket.carry[0].finished_n.shape == (2,)


def test_vectorized_hypertrick_end_to_end():
    """A full (tiny) HyperTrick search on the vectorized backend produces
    the same summary schema as every other backend."""
    policy = HyperTrick(paper_rl_space(), 4, 2, 0.25, seed=0)
    res = PopulationCluster(4, game="pong", episodes_per_phase=2, n_envs=4,
                            max_updates=10, seed=0, device="cpu").run(policy)
    s = res.summary()
    assert s["n_trials"] == 4
    assert s["best_metric"] is not None
    assert res.env_steps and res.env_steps > 0 and res.updates > 0
    assert all(r.metric == r.metric for r in res.records)  # no NaN scores


def test_objective_registry_matches_string_construction():
    """An engine built from ``get_objective("ga3c", ...)`` reproduces the
    game-string path bit for bit on identical leases."""
    ref, _ = _one_trial_metrics("pong")
    got, _ = _one_trial_metrics(objectives.get_objective("ga3c", game="pong", n_envs=4,
                                                         device="cpu"))
    assert got == ref                      # bit-for-bit, not approx


def test_objective_specs_are_the_reference_specs():
    for name in ("ga3c", "rl", "lm", "synthetic"):
        assert (dataclasses.asdict(objectives.spec_for(name))
                == dataclasses.asdict(ref_objectives.spec_for(name))), name
    obj = objectives.objective_from_spec({"kind": "rl", "game": "boxing", "n_envs": 3,
                                          "device": "cpu", "episodes_per_phase": 5})
    assert (obj.game, obj.n_envs, obj.update_cost(6)) == ("boxing", 3, 18)
    ref = RefGA3C("boxing", n_envs=3)
    hp = {"learning_rate": 1e-3, "gamma": 0.9, "t_max": 6}
    assert obj.bucket_key(hp) == ref.bucket_key(hp) and obj.cache_key() == ref.cache_key()
    assert obj.traced_values(hp) == ref.traced_values(hp)
    lm = objectives.objective_from_spec({"kind": "lm", "arch": "gemma2-2b", "seq": 8,
                                         "device": "cpu"})
    ref_lm = ref_objectives.objective_from_spec({"kind": "lm", "arch": "gemma2-2b", "seq": 8})
    hp = {"learning_rate": 1e-3, "loss_chunk": 256, "grad_clip": 0.5}
    assert lm.bucket_key(hp) == ref_lm.bucket_key(hp) and lm.cache_key() == ref_lm.cache_key()
    assert lm.traced_values(hp) == ref_lm.traced_values(hp)


# ---------------------------------------------------------------------------
# rungs (tests/test_population_sharded.py, test_bracket_barrier.py,
# test_scheduler.py)
# ---------------------------------------------------------------------------
def test_rung_demotion_frees_exactly_bottom_one_over_eta():
    """At a rung barrier the engine demotes exactly ``n // eta`` slots, the
    cohort's bottom metrics; freed slots are hot-swapped with the rest of
    the budget."""
    policy = RandomSearchPolicy(_tiny_space(), 8, 2, seed=0)
    res = PopulationCluster(6, game="pong", episodes_per_phase=2, n_envs=2,
                            max_updates=5, seed=0, bracket_eta=3, device="cpu").run(policy)
    s = res.summary()
    first = s["rungs"][0]
    assert first["phase"] == 0 and first["n"] == 6
    assert len(first["demoted"]) == 6 // 3          # exactly bottom 1/eta
    cohort = [(r.metric, r.trial_id) for r in res.records
              if r.phase == 0 and r.trial_id in set(first["demoted"]) | set(first["promoted"])]
    ranked = [tid for _, tid in sorted(cohort, key=lambda p: p[0])]
    assert set(first["demoted"]) == set(ranked[:2])
    for tid in first["demoted"]:
        assert res.service.db.trials[tid].status is TrialStatus.KILLED
    assert s["n_trials"] == 8                       # 6 initial + 2 refills
    assert s["bracket"]["n"][0] == 6
    assert 0 < s["bracket_alpha"] <= 1


def test_bracket_end_to_end_summary():
    """A bracket search over the real RL space completes and the summary
    carries the rung log (promotions visible)."""
    policy = RandomSearchPolicy(paper_rl_space(), 4, 3, seed=0)
    res = PopulationCluster(4, game="pong", episodes_per_phase=2, n_envs=4,
                            max_updates=8, seed=0, bracket_eta=3, device="cpu").run(policy)
    s = res.summary()
    assert s["n_trials"] == 4
    assert s["rungs"] and s["rungs"][0]["promoted"]
    assert s["by_status"].get("killed", 0) == sum(len(r["demoted"]) for r in s["rungs"])
    assert s["best_metric"] is not None


def test_engine_abandons_parked_slot_and_drops_pending_report():
    """Lease loss while a slot is parked at a rung: ``_abandon`` frees the
    slot and drops the withheld report, and the slot is admittable again."""
    engine = _engine(2, bracket_eta=3)
    hp = {"learning_rate": 1e-3, "t_max": 4, "gamma": 0.99}
    engine.admit(TrialLease(0, dict(hp)))
    engine.admit(TrialLease(1, dict(hp)))
    bucket = engine.buckets[4]
    bucket.meta[0].pending = (1.5, 0.0, 1.0, 8)
    bucket.park(0)
    assert engine._any_parked() and engine.n_occupied == 2
    engine._abandon({0})
    assert not engine._any_parked()
    assert engine.n_occupied == 1
    assert bucket.meta[0] is None
    assert engine.records == []
    engine.admit(TrialLease(2, dict(hp)))
    assert bucket.meta[0].trial_id == 2 and bucket.n_active == 2


def test_engine_speculative_refill_overlaps_barrier_wait():
    """Once every local slot is parked at the barrier, the engine acquires
    the entrants its demotions will make room for BEFORE the verdict polls
    deliver."""

    class ScriptedDriver:
        """3-slot bracket, eta 3: parks trials 0-2 at phase 0, withholds
        verdicts until the engine has acquired the speculative entrant,
        then demotes trial 0."""

        def __init__(self):
            self.granted = 0
            self.parked = set()
            self.speculative_acquires = 0
            self.resolved = False

        def acquire_many(self, k, rung=None):
            assert rung == 0                     # bracket participants hint
            if len(self.parked) == 3 and not self.resolved:
                self.speculative_acquires += 1
            leases = []
            for _ in range(min(k, 4 - self.granted)):
                leases.append(TrialLease(self.granted, {"learning_rate": 1e-3, "t_max": 4,
                                                        "gamma": 0.99}, 2))
                self.granted += 1
            return leases, None

        def report(self, tid, phase, metric, ts, te, env_steps=None):
            if phase == 0 and tid < 3:
                self.parked.add(tid)
                if self.speculative_acquires:    # entrant already granted
                    self.resolved = True
                    return "stop" if tid == 0 else "continue"
                return "parked"
            return "stop" if phase >= 1 else "continue"

        def poll_lost(self):
            return set()

    engine = _engine(3, episodes_per_phase=1, max_updates=1, bracket_eta=3)
    engine.park_poll_interval = 0.0
    driver = ScriptedDriver()
    engine.run(driver)
    assert driver.speculative_acquires >= 1      # acquired while parked
    assert engine.speculated == 1                # exactly n // eta = 1
    assert driver.granted == 4                   # 3 initial + 1 speculative


def test_population_cluster_refuses_several_devices():
    with pytest.raises(NotImplementedError, match="not owed on one card"):
        PopulationCluster(2, devices=2, device="cpu")
