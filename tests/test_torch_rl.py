"""GA3C, port against reference: the four mini-games step by step, the net,
the n-step returns, the A3C loss and its gradients, the rollout and one full
GA3C update.

torch cannot reproduce ``jax.random`` streams, so the port's envs and
rollout take their random draws as inputs. These tests derive the draws
from the reference's keys, split exactly as ``init_loop_state``,
``rollout``, ``auto_reset`` and each env's ``reset`` / ``step`` split them,
and feed them to the port: states, observations, rewards, dones, actions
and trajectories must then be equal, not close."""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.rl import a3c as ref_a3c  # noqa: E402
from repro.rl import ga3c as ref_ga3c  # noqa: E402
from repro.rl import network as ref_net  # noqa: E402
from repro.rl.envs import base as ref_base  # noqa: E402
from repro.rl.envs import minigames as ref_games  # noqa: E402
from repro_torch.models.convert import a3c_params_from_numpy  # noqa: E402
from repro_torch.rl import a3c, ga3c, network  # noqa: E402
from repro_torch.rl.envs import base, minigames  # noqa: E402

G = ref_games.G
GAMES = sorted(ref_games.GAMES)
# the net's outputs and gradients: f32, the convolutions summed in another
# order (XLA's convolution against a copy of the windows and a matmul)
NET_ATOL = 1e-5
PONG_VY = jnp.array([-1.0, -0.5, 0.5, 1.0])
PONG_VX = jnp.array([-1.0, 1.0])


# ---------------------------------------------------------------------------
# the reference's draws, from its keys
# ---------------------------------------------------------------------------
def _reset_draws_of(game, key):
    """What ``reset(key)`` of ``game`` draws, as the port takes it."""
    if game == "pong":
        ky, kv = jax.random.split(key)
        vy = jax.random.choice(ky, PONG_VY)
        vx = jax.random.choice(kv, PONG_VX)
        return (jnp.argmax(PONG_VY == vy), jnp.argmax(PONG_VX == vx))
    if game == "boxing":
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, (2,)), jax.random.uniform(k2, (2,)))
    if game == "centipede":
        return (jax.random.uniform(key, (G,)),)
    return (jax.random.uniform(key, (G, G)),)


def _step_draws_of(game, key):
    """What ``step(state, action, key)`` of ``game`` draws."""
    if game == "pong":
        return ()
    if game == "boxing":
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, (2,), minval=-0.5, maxval=0.5), jax.random.uniform(k2))
    if game == "centipede":
        return (jax.random.uniform(jax.random.fold_in(key, 7), (G,)),)
    k1, k2 = jax.random.split(key)
    return (jax.random.randint(k1, (), 1, 5), jax.random.uniform(k2))


class RefDraws:
    """Batched draw makers of one game: ``reset(keys)`` / ``step(keys)`` for
    one key an env; ``auto_reset(keys)`` the (step, reset) draws of the
    reference's ``auto_reset``, which splits each env's key in two."""

    def __init__(self, game):
        self._reset = jax.jit(jax.vmap(partial(_reset_draws_of, game)))
        self._step = jax.jit(jax.vmap(partial(_step_draws_of, game)))
        gen, env = torch.Generator(), minigames.make_env(game, "cpu")
        self._reset_cls = type(env.reset_draws(gen, 1))
        self._step_cls = type(env.step_draws(gen, 1))

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def of(game):
        """One maker a game for the whole module: each compiles its draws once."""
        return RefDraws(game)

    @staticmethod
    def _port(cls, arrays):
        return cls(*(torch.from_numpy(np.array(a)) for a in arrays))

    def reset(self, keys):
        return self._port(self._reset_cls, self._reset(keys))

    def step(self, keys):
        return self._port(self._step_cls, self._step(keys))

    def auto_reset(self, keys):
        ks = jax.vmap(jax.random.split)(keys)
        return self.step(ks[:, 0]), self.reset(ks[:, 1])


def _stack_draws(draws):
    """A list of one step's draws -> the draws with a leading step axis."""
    return type(draws[0])(*(torch.stack(f) for f in zip(*draws)))


def _assert_state_equal(ref, ours, what):
    assert ours._fields == ref._fields, what
    for name, a, b in zip(ref._fields, ref, ours):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}")


def _state_from_ref(ref_state, port_state_cls, like):
    """The reference's state as the port's, each field in the port's dtype."""
    return port_state_cls(*(torch.from_numpy(np.array(a)).to(b.dtype)
                            for a, b in zip(ref_state, like)))


# ---------------------------------------------------------------------------
# (a) the envs, step by step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("game", GAMES)
def test_env_matches_reference_step_by_step(game):
    """reset, then 40 steps of auto_reset on 8 envs with numpy-drawn
    actions. The episodes start 12 to 33 steps short of the game's step
    limit, so every env ends at least one episode (by the limit, a score or
    a capture) and the reset branch is taken."""
    n, steps = 8, 40
    ref_env, env = ref_games.make_env(game), minigames.make_env(game, "cpu")
    draws = RefDraws.of(game)
    ref_reset = jax.jit(jax.vmap(ref_env.reset))
    ref_step = jax.jit(jax.vmap(partial(ref_base.auto_reset, ref_env)))
    rng = np.random.default_rng(0)
    key, k0 = jax.random.split(jax.random.PRNGKey(3))
    keys = jax.random.split(k0, n)
    rs, robs = ref_reset(keys)
    st, obs = env.reset(draws.reset(keys))
    _assert_state_equal(rs, st, f"{game} reset")
    np.testing.assert_array_equal(obs.numpy(), np.asarray(robs))
    t0 = ref_env.spec.max_steps - 12 - 3 * np.arange(n, dtype=np.int32)
    rs = rs._replace(t=jnp.asarray(t0))
    st = st._replace(t=torch.from_numpy(t0))
    ends = 0
    for t in range(steps):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, n)
        acts = rng.integers(0, ref_env.spec.n_actions, n)
        rs, robs, rr, rd = ref_step(rs, jnp.asarray(acts, jnp.int32), keys)
        st, obs, r, d = base.auto_reset(env, st, torch.from_numpy(acts), *draws.auto_reset(keys))
        what = f"{game} step {t}"
        _assert_state_equal(rs, st, what)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(robs), err_msg=what)
        np.testing.assert_array_equal(r.numpy(), np.asarray(rr), err_msg=what)
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd), err_msg=what)
        assert obs.dtype == torch.float32 and r.dtype == torch.float32
        assert 0.0 <= float(obs.min()) and float(obs.max()) <= 1.0
        ends += int(d.sum())
    assert ends >= n, (game, ends)


@pytest.mark.parametrize("game", GAMES)
def test_env_draws_have_the_reference_shapes_and_ranges(game):
    env = minigames.make_env(game, "cpu")
    gen = torch.Generator().manual_seed(0)
    key = jax.random.split(jax.random.PRNGKey(0), 5)
    draws = RefDraws.of(game)
    for mine, ref in ((env.reset_draws(gen, 5), draws.reset(key)),
                      (env.step_draws(gen, 5), draws.step(key))):
        assert type(mine) is type(ref)
        for a, b in zip(mine, ref):
            assert a.shape == b.shape and a.dtype.is_floating_point == b.dtype.is_floating_point
    big = env.step_draws(gen, (3, 4000))
    if game == "boxing":
        assert -0.5 <= float(big.jitter.min()) and float(big.jitter.max()) < 0.5
    if game == "pacman":
        assert set(big.move.unique().tolist()) == {1, 2, 3, 4}
    if game == "pong":
        r = env.reset_draws(gen, (3, 4000))
        assert set(r.vy.unique().tolist()) == {0, 1, 2, 3} and set(r.vx.unique().tolist()) == {0, 1}


def test_shooter_fires_the_first_free_slot():
    """argmax over the free slots (cast from bool, which CUDA's argmax does
    not take) must pick the first one, as the reference's does."""
    env = minigames.make_env("centipede", "cpu")
    st, _ = env.reset(minigames.ShooterResetDraws(torch.zeros(3, G)))
    by = torch.tensor([[5.0, -1.0, -1.0, 3.0], [-1.0, 2.0, 4.0, -1.0], [2.0, 3.0, 4.0, 5.0]])
    st = st._replace(bullets=torch.stack([by, torch.full_like(by, 7.0)], -1))
    st2, *_ = env.step(st, torch.tensor([3, 3, 3]), minigames.ShooterStepDraws(torch.ones(3, G)))
    fired = st2.bullets[..., 0] == G - 2.0
    assert fired.tolist() == [[False, True, False, False], [True, False, False, False],
                              [False, False, False, False]]


def test_maze_paints_the_ghost_over_the_agent():
    env = minigames.make_env("pacman", "cpu")
    st, _ = env.reset(minigames.MazeResetDraws(torch.ones(1, G, G)))
    st = st._replace(me=torch.tensor([[3, 4]]), ghost=torch.tensor([[3, 4]]))
    assert float(env._obs(st)[0, 3, 4]) == pytest.approx(0.6)


# ---------------------------------------------------------------------------
# (b) the net
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_tree(n_actions, seed):
    cfg = ref_net.A3CNetConfig(grid=G, n_actions=n_actions)
    return jax.tree.map(np.asarray, ref_net.init_net(cfg, jax.random.PRNGKey(seed)))


def _nets(n_actions, seed=0):
    """The reference's weights (numpy) and the port's net holding them."""
    tree = _ref_tree(n_actions, seed)
    port_cfg = network.A3CNetConfig(grid=G, n_actions=n_actions)
    return tree, a3c_params_from_numpy(tree, port_cfg, "cpu")


@pytest.mark.parametrize("n_actions", [3, 4, 5, 6])
def test_net_matches_reference(n_actions):
    tree, net = _nets(n_actions)
    obs = np.random.default_rng(n_actions).random((5, 2, G, G), dtype=np.float32)
    logits, value = ref_net.apply_net(tree, jnp.asarray(obs))
    with torch.no_grad():
        ours_l, ours_v = net(torch.from_numpy(obs))
    assert ours_l.shape == (5, n_actions) and ours_v.shape == (5,)
    np.testing.assert_allclose(ours_l.numpy(), np.asarray(logits), atol=NET_ATOL, rtol=0)
    np.testing.assert_allclose(ours_v.numpy(), np.asarray(value), atol=NET_ATOL, rtol=0)


def test_net_init_follows_the_reference_scheme():
    gen = torch.Generator().manual_seed(0)
    net = network.A3CNet(network.A3CNetConfig(n_actions=6), gen)
    tree, _ = _nets(6)
    for name, p in net.named_parameters():
        ref = tree[name].T if name in network.LINEAR else tree[name]
        assert p.shape == ref.shape, name
        if name.endswith("b"):
            assert not p.detach().any(), name
        else:      # He: std sqrt(2 / fan_in), the policy head x 0.01
            fan_in = int(np.prod(p.shape[1:]))
            want = np.sqrt(2.0 / fan_in) * (0.01 if name == "pw" else 1.0)
            assert 0.6 * want < float(p.detach().std()) < 1.4 * want, name


def test_a3c_params_from_numpy_refuses_a_wrong_tree():
    tree, _ = _nets(4)
    cfg = network.A3CNetConfig(n_actions=4)
    with pytest.raises(ValueError, match="keys"):
        a3c_params_from_numpy({k: v for k, v in tree.items() if k != "vb"}, cfg, "cpu")
    with pytest.raises(ValueError, match="fcw"):
        a3c_params_from_numpy({**tree, "fcw": tree["fcw"].T}, cfg, "cpu")


# ---------------------------------------------------------------------------
# (c) n-step returns
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gamma", [0.0, 0.5, 0.9, 0.99, 0.9999])
@pytest.mark.parametrize("dones", ["none", "first", "last", "all", "random"])
def test_n_step_returns_match_reference(gamma, dones):
    T, B = 7, 5
    rng = np.random.default_rng(int(gamma * 1e4))
    r = rng.standard_normal((T, B)).astype(np.float32)
    step = np.arange(T)[:, None] + np.zeros((1, B))
    d = {"none": step < 0, "all": step >= 0, "first": step == 0, "last": step == T - 1,
         "random": rng.random((T, B)) < 0.3}[dones].astype(np.float32)
    v = rng.standard_normal(B).astype(np.float32)
    ref = ref_a3c.n_step_returns(jnp.asarray(r), jnp.asarray(d), jnp.asarray(v), gamma)
    ours = a3c.n_step_returns(torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(v), gamma)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_n_step_returns_by_hand():
    out = a3c.n_step_returns(torch.tensor([[2.0], [0.0], [1.0]]), torch.zeros(3, 1),
                             torch.tensor([8.0]), 0.5)
    assert out[:, 0].tolist() == [3.25, 2.5, 5.0]
    out = a3c.n_step_returns(torch.tensor([[1.0], [1.0]]), torch.tensor([[1.0], [0.0]]),
                             torch.tensor([100.0]), 0.9)
    np.testing.assert_allclose(out[:, 0].numpy(), [1.0, 91.0])


# ---------------------------------------------------------------------------
# (d) the loss and its gradients
# ---------------------------------------------------------------------------
def _trajectory(T, B, A, seed):
    rng = np.random.default_rng(seed)
    obs = rng.random((T, B, 2, G, G), dtype=np.float32)
    return (obs, rng.integers(0, A, (T, B)).astype(np.int32),
            rng.integers(-1, 2, (T, B)).astype(np.float32),
            (rng.random((T, B)) < 0.2).astype(np.float32),
            rng.standard_normal(B).astype(np.float32))


@pytest.mark.parametrize("gamma,beta,A", [(0.99, 0.01, 3), (0.9, 0.05, 6), (0.5, 0.0, 4)])
def test_a3c_loss_and_gradients_match_reference(gamma, beta, A):
    T, B = 6, 4
    obs, acts, rew, dones, v_boot = _trajectory(T, B, A, seed=A)
    tree, net = _nets(A, seed=A)
    ref_traj = ref_a3c.Trajectory(jnp.asarray(obs), jnp.asarray(acts), jnp.asarray(rew),
                                  jnp.asarray(dones))
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda p: ref_a3c.a3c_loss(p, ref_traj, jnp.asarray(v_boot), gamma=gamma, beta=beta),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    traj = a3c.Trajectory(torch.from_numpy(obs), torch.from_numpy(acts).long(),
                          torch.from_numpy(rew), torch.from_numpy(dones))
    loss, m = a3c.a3c_loss(net, traj, torch.from_numpy(v_boot), gamma=gamma, beta=beta)
    names, params = zip(*net.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), atol=NET_ATOL, rtol=NET_ATOL)
    assert set(m) == set(ref_m) == {"policy_loss", "value_loss", "entropy"}
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()), float(ref_m[k]), atol=NET_ATOL, rtol=NET_ATOL,
                                   err_msg=k)
    assert set(grads) == set(ref_g)
    for name, g in grads.items():
        want = np.asarray(ref_g[name])
        want = want.T if name in network.LINEAR else want
        np.testing.assert_allclose(g.numpy(), want, atol=NET_ATOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# (e) the rollout
# ---------------------------------------------------------------------------
def _loop_from_ref(ref_loop, env, n):
    like, _ = env.reset(env.reset_draws(torch.Generator(), n))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return a3c.LoopState(_state_from_ref(ref_loop.env_state, type(like), like),
                         t(ref_loop.obs_stack), t(ref_loop.ep_return),
                         t(ref_loop.finished_sum), t(ref_loop.finished_n))


def _rollout_draws_of(ref_loop_rng, t_max, n, n_actions, draws):
    """What the reference's rollout draws from the loop's key, step by
    step: the Gumbel noise of ``categorical`` and each env's auto_reset."""
    rng, gs, steps, resets = ref_loop_rng, [], [], []
    for _ in range(t_max):
        rng, k_act, k_env = jax.random.split(rng, 3)
        gs.append(torch.from_numpy(np.array(jax.random.gumbel(k_act, (n, n_actions)))))
        s, r = draws.auto_reset(jax.random.split(k_env, n))
        steps.append(s)
        resets.append(r)
    return a3c.RolloutDraws(torch.stack(gs), _stack_draws(steps), _stack_draws(resets))


def _assert_loop_equal(ref, ours, what):
    _assert_state_equal(ref.env_state, ours.env_state, what)
    for name in ("obs_stack", "ep_return", "finished_sum", "finished_n"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("game", ["pong", "pacman"])
@pytest.mark.parametrize("t_max", [2, 7])
def test_rollout_matches_reference(game, t_max):
    n = 6
    ref_env, env = ref_games.make_env(game), minigames.make_env(game, "cpu")
    A = env.spec.n_actions
    tree, net = _nets(A, seed=1)
    ref_loop = ref_a3c.init_loop_state(ref_env, n, jax.random.PRNGKey(5))
    draws = RefDraws.of(game)
    loop = _loop_from_ref(ref_loop, env, n)
    ref_traj, ref_new = ref_a3c.rollout(ref_env, tree, ref_loop, t_max)
    traj, new = a3c.rollout(env, net, loop, t_max,
                            _rollout_draws_of(ref_loop.rng, t_max, n, A, draws))
    assert traj.obs.shape == (t_max, n, 2, G, G) and traj.obs.shape[0] == t_max
    for name in ref_a3c.Trajectory._fields:
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(ref_traj, name)), err_msg=name)
    _assert_loop_equal(ref_new, new, f"{game} t_max {t_max}")


def test_init_loop_state_matches_reference():
    n = 5
    ref_env, env = ref_games.make_env("boxing"), minigames.make_env("boxing", "cpu")
    ref_loop = ref_a3c.init_loop_state(ref_env, n, jax.random.PRNGKey(2))
    rngs = jax.random.split(jax.random.PRNGKey(2), n + 1)
    loop = a3c.init_loop_state(env, RefDraws.of("boxing").reset(rngs[1:]))
    _assert_loop_equal(ref_loop, loop, "init")


# ---------------------------------------------------------------------------
# (f) one full GA3C update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("game,t_max", [("boxing", 5), ("centipede", 3)])
def test_ga3c_update_matches_reference_jitted_step(game, t_max):
    n = 8
    hp = dict(learning_rate=3e-3, gamma=0.95, t_max=t_max, beta=0.02)
    ref = ref_ga3c.GA3CTrainer(game, ref_ga3c.GA3CHyperParams(**hp), n_envs=n, seed=4)
    ours = ga3c.GA3CTrainer(game, ga3c.GA3CHyperParams(**hp), n_envs=n, seed=0, device="cpu")
    ours.net = a3c_params_from_numpy(jax.tree.map(np.asarray, ref.params), ours.net.cfg, "cpu")
    ours.loop = _loop_from_ref(ref.loop, ours.env, n)
    draws = RefDraws.of(game)
    params, opt, loop = ref.params, ref.opt_state, ref.loop
    for update in range(2):
        d = _rollout_draws_of(loop.rng, t_max, n, ours.env.spec.n_actions, draws)
        params, opt, loop, ref_m = ref._step(params, opt, loop)
        traj, m = ours.step(d)
        what = f"{game} update {update}"
        _assert_loop_equal(loop, ours.loop, what)
        for k in ("policy_loss", "value_loss", "entropy", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), atol=NET_ATOL,
                                       rtol=NET_ATOL, err_msg=f"{what}: {k}")
        for name, p in ours.net.named_parameters():
            want = np.asarray(params[name])
            want = want.T if name in network.LINEAR else want
            np.testing.assert_allclose(p.detach().numpy(), want, atol=NET_ATOL, rtol=0,
                                       err_msg=f"{what}: {name}")
            acc = np.asarray(opt.acc1[name])
            np.testing.assert_allclose(ours.opt_state.acc1[name].numpy(),
                                       acc.T if name in network.LINEAR else acc,
                                       atol=NET_ATOL, rtol=1e-4, err_msg=f"{what}: acc {name}")
    assert ours.updates == 2 and ours.env_steps == 2 * t_max * n


def test_trial_seed_is_the_reference_formula():
    for hp in ({"learning_rate": 1e-3, "gamma": 0.99, "t_max": 5}, {"x": 2.0}, {}):
        for seed in (0, 7):
            assert ga3c.trial_seed(seed, hp) == ref_ga3c.trial_seed(seed, hp)
    tc = ga3c.ga3c_train_config(2e-4)
    ref_tc = ref_ga3c.ga3c_train_config(2e-4)
    for f in ("learning_rate", "optimizer", "rmsprop_decay", "rmsprop_eps", "grad_clip",
              "warmup_steps"):
        assert getattr(tc, f) == getattr(ref_tc, f), f


def test_trainers_on_one_draw_see_the_same_draws():
    """``init_device`` draws the weights and every rollout draw there: two
    trainers of one seed take the same updates, whatever their devices."""
    hp = ga3c.GA3CHyperParams(learning_rate=1e-3, t_max=4)
    a = ga3c.GA3CTrainer("boxing", hp, n_envs=4, seed=3, device="cpu", init_device="cpu")
    b = ga3c.GA3CTrainer("boxing", hp, n_envs=4, seed=3, device="cpu")
    for _ in range(3):
        (ta, ma), (tb, mb) = a.step(), b.step()
        assert torch.equal(ta.actions, tb.actions) and torch.equal(ta.rewards, tb.rewards)
        assert float(ma["loss"]) == float(mb["loss"])
