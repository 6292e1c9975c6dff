"""GA3C (port of ``repro/rl/ga3c.py``): the prediction/training queues of the
GPU implementation dissolve because environments are on the device —
simulation, batched inference and the update of ``n_envs`` vectorized agents
form one train step. Hyperparameter semantics (lr, gamma, t_max, beta) are
preserved exactly.

Each trainer holds its own ``torch.Generator``, seeded by ``trial_seed``,
which draws the weights and then every update's rollout draws
(``a3c.rollout_draws``). With ``init_device`` set, the generator lives there
and its draws are copied to ``device``: two trainers on two devices then
start alike and see the same draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import apply_updates, apply_updates_slots, init_opt_state
from repro_torch.rl.a3c import (a3c_loss, a3c_loss_slots, init_loop_state, rollout,
                                rollout_draws, rollout_slots)
from repro_torch.rl.envs.base import draws_to
from repro_torch.rl.envs.minigames import make_env
from repro_torch.rl.network import A3CNet, A3CNetConfig, apply_net, apply_net_slots


@dataclass
class GA3CHyperParams:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    t_max: int = 8
    beta: float = 0.01


def trial_seed(base_seed: int, hparams: dict) -> int:
    """Per-trial seed derivation, the reference's: Python's ``str`` hash is
    salted per process, so a trial's seed is stable within one process
    only (unless PYTHONHASHSEED is pinned)."""
    return base_seed + hash(str(sorted(hparams.items()))) % 10_000


def ga3c_train_config(learning_rate: float) -> TrainConfig:
    """The paper's GA3C optimizer settings (shared-statistics RMSProp)."""
    return TrainConfig(learning_rate=learning_rate, optimizer="rmsprop",
                       rmsprop_decay=0.99, rmsprop_eps=0.1, grad_clip=5.0)


def ga3c_update(env, tc: TrainConfig, params: dict, opt_state, loop, draws, *, gamma, beta,
                lr=None):
    """One GA3C update of one trial (``GA3CTrainer.step``'s body): a t_max
    rollout on ``draws``, the bootstrap, the A3C gradient and RMSProp.
    ``params`` maps names to weights that require grad; they and the
    accumulators are updated in place. ``lr`` overrides ``tc``'s. Returns
    (trajectory, loop state, optimizer state, metrics on the device)."""
    net = partial(apply_net, params)
    traj, loop = rollout(env, net, loop, draws.gumbel.shape[0], draws)
    with torch.no_grad():
        _, v_boot = net(loop.obs_stack)
        v_boot = v_boot * (1.0 - traj.dones[-1])
    loss, metrics = a3c_loss(net, traj, v_boot, gamma=gamma, beta=beta)
    grads = torch.autograd.grad(loss, list(params.values()))
    _, opt_state, gn = apply_updates(tc, params, dict(zip(params, grads)), opt_state, lr=lr)
    return traj, loop, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in metrics.items()},
                                   "grad_norm": gn}


def ga3c_update_slots(env, tc: TrainConfig, params: dict, opt_state, loop, draws, *, gamma,
                      beta, lr):
    """``ga3c_update`` for S trials at once, each weight, accumulator and
    loop field with a leading slot axis and ``gamma`` / ``beta`` / ``lr``
    ``(S,)`` tensors; ``draws`` from ``a3c.stack_slot_draws``. One set of
    launches serves every slot (``rollout_slots``, ``a3c_loss_slots``,
    ``apply_updates_slots``); slot s's numbers are its own trial's, within
    the f32 rounding of another order of sums."""
    traj, loop = rollout_slots(env, params, loop, draws.gumbel.shape[0], draws)
    with torch.no_grad():
        _, v_boot = apply_net_slots(params, loop.obs_stack)
        v_boot = v_boot * (1.0 - traj.dones[:, -1])
    loss, metrics = a3c_loss_slots(params, traj, v_boot, gamma=gamma, beta=beta)
    grads = torch.autograd.grad(loss, list(params.values()))
    _, opt_state, gn = apply_updates_slots(tc, params, dict(zip(params, grads)), opt_state, lr)
    return traj, loop, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in metrics.items()},
                                   "grad_norm": gn}


class GA3CTrainer:
    """One GA3C worker: trains a policy on one game. ``run_episodes`` is the
    phase unit HyperTrick schedules (paper: 2500 episodes/phase)."""

    def __init__(self, game: str, hp: GA3CHyperParams, n_envs: int = 32, seed: int = 0,
                 device="cuda", init_device=None):
        self.device = resolve_device(device)
        init_dev = self.device if init_device is None else resolve_device(init_device)
        self.gen = torch.Generator(device=init_dev).manual_seed(seed)
        self.env = make_env(game, self.device)
        self.hp = hp
        self.n_envs = n_envs
        net_cfg = A3CNetConfig(grid=self.env.spec.grid, n_actions=self.env.spec.n_actions)
        self.net = A3CNet(net_cfg, self.gen).to(self.device)
        self.tc = ga3c_train_config(hp.learning_rate)
        self.opt_state = init_opt_state(self.tc, self.net)
        self.loop = init_loop_state(self.env, draws_to(
            self.env.reset_draws(self.gen, n_envs), self.device))
        self.episodes = 0
        self.updates = 0
        self._last_scores: list = []

    @property
    def env_steps(self) -> int:
        """Env transitions taken so far: updates x t_max x n_envs."""
        return self.updates * self.hp.t_max * self.n_envs

    def step(self, draws=None):
        """One update: a t_max rollout, the bootstrap, the A3C gradient and
        RMSProp. ``draws``: the rollout's ``RolloutDraws`` (by default the
        trainer's generator makes them). Returns (trajectory, metrics); the
        metrics stay on the device."""
        hp = self.hp
        if draws is None:
            draws = rollout_draws(self.env, self.gen, hp.t_max, self.n_envs, self.device)
        traj, self.loop, self.opt_state, metrics = ga3c_update(
            self.env, self.tc, dict(self.net.named_parameters()), self.opt_state, self.loop,
            draws, gamma=hp.gamma, beta=hp.beta)
        self.updates += 1
        return traj, metrics

    def run_episodes(self, n_episodes: int, max_updates: int = 10_000):
        """Train until n_episodes finish; returns the mean score of the
        episodes completed in this phase (the metric reported to the
        metaopt service). Reads the finished count on the host once an
        update, as the reference does."""
        start_sum = float(self.loop.finished_sum)
        start_n = float(self.loop.finished_n)
        updates = 0
        while (float(self.loop.finished_n) - start_n) < n_episodes and updates < max_updates:
            _, self._metrics = self.step()
            updates += 1
        n = float(self.loop.finished_n) - start_n
        s = float(self.loop.finished_sum) - start_sum
        self.episodes += int(n)
        score = s / max(n, 1.0)
        self._last_scores.append(score)
        return score


def make_rl_objective(game: str, episodes_per_phase: int, n_envs: int = 16, seed: int = 0,
                      max_updates: int = 2000, device="cuda"):
    """Objective for the thread executor: objective(hparams, phase, state)
    -> (metric, state). State carries the live trainer (no preemption needed
    — HyperTrick never pauses a worker). ``objective.trainers`` lists every
    trainer it built, in order, for the caller to count their updates."""
    trainers = []

    def objective(hparams: dict, phase: int, state):
        if state is None:
            hp = GA3CHyperParams(
                learning_rate=float(hparams["learning_rate"]),
                gamma=float(hparams["gamma"]),
                t_max=int(hparams["t_max"]),
                beta=float(hparams.get("beta", 0.01)))
            state = GA3CTrainer(game, hp, n_envs=n_envs, seed=trial_seed(seed, hparams),
                                device=device)
            trainers.append(state)
        metric = state.run_episodes(episodes_per_phase, max_updates=max_updates)
        return metric, state

    objective.trainers = trainers
    return objective
