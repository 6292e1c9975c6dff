"""A3C losses and the vectorized t_max rollout (paper Eqs. 6-7; port of
``repro/rl/a3c.py``).

policy loss:  -log pi(a|s)[R~ - V(s)] - beta H[pi(s)]        (Eq. 6)
value  loss:  [R~ - V(s)]^2                                  (Eq. 7)
R~_t = sum_{i<k} gamma^i r_{t+i} + gamma^k V(s_{t+k}),  k <= t_max.

t_max is BOTH the bias/variance knob of the bootstrapped critic AND the
batch-size knob (t_max * n_envs samples per update) — the cost/quality
coupling HyperTrick exploits (paper §5.1).

The rollout takes its random draws as inputs (``RolloutDraws``): per step
the Gumbel noise of the action sample, which makes ``argmax(logits + g)``
exactly ``jax.random.categorical``, and each env's step and reset draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.rl.envs.base import Env, auto_reset, draws_to, index_draws
from repro_torch.rl.network import apply_net_slots


class Trajectory(NamedTuple):
    obs: torch.Tensor       # (T, B, frames, G, G)
    actions: torch.Tensor   # (T, B) int64
    rewards: torch.Tensor   # (T, B)
    dones: torch.Tensor     # (T, B) f32


class LoopState(NamedTuple):
    env_state: NamedTuple
    obs_stack: torch.Tensor   # (B, frames, G, G)
    ep_return: torch.Tensor   # (B,) running episode return
    # episode-score bookkeeping
    finished_sum: torch.Tensor
    finished_n: torch.Tensor


class RolloutDraws(NamedTuple):
    gumbel: torch.Tensor      # (T, B, A)
    step: NamedTuple          # the env's step draws, leading axes (T, B)
    reset: NamedTuple         # the env's reset draws, leading axes (T, B)


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise: ``-log(-log(u))``, u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))


def rollout_draws(env: Env, gen: torch.Generator, t_max: int, n_envs: int,
                  device=None) -> RolloutDraws:
    """A rollout's draws, made on ``gen``'s device and copied to ``device``."""
    shape = (t_max, n_envs)
    dev = gen.device if device is None else device
    return RolloutDraws(gumbel(gen, shape + (env.spec.n_actions,)).to(dev),
                        draws_to(env.step_draws(gen, shape), dev),
                        draws_to(env.reset_draws(gen, shape), dev))


def stack_slot_draws(draws) -> RolloutDraws:
    """S trials' ``RolloutDraws`` (each field ``(T, B, ...)``) as one with a
    slot axis after the step axis, ``(T, S, B, ...)``: a step's draws of
    every slot are then one contiguous block of S·B envs."""
    def stack(fields):
        return type(fields[0])(*(torch.stack(f, 1) for f in zip(*fields)))
    return RolloutDraws(torch.stack([d.gumbel for d in draws], 1),
                        stack([d.step for d in draws]), stack([d.reset for d in draws]))


def init_loop_state(env: Env, reset_draws) -> LoopState:
    """The reference's ``init_loop_state(env, n_envs, rng)``, given the
    envs' reset draws in place of the key."""
    states, obs = env.reset(reset_draws)
    stack = torch.stack([torch.zeros_like(obs), obs], 1)
    zero = torch.zeros((), device=obs.device)
    return LoopState(states, stack, torch.zeros(len(obs), device=obs.device), zero, zero)


@torch.no_grad()
def rollout(env: Env, net, loop: LoopState, t_max: int, draws: RolloutDraws):
    """Collect t_max steps from every env; returns (traj, new loop state)."""
    obs, actions, rewards, dones = [], [], [], []
    ls = loop
    for t in range(t_max):
        logits, _ = net(ls.obs_stack)
        act = torch.argmax(logits + draws.gumbel[t], -1)
        env_state, ob, reward, done = auto_reset(
            env, ls.env_state, act, index_draws(draws.step, t), index_draws(draws.reset, t))
        stack = torch.stack([ls.obs_stack[:, -1], ob], 1)
        ep = ls.ep_return + reward
        fin_sum = ls.finished_sum + torch.where(done, ep, 0.0).sum()
        fin_n = ls.finished_n + done.sum()
        ep = torch.where(done, 0.0, ep)
        obs.append(ls.obs_stack)
        actions.append(act)
        rewards.append(reward)
        dones.append(done)
        ls = LoopState(env_state, stack, ep, fin_sum, fin_n)
    return Trajectory(torch.stack(obs), torch.stack(actions), torch.stack(rewards),
                      torch.stack(dones).float()), ls


@torch.no_grad()
def rollout_slots(env: Env, params, loop: LoopState, t_max: int, draws: RolloutDraws):
    """``rollout`` for S trials at once, through ``apply_net_slots``. Every
    field of ``loop`` has a leading slot axis: env states ``(S, B, ...)``,
    ``finished_sum`` / ``finished_n`` ``(S,)``, each slot's own tally.
    ``draws`` come from ``stack_slot_draws``. The S·B envs step as one env
    batch. Returns a trajectory of ``(S, T, B, ...)`` fields and the new
    loop state."""
    s, b = loop.ep_return.shape
    flat = lambda t: t.flatten(0, 1)  # noqa: E731
    env_state = type(loop.env_state)(*map(flat, loop.env_state))
    stack, ep = loop.obs_stack, loop.ep_return
    fin_sum, fin_n = loop.finished_sum, loop.finished_n
    obs, actions, rewards, dones = [], [], [], []
    for t in range(t_max):
        logits, _ = apply_net_slots(params, stack)
        act = torch.argmax(logits + draws.gumbel[t], -1)
        env_state, ob, reward, done = auto_reset(
            env, env_state, flat(act), type(draws.step)(*map(flat, index_draws(draws.step, t))),
            type(draws.reset)(*map(flat, index_draws(draws.reset, t))))
        reward, done = reward.view(s, b), done.view(s, b)
        obs.append(stack)
        stack = torch.stack([stack[:, :, -1], ob.view(s, b, *ob.shape[1:])], 2)
        ep = ep + reward
        fin_sum = fin_sum + torch.where(done, ep, 0.0).sum(1)
        fin_n = fin_n + done.sum(1)
        ep = torch.where(done, 0.0, ep)
        actions.append(act)
        rewards.append(reward)
        dones.append(done)
    env_state = type(env_state)(*(f.view(s, b, *f.shape[1:]) for f in env_state))
    return (Trajectory(torch.stack(obs, 1), torch.stack(actions, 1), torch.stack(rewards, 1),
                       torch.stack(dones, 1).float()),
            LoopState(env_state, stack, ep, fin_sum, fin_n))


def n_step_returns(rewards, dones, v_bootstrap, gamma: float):
    """R~_t backwards from the bootstrap value (zeroed across terminals)."""
    R = v_bootstrap
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        R = rewards[t] + gamma * (1.0 - dones[t]) * R
        out.append(R)
    return torch.stack(out[::-1])


def a3c_loss(net, traj: Trajectory, v_bootstrap, *, gamma: float, beta: float,
             value_coef: float = 0.5):
    T, B = traj.actions.shape
    logits, values = net(traj.obs.reshape((T * B,) + traj.obs.shape[2:]))
    logits = logits.view(T, B, -1)
    values = values.view(T, B)

    returns = n_step_returns(traj.rewards, traj.dones, v_bootstrap, gamma)
    adv = returns - values

    logp = F.log_softmax(logits, -1)
    ent = -torch.sum(torch.exp(logp) * logp, -1)
    logp_a = torch.gather(logp, -1, traj.actions[..., None])[..., 0]

    policy_loss = -torch.mean(logp_a * adv.detach()) - beta * torch.mean(ent)
    value_loss = torch.mean(adv ** 2)
    loss = policy_loss + value_coef * value_loss
    return loss, {"policy_loss": policy_loss, "value_loss": value_loss,
                  "entropy": torch.mean(ent)}


def a3c_loss_slots(params, traj: Trajectory, v_bootstrap, *, gamma, beta,
                   value_coef: float = 0.5):
    """``a3c_loss`` of S trials at once: ``traj`` from ``rollout_slots``
    (``(S, T, B, ...)``), ``v_bootstrap`` ``(S, B)``, ``gamma`` and ``beta``
    ``(S,)`` tensors, one value a slot. Each slot's loss is ``a3c_loss`` of
    its own trajectory, a mean over its own T·B samples; the returned loss
    is their sum, so each slot's weights get the gradient of their own loss
    (a mean over slots would scale each by 1/S). The metrics are ``(S,)``."""
    s, t, b = traj.actions.shape
    logits, values = apply_net_slots(params, traj.obs.reshape(s, t * b, *traj.obs.shape[3:]))
    logits = logits.view(s, t, b, -1)
    values = values.view(s, t, b)

    # time-major for n_step_returns; gamma (S, 1) against each step's (S, B)
    returns = n_step_returns(traj.rewards.transpose(0, 1), traj.dones.transpose(0, 1),
                             v_bootstrap, gamma[:, None]).transpose(0, 1)
    adv = returns - values

    logp = F.log_softmax(logits, -1)
    ent = -torch.sum(torch.exp(logp) * logp, -1)
    logp_a = torch.gather(logp, -1, traj.actions[..., None])[..., 0]

    entropy = torch.mean(ent, (1, 2))
    policy_loss = -torch.mean(logp_a * adv.detach(), (1, 2)) - beta * entropy
    value_loss = torch.mean(adv ** 2, (1, 2))
    loss = policy_loss + value_coef * value_loss
    return loss.sum(), {"policy_loss": policy_loss, "value_loss": value_loss,
                        "entropy": entropy}
