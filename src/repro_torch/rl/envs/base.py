"""Batched environment API (port of ``repro/rl/envs/base.py``).

The reference's envs are pure functions of one env, vmapped outside, that
draw from a ``jax.random`` key. Here an env is batched tensor code on an
explicit device: a state is a NamedTuple of tensors with a leading env axis,
and ``reset`` / ``step`` take their random draws as tensors. A draw is the
*result* of the reference's random op (Pong's ``vy`` index, Duel's jitter
vector), not a key, so a test can feed the draws that the reference's keys
give and compare states step by step. ``reset_draws(gen, n)`` /
``step_draws(gen, n)`` make them from an explicit ``torch.Generator``, on
its device; ``n`` is the env count or a shape of leading axes (a rollout
draws ``(t_max, n_envs)`` at once).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device


class EnvSpec(NamedTuple):
    name: str
    n_actions: int
    grid: int                 # observations are (grid, grid) grayscale
    max_steps: int


def lead(n) -> tuple:
    """The leading axes of a draw: ``n`` envs, or a shape."""
    return (n,) if isinstance(n, int) else tuple(n)


def index_draws(draws: NamedTuple, i) -> NamedTuple:
    """``draws`` at index ``i`` of their first axis (one step of a rollout)."""
    return type(draws)(*(d[i] for d in draws))


def draws_to(draws: NamedTuple, device) -> NamedTuple:
    return type(draws)(*(d.to(device) for d in draws))


class Env:
    spec: EnvSpec

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def reset_draws(self, gen: torch.Generator, n) -> NamedTuple:
        raise NotImplementedError

    def step_draws(self, gen: torch.Generator, n) -> NamedTuple:
        raise NotImplementedError

    def reset(self, draws) -> Tuple[NamedTuple, torch.Tensor]:
        """-> (state, obs (n, grid, grid))."""
        raise NotImplementedError

    def step(self, state, action, draws):
        """-> (state, obs, reward (n,) f32, done (n,) bool)."""
        raise NotImplementedError


def _select(done, fresh, old):
    d = done.view(done.shape + (1,) * (old.dim() - done.dim()))
    return torch.where(d, fresh, old)


def auto_reset(env: Env, state, action, step_draws, reset_draws):
    """Step every env, reset every env, and keep the fresh episode where the
    step ended one: the reference's semantics, whose reset draws are spent
    on every step."""
    state2, obs, reward, done = env.step(state, action, step_draws)
    state0, obs0 = env.reset(reset_draws)
    state_out = type(state2)(*(_select(done, b, a) for a, b in zip(state2, state0)))
    return state_out, _select(done, obs0, obs), reward, done
