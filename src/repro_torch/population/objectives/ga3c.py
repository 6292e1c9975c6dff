"""GA3C as a ``PopulationObjective`` — the engine's default workload (port
of ``repro/population/objectives/ga3c.py``).

* traced:      ``learning_rate``, ``gamma``, ``beta`` — ``(S,)`` tensors
  into one step of the bucket;
* structural:  ``t_max`` — the rollout's length, hence the bucket key;
* learner:     ``(params, opt_state)``: the net's weights by name and the
  RMSProp state;
* carry:       ``(LoopState, generator)``: env state and episode counters,
  and the trial's own ``torch.Generator``, which draws every rollout draw
  of the trial as ``LoopState.rng`` does in the reference;
* cost:        ``t_max * n_envs`` env transitions per update per slot.

A bucket of capacity 1 runs ``rl.ga3c.ga3c_update``, the thread
trainer's own update, on its slot: a population of one is the thread
backend bit for bit. A larger bucket runs ``ga3c_update_slots``, one
set of launches for all of its slots: each slot's rollout draws come from
its own generator, in slot order, and its envs step with every other
slot's as one env batch of ``S × n_envs``.

The reference's ``UNROLL_T_MAX`` (a full unroll of the rollout's scan
below t_max 16, an XLA:CPU compile-time trade) has no counterpart here:
an eager rollout is a Python loop over steps at every t_max.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable

from repro_torch.device import resolve_device
from repro_torch.population.objectives import GA3C_SPEC, HparamSpec, PopulationObjective
from repro_torch.rl.a3c import LoopState, rollout_draws, stack_slot_draws
from repro_torch.rl.envs.minigames import make_env
from repro_torch.rl.ga3c import (GA3CHyperParams, GA3CTrainer, ga3c_train_config, ga3c_update,
                                 ga3c_update_slots)
from repro_torch.rl.network import A3CNetConfig


class GA3CObjective(PopulationObjective):
    name = "ga3c"

    def __init__(self, game: str = "pong", n_envs: int = 16, device="cuda"):
        self.game = game
        self.n_envs = n_envs
        self.device = resolve_device(device)
        self.env = make_env(game, self.device)
        self.net_cfg = A3CNetConfig(grid=self.env.spec.grid, n_actions=self.env.spec.n_actions)
        # lr is each slot's own inside the step; the config value is only
        # the (unused) default
        self.tc = ga3c_train_config(3e-4)

    @classmethod
    def hparam_spec(cls) -> HparamSpec:
        return GA3C_SPEC

    def bucket_key(self, hparams: Dict[str, Any]) -> int:
        return int(hparams.get("t_max", 8))

    def cache_key(self) -> Hashable:
        return ("ga3c", self.game, self.n_envs)

    def init_slot_state(self, seed: int, hparams: Dict[str, Any]):
        """A fresh ``GA3CTrainer``'s state: its generator, seeded by
        ``seed``, has drawn the weights and then the envs' resets."""
        tr = GA3CTrainer(self.game, GA3CHyperParams(), n_envs=self.n_envs, seed=seed,
                         device=self.device)
        params = {n: p.detach() for n, p in tr.net.named_parameters()}
        return (params, tr.opt_state), (tr.loop, tr.gen)

    def make_step(self, structural: Hashable, capacity: int):
        env, tc, n_envs, dev = self.env, self.tc, self.n_envs, self.device
        t_max = int(structural)

        def trainable(params):
            # the slot's weights as autograd leaves on the same memory: the
            # update writes them in place
            return {n: v.detach().requires_grad_() for n, v in params.items()}

        if capacity == 1:
            def step(learner, carry, lr, gamma, beta):
                (params, opt), (loop, gens) = learner, carry
                one = lambda t: t[0]  # noqa: E731
                loop1 = LoopState(type(loop.env_state)(*map(one, loop.env_state)),
                                  *map(one, loop[1:]))
                opt1 = opt._replace(step=opt.step[0],
                                    acc1={n: a[0] for n, a in opt.acc1.items()})
                draws = rollout_draws(env, gens[0], t_max, n_envs, dev)
                _, loop1, opt1, _ = ga3c_update(
                    env, tc, trainable({n: v[0] for n, v in params.items()}), opt1, loop1,
                    draws, gamma=gamma[0], beta=beta[0], lr=lr[0])
                some = lambda t: t[None]  # noqa: E731
                loop = LoopState(type(loop1.env_state)(*map(some, loop1.env_state)),
                                 *map(some, loop1[1:]))
                return (params, opt._replace(step=opt1.step[None])), (loop, gens)
            return step

        def step(learner, carry, lr, gamma, beta):
            (params, opt), (loop, gens) = learner, carry
            draws = stack_slot_draws([rollout_draws(env, g, t_max, n_envs, dev) for g in gens])
            _, loop, opt, _ = ga3c_update_slots(env, tc, trainable(params), opt, loop, draws,
                                                gamma=gamma, beta=beta, lr=lr)
            return (params, opt), (loop, gens)
        return step

    def progress(self, carry):
        loop, _ = carry
        return loop.finished_n, loop.finished_sum

    def update_cost(self, structural: Hashable) -> int:
        return int(structural) * self.n_envs
