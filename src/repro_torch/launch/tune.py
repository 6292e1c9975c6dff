"""HyperTrick's search on the card (port of ``repro/launch/tune.py``'s
thread and vectorized backends).

  # the paper's search, the default: tune GA3C on a mini-Atari game
  PYTHONPATH=src python -m repro_torch.launch.tune --objective rl --game pong \\
      --workers 12 --nodes 4 --phases 5 --eviction-rate 0.25

  # the same search on the population engine: every live trial trains at
  # once, from one host thread
  PYTHONPATH=src python -m repro_torch.launch.tune --backend vectorized

  # successive-halving rungs on the population engine
  PYTHONPATH=src python -m repro_torch.launch.tune --backend vectorized \\
      --bracket --eta 3

  # tune LM training of a zoo architecture's reduced config
  PYTHONPATH=src python -m repro_torch.launch.tune --objective lm \\
      --arch yi-9b --workers 12 --nodes 4 --phases 5

  # the same LM search on the population engine: every trial in one bucket
  PYTHONPATH=src python -m repro_torch.launch.tune --backend vectorized \\
      --objective lm

  # Population Based Training: CLONE verdicts copy a parent's weights into
  # the child's slot on the device (vectorized) or only hand the child the
  # perturbed hyperparameters (thread)
  PYTHONPATH=src python -m repro_torch.launch.tune --backend vectorized \\
      --scheduler pbt --workers 4 --phases 3 --episodes-per-phase 2 --n-envs 2

``--backend thread`` (the default): ``--nodes`` threads each pull a
configuration from the optimization service, train it phase by phase and
report after each phase; HyperTrick stops the trials that fall behind.
``--backend vectorized``: the population engine trains ``--slots``
(default ``--workers``) trials at once, the trials that share a bucket
key (GA3C: ``t_max``; LM: the effective ``loss_chunk``) stepped together,
and hot-swaps a fresh configuration into each slot the service stops;
``--bracket`` adds the service's rung barrier (demote the bottom
1/``--eta`` at each rung) over a random search. A GA3C trial
(``--objective rl``, the reference's default) trains ``--n-envs`` envs of
``--game`` for ``--episodes-per-phase`` episodes a phase and reports their
mean score; an LM trial (``lm``) trains ``--steps-per-phase`` steps of the
architecture's reduced config and reports -loss (thread backend: batch 8 x
64 tokens, ``make_lm_objective``; vectorized: batch 2 x 32,
``population.objectives.lm``, the reference's); ``synthetic`` is the
planted-optimum toy objective (thread backend). ``--scheduler pbt`` runs
Population Based Training over ``--workers`` members on either backend
(its perturbations keep the objective's structural keys). Every trial
trains on ``--device`` (default ``cuda``), and a missing card raises
before any trial starts; ``--device cpu`` runs the plain PyTorch path.
Prints the reference's summary as JSON.

Ported: ``--backend thread`` and ``vectorized``, ``--objective`` rl, lm or
synthetic (thread), ``--policy`` and ``--scheduler`` hypertrick or random,
``--scheduler pbt``, ``--bracket`` and ``--eta`` (vectorized). The other
options raise ``NotImplementedError`` naming the ROADMAP item that ports
them; ``--devices`` above 1 is not owed on one card. Combinations the
reference refuses exit through ``argparse``'s error, as there
(``--scheduler hyperband`` off the process and server backends among
them).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.completion import expected_alpha, min_alpha
from repro_torch.core.executor import PopulationCluster, ThreadCluster
from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy
from repro_torch.core.scheduler import PBTScheduler
from repro_torch.core.search_space import LogUniform, SearchSpace, lm_space, paper_rl_space
from repro_torch.device import resolve_device
from repro_torch.distributed.worker import make_synthetic_objective
from repro_torch.population.objectives import spec_for
from repro_torch.population.objectives.lm import LMObjective
from repro_torch.rl.ga3c import make_rl_objective
from repro_torch.train.trainer import make_lm_objective

# what is not ported yet, and the ROADMAP queue 1 item that ports it
NOT_PORTED = {
    "backend process": "7c (the control plane)",
    "backend server": "7c (the control plane)",
    "scheduler hyperband": "7c (the control plane: Hyperband pools its cohorts at the "
                           "server's rung barrier)",
    "journal": "7c (the control plane)",
    "resume": "7c (the control plane)",
}


def synthetic_space() -> SearchSpace:
    """Planted-optimum toy space for demos / backend smoke runs."""
    return SearchSpace({"x": LogUniform(0.01, 100.0)})


def _refuse(what: str):
    raise NotImplementedError(f"--{what} is not ported: ROADMAP queue 1 item "
                              f"{NOT_PORTED[what]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--objective", choices=["rl", "lm", "synthetic"], default="rl")
    ap.add_argument("--game", default="pong")
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--workers", type=int, default=12)     # W0
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--phases", type=int, default=5)       # N_p
    ap.add_argument("--eviction-rate", type=float, default=0.25)
    ap.add_argument("--episodes-per-phase", type=int, default=60)
    ap.add_argument("--steps-per-phase", type=int, default=25)
    ap.add_argument("--synthetic-sleep", type=float, default=0.05)
    ap.add_argument("--policy", choices=["hypertrick", "random"], default="hypertrick")
    ap.add_argument("--scheduler", choices=["hypertrick", "random", "hyperband", "pbt"],
                    default=None,
                    help="hypertrick / random: the same as --policy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=["thread", "process", "server", "vectorized"],
                    default="thread",
                    help="thread: in-process node threads; vectorized: the population "
                         "engine — all live trials train at once on the device")
    ap.add_argument("--slots", type=int, default=None,
                    help="vectorized: trials on the device at once (default: --workers)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--bracket", action="store_true",
                    help="vectorized: successive-halving rungs through the service's "
                         "generation barrier; the policy becomes a random search")
    ap.add_argument("--eta", type=int, default=3,
                    help="rung demotion factor for --bracket (default 3)")
    ap.add_argument("--n-envs", type=int, default=16,
                    help="envs a trial (vectorized backend)")
    ap.add_argument("--journal", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # the reference's refusals and scheduler checks (src/repro/launch/tune.py)
    scheduler = args.scheduler or args.policy
    if scheduler == "hyperband":
        if args.bracket:
            ap.error("--scheduler hyperband IS a bracket scheduler (every (eta, R) bracket "
                     "runs concurrently); drop --bracket")
        if args.backend not in ("process", "server"):
            ap.error("--scheduler hyperband pools its bracket cohorts at the server-side "
                     "rung barrier; use --backend process or server")
        _refuse("scheduler hyperband")
    if scheduler == "pbt" and args.bracket:
        ap.error("--scheduler pbt is asynchronous (no rung barrier); drop --bracket")
    if args.backend in ("process", "server"):
        _refuse(f"backend {args.backend}")
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: slots sharded over several cards are not owed on one "
            "card (ROADMAP queue 1, not owed on one card)")
    if args.backend == "thread" and args.bracket:
        ap.error("--bracket needs the service-side rung barrier; use "
                 "--backend vectorized")
    if args.bracket and args.eta < 2:
        ap.error("--eta must be >= 2 (demote bottom 1/eta per rung)")
    if args.backend == "vectorized":
        if args.objective not in ("rl", "lm"):
            ap.error("--backend vectorized runs the population engine; use --objective rl "
                     "or lm")
        if args.resume or args.journal:
            ap.error("--journal/--resume need a socket backend")
    for flag in ("journal", "resume"):
        if getattr(args, flag):
            _refuse(flag)
    resolve_device(args.device)     # no card: raise before any trial runs

    if args.objective == "rl":
        space = paper_rl_space()
    elif args.objective == "lm":
        space = lm_space()
    else:
        space = synthetic_space()
    if scheduler == "pbt":
        # perturbations keep the objective's structural keys (rl: t_max, lm:
        # loss_chunk): a perturbed one would move the child to another bucket
        policy = PBTScheduler(space, population=args.workers, n_phases=args.phases,
                              seed=args.seed, frozen=spec_for(args.objective).structural)
    elif args.bracket:
        # rung demotion needs a pure sampler upstream: every eviction is
        # the barrier's ranking
        policy = RandomSearchPolicy(space, args.workers, args.phases, seed=args.seed)
    elif scheduler == "hypertrick":
        policy = HyperTrick(space, args.workers, args.phases,
                            args.eviction_rate, seed=args.seed)
    else:
        policy = RandomSearchPolicy(space, args.workers, args.phases, seed=args.seed)

    if args.backend == "vectorized":
        if args.objective == "lm":
            objective = LMObjective(args.arch, data_seed=args.seed, device=args.device)
            units_per_phase = args.steps_per_phase
        else:
            objective, units_per_phase = None, args.episodes_per_phase   # GA3C on --game
        result = PopulationCluster(
            args.slots or args.workers, game=args.game, objective=objective,
            episodes_per_phase=units_per_phase, n_envs=args.n_envs,
            seed=args.seed, bracket_eta=args.eta if args.bracket else None,
            device=args.device).run(policy)
    else:
        if args.objective == "rl":
            objective = make_rl_objective(args.game, args.episodes_per_phase, seed=args.seed,
                                          device=args.device)
        elif args.objective == "lm":
            objective = make_lm_objective(args.arch, args.steps_per_phase, seed=args.seed,
                                          device=args.device)
        else:
            objective = make_synthetic_objective(sleep=args.synthetic_sleep, seed=args.seed)
        result = ThreadCluster(args.nodes, objective).run(policy)
        if args.objective == "rl":
            result.env_steps = sum(tr.env_steps for tr in objective.trainers)
            result.updates = sum(tr.updates for tr in objective.trainers)
    summary = result.summary()
    summary["expected_alpha"] = expected_alpha(args.eviction_rate, args.phases)
    summary["min_alpha"] = min_alpha(args.eviction_rate, args.phases)
    print(json.dumps(summary, indent=2, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return result


if __name__ == "__main__":
    main()
