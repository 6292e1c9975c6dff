"""HyperTrick's search on the card (port of ``repro/launch/tune.py``'s
thread backend).

  # the paper's search, the default: tune GA3C on a mini-Atari game
  PYTHONPATH=src python -m repro_torch.launch.tune --objective rl --game pong \\
      --workers 12 --nodes 4 --phases 5 --eviction-rate 0.25

  # tune LM training of a zoo architecture's reduced config
  PYTHONPATH=src python -m repro_torch.launch.tune --objective lm \\
      --arch yi-9b --workers 12 --nodes 4 --phases 5

``--nodes`` threads each pull a configuration from the optimization
service, train it phase by phase and report after each phase; HyperTrick
stops the trials that fall behind. A GA3C trial (``--objective rl``, the
reference's default) trains 16 envs of ``--game`` for
``--episodes-per-phase`` episodes a phase and reports their mean score; an
LM trial (``lm``) trains ``--steps-per-phase`` steps of the architecture's
reduced config (batch 8 x 64 tokens) and reports -loss; ``synthetic`` is
the planted-optimum toy objective. Every trial trains on ``--device``
(default ``cuda``), and a missing card raises before any trial starts;
``--device cpu`` runs the plain PyTorch path. Prints the reference's
summary as JSON.

Ported: ``--backend thread``, ``--objective`` rl, lm or synthetic,
``--policy`` and ``--scheduler`` hypertrick or random. The other options
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.completion import expected_alpha, min_alpha
from repro_torch.core.executor import ThreadCluster
from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy
from repro_torch.core.search_space import LogUniform, SearchSpace, lm_space, paper_rl_space
from repro_torch.device import resolve_device
from repro_torch.distributed.worker import make_synthetic_objective
from repro_torch.rl.ga3c import make_rl_objective
from repro_torch.train.trainer import make_lm_objective

# what is not ported yet, and the ROADMAP queue 1 item that ports it
NOT_PORTED = {
    "backend vectorized": "7a-1 (the population engine)",
    "backend process": "7c (the control plane)",
    "backend server": "7c (the control plane)",
    "scheduler pbt": "7a-2 (the PBT and Hyperband schedulers)",
    "scheduler hyperband": "7a-2 (the PBT and Hyperband schedulers)",
    "bracket": "7a-1 (the population engine's rungs; 7c across processes)",
    "devices": "7a-1 (the population engine)",
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
                    default="thread")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--bracket", action="store_true")
    ap.add_argument("--journal", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.backend != "thread":
        _refuse(f"backend {args.backend}")
    scheduler = args.scheduler or args.policy
    if scheduler in ("pbt", "hyperband"):
        _refuse(f"scheduler {scheduler}")
    for flag in ("bracket", "journal", "resume"):
        if getattr(args, flag):
            _refuse(flag)
    if args.devices > 1:
        _refuse("devices")
    resolve_device(args.device)     # no card: raise before any trial runs

    if args.objective == "rl":
        space = paper_rl_space()
        objective = make_rl_objective(args.game, args.episodes_per_phase, seed=args.seed,
                                      device=args.device)
    elif args.objective == "lm":
        space = lm_space()
        objective = make_lm_objective(args.arch, args.steps_per_phase, seed=args.seed,
                                      device=args.device)
    else:
        space = synthetic_space()
        objective = make_synthetic_objective(sleep=args.synthetic_sleep, seed=args.seed)
    if scheduler == "hypertrick":
        policy = HyperTrick(space, args.workers, args.phases,
                            args.eviction_rate, seed=args.seed)
    else:
        policy = RandomSearchPolicy(space, args.workers, args.phases, seed=args.seed)
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
