"""HyperTrick's search on the card (port of ``repro/launch/tune.py``: the
thread, process, server and vectorized backends).

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

  # OS-process workers against the TCP server, with a durable journal;
  # after a kill, the same command with --resume goes on from the journal
  PYTHONPATH=src python -m repro_torch.launch.tune --backend server \\
      --objective lm --journal /tmp/metaopt_journal.jsonl

  # population workers: one process leases 12 trials and trains them at
  # once on its card (--nodes 2 --slots 6: two processes of 6 each)
  PYTHONPATH=src python -m repro_torch.launch.tune --backend server \\
      --objective lm --nodes 1 --slots 12 --journal /tmp/metaopt_journal.jsonl

  # Hyperband: every bracket at once, cohorts pooled at the server's barrier
  PYTHONPATH=src python -m repro_torch.launch.tune --backend process \\
      --objective lm --scheduler hyperband --phases 4 --eta 2 --nodes 10

  # Population Based Training: CLONE verdicts copy a parent's weights into
  # the child's slot on the device (vectorized) or only hand the child the
  # perturbed hyperparameters (thread)
  PYTHONPATH=src python -m repro_torch.launch.tune --backend vectorized \\
      --scheduler pbt --workers 4 --phases 3 --episodes-per-phase 2 --n-envs 2

``--backend thread`` (the default): ``--nodes`` threads each pull a
configuration from the optimization service, train it phase by phase and
report after each phase; HyperTrick stops the trials that fall behind.
``--backend process``: ``--nodes`` OS-process workers
(``python -m repro_torch.distributed.worker``) each do the same against a
TCP server in this process, with per-trial leases (``--lease-ttl``) and,
with ``--journal``, a durable journal; ``--backend server`` is the same
with the journal on by default (``metaopt_journal.jsonl``), and
``--resume`` replays it so that a killed search goes on where it died.
``--scheduler hyperband`` (process and server) runs every bracket of the
(``--eta``, R = ``--phases``) construction at once through the server's
rung barrier; ``--bracket`` there is one successive-halving bracket
across every worker process. ``--slots`` above 1 there (rl and lm) makes
each worker process a population worker
(``python -m repro_torch.population.worker``) that leases up to that many
trials at once and trains them in one population engine; the bracket's
cohorts pool across every slot of every process. ``--backend
vectorized``: the population engine trains ``--slots`` (default ``--workers``) trials at once, the
trials that share a bucket key (GA3C: ``t_max``; LM: the effective
``loss_chunk``) stepped together, and hot-swaps a fresh configuration into
each slot the service stops; ``--bracket`` adds the service's rung barrier
(demote the bottom 1/``--eta`` at each rung) over a random search. A GA3C
trial (``--objective rl``, the reference's default) trains ``--n-envs``
envs of ``--game`` (vectorized; 16 on the other backends) for
``--episodes-per-phase`` episodes a phase and reports their mean score; an
LM trial (``lm``) trains ``--steps-per-phase`` steps of the architecture's
reduced config and reports -loss (thread, process and server backends:
batch 8 x 64 tokens, ``make_lm_objective``; vectorized: batch 2 x 32,
``population.objectives.lm``, the reference's); ``synthetic`` is the
planted-optimum toy objective (not vectorized). ``--scheduler pbt`` runs
Population Based Training over ``--workers`` members on the thread and
vectorized backends (its perturbations keep the objective's structural
keys). Every trial trains on ``--device`` (default ``cuda``), and a
missing card raises before any trial starts: on the thread and vectorized
backends here; on the process and server backends in each worker process,
before it connects, so it exits without a lease and the launcher raises
"all workers failed" (the launcher there imports no torch). ``--device
cpu`` runs the plain PyTorch path. Prints the reference's summary as JSON.

Ported: every backend, objective, policy and scheduler of the reference,
``--slots``, ``--bracket``, ``--eta``, ``--journal``, ``--resume`` and
``--lease-ttl``. ``--devices`` above 1 is not owed on one card. Combinations
the reference refuses exit through ``argparse``'s error, as there.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from repro_torch.core.completion import expected_alpha, min_alpha
from repro_torch.core.executor import PopulationCluster, ProcessCluster, ThreadCluster
from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy
from repro_torch.core.scheduler import HyperbandScheduler, PBTScheduler
from repro_torch.core.search_space import LogUniform, SearchSpace, lm_space, paper_rl_space
from repro_torch.distributed.worker import build_spec, make_synthetic_objective

# the entry points that import torch, loaded on first use (module
# ``__getattr__``): on the process and server backends only the workers
# train, so the launcher never loads torch there (seconds of start-up a
# launch on a CUDA build of torch), and each worker checks the device
# before it connects
_TORCH_ENTRY_POINTS = {"resolve_device": "repro_torch.device",
                       "LMObjective": "repro_torch.population.objectives.lm",
                       "make_rl_objective": "repro_torch.rl.ga3c",
                       "make_lm_objective": "repro_torch.train.trainer"}


def __getattr__(name):
    if name not in _TORCH_ENTRY_POINTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_TORCH_ENTRY_POINTS[name]), name)
    globals()[name] = value
    return value


def synthetic_space() -> SearchSpace:
    """Planted-optimum toy space for demos / backend smoke runs."""
    return SearchSpace({"x": LogUniform(0.01, 100.0)})


def build_objective_spec(args) -> dict:
    """JSON-able spec resolved by repro_torch.distributed.worker in each
    process; it carries the device the trials train on."""
    return build_spec(args.objective, game=args.game, arch=args.arch,
                      episodes_per_phase=args.episodes_per_phase,
                      steps_per_phase=args.steps_per_phase, seed=args.seed,
                      synthetic_sleep=args.synthetic_sleep, device=args.device)


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
                    help="hypertrick / random: the same as --policy; hyperband: every "
                         "bracket of the (eta, R=--phases) construction at once through "
                         "the server's rung barrier (process / server); pbt: a population "
                         "of --workers trials with exploit/explore CLONE verdicts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=["thread", "process", "server", "vectorized"],
                    default="thread",
                    help="thread: in-process node threads; process: OS-process workers "
                         "over TCP; server: process workers plus a durable journal "
                         "(resumable); vectorized: the population engine — all live "
                         "trials train at once on the device")
    ap.add_argument("--slots", type=int, default=None,
                    help="vectorized: trials on the device at once (default: --workers); "
                         "process / server with an rl or lm objective: trials leased a "
                         "worker process (default 1 = classic scalar workers)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--bracket", action="store_true",
                    help="successive-halving rungs through the service's generation "
                         "barrier (vectorized: the local population; process / server: "
                         "one bracket across every worker process); the policy becomes "
                         "a random search")
    ap.add_argument("--eta", type=int, default=3,
                    help="rung demotion factor for --bracket (default 3)")
    ap.add_argument("--n-envs", type=int, default=16,
                    help="envs a trial (vectorized backend)")
    ap.add_argument("--journal", default=None,
                    help="journal path (default for --backend server: "
                         "metaopt_journal.jsonl; optional for process). A fresh run "
                         "overwrites an existing journal; use --resume to replay it")
    ap.add_argument("--resume", action="store_true",
                    help="replay an existing journal before serving")
    ap.add_argument("--lease-ttl", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.objective == "rl":
        space = paper_rl_space()
    elif args.objective == "lm":
        space = lm_space()
    else:
        space = synthetic_space()

    # the reference's refusals and scheduler checks, in its order
    # (src/repro/launch/tune.py)
    scheduler = args.scheduler or args.policy
    if scheduler == "hyperband":
        if args.bracket:
            ap.error("--scheduler hyperband IS a bracket scheduler (every (eta, R) bracket "
                     "runs concurrently); drop --bracket")
        if args.backend not in ("process", "server"):
            ap.error("--scheduler hyperband pools its bracket cohorts at the server-side "
                     "rung barrier; use --backend process or server")
        policy = HyperbandScheduler(space, n_phases=args.phases, eta=args.eta, seed=args.seed)
    elif scheduler == "pbt":
        if args.bracket:
            ap.error("--scheduler pbt is asynchronous (no rung barrier); drop --bracket")
        # perturbations keep the objective's structural keys (rl: t_max, lm:
        # loss_chunk): a perturbed one would move the child to another bucket
        from repro_torch.population.objectives import spec_for
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

    if args.backend != "vectorized" and args.devices > 1:
        ap.error("--devices drives the on-device population engine; use --backend "
                 "vectorized")
    if args.backend == "thread" and args.bracket:
        ap.error("--bracket needs the service-side rung barrier; use --backend vectorized "
                 "(one host) or process/server (multi-host brackets)")
    if (args.bracket or scheduler == "hyperband") and args.eta < 2:
        ap.error("--eta must be >= 2 (demote bottom 1/eta per rung)")

    if args.backend == "vectorized":
        if args.objective not in ("rl", "lm"):
            ap.error("--backend vectorized runs the population engine; use --objective rl "
                     "or lm")
        if args.resume or args.journal:
            ap.error("--journal/--resume need a socket backend (--backend process or "
                     "server)")
        if args.devices > 1:
            raise NotImplementedError(
                f"--devices {args.devices}: slots sharded over several cards are not owed "
                "on one card (ROADMAP queue 1, not owed on one card)")
    elif args.backend == "thread":
        if args.resume or args.journal:
            ap.error("--journal/--resume need a socket backend (--backend process or "
                     "server)")
    else:
        journal_path = args.journal
        if args.backend == "server" and journal_path is None:
            journal_path = "metaopt_journal.jsonl"
        if args.resume and journal_path is None:
            ap.error("--resume requires a journal (--backend server or --journal PATH)")
        if args.slots and args.slots > 1 and args.objective not in ("rl", "lm"):
            ap.error("--slots > 1 (population workers) requires --objective rl or lm")

    if args.backend in ("thread", "vectorized"):
        for name in _TORCH_ENTRY_POINTS:     # into this module's globals
            getattr(sys.modules[__name__], name)
        resolve_device(args.device)     # no card: raise before any trial runs

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
    elif args.backend == "thread":
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
    else:
        result = ProcessCluster(args.nodes, build_objective_spec(args),
                                lease_ttl=args.lease_ttl, journal_path=journal_path,
                                resume=args.resume, slots=args.slots or 1,
                                bracket_eta=args.eta if args.bracket else None).run(policy)
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
