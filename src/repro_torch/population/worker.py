"""Multi-trial worker (port of ``repro/population/worker.py``): one process
leases up to ``--slots`` trials from the TCP server and trains them all in
the population engine on its card.

  PYTHONPATH=src python -m repro_torch.population.worker --host H --port P \\
      --game pong --slots 8
  PYTHONPATH=src python -m repro_torch.population.worker --host H --port P \\
      --objective lm --arch yi-9b --slots 12 --episodes-per-phase 25

This is the deployment shape where a single GPU node serves an entire
HyperTrick search: the ACQUIRE verb carries a ``slots`` hint, the server
grants a batch of leases, and the engine keeps every leased trial training
on the slot axis while a heartbeat thread renews all the leases. A lease
the server reaps (this worker presumed dead, or a server restart) is
abandoned mid-flight — its slot is masked and hot-swapped, the same
strictly-local effect as a whole-worker death in the scalar protocol.

The device (``--device``, default ``cuda``) and the objective are built
before the worker connects: a worker asked for ``cuda`` on a host without
a card exits 1 having leased nothing. ``--objective lm`` takes the
registry's language models: their attention, mamba, MLP and MoE blocks all
have a slot form (``models.model.forward_slots``). The closing line keeps the reference's words and adds, as one JSON
object, this process's kernel launch counters and the engine's env steps,
updates and loop steps (``closing_line``; read back by
``distributed.worker.parse_closing_line``).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import uuid
from typing import Optional

from repro_torch.distributed.client import ServiceClient, ServiceError
from repro_torch.distributed.protocol import ProtocolError
from repro_torch.population.engine import PopulationEngine, RemoteDriver


class PopulationWorkerAgent:
    """``WorkerAgent`` generalized from one leased trial to a population."""

    def __init__(self, client: ServiceClient, engine: PopulationEngine,
                 heartbeat_interval: float = 2.0,
                 node: Optional[int] = None):
        self.client = client
        self.engine = engine
        # distributed tracing on by default, as in WorkerAgent: the
        # engine's phase reports stitch into per-trial server spans
        if getattr(client, "trace_ctx", None) is None:
            client.trace_ctx = (f"pop{node}-{uuid.uuid4().hex[:6]}"
                                if node is not None
                                else f"pop-{uuid.uuid4().hex[:6]}")
        self.driver = RemoteDriver(client, node=node)
        self.heartbeat_interval = heartbeat_interval
        self._stop = threading.Event()

    def run(self) -> int:
        """Drive the engine until the search budget is spent or the server
        goes away. Returns the number of phase reports delivered."""
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb.start()
        try:
            # only driver I/O means "server gone"; engine / CUDA failures
            # must propagate (an OOM swallowed here would loop forever
            # through lease-reap -> requeue -> same worker -> same OOM)
            records = self.engine.run(self.driver)
        except (ServiceError, ProtocolError, OSError):
            records = self.engine.records    # server gone — we are done
        finally:
            self._stop.set()
            hb.join(timeout=2 * self.heartbeat_interval)
        return len(records)

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            try:
                for tid in self.engine.active_trial_ids():
                    ok = self.client.heartbeat(tid)
                    if not ok:
                        self.driver.mark_lost(tid)
            except Exception:               # noqa: BLE001 — never let the
                continue                    # lease-renewal thread die


def closing_line(node, n: int, engine: PopulationEngine) -> str:
    """``population worker node=N delivered n phase reports (k env steps)``,
    the reference's line, then one JSON object: this process's launch
    counters, the engine's env steps and updates, and its loop steps
    (``engine.step_s``'s count: the steps of the bucket where every trial
    shares one)."""
    from repro_torch.distributed.worker import launch_counters
    extra = {"launches": launch_counters(), "env_steps": engine.total_env_steps,
             "updates": engine.total_updates,
             "engine_steps": engine.metrics.histogram("engine.step_s").count}
    return (f"population worker node={node} delivered {n} phase reports "
            f"({engine.total_env_steps} env steps) {json.dumps(extra, sort_keys=True)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--objective", default="ga3c", choices=("ga3c", "lm"),
                    help="engine workload (population.objectives): ga3c "
                         "trains --game, lm fine-tunes the reduced --arch "
                         "model with per-trial lr/clip/warmup on the slot "
                         "axis")
    ap.add_argument("--game", default="pong")
    ap.add_argument("--arch", default="yi-9b",
                    help="configs.registry architecture for --objective lm")
    ap.add_argument("--lm-batch", type=int, default=2)
    ap.add_argument("--lm-seq", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--episodes-per-phase", type=int, default=20,
                    help="phase length in the objective's progress units "
                         "(GA3C: finished episodes; lm: updates)")
    ap.add_argument("--max-updates", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--node", type=int, default=None)
    ap.add_argument("--heartbeat-interval", type=float, default=2.0)
    ap.add_argument("--devices", type=int, default=1,
                    help="1: the slot axis on one card (sharding it over "
                         "several cards is not owed on one card)")
    ap.add_argument("--bracket", action="store_true",
                    help="join the server-side successive-halving bracket: "
                         "acquires carry the rung-0 refill hint and rung-"
                         "phase reports park until the cohort — pooled "
                         "across every participating host — resolves. The "
                         "demotion factor eta is the SERVER's (set where "
                         "the service is built); --eta here only marks "
                         "participation")
    ap.add_argument("--eta", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="where the slots train; checked before the worker "
                         "connects")
    args = ap.parse_args(argv)

    if args.bracket and args.eta < 2:
        ap.error("--eta must be >= 2 (demote bottom 1/eta per rung)")
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: slots sharded over several cards are not owed "
            "on one card (ROADMAP queue 1, not owed on one card)")

    from repro_torch.device import resolve_device
    try:
        device = resolve_device(args.device)   # no card: exit before any lease
    except RuntimeError as e:
        print(f"population worker node={args.node}: {e}", file=sys.stderr)
        return 1
    if args.objective == "lm":
        from repro_torch.population.objectives.lm import LMObjective
        workload = LMObjective(arch=args.arch, batch=args.lm_batch,
                               seq=args.lm_seq, data_seed=args.seed, device=device)
    else:
        from repro_torch.population.objectives.ga3c import GA3CObjective
        workload = GA3CObjective(args.game, n_envs=args.n_envs, device=device)
    engine = PopulationEngine(workload, max_slots=args.slots,
                              n_envs=args.n_envs,
                              episodes_per_phase=args.episodes_per_phase,
                              max_updates=args.max_updates, seed=args.seed,
                              bracket_eta=args.eta if args.bracket else None,
                              device=device)
    try:
        client = ServiceClient(args.host, args.port)
    except OSError as e:
        print(f"cannot reach server at {args.host}:{args.port}: {e}")
        return 1
    with client:
        agent = PopulationWorkerAgent(
            client, engine, heartbeat_interval=args.heartbeat_interval,
            node=args.node)
        n = agent.run()
    from repro_torch.distributed.worker import write_line
    write_line(closing_line(args.node, n, engine))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
