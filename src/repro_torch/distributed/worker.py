"""Worker-agent entrypoint (port of ``repro/distributed/worker.py``):
``python -m repro_torch.distributed.worker``.

Runs the same ``objective(hparams, phase, state) -> (metric, state)``
contract as ``ThreadCluster``, but against a remote server: acquire a
trial, run phases, report after each one, heartbeat in the background so
the lease stays alive, and obey stop decisions. A worker that loses its
lease (server restarted, or it was presumed dead) abandons the trial and
acquires a fresh one — never stalling the search.

  PYTHONPATH=src python -m repro_torch.distributed.worker --host H --port P \\
      --spec '{"kind": "lm", "arch": "yi-9b", "steps_per_phase": 25, "device": "cuda"}'

The spec carries ``"device"`` (the port's one addition to it): the worker
resolves it before it connects, so a worker asked for ``cuda`` on a host
without a card exits non-zero and leases nothing; ``--device`` (default
``cuda``) fills it where the spec has none. An LM trial trains through the
port's RMSNorm and flash-attention kernels in this process. The closing
line (``worker node=N ran n trials``) carries, as one JSON object, this
process's kernel launch counters and, for GA3C trials, its trainers' env
steps and updates (``closing_line`` / ``parse_closing_line``): they live in
the worker process, and the launcher cannot read them otherwise.

``--slots > 1`` hands an rl or lm spec to the population worker
(``repro_torch.population.worker``): one engine in this process leasing up
to that many trials at once, on the spec's device.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import sys
import threading
import time
import traceback
import uuid
from typing import Callable, Optional

import numpy as np

from repro_torch.distributed.client import (Pending, RemoteTrial, ServiceClient,
                                            ServiceError)


# -- objective registry (specs are JSON so they cross process boundaries) ---
def make_synthetic_objective(sleep: float = 0.0, noise: float = 0.0,
                             seed: int = 0,
                             crash_above: Optional[float] = None) -> Callable:
    """Planted-optimum objective over hparam ``x`` (optimum at x=1), with a
    learning curve that rises with phases — cheap enough for tests and
    protocol-overhead benchmarks. ``crash_above`` makes configs with
    x > crash_above raise, to exercise the crash path."""
    rng = np.random.default_rng(seed)

    def objective(hparams, phase, state):
        x = float(hparams.get("x", 1.0))
        if crash_above is not None and x > crash_above:
            raise RuntimeError(f"synthetic crash at x={x}")
        if sleep:
            time.sleep(sleep)
        quality = -abs(math.log(x))
        metric = quality * (1 + 0.1 * phase)
        if noise:
            metric += float(rng.normal(0.0, noise))
        return metric, state

    return objective


def build_spec(objective: str, *, game: str = "pong", arch: str = "yi-9b",
               episodes_per_phase: int = 20, steps_per_phase: int = 25,
               seed: int = 0, synthetic_sleep: float = 0.0,
               device: str = "cuda") -> dict:
    """The one place objective specs are built — used by both the worker
    CLI and the launcher (launch/tune.py), so the fields cannot drift."""
    if objective == "rl":
        return {"kind": "rl", "game": game,
                "episodes_per_phase": episodes_per_phase, "seed": seed,
                "device": device}
    if objective == "lm":
        return {"kind": "lm", "arch": arch,
                "steps_per_phase": steps_per_phase, "seed": seed,
                "device": device}
    if objective == "synthetic":
        return {"kind": "synthetic", "sleep": synthetic_sleep, "seed": seed,
                "device": device}
    raise ValueError(f"unknown objective {objective!r}")


def resolve_objective(spec: dict) -> Callable:
    """Build an objective from a JSON-able spec: {"kind": ..., **kwargs}.
    ``device`` goes to the rl / lm objectives (default ``cuda``); the
    synthetic objective runs on no device."""
    kind = spec.get("kind", "synthetic")
    kwargs = {k: v for k, v in spec.items() if k != "kind"}
    if kind == "synthetic":
        kwargs.pop("device", None)
        return make_synthetic_objective(**kwargs)
    if kind == "rl":
        from repro_torch.rl.ga3c import make_rl_objective
        return make_rl_objective(
            kwargs.pop("game", "pong"),
            kwargs.pop("episodes_per_phase", 20), **kwargs)
    if kind == "lm":
        from repro_torch.train.trainer import make_lm_objective
        return make_lm_objective(
            kwargs.pop("arch", "yi-9b"),
            kwargs.pop("steps_per_phase", 25), **kwargs)
    raise ValueError(f"unknown objective kind {kind!r}")


class WorkerAgent:
    """The node-loop of ``ThreadCluster`` over a ``ServiceClient``.

    With ``bracket=True`` the worker joins a server-side successive-halving
    bracket: its acquires carry the rung-0 hint (enrolling the trial in the
    rung barrier), and a report answered ``"parked"`` is simply re-sent —
    the trainer state is already in-process, so "preemption" while the rung
    cohort fills on other hosts is just this loop sleeping — until the
    barrier resolves it to continue (promoted) or stop (demoted)."""

    def __init__(self, client: ServiceClient, objective: Callable,
                 heartbeat_interval: float = 2.0,
                 node: Optional[int] = None, bracket: bool = False,
                 park_poll_interval: float = 0.2, batched: bool = True):
        self.client = client
        self.objective = objective
        self.heartbeat_interval = heartbeat_interval
        self.node = node
        self.bracket = bracket
        self.park_poll_interval = park_poll_interval
        # speak the batched report verb (one-entry batches for a scalar
        # worker — same round-trip count, but the whole fleet exercises
        # one server code path). False talks the classic per-trial verb,
        # e.g. against a pre-batch server.
        self.batched = batched
        self._active: Optional[int] = None     # trial currently leased
        self._lost: set = set()                # trials whose lease was lost
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        # distributed tracing on by default: acquire/report frames carry
        # this worker's trace context so a journal-backed server stitches
        # its phase spans onto the server clock (telemetry.spans). A
        # caller that set its own ctx on the client wins.
        if getattr(client, "trace_ctx", None) is None:
            client.trace_ctx = (f"w{node}-{uuid.uuid4().hex[:6]}"
                                if node is not None
                                else f"w-{uuid.uuid4().hex[:6]}")

    def _clock(self) -> float:
        """The worker clock every t_start/t_end (and trace ``t``) uses."""
        return time.monotonic() - self._t0

    def run(self) -> int:
        """Acquire/run/report until the budget is spent or the server goes
        away. Returns the number of trials this worker ran."""
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb.start()
        n = 0
        try:
            while True:
                try:
                    trial = self.client.acquire(
                        self.node, rung=0 if self.bracket else None,
                        trace_t=self._clock())
                except (ServiceError, OSError, RuntimeError):
                    break                       # server gone — we are done
                if trial is None:
                    break
                if isinstance(trial, Pending):
                    # budget spent but a dead worker's config may come back
                    time.sleep(trial.retry_after)
                    continue
                self._run_trial(trial)
                n += 1
        finally:
            self._stop.set()
            hb.join(timeout=2 * self.heartbeat_interval)
        return n

    def _run_trial(self, trial: RemoteTrial):
        state = None
        self._active = trial.trial_id
        try:
            for phase in range(trial.n_phases):
                t_start = self._clock()
                try:
                    metric, state = self.objective(trial.hparams, phase,
                                                   state)
                except Exception:               # noqa: BLE001 — local effect
                    traceback.print_exc()
                    try:
                        self.client.crash(trial.trial_id,
                                          reason=traceback.format_exc(limit=1))
                    except (ServiceError, OSError, RuntimeError):
                        pass
                    return
                t_end = self._clock()
                if trial.trial_id in self._lost:
                    return                      # lease reclaimed — abandon
                while True:
                    try:
                        decision = self._report(trial.trial_id, phase,
                                                metric, t_start, t_end)
                    except (ServiceError, OSError, RuntimeError):
                        return                  # stale trial or server gone
                    if decision != "parked":
                        break
                    # rung barrier: report withheld until the cohort —
                    # possibly spanning other hosts — is complete; poll by
                    # re-sending it (each poll renews the lease)
                    if trial.trial_id in self._lost:
                        return
                    time.sleep(self.park_poll_interval)
                if decision == "stop":
                    return
                if getattr(decision, "perturb", None) is not None:
                    # PBT clone verdict: a scalar worker cannot copy a
                    # remote parent's weights (they never cross hosts), so
                    # it adopts the perturbed hyperparameters and keeps
                    # its own trainer state
                    trial.hparams = dict(decision.perturb)
        finally:
            self._active = None

    def _report(self, trial_id: int, phase: int, metric: float,
                t_start: float, t_end: float):
        if self.batched:
            return self.client.report_batch(
                [{"trial_id": trial_id, "phase": phase, "metric": metric,
                  "t_start": t_start, "t_end": t_end}],
                node=self.node, trace_t=self._clock())[0]
        return self.client.report(trial_id, phase, metric,
                                  t_start=t_start, t_end=t_end,
                                  node=self.node, trace_t=self._clock())

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            tid = self._active
            if tid is None:
                continue
            try:
                ok = self.client.heartbeat(tid)
            except (ServiceError, OSError, RuntimeError):
                continue
            if not ok:
                self._lost.add(tid)


# -- the closing line: what only the worker process can count ----------------
_CLOSING = re.compile(r"^worker node=(\S+) ran (\d+) trials (\{.*\})$")
_POP_CLOSING = re.compile(
    r"^population worker node=(\S+) delivered (\d+) phase reports \(\d+ env steps\) "
    r"(\{.*\})$")


def launch_counters() -> dict:
    """This process's launch counters: every ``launches*`` attribute of the
    four kernel ops (``kernels/counters.py``), by op."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gmm.ops import gmm
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.selective_scan.ops import selective_scan
    ops = {"rmsnorm": rmsnorm, "flash_attention": flash_attention, "gmm": gmm,
           "selective_scan": selective_scan}
    return {name: {k: v for k, v in sorted(vars(op).items()) if k.startswith("launches")}
            for name, op in ops.items()}


def closing_line(node, n: int, objective: Callable) -> str:
    """``worker node=N ran n trials {...}``: the reference's line, then one
    JSON object of this process's launch counters and, for GA3C trials
    (``objective.trainers``), the trainers' env steps and updates."""
    extra = {"launches": launch_counters()}
    trainers = getattr(objective, "trainers", None)
    if trainers is not None:
        extra["env_steps"] = sum(tr.env_steps for tr in trainers)
        extra["updates"] = sum(tr.updates for tr in trainers)
    return f"worker node={node} ran {n} trials {json.dumps(extra, sort_keys=True)}"


def write_line(line: str) -> None:
    """``line`` and its newline to stdout in one write. A launcher's
    workers share its stdout pipe, and ``print`` on an unbuffered stdout
    writes the newline apart, so another worker's line could land between
    them; one write under ``PIPE_BUF`` bytes is not split."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def parse_closing_line(line: str) -> Optional[dict]:
    """A worker's closing line as its fields: ``{"node", "trials",
    "launches", ...}`` for a scalar worker's, ``{"node", "reports",
    "launches", "env_steps", "updates", "engine_steps"}`` for a population
    worker's (``population.worker.closing_line``); None for any other
    line."""
    line = line.strip()
    for pattern, count in ((_CLOSING, "trials"), (_POP_CLOSING, "reports")):
        m = pattern.match(line)
        if m is not None:
            node = None if m.group(1) == "None" else int(m.group(1))
            return {"node": node, count: int(m.group(2)), **json.loads(m.group(3))}
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--spec", default=None,
                    help="JSON objective spec, e.g. "
                         "'{\"kind\": \"synthetic\", \"sleep\": 0.01}'")
    ap.add_argument("--objective", choices=["synthetic", "rl", "lm"],
                    default="synthetic")
    ap.add_argument("--game", default="pong")
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--episodes-per-phase", type=int, default=20)
    ap.add_argument("--steps-per-phase", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the trials train, when the spec names no "
                         "device; checked before the worker connects")
    ap.add_argument("--node", type=int, default=None)
    ap.add_argument("--heartbeat-interval", type=float, default=2.0)
    ap.add_argument("--slots", type=int, default=1,
                    help="1 = classic scalar worker; >1 = population worker "
                         "leasing that many trials at once (rl / lm specs)")
    ap.add_argument("--bracket", action="store_true",
                    help="join the server-side successive-halving bracket: "
                         "acquires carry the rung-0 hint and 'parked' "
                         "report decisions are polled until the rung "
                         "cohort (pooled across every host) resolves")
    ap.add_argument("--unbatched", action="store_true",
                    help="report via the classic per-trial verb instead of "
                         "report_batch (for servers predating the batch "
                         "verbs)")
    ap.add_argument("--search", default=None,
                    help="tenant id on a multi-tenant server; omit for the "
                         "default (single-search) tenant")
    args = ap.parse_args(argv)

    if args.spec is not None:
        spec = json.loads(args.spec)
        spec.setdefault("device", args.device)
    else:
        spec = build_spec(args.objective, game=args.game, arch=args.arch,
                          episodes_per_phase=args.episodes_per_phase,
                          steps_per_phase=args.steps_per_phase,
                          seed=args.seed, device=args.device)

    if args.slots > 1:
        if spec.get("kind") not in ("rl", "lm"):
            print(f"--slots {args.slots} requires an rl or lm spec, got "
                  f"{spec.get('kind')!r}")
            return 2
        from repro_torch.population.worker import main as population_main
        if spec.get("kind") == "lm":
            # the LM spec's steps_per_phase is the engine's generic
            # units-per-phase knob (the lm objective counts updates)
            workload = ["--objective", "lm",
                        "--arch", spec.get("arch", "yi-9b"),
                        "--episodes-per-phase",
                        str(spec.get("steps_per_phase", 25))]
        else:
            workload = ["--game", spec.get("game", "pong"),
                        "--episodes-per-phase",
                        str(spec.get("episodes_per_phase", 20))]
        return population_main([
            "--host", args.host, "--port", str(args.port)]
            + workload + [
            "--slots", str(args.slots),
            "--max-updates", str(spec.get("max_updates", 2000)),
            "--seed", str(spec.get("seed", 0)),
            "--heartbeat-interval", str(args.heartbeat_interval),
            "--device", str(spec["device"])]
            + (["--bracket"] if args.bracket else [])
            + ([] if args.node is None else ["--node", str(args.node)]))

    from repro_torch.device import resolve_device
    try:
        resolve_device(spec["device"])   # no card: exit before any lease
    except RuntimeError as e:
        print(f"worker node={args.node}: {e}", file=sys.stderr)
        return 1
    objective = resolve_objective(spec)
    try:
        client = ServiceClient(args.host, args.port, search=args.search)
    except OSError as e:
        print(f"cannot reach server at {args.host}:{args.port}: {e}")
        return 1
    with client:
        n = WorkerAgent(client, objective,
                        heartbeat_interval=args.heartbeat_interval,
                        node=args.node, bracket=args.bracket,
                        batched=not args.unbatched).run()
    write_line(closing_line(args.node, n, objective))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
