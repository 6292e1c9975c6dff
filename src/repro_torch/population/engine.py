"""The population engine (port of ``repro/population/engine.py``): every
live trial of a search trains at once on one device, from one host thread.

The engine is pure *mechanism*, generic over a ``PopulationObjective``
(``population.objectives``): the objective supplies one trial's device
state as a ``(learner, carry)`` pair, a step over a stack of slots with
per-slot traced hyperparameters, and the traced-vs-structural hparam
split. The engine supplies everything else: per-trial state stacked along
a leading *slot* axis, trials bucketed by the objective-declared
structural key (each bucket is one step, one set of launches for all of
its slots), eviction masks, hot-swap admission and park/poll rung
barriers. Eviction masks the slot — a stopped slot is left out of its
bucket's steps — and the slot is immediately hot-swapped with the next
configuration from the service: the paper's §3.2 "the stopped worker's
node immediately acquires a fresh configuration", at slot granularity on
one device.

A masked slot does not move: a bucket with masked slots gathers its
active slots, steps them and writes them back, so a masked slot's
weights, optimizer and env state, episode counters and generator stay as
they were (the reference freezes them with a ``where`` over the whole
stack, its rng with them).

**Successive-halving rungs** (``bracket_eta``) — the generation barrier
lives in the SERVICE (``core.service.RungBarrier``), not here: a report at
a rung phase is answered ``"parked"``, the engine masks the slot and keeps
polling by re-sending the identical report, and promote/demote come back
as plain continue/stop decisions once the rung cohort is complete. The
engine never ranks a cohort itself; it only tells ACQUIRE (via the
``rung`` hint) that freed capacity is refilling the bracket.

**PBT exploit/explore** (``--scheduler pbt``): a CLONE verdict rides the
report reply; the engine copies the parent slot's learner (weights and
optimizer state, not the carry: the clone keeps its own envs or data and
generator) into the child's slot on the device (``Bucket.clone_slot``),
possibly across buckets, and installs the perturbed hyperparameters. A
parent that holds no slot here any more leaves the child its own learner:
it adopts the hyperparameters only.

The engine talks to the service through a *driver*, so the same loop
serves two deployments:

* ``LocalDriver``  — an in-process ``OptimizationService``
  (``core.executor.PopulationCluster``, ``launch/tune.py --backend
  vectorized``);
* ``RemoteDriver`` — the TCP ``ServiceClient``, leasing up to ``slots``
  trials an ACQUIRE, so one card trains a whole search or a share of it
  (``population.worker``; ``tune --backend process / server --slots N``).

With ``spans`` (a ``telemetry.spans.SpanRecorder``) the engine records the
reference's ``engine.compile`` (the host seconds of a bucket's first step
at its slot count: the kernel library's load, cuBLAS's and the caching
allocator's warm-up; there is no trace to compile, and the host clock
needs no sync with the card), ``engine.phase``, ``engine.clone`` and
``engine.park_stall`` spans.

Not ported: the ``shard_map`` slots over several devices (not owed on one
card).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.population.objectives import PopulationObjective
from repro_torch.rl.ga3c import trial_seed
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.spans import NULL_RECORDER


@dataclass(frozen=True)
class TrialLease:
    trial_id: int
    hparams: Dict[str, Any]
    n_phases: Optional[int] = None    # search length, when the driver knows it


# ---------------------------------------------------------------------------
# drivers: how the engine talks to the metaoptimization service
# ---------------------------------------------------------------------------
class LocalDriver:
    """In-process service — the engine IS the whole cluster. Speaks the
    same park/resolve interface as the reference's TCP path (the barrier
    lives in the service either way)."""

    def __init__(self, service):
        self.service = service

    def acquire_many(self, k: int, rung: Optional[int] = None,
                     ) -> Tuple[List[TrialLease], Optional[float]]:
        """Up to ``k`` fresh leases. ``(leases, retry)``: ``retry`` is None
        when an empty result is final (budget spent), else seconds to wait
        before polling again. ``rung`` is the bracket-refill hint."""
        n_phases = getattr(self.service.policy, "n_phases", None)
        leases = []
        for _ in range(k):
            rec = self.service.acquire_trial(rung=rung)
            if rec is None:
                break
            leases.append(TrialLease(rec.trial_id, rec.hparams, n_phases))
        return leases, None

    def report(self, trial_id: int, phase: int, metric: float,
               t_start: float, t_end: float,
               env_steps: Optional[int] = None) -> "ReportReply":
        from repro_torch.core.scheduler import ReportReply
        verdict = self.service.report_verdict(trial_id, phase, metric,
                                              t_start=t_start, t_end=t_end,
                                              env_steps=env_steps)
        return ReportReply(verdict.decision.value,
                           clone_from=verdict.clone_from,
                           perturb=verdict.perturb)

    def report_many(self, reports: List[dict]) -> List["ReportReply"]:
        """Batched reports (one engine generation). In-process there is no
        round-trip to save, so this simply loops."""
        return [self.report(r["trial_id"], r["phase"], r["metric"],
                            r["t_start"], r["t_end"],
                            env_steps=r.get("env_steps")) for r in reports]

    def poll_lost(self) -> set:
        """Trials whose lease was revoked out from under us (remote only)."""
        return set()


class RemoteDriver:
    """The TCP client: one process leases a whole population. A lease lost
    to the server's reaper (reported by the worker's heartbeat thread via
    ``mark_lost``) is abandoned without a report, exactly like a worker
    death with strictly local effect."""

    def __init__(self, client, node: Optional[int] = None):
        self.client = client
        self.node = node
        # written by the heartbeat thread, taken by the engine's loop
        self._lost: set = set()
        self._lost_lock = threading.Lock()
        self._t0 = time.monotonic()

    def set_timebase(self, t0: float) -> None:
        """Adopt the engine's run clock (``time.monotonic()`` at run start)
        so the trace ``t`` this driver sends shares the t_start / t_end
        timebase of the engine's reports."""
        self._t0 = t0

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def acquire_many(self, k: int, rung: Optional[int] = None,
                     ) -> Tuple[List[TrialLease], Optional[float]]:
        from repro_torch.distributed.client import Pending
        got = self.client.acquire_batch(node=self.node, slots=k, rung=rung,
                                        trace_t=self._now())
        if got is None:
            return [], None
        if isinstance(got, Pending):
            return [], got.retry_after
        return [TrialLease(t.trial_id, t.hparams, t.n_phases) for t in got], None

    def report(self, trial_id: int, phase: int, metric: float,
               t_start: float, t_end: float,
               env_steps: Optional[int] = None) -> str:
        from repro_torch.distributed.client import ServiceError
        try:
            return self.client.report(trial_id, phase, metric,
                                      t_start=t_start, t_end=t_end,
                                      node=self.node, env_steps=env_steps,
                                      trace_t=self._now())
        except ServiceError:
            # stale trial (server restarted / lease reaped between our
            # heartbeat and this report): strictly local effect — drop the
            # one slot, keep the rest of the population training
            return "stop"

    def report_many(self, reports: List[dict]) -> List:
        """A whole generation's reports in ONE ``report_batch`` frame. A
        server-rejected entry comes back ``"stop"`` (the client maps entry
        errors), and a frame the server rejects as a whole stops every slot
        in it: the same strictly-local abandonment as the per-trial path. A
        broken connection raises, and the worker ends as "server gone"."""
        from repro_torch.distributed.client import ServiceError
        entries = []
        for r in reports:
            e = {"trial_id": r["trial_id"], "phase": r["phase"],
                 "metric": r["metric"], "t_start": r["t_start"],
                 "t_end": r["t_end"]}
            if r.get("env_steps") is not None:
                e["env_steps"] = r["env_steps"]
            entries.append(e)
        try:
            return self.client.report_batch(entries, node=self.node,
                                            trace_t=self._now())
        except ServiceError:
            return ["stop"] * len(reports)

    def mark_lost(self, trial_id: int) -> None:
        with self._lost_lock:
            self._lost.add(trial_id)

    def poll_lost(self) -> set:
        with self._lost_lock:
            lost, self._lost = self._lost, set()
        return lost


# ---------------------------------------------------------------------------
# slots and buckets
# ---------------------------------------------------------------------------
@dataclass
class SlotMeta:
    """Host-side bookkeeping for one live trial in a bucket slot."""
    trial_id: int
    hparams: Dict[str, Any]
    slot_id: int                      # stable global slot number ("node")
    phase: int = 0
    updates_in_phase: int = 0
    phase_t0: float = 0.0
    start_sum: float = 0.0
    start_n: float = 0.0
    # bracket mode: (metric, t_start, t_end, env_steps) of a rung-phase
    # report the service answered "parked" — re-sent verbatim as the
    # barrier poll until the cohort resolves and a continue/stop verdict
    # comes back
    pending: Optional[Tuple[float, float, float, int]] = None
    # telemetry: wall time (perf_counter) the slot parked, for the
    # park-stall histogram; None while training
    parked_at: Optional[float] = None


class _Slots(list):
    """One object a slot (a trial's generator): the stacked form of a
    non-tensor leaf of the slot state. A pytree leaf, not a node."""


def _stacked(leaf, capacity: int):
    if isinstance(leaf, torch.Tensor):
        return leaf.new_zeros((capacity,) + tuple(leaf.shape))
    return None if leaf is None else _Slots([None] * capacity)


def _padded(stack, pad: int):
    if isinstance(stack, torch.Tensor):
        return torch.cat([stack, stack.new_zeros((pad,) + tuple(stack.shape[1:]))])
    return None if stack is None else _Slots(stack + [None] * pad)


def _take(stack, idx: np.ndarray, idx_dev: torch.Tensor):
    if isinstance(stack, torch.Tensor):
        return stack.index_select(0, idx_dev)
    return None if stack is None else _Slots(stack[i] for i in idx)


def _put(stack, idx: np.ndarray, idx_dev: torch.Tensor, new) -> None:
    if isinstance(stack, torch.Tensor):
        stack.index_copy_(0, idx_dev, new)
    elif stack is not None:
        for j, i in enumerate(idx):
            stack[i] = new[j]


class Bucket:
    """All slots sharing one structural bucket key (GA3C: ``t_max``):
    every leaf of the slot state stacked along a leading axis of
    ``capacity`` (tensors), or one object a slot (a trial's generator),
    and one step for the whole stack."""

    def __init__(self, engine: "PopulationEngine", key: Hashable,
                 capacity: int, template_hparams: Dict[str, Any]):
        self.engine = engine
        self.key = key
        obj = engine.objective
        self.traced_names = obj.hparam_spec().traced
        # work units (env transitions / tokens) one update of one slot
        # performs — the engine's throughput accounting
        self.update_cost = int(obj.update_cost(key))
        self.capacity = capacity
        # a template trial fixes the stacked shapes and dtypes only (zeros;
        # real state is written per slot at admission)
        learner, carry = obj.init_slot_state(0, template_hparams)
        leaves, self._spec = tree_flatten((learner, carry))
        # the learner's leaves come first: what a PBT clone copies
        self._n_learner = len(tree_flatten(learner)[0])
        self.leaves = [_stacked(leaf, capacity) for leaf in leaves]
        self.hyper = {n: np.zeros(capacity) for n in self.traced_names}
        self.active = np.zeros(capacity, bool)
        self._dev = None                # active slots and their hparams on the device
        self.meta: List[Optional[SlotMeta]] = [None] * capacity
        self.slot_ids = [engine._new_slot_id() for _ in range(capacity)]
        self._stepped = False           # telemetry: the first step is engine.compile
        self._step = obj.make_step(key, capacity)

    @property
    def learner(self):
        return tree_unflatten(self.leaves, self._spec)[0]

    @property
    def carry(self):
        return tree_unflatten(self.leaves, self._spec)[1]

    # -- slot management ----------------------------------------------------
    def free_index(self) -> Optional[int]:
        for i in range(self.capacity):
            if not self.active[i] and self.meta[i] is None:
                return i
        return None

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_occupied(self) -> int:
        """Active + parked slots (a parked trial still owns its slot)."""
        return sum(1 for m in self.meta if m is not None)

    def grow(self, new_capacity: int) -> None:
        """Pad every stack with empty slots; from capacity 2 on the bucket
        steps its slots together (``make_step``)."""
        pad = new_capacity - self.capacity
        assert pad > 0
        self.leaves = [_padded(stack, pad) for stack in self.leaves]
        self.hyper = {n: np.concatenate([a, np.zeros(pad)]) for n, a in self.hyper.items()}
        self.active = np.concatenate([self.active, np.zeros(pad, bool)])
        self._dev = None
        self.meta += [None] * pad
        self.slot_ids += [self.engine._new_slot_id() for _ in range(pad)]
        self.capacity = new_capacity
        self._stepped = False           # a new slot count: its first step again
        self._step = self.engine.objective.make_step(self.key, new_capacity)

    def write_slot(self, i: int, meta: SlotMeta, learner, carry,
                   traced: Sequence[float]) -> None:
        """Hot-swap a fresh configuration into slot ``i``. ``traced`` are
        the per-slot hyperparameter scalars in ``hparam_spec().traced``
        order (``PopulationObjective.traced_values``)."""
        leaves, spec = tree_flatten((learner, carry))
        assert spec == self._spec, "a slot's state must have the template's structure"
        for stack, leaf in zip(self.leaves, leaves):
            if stack is not None:
                stack[i] = leaf
        self.set_traced(i, traced)
        self.active[i] = True
        self.meta[i] = meta

    def set_traced(self, i: int, traced: Sequence[float]) -> None:
        """Slot ``i``'s traced hyperparameters, in ``hparam_spec().traced``
        order."""
        for n, v in zip(self.traced_names, traced):
            self.hyper[n][i] = v
        self._dev = None

    def clone_slot(self, dst: int, src_bucket: "Bucket", src: int,
                   traced: Sequence[float]) -> None:
        """PBT exploit: copy ``src_bucket``'s slot ``src`` learner (weights
        and optimizer state, NOT the carry: the clone keeps its own envs or
        data stream and generator) into slot ``dst``, one device-side copy
        a leaf (nothing crosses to the host), and install the perturbed
        traced hyperparameters. Learner shapes do not depend on the bucket
        key, so the source may be another bucket of the same engine."""
        for stack, source in zip(self.leaves[:self._n_learner],
                                 src_bucket.leaves[:self._n_learner]):
            if isinstance(stack, torch.Tensor):
                stack[dst].copy_(source[src])
            elif stack is not None:
                stack[dst] = source[src]
        self.set_traced(dst, traced)

    def release(self, i: int) -> None:
        """Eviction: mask the slot; it stops updating until a fresh config
        is swapped in."""
        self.active[i] = False
        self.meta[i] = None
        self._dev = None

    def park(self, i: int) -> None:
        """Rung barrier: mask the slot but keep the trial — its whole state
        stays as it is until the generation resolves and the survivor is
        unparked (promoted)."""
        self.active[i] = False
        self._dev = None

    def unpark(self, i: int) -> None:
        self.active[i] = True
        self._dev = None

    # -- the one step -------------------------------------------------------
    def step(self) -> None:
        """One update of every active slot, with one call of the step. The
        active slots and their hyperparameters go to the device when they
        change, not every step."""
        if self._dev is None:
            idx = np.flatnonzero(self.active)
            dev = self.engine.objective.device
            hyper = torch.tensor(np.stack([self.hyper[n][idx] for n in self.traced_names]),
                                 dtype=torch.float32, device=dev)
            idx_dev = None if len(idx) == self.capacity else torch.as_tensor(idx, device=dev)
            self._dev = idx, idx_dev, tuple(hyper)
        idx, idx_dev, hyper = self._dev
        if idx_dev is None:
            out = self._step(*tree_unflatten(self.leaves, self._spec), *hyper)
            self.leaves = tree_flatten(out)[0]
            return
        sub = [_take(stack, idx, idx_dev) for stack in self.leaves]
        out = self._step(*tree_unflatten(sub, self._spec), *hyper)
        for stack, new in zip(self.leaves, tree_flatten(out)[0]):
            _put(stack, idx, idx_dev, new)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class PopulationEngine:
    """Runs a whole asynchronous search on one device.

    The loop: fill free slots from the driver (service), run every bucket's
    step once, poll the episode counters, report finished phases, mask
    evicted slots and hot-swap fresh configurations into them. Phase
    semantics match ``GA3CTrainer.run_episodes`` exactly: a phase ends after
    the update in which ``episodes_per_phase`` episodes have finished, or at
    ``max_updates`` updates.

    ``objective``: a ``PopulationObjective`` or a game name, which builds
    the GA3C objective with ``n_envs`` envs a trial on ``device``.
    ``spans``: a ``telemetry.spans.SpanRecorder`` for the ``engine.*``
    spans (default ``NULL_RECORDER``, which records nothing)."""

    def __init__(self, objective, *, max_slots: int, n_envs: int = 16,
                 episodes_per_phase: int = 60, max_updates: int = 2000,
                 seed: int = 0, bracket_eta: Optional[int] = None,
                 metrics=None, spans=None, device="cuda"):
        if isinstance(objective, str):
            from repro_torch.population.objectives.ga3c import GA3CObjective
            objective = GA3CObjective(objective, n_envs=n_envs, device=device)
        self.objective: PopulationObjective = objective
        self.game = getattr(objective, "game", objective.name)
        # telemetry (engine.* metrics — see telemetry.metrics.METRIC_SCHEMA);
        # pass NULL_REGISTRY for a zero-overhead run
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # a SpanRecorder sinking to a journal, or the no-op twin (spans are
        # recorded per phase, clone, park and first step, never per step)
        self.spans = spans if spans is not None else NULL_RECORDER
        self.max_slots = max_slots
        self.n_envs = n_envs
        self.episodes_per_phase = episodes_per_phase
        self.max_updates = max_updates
        self.seed = seed
        # bracket mode: the rung barrier itself lives in the SERVICE (the
        # driver answers "parked" at rung phases); the engine only needs to
        # know it is a bracket participant so ACQUIRE carries the rung-0
        # refill hint, and eta for the speculative refill below
        assert bracket_eta is None or bracket_eta >= 2, bracket_eta
        self.bracket_eta = bracket_eta
        self._rung_hint = 0 if bracket_eta is not None else None
        # seconds between barrier polls of parked slots while other slots
        # still train (an idle host polls continuously instead)
        self.park_poll_interval = 0.2
        # speculative rung-0 refill: once every local slot is parked at a
        # rung barrier, the bottom 1/eta of them WILL be demoted when the
        # cohort resolves — acquire (and start training) that many fresh
        # entrants immediately instead of idling them across the verdict
        # poll's round-trip (see ``run``)
        self.buckets: Dict[Hashable, Bucket] = {}
        self.total_env_steps = 0       # active-lane env transitions
        self.total_updates = 0
        self.speculated = 0            # leases acquired by speculative refill
        self.clones = 0                # PBT clones executed as slot copies
        self._slot_counter = 0
        self.records: List[Tuple] = []  # (trial_id, slot, phase, t0, t1, m)

    def _new_slot_id(self) -> int:
        self._slot_counter += 1
        return self._slot_counter - 1

    @property
    def n_active(self) -> int:
        return sum(b.n_active for b in self.buckets.values())

    @property
    def n_occupied(self) -> int:
        """Active + parked: slots that cannot take a fresh configuration."""
        return sum(b.n_occupied for b in self.buckets.values())

    def active_trial_ids(self) -> List[int]:
        """Snapshot of live trial ids (parked trials included — they still
        hold leases that heartbeats must renew). Called from the worker's
        heartbeat thread while the engine mutates buckets: every container
        is copied in one C-level call (atomic under the GIL) before
        iterating."""
        return [m.trial_id for b in list(self.buckets.values()) for m in list(b.meta)
                if m is not None]

    # -- admission ----------------------------------------------------------
    def admit(self, lease: TrialLease, now: float = 0.0) -> None:
        hp = lease.hparams
        obj = self.objective
        key = obj.bucket_key(hp)
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = self.buckets[key] = Bucket(self, key, 1, hp)
        i = bucket.free_index()
        if i is None:
            i = bucket.capacity
            bucket.grow(bucket.capacity + 1)
        learner, carry = obj.init_slot_state(trial_seed(self.seed, hp), hp)
        meta = SlotMeta(lease.trial_id, hp, bucket.slot_ids[i], phase_t0=now)
        bucket.write_slot(i, meta, learner, carry, obj.traced_values(hp))

    def _admit_grouped(self, leases: Sequence[TrialLease], now: float) -> None:
        """Group by bucket key and pre-size buckets so an initial population
        of k same-bucket trials builds one stack of k, not k growths."""
        by_key: Dict[Hashable, List[TrialLease]] = {}
        for lease in leases:
            by_key.setdefault(self.objective.bucket_key(lease.hparams), []).append(lease)
        for key, group in by_key.items():
            bucket = self.buckets.get(key)
            free = (bucket.capacity - bucket.n_occupied) if bucket else 0
            need = len(group) - free
            if bucket is None:
                self.buckets[key] = Bucket(self, key, len(group), group[0].hparams)
            elif need > 0:
                bucket.grow(bucket.capacity + need)
            for lease in group:
                self.admit(lease, now)

    # -- the loop -----------------------------------------------------------
    def run(self, driver) -> List[Tuple]:
        t0 = time.monotonic()
        set_tb = getattr(driver, "set_timebase", None)
        if set_tb is not None:
            # remote tracing: the driver's trace `t` must share this run's
            # t_start/t_end timebase, or the server's clock offset is off
            # by the construction-to-run gap
            set_tb(t0)
        exhausted = False
        retry_at = 0.0
        poll_at = 0.0
        while True:
            now = time.monotonic()
            want = 0
            if not exhausted and now >= retry_at:
                if self.n_occupied < self.max_slots:
                    want = self.max_slots - self.n_occupied
                elif (self.bracket_eta and self.n_active == 0 and self._any_parked()):
                    # speculative rung-0 refill: the local cohort is fully
                    # parked; acquire the entrants its demotions will make
                    # room for BEFORE the verdict polls return (the service
                    # resolves any ready cohort before enrolling them, so
                    # they land in the next generation)
                    from repro_torch.core.asha import rung_demotions
                    want = (self.max_slots
                            + rung_demotions(self._n_parked(), self.bracket_eta)
                            - self.n_occupied)
            if want > 0:
                leases, retry = driver.acquire_many(want, rung=self._rung_hint)
                if self.n_occupied >= self.max_slots:
                    self.speculated += len(leases)
                    self.metrics.counter("engine.speculative_leases").inc(len(leases))
                if leases:
                    # stamped after the acquire returns, so that a slot's
                    # first phase never starts before the server granted
                    # its lease
                    self._admit_grouped(leases, time.monotonic() - t0)
                elif retry is None:
                    exhausted = True
                else:
                    retry_at = now + retry
            lost = driver.poll_lost()
            if lost:
                self._abandon(lost)
            if self._any_parked() and (self.n_active == 0 or now >= poll_at):
                # barrier poll: every parked slot re-sends its withheld
                # report; the service answers "parked" until the rung
                # cohort is complete, then promote/demote come back as
                # continue/stop
                self._poll_parked(driver, t0)
                poll_at = now + self.park_poll_interval
            if self.n_active == 0:
                if self._any_parked():
                    time.sleep(min(self.park_poll_interval, 0.05))
                    continue
                if exhausted:
                    break
                time.sleep(min(max(retry_at - time.monotonic(), 0.01), 0.5))
                continue
            iter_t0 = time.perf_counter()
            for bucket in self.buckets.values():
                if bucket.n_active:
                    step_t0 = time.perf_counter()
                    bucket.step()
                    if not bucket._stepped:
                        # the first step at this slot count: host seconds
                        # (the kernel library's load, cuBLAS's and the
                        # allocator's warm-up), no sync with the card
                        bucket._stepped = True
                        first_s = time.perf_counter() - step_t0
                        self.metrics.histogram("engine.compile_s").observe(first_s)
                        # it serves every trial stacked in the bucket
                        self.spans.end("engine.compile", first_s, cat="engine",
                                       bucket=bucket.key,
                                       trials=[m.trial_id for m in bucket.meta
                                               if m is not None])
                    stepped = bucket.n_active
                    self.total_updates += stepped
                    self.total_env_steps += stepped * bucket.update_cost
                    self.metrics.counter("engine.updates").inc(stepped)
                    self.metrics.counter("engine.env_steps").inc(stepped * bucket.update_cost)
            self._poll_phases(driver, t0)
            self.metrics.histogram("engine.step_s").observe(time.perf_counter() - iter_t0)
            self.metrics.gauge("engine.slots_active").set(self.n_active)
            self.metrics.gauge("engine.slots_occupied").set(self.n_occupied)
            elapsed = time.monotonic() - t0
            if elapsed > 0:
                self.metrics.gauge("engine.env_steps_s").set(self.total_env_steps / elapsed)
        return self.records

    def _progress(self, bucket: Bucket) -> Tuple[np.ndarray, np.ndarray]:
        """The bucket's (episodes finished, their score sum) a slot, read
        with one copy to the host."""
        counts, sums = self.objective.progress(bucket.carry)
        both = torch.stack((counts, sums)).cpu().numpy()
        return both[0], both[1]

    @staticmethod
    def _report_many(driver, reports: List[dict]) -> List:
        """Send a generation's reports through the driver — one
        ``report_many`` call when the driver has it, a per-report loop
        otherwise (scripted test drivers)."""
        many = getattr(driver, "report_many", None)
        if many is not None:
            return many(reports)
        return [driver.report(r["trial_id"], r["phase"], r["metric"],
                              r["t_start"], r["t_end"],
                              env_steps=r.get("env_steps"))
                for r in reports]

    def _poll_phases(self, driver, t0: float) -> None:
        # two passes so every slot that finished its phase this iteration
        # reports in ONE driver call: first collect the finished slots,
        # then apply the index-aligned decisions
        ready: List[tuple] = []
        for bucket in self.buckets.values():
            if not bucket.n_active:
                continue
            fin_n, fin_sum = self._progress(bucket)
            for i in range(bucket.capacity):
                meta = bucket.meta[i]
                if meta is None or not bucket.active[i]:
                    continue
                meta.updates_in_phase += 1
                n = float(fin_n[i]) - meta.start_n
                if n < self.episodes_per_phase and meta.updates_in_phase < self.max_updates:
                    continue
                score = (float(fin_sum[i]) - meta.start_sum) / max(n, 1.0)
                t_now = time.monotonic() - t0
                phase_steps = meta.updates_in_phase * bucket.update_cost
                phase_s = t_now - meta.phase_t0
                if phase_s > 0:
                    self.metrics.histogram("engine.phase_env_steps_s").observe(
                        phase_steps / phase_s)
                self.spans.end("engine.phase", phase_s, cat="engine",
                               trial_id=meta.trial_id, phase=meta.phase,
                               slot=meta.slot_id)
                ready.append((bucket, fin_n, fin_sum, i, meta, score, t_now, phase_steps))
        if not ready:
            return
        decisions = self._report_many(driver, [
            {"trial_id": m.trial_id, "phase": m.phase, "metric": score,
             "t_start": m.phase_t0, "t_end": t_now, "env_steps": phase_steps}
            for (_, _, _, _, m, score, t_now, phase_steps) in ready])
        for ((bucket, fin_n, fin_sum, i, meta, score, t_now, phase_steps),
             decision) in zip(ready, decisions):
            if decision == "parked":
                # rung phase: the service withheld the report at the
                # barrier — mask the slot and keep the exact report for
                # the barrier polls
                meta.pending = (score, meta.phase_t0, t_now, phase_steps)
                meta.parked_at = time.perf_counter()
                bucket.park(i)
                continue
            self.records.append((meta.trial_id, meta.slot_id, meta.phase,
                                 meta.phase_t0, t_now, score))
            if decision == "stop":
                bucket.release(i)
                continue
            if getattr(decision, "clone_from", None) is not None:
                # PBT exploit/explore: copy the parent's learner on the
                # device and adopt the perturbed hyperparameters
                self._exploit(bucket, i, meta, decision)
            meta.phase += 1
            meta.updates_in_phase = 0
            meta.start_n = float(fin_n[i])
            meta.start_sum = float(fin_sum[i])
            meta.phase_t0 = t_now

    # -- PBT exploit/explore (CLONE verdicts) -------------------------------
    def _find_slot(self, trial_id: int) -> Optional[Tuple[Bucket, int]]:
        for bucket in self.buckets.values():
            for i, meta in enumerate(bucket.meta):
                if meta is not None and meta.trial_id == trial_id:
                    return bucket, i
        return None

    def _exploit(self, bucket: Bucket, i: int, meta: SlotMeta, reply) -> None:
        """Execute a CLONE verdict: the trial goes on as a copy of
        ``reply.clone_from``'s learner under ``reply.perturb``. A parent in
        a slot of this engine is copied slot to slot on the device; a parent
        that left its slot cannot give its weights, so the trial keeps its
        own learner and adopts the perturbed hyperparameters only."""
        hp = dict(reply.perturb) if reply.perturb else dict(meta.hparams)
        traced = self.objective.traced_values(hp, fallback=meta.hparams)
        src = self._find_slot(reply.clone_from)
        if src is not None and src != (bucket, i):
            src_bucket, j = src
            clone_t0 = time.perf_counter()
            bucket.clone_slot(i, src_bucket, j, traced)
            self.clones += 1
            self.metrics.counter("engine.clones").inc()
            self.spans.end("engine.clone", time.perf_counter() - clone_t0, cat="engine",
                           trial_id=meta.trial_id, clone_from=reply.clone_from)
        else:
            bucket.set_traced(i, traced)
        meta.hparams = hp

    # -- rung barriers (service-side successive halving) --------------------
    def _any_parked(self) -> bool:
        return any(m is not None and not b.active[i]
                   for b in self.buckets.values()
                   for i, m in enumerate(b.meta))

    def _n_parked(self) -> int:
        return sum(1 for b in self.buckets.values()
                   for i, m in enumerate(b.meta)
                   if m is not None and not b.active[i])

    def _poll_parked(self, driver, t0: float) -> None:
        """The thin-client side of the service's rung barrier: re-send each
        parked slot's withheld report. ``"parked"`` → the cohort is still
        filling, keep waiting; ``"continue"`` → promoted, unpark into the
        next phase; ``"stop"`` → demoted (or the lease is gone), free the
        slot for the admission path to hot-swap a fresh configuration."""
        polls: List[tuple] = []
        for bucket in self.buckets.values():
            for i in range(bucket.capacity):
                meta = bucket.meta[i]
                if meta is None or bucket.active[i] or meta.pending is None:
                    continue
                polls.append((bucket, i, meta))
        if not polls:
            return
        self.metrics.counter("engine.park_polls").inc(len(polls))
        decisions = self._report_many(driver, [
            {"trial_id": m.trial_id, "phase": m.phase,
             "metric": m.pending[0], "t_start": m.pending[1],
             "t_end": m.pending[2], "env_steps": m.pending[3]}
            for (_, _, m) in polls])
        # each bucket's episode counters are read only when one of its
        # slots actually unparks
        counters: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for (bucket, i, meta), decision in zip(polls, decisions):
            if decision == "parked":
                continue
            score, ts, te, phase_steps = meta.pending
            self.records.append((meta.trial_id, meta.slot_id, meta.phase, ts, te, score))
            meta.pending = None
            if meta.parked_at is not None:
                stall_s = time.perf_counter() - meta.parked_at
                self.metrics.histogram("engine.park_stall_s").observe(stall_s)
                self.spans.end("engine.park_stall", stall_s, cat="engine",
                               trial_id=meta.trial_id, phase=meta.phase, slot=meta.slot_id)
                meta.parked_at = None
            if decision == "stop":
                bucket.release(i)
                continue
            key = id(bucket)
            if key not in counters:
                counters[key] = self._progress(bucket)
            fin_n, fin_sum = counters[key]
            meta.phase += 1
            meta.updates_in_phase = 0
            meta.start_n = float(fin_n[i])
            meta.start_sum = float(fin_sum[i])
            meta.phase_t0 = time.monotonic() - t0
            bucket.unpark(i)

    def _abandon(self, trial_ids: set) -> None:
        for bucket in self.buckets.values():
            for i in range(bucket.capacity):
                meta = bucket.meta[i]
                if meta is not None and meta.trial_id in trial_ids:
                    bucket.release(i)
