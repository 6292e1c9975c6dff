"""Fault-tolerant TCP server wrapping one or many ``OptimizationService``s
(port of ``repro/distributed/server.py``, copied whole).

A single selector-driven event loop (``selectors``/non-blocking sockets —
no thread per connection) speaks the ``protocol`` verbs; a reaper thread
enforces per-trial *leases*: every acquire grants a lease of ``lease_ttl``
seconds, renewed by heartbeats and reports. When a worker dies silently its
lease expires, the trial is marked CRASHED (strictly local effect, paper
§3.2) and its configuration is requeued so the node's budget slot is
re-issued and the search never stalls.

Multi-tenancy: the server hosts any number of *searches*, each a fully
independent ``_Search`` — its own ``OptimizationService``/``Scheduler``,
its own journal, its own leases and metrics registry. Frames carry an
optional ``search`` id routing to a tenant registered via ``add_search``;
frames without one hit the default tenant (the constructor's service), so
single-search peers are wire-identical to the pre-tenant server.

All state changes are written to the tenant's ``Journal`` before the
response leaves the event loop, and ``compact_every`` journaled events the
journal is snapshot-compacted (``Journal.compact`` +
``OptimizationService.state_snapshot``) so restart replay stays O(live
trials) as history grows.
"""
from __future__ import annotations

import selectors
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler import Verdict, VerdictKind
from repro_torch.core.service import Decision, OptimizationService, TrialStatus
from repro_torch.distributed import protocol as proto
from repro_torch.distributed.journal import Journal
from repro_torch.telemetry.spans import NULL_RECORDER, SpanRecorder

# verbs that get an `rpc.<verb>` span in the journal. Heartbeats are too
# chatty (one per live trial per interval) and stats/summary/shutdown are
# tooling — none of them explain where a trial's wall-clock went.
_SPANNED_VERBS = frozenset(("acquire", "report", "crash", "acquire_batch",
                            "report_batch"))


class _Search:
    """One tenant: a service, its journal/spans, its leases, its metrics.
    Everything a verb touches hangs off the routed ``_Search``, so tenants
    share nothing but the event loop and the listening socket."""

    __slots__ = ("service", "journal", "spans", "metrics", "leases",
                 "lock", "trace_ctx", "report_log", "log_lock",
                 "events_since_compact")

    def __init__(self, service: OptimizationService,
                 journal: Optional[Journal]):
        self.service = service
        self.journal = journal
        # spans land in the same journal as every other event; a
        # journal-less tenant records nothing (the null twin)
        self.spans = (SpanRecorder(journal) if journal is not None
                      else NULL_RECORDER)
        # per-tenant metric labeling: the tenant's wire metrics land in the
        # same registry as its service's verdict metrics, so one STATS verb
        # (scoped by `search`) covers both for exactly that tenant
        self.metrics = service.metrics
        self.leases: Dict[int, float] = {}           # trial_id -> expiry
        # guards leases + every barrier-resolution trigger, exactly as the
        # old single-tenant _lease_lock did (the reaper thread still runs
        # concurrently with the event loop)
        self.lock = threading.Lock()
        # distributed tracing: per-trial worker context — "ctx" (the
        # worker's trace id, stamped onto journal acquire events) and
        # "offset" (server wall clock minus the worker's t_start/t_end
        # clock, refreshed from every traced frame's "t")
        self.trace_ctx: Dict[int, dict] = {}
        # (trial_id, node, phase, t_start, t_end, metric) per report, so
        # the launcher can rebuild ExecRecords for occupancy accounting
        self.report_log: List[Tuple] = []
        self.log_lock = threading.Lock()
        self.events_since_compact = 0


class _Conn:
    """Per-connection event-loop state: the incremental frame decoder and
    the pending outbound bytes."""

    __slots__ = ("sock", "frames", "out", "shutdown_after")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.frames = proto.FrameBuffer()
        self.out = bytearray()
        self.shutdown_after = False


class MetaoptServer:
    def __init__(self, service: OptimizationService, host: str = "127.0.0.1",
                 port: int = 0, lease_ttl: float = 15.0,
                 journal: Optional[Journal] = None, clock=time.monotonic,
                 bracket_capacity: Optional[int] = None,
                 compact_every: Optional[int] = None):
        self.lease_ttl = lease_ttl
        self.clock = clock
        # journal snapshot-compaction cadence (per tenant, in journaled
        # events); None disables — restart replay then walks full history
        self.compact_every = compact_every
        if bracket_capacity is not None:
            # bracket mode: the first rung-0 cohort waits for this many
            # enrollments (the fleet's total slots, capped by budget by the
            # caller), so pooling never depends on host connection timing;
            # the patience valve keeps dead capacity from wedging it
            service.configure_bracket(
                expect_entrants=bracket_capacity,
                entrant_patience=max(2.0 * lease_ttl, 10.0))
        default = _Search(service, journal)
        # None routes the tenantless wire — the constructor's service
        self._searches: Dict[Optional[str], _Search] = {None: default}
        # single-tenant attribute surface, unchanged: these alias the
        # default tenant's objects (same instances, so mutation through
        # either name is visible to launchers/tests that predate tenants)
        self.service = service
        self.journal = journal
        self.spans = default.spans
        self.metrics = default.metrics
        self.report_log = default.report_log
        self._log_lock = default.log_lock
        self._leases = default.leases
        self._lease_lock = default.lock
        self._trace_ctx = default.trace_ctx
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()                 # event-loop thread only
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]

    # -- tenancy ------------------------------------------------------------
    def add_search(self, search_id: str, service: OptimizationService,
                   journal: Optional[Journal] = None,
                   bracket_capacity: Optional[int] = None) -> None:
        """Register a tenant: frames carrying ``search=search_id`` route to
        ``service`` (its own scheduler, journal, leases, metrics). Safe to
        call on a running server — the dict swap is atomic under the GIL
        and the event loop reads it per frame."""
        if search_id in self._searches:
            raise ValueError(f"search {search_id!r} already registered")
        if bracket_capacity is not None:
            service.configure_bracket(
                expect_entrants=bracket_capacity,
                entrant_patience=max(2.0 * self.lease_ttl, 10.0))
        self._searches[search_id] = _Search(service, journal)
        self.metrics.gauge("server.searches.open").set(
            len(self._searches))

    def detach_search(self, search_id: str) -> None:
        """Unregister a tenant: its leases drop, its journal closes, and
        subsequent frames for it answer `error`. The other searches (and
        the server) keep running — the wire-level half is a ``shutdown``
        frame carrying the ``search`` id."""
        st = self._searches.pop(search_id, None)
        if st is None:
            raise LookupError(f"unknown search {search_id!r}")
        with st.lock:
            st.leases.clear()
        if st.journal is not None:
            st.journal.close()
        self.metrics.gauge("server.searches.open").set(
            len(self._searches))

    def _route(self, msg) -> Optional[_Search]:
        return self._searches.get(getattr(msg, "search", None))

    # -- lifecycle ----------------------------------------------------------
    def live_lease_count(self) -> int:
        total = 0
        for st in list(self._searches.values()):
            with st.lock:
                total += len(st.leases)
        return total

    def start(self) -> "MetaoptServer":
        for target in (self._serve_loop, self._reaper_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        cur = threading.current_thread()
        for t in self._threads:
            if t is not cur:
                t.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- the event loop -----------------------------------------------------
    def _serve_loop(self):
        sel = selectors.DefaultSelector()
        self._listener.setblocking(False)
        try:
            sel.register(self._listener, selectors.EVENT_READ, None)
        except (OSError, ValueError):
            return                      # stop() already closed the listener
        try:
            while not self._stop.is_set():
                for key, mask in sel.select(timeout=0.05):
                    if key.data is None:
                        self._accept(sel)
                    else:
                        self._service_conn(sel, key.data, mask)
        finally:
            for conn in list(self._conns):
                self._drop(sel, conn)
            sel.close()

    def _accept(self, sel) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return                  # listener closed mid-select
            sock.setblocking(False)
            conn = _Conn(sock)
            self._conns.add(conn)
            sel.register(sock, selectors.EVENT_READ, conn)
            self.metrics.counter("server.connections.opened").inc()
            self.metrics.gauge("server.connections.open").add(1)

    def _service_conn(self, sel, conn: _Conn, mask: int) -> None:
        if mask & selectors.EVENT_READ:
            try:
                data = conn.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                data = None
            except OSError:
                self._drop(sel, conn)
                return
            if data == b"":             # peer EOF — same as the old close
                self._drop(sel, conn)
                return
            if data:
                try:
                    msgs = conn.frames.feed(data)
                except proto.ProtocolError:
                    self._drop(sel, conn)
                    return
                for msg in msgs:
                    conn.out += proto.encode(self._respond(msg))
                    if (isinstance(msg, proto.ShutdownRequest)
                            and msg.search is None):
                        conn.shutdown_after = True
        if conn.out:
            try:
                sent = conn.sock.send(memoryview(conn.out))
                del conn.out[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._drop(sel, conn)
                return
        try:
            sel.modify(conn.sock, selectors.EVENT_READ
                       | (selectors.EVENT_WRITE if conn.out else 0), conn)
        except (KeyError, ValueError, OSError):
            return
        if conn.shutdown_after and not conn.out:
            # whole-server shutdown: the response is flushed, stop from a
            # helper thread (stop() joins this loop's thread)
            conn.shutdown_after = False
            threading.Thread(target=self.stop, daemon=True).start()

    def _drop(self, sel, conn: _Conn) -> None:
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn in self._conns:
            self._conns.discard(conn)
            self.metrics.counter("server.connections.closed").inc()
            self.metrics.gauge("server.connections.open").add(-1)

    # -- verbs --------------------------------------------------------------
    def _respond(self, msg):
        t0 = time.perf_counter()
        wall0 = time.time()
        st = self._route(msg)
        if st is None:
            # unknown tenant: answer error, keep the connection (and the
            # peer's other searches) alive
            self.metrics.counter("server.errors").inc()
            return proto.ErrorResponse(
                f"unknown search {getattr(msg, 'search', None)!r}")
        try:
            resp = self._dispatch(st, msg)
        except Exception as e:  # noqa: BLE001 — fault isolation
            resp = proto.ErrorResponse(f"{type(e).__name__}: {e}")
        rpc_s = time.perf_counter() - t0
        st.metrics.histogram("server.rpc_s." + msg.TYPE).observe(rpc_s)
        if msg.TYPE in _SPANNED_VERBS:
            st.spans.record("rpc." + msg.TYPE, wall0, rpc_s, cat="rpc",
                            trial_id=getattr(msg, "trial_id", None),
                            node=getattr(msg, "node", None))
        if isinstance(resp, proto.ErrorResponse):
            st.metrics.counter("server.errors").inc()
        if not isinstance(msg, proto.ShutdownRequest):
            # a search-shutdown just closed st's journal — nothing to
            # compact there anymore
            self._maybe_compact(st)
        return resp

    def _dispatch(self, st: _Search, msg):
        if isinstance(msg, proto.AcquireRequest):
            return self._do_acquire(st, msg)
        if isinstance(msg, proto.ReportRequest):
            return self._do_report(st, msg)
        if isinstance(msg, proto.AcquireBatchRequest):
            return self._do_acquire_batch(st, msg)
        if isinstance(msg, proto.ReportBatchRequest):
            return self._do_report_batch(st, msg)
        if isinstance(msg, proto.HeartbeatRequest):
            with st.lock:
                alive = msg.trial_id in st.leases
                if alive:
                    st.leases[msg.trial_id] = self.clock() + self.lease_ttl
            return proto.HeartbeatResponse(ok=alive)
        if isinstance(msg, proto.CrashRequest):
            # under the tenant lock like every other barrier-resolution
            # trigger (_do_report, _reclaim): the crashed trial may be the
            # last unparked member of a rung cohort, and the resolution its
            # departure causes must not interleave with a concurrent
            # report's recorded-check on a cohort-mate
            with st.lock:
                st.service.crash(msg.trial_id)
                st.leases.pop(msg.trial_id, None)
                resolved = st.service.drain_resolved()
            self._journal_status(st, msg.trial_id)
            self._absorb_resolved(st, resolved)
            return proto.CrashResponse()
        if isinstance(msg, proto.SummaryRequest):
            s = st.service.db.summary()
            s["alpha"] = round(st.service.db.completion_rate(
                st.service.policy.n_phases), 4)
            return proto.SummaryResponse(summary=s)
        if isinstance(msg, proto.StatsRequest):
            # live telemetry snapshot (service + server metrics share one
            # registry per tenant) plus the one value only the server knows
            snap = st.metrics.snapshot()
            with st.lock:
                snap["live_leases"] = len(st.leases)
            return proto.StatsResponse(stats=snap)
        if isinstance(msg, proto.ShutdownRequest):
            if msg.search is not None:
                self.detach_search(msg.search)
            return proto.ShutdownResponse()
        raise proto.ProtocolError(f"unexpected message {msg.TYPE!r}")

    def _grant(self, st: _Search, node, slots: int, rung, trace) -> list:
        """The shared acquire path: lease up to ``slots`` trials and
        journal each grant. Atomic with the reaper: either we get the
        requeued config of a just-reclaimed trial, or we still see its
        lease and tell the worker to retry — a dying worker's config can
        never be lost. Returns the granted records; an empty list means
        the caller should consult ``_retry_after``."""
        recs = []
        with st.lock:
            for _ in range(max(1, slots)):
                rec = st.service.acquire_trial(node, rung=rung)
                if rec is None:
                    break
                st.leases[rec.trial_id] = self.clock() + self.lease_ttl
                recs.append(rec)
        for rec in recs:
            ctx = self._note_trace(st, rec.trial_id, trace)
            ev = {"ev": "acquire", "trial_id": rec.trial_id,
                  "hparams": rec.hparams, "node": rec.node,
                  "requeued": rec.requeued, "t": rec.start_time}
            if rec.bracket_id:
                ev["bracket"] = rec.bracket_id
            if ctx is not None:
                ev["ctx"] = ctx
            self._journal(st, ev)
        return recs

    def _retry_after(self, st: _Search) -> Optional[float]:
        with st.lock:
            return min(1.0, self.lease_ttl / 2) if st.leases else None

    def _do_acquire(self, st: _Search, msg: proto.AcquireRequest):
        n_phases = st.service.policy.n_phases
        recs = self._grant(st, msg.node,
                           int(getattr(msg, "slots", 1) or 1),
                           getattr(msg, "rung", None),
                           getattr(msg, "trace", None))
        if not recs:
            return proto.AcquireResponse(None, None, n_phases,
                                         retry_after=self._retry_after(st))

        def batch_entry(r):
            entry = {"trial_id": r.trial_id, "hparams": r.hparams}
            if r.bracket_id:
                entry["bracket_id"] = r.bracket_id
            return entry

        batch = [batch_entry(r) for r in recs[1:]] or None
        return proto.AcquireResponse(recs[0].trial_id, recs[0].hparams,
                                     n_phases, batch=batch,
                                     bracket_id=recs[0].bracket_id or None)

    def _do_acquire_batch(self, st: _Search, msg: proto.AcquireBatchRequest):
        n_phases = st.service.policy.n_phases
        recs = self._grant(st, msg.node,
                           int(getattr(msg, "slots", 1) or 1),
                           getattr(msg, "rung", None),
                           getattr(msg, "trace", None))
        leases = []
        for r in recs:
            entry = {"trial_id": r.trial_id, "hparams": r.hparams}
            if r.bracket_id:
                entry["bracket_id"] = r.bracket_id
            leases.append(entry)
        return proto.AcquireBatchResponse(
            leases, n_phases,
            retry_after=None if recs else self._retry_after(st))

    def _note_trace(self, st: _Search, trial_id: int,
                    tr) -> Optional[str]:
        """Absorb a frame's trace context; returns the trial's ctx (if
        any). ``offset`` maps the worker's t_start/t_end clock onto the
        server's wall clock — refreshed every traced frame, so worker
        clock drift re-zeros at each report."""
        entry = st.trace_ctx.get(trial_id)
        if isinstance(tr, dict):
            if entry is None:
                entry = st.trace_ctx[trial_id] = {}
            ctx = tr.get("ctx")
            if ctx is not None:
                entry["ctx"] = str(ctx)
            t = tr.get("t")
            if isinstance(t, (int, float)):
                entry["offset"] = time.time() - float(t)
        return entry.get("ctx") if entry else None

    def _phase_span(self, st: _Search, trial_id: int, phase: int,
                    t_start: float, t_end: float, node) -> None:
        """A stitched `trial.phase` span: the worker-side interval mapped
        onto the server wall clock via the trial's trace offset. Without a
        trace context the span is anchored so it *ends now* — exact for a
        fresh report (sent right after t_end), shifted-but-well-formed for
        a barrier-resolved one."""
        dur = t_end - t_start
        if dur < 0:
            return
        entry = st.trace_ctx.get(trial_id, {})
        offset = entry.get("offset")
        ts = (offset + t_start) if offset is not None else time.time() - dur
        st.spans.record("trial.phase", ts, dur, cat="trial",
                        trial_id=trial_id, phase=phase, node=node,
                        ctx=entry.get("ctx"))

    def _do_report(self, st: _Search, msg: proto.ReportRequest):
        rec = st.service.db.trials.get(msg.trial_id)
        if rec is None:
            return proto.ErrorResponse(f"unknown trial {msg.trial_id}")
        self._note_trace(st, msg.trial_id, getattr(msg, "trace", None))
        # atomic with the reaper: a zombie whose lease was reclaimed gets
        # "stop" and its metric is never recorded — the status check, the
        # report, and the lease renewal cannot interleave with _reclaim
        with st.lock:
            if rec.status is TrialStatus.CRASHED:
                return proto.ReportResponse(decision="stop")
            n_before = rec.phases_completed
            b = st.service.barrier
            was_parked = b is not None and b.is_parked(msg.trial_id)
            verdict = st.service.report_verdict(
                msg.trial_id, msg.phase, msg.metric, t_start=msg.t_start,
                t_end=msg.t_end, node=msg.node,
                env_steps=getattr(msg, "env_steps", None))
            decision = verdict.decision
            # the FIRST park of a rung-phase report is journaled (polls are
            # not): the dashboard derives cohort occupancy and park-to-
            # resolution waits from it. Replay skips unknown event kinds,
            # so old servers/journals are unaffected.
            parked_now = (decision is Decision.PARKED and not was_parked)
            if getattr(msg, "demote", None):
                # client-side rung demotion (pre-barrier population
                # engines): metric recorded above, trial killed here
                st.service.stop_trial(msg.trial_id)
                verdict = Verdict.STOP
                decision = Decision.STOP
            if decision.value == "stop":
                st.leases.pop(msg.trial_id, None)
            else:
                # renewed for "continue" AND "parked": a parked trial keeps
                # its lease alive through polls (and heartbeats) while the
                # rung cohort fills
                st.leases[msg.trial_id] = self.clock() + self.lease_ttl
            # a "parked" answer journals nothing here — even when this very
            # report completed the cohort and the resolution recorded it
            # (the drain below carries it, exactly once). A verdict poll's
            # report was recorded at resolution too. Only a fresh normal
            # recording journals here. The timestamp is captured INSIDE the
            # lock: a concurrent report on the same trial could otherwise
            # append first and we would journal its timestamp.
            recorded = (decision is not Decision.PARKED
                        and rec.phases_completed > n_before)
            report_t = rec.reports[-1][1] if recorded else None
            resolved = st.service.drain_resolved()
        if parked_now:
            self._journal(st, {"ev": "park", "trial_id": msg.trial_id,
                               "phase": msg.phase})
        if recorded:
            ev = {"ev": "report", "trial_id": msg.trial_id,
                  "phase": msg.phase, "metric": msg.metric, "t": report_t}
            if getattr(msg, "env_steps", None) is not None:
                ev["env_steps"] = msg.env_steps
            self._journal(st, ev)
            self._phase_span(st, msg.trial_id, msg.phase, msg.t_start,
                             msg.t_end, msg.node)
            if verdict.kind is VerdictKind.CLONE:
                # the trial's live hparams became the perturbed ones: a
                # replayed journal must rebuild the same configuration
                self._journal(st, {"ev": "perturb",
                                   "trial_id": msg.trial_id,
                                   "hparams": verdict.perturb,
                                   "clone_from": verdict.clone_from})
            if rec.status is not TrialStatus.RUNNING:
                self._journal_status(st, msg.trial_id)
            node = msg.node if msg.node is not None else rec.node
            with st.log_lock:
                st.report_log.append((msg.trial_id, node, msg.phase,
                                      msg.t_start, msg.t_end, msg.metric))
        self._absorb_resolved(st, resolved)
        return proto.ReportResponse(decision=decision.value,
                                    clone_from=verdict.clone_from,
                                    perturb=verdict.perturb)

    def _do_report_batch(self, st: _Search, msg: proto.ReportBatchRequest):
        """One frame, many reports: each entry runs the full single-report
        path (journal-before-reply included), so the journal stream is
        exactly what the same reports sent as single frames would write —
        crash-restart replay needs no batch awareness. A bad entry yields
        an index-aligned ``error`` reply without failing its batch-mates.
        """
        replies = []
        for entry in msg.reports:
            try:
                req = proto.ReportRequest(
                    trial_id=int(entry["trial_id"]),
                    phase=int(entry["phase"]),
                    metric=float(entry["metric"]),
                    t_start=float(entry.get("t_start", 0.0)),
                    t_end=float(entry.get("t_end", 0.0)),
                    node=entry.get("node", msg.node),
                    demote=entry.get("demote"),
                    env_steps=entry.get("env_steps"),
                    trace=msg.trace)
            except (KeyError, TypeError, ValueError) as e:
                st.metrics.counter("server.errors").inc()
                replies.append({"error": f"bad report entry: {e}"})
                continue
            try:
                resp = self._do_report(st, req)
            except Exception as e:  # noqa: BLE001 — entry isolation
                resp = proto.ErrorResponse(f"{type(e).__name__}: {e}")
            if isinstance(resp, proto.ErrorResponse):
                st.metrics.counter("server.errors").inc()
                replies.append({"error": resp.error})
            else:
                rep = {"decision": resp.decision}
                if resp.clone_from is not None:
                    rep["clone_from"] = resp.clone_from
                if resp.perturb is not None:
                    rep["perturb"] = resp.perturb
                replies.append(rep)
        st.metrics.counter("server.batch_reports").inc(len(msg.reports))
        return proto.ReportBatchResponse(replies)

    def _absorb_resolved(self, st: _Search, resolved) -> None:
        """Journal + log the withheld reports a barrier resolution just
        recorded (in the cohort's park order). Leases are NOT released
        here: a resolved trial keeps its lease until its worker polls the
        verdict (a normal "stop"-releases-lease report), so the verdict
        can never race the reaper; a dead worker's lease simply expires."""
        for rep in resolved:
            ev = {"ev": "report", "trial_id": rep.trial_id,
                  "phase": rep.phase, "metric": rep.metric,
                  "t": rep.t_recorded}
            if rep.env_steps is not None:
                ev["env_steps"] = rep.env_steps
            self._journal(st, ev)
            node = rep.node
            if node is None:
                trial = st.service.db.trials.get(rep.trial_id)
                node = trial.node if trial is not None else None
            self._phase_span(st, rep.trial_id, rep.phase, rep.t_start,
                             rep.t_end, node)
            if rep.decision is not Decision.CONTINUE:
                self._journal_status(st, rep.trial_id)
            with st.log_lock:
                st.report_log.append((rep.trial_id, node, rep.phase,
                                      rep.t_start, rep.t_end, rep.metric))

    # -- lease reaper -------------------------------------------------------
    def _reaper_loop(self):
        interval = max(min(self.lease_ttl / 4.0, 1.0), 0.05)
        while not self._stop.wait(interval):
            now = self.clock()
            for st in list(self._searches.values()):
                with st.lock:
                    expired = [tid for tid, exp in st.leases.items()
                               if exp < now]
                    for tid in expired:
                        del st.leases[tid]
                        # crash+requeue atomic with acquire
                        self._reclaim(st, tid)

    def _reclaim(self, st: _Search, trial_id: int):
        rec = st.service.db.trials.get(trial_id)
        if rec is None or rec.status is not TrialStatus.RUNNING:
            return
        st.metrics.counter("server.lease_reaps").inc()
        st.service.crash(trial_id)
        st.service.requeue(rec.hparams, rec.bracket_id)
        self._journal_status(st, trial_id)
        ev = {"ev": "requeue", "hparams": rec.hparams}
        if rec.bracket_id:
            ev["bracket"] = rec.bracket_id
        self._journal(st, ev)
        # reaper-shrink: the dead trial leaves its rung cohort (parked or
        # not), and if the shrunken cohort is now complete the barrier
        # resolves here instead of wedging on a dead host
        self._absorb_resolved(st, st.service.drain_resolved())

    # -- journal helpers ----------------------------------------------------
    def _journal(self, st: _Search, event: dict):
        if st.journal is not None:
            st.journal.append(event)
            st.events_since_compact += 1

    def _journal_status(self, st: _Search, trial_id: int):
        rec = st.service.db.trials[trial_id]
        self._journal(st, {"ev": "status", "trial_id": trial_id,
                           "status": rec.status.value, "t": rec.end_time})

    def _maybe_compact(self, st: _Search) -> None:
        """Snapshot-compact the tenant's journal once enough events have
        accumulated. Runs only on the event-loop thread between frames,
        under the tenant lock — the reaper journals atomically under the
        same lock, so a snapshot can never land between a state mutation
        and its journal line (which would double-apply on replay)."""
        if (self.compact_every is None or st.journal is None
                or st.events_since_compact < self.compact_every):
            return
        with st.lock:
            st.journal.compact(st.service.state_snapshot())
            st.events_since_compact = 0
        st.metrics.counter("server.compactions").inc()
