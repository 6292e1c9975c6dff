"""Client SDK for the metaoptimization server (port of
``repro/distributed/client.py``, copied whole).

One persistent socket per client; calls are serialized by a lock so a
background heartbeat thread can share the connection with the main
acquire/report loop. A client bound to a named ``search`` stamps the
tenant id on every frame (multi-tenant servers route on it); the default
``search=None`` keeps every frame byte-identical to the single-search
wire.
"""
from __future__ import annotations

import socket
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core.scheduler import ReportReply
from repro_torch.distributed import protocol as proto


class ServiceError(RuntimeError):
    """The server rejected a request (stale trial, bad phase order, ...)."""


@dataclass
class RemoteTrial:
    trial_id: int
    hparams: Dict[str, Any]
    n_phases: int


@dataclass
class Pending:
    """Budget spent but live leases remain — poll acquire again later."""
    retry_after: float


class ServiceClient:
    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 trace_ctx: Optional[str] = None,
                 search: Optional[str] = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._lock = threading.Lock()
        # distributed tracing (opt-in): when set, acquire/report frames
        # carry {"ctx": trace_ctx, "t": <caller clock>} so the server can
        # stitch this worker's spans onto its own clock. None (the
        # default) keeps every frame byte-identical to an untraced client.
        self.trace_ctx = trace_ctx
        # multi-tenancy (opt-in): the search id stamped on every frame
        self.search = search

    def _trace(self, t: Optional[float]) -> Optional[Dict[str, Any]]:
        if self.trace_ctx is None:
            return None
        tr: Dict[str, Any] = {"ctx": self.trace_ctx}
        if t is not None:
            tr["t"] = round(float(t), 6)
        return tr

    def _call(self, msg):
        with self._lock:
            proto.send_message(self._sock, msg)
            resp = proto.recv_message(self._sock)
        if resp is None:
            raise proto.ProtocolError("server closed the connection")
        if isinstance(resp, proto.ErrorResponse):
            raise ServiceError(resp.error)
        return resp

    # -- verbs --------------------------------------------------------------
    def acquire(self, node: Optional[int] = None,
                rung: Optional[int] = None,
                trace_t: Optional[float] = None):
        """A RemoteTrial, a Pending marker (retry later), or None (done).
        ``rung`` is the bracket hint: granted trials enroll in the
        server-side rung barrier at grant time (pass 0 when refilling
        bracket capacity; omit for plain searches). ``trace_t`` is the
        caller's clock at send (the t_start/t_end timebase) when the
        client traces."""
        resp = self._call(proto.AcquireRequest(node=node, rung=rung,
                                               trace=self._trace(trace_t),
                                               search=self.search))
        if resp.trial_id is None:
            if resp.retry_after is not None:
                return Pending(resp.retry_after)
            return None
        return RemoteTrial(resp.trial_id, resp.hparams, resp.n_phases)

    def acquire_batch(self, node: Optional[int] = None, slots: int = 1,
                      rung: Optional[int] = None,
                      trace_t: Optional[float] = None):
        """Lease up to ``slots`` trials in one round-trip (population
        workers) via the batched ``acquire_batch`` verb. A list of
        RemoteTrials (possibly fewer than ``slots``), a Pending marker, or
        None (budget spent for good). ``rung`` as in :meth:`acquire`."""
        resp = self._call(proto.AcquireBatchRequest(
            node=node, slots=max(1, slots), rung=rung,
            trace=self._trace(trace_t), search=self.search))
        if not resp.leases:
            if resp.retry_after is not None:
                return Pending(resp.retry_after)
            return None
        return [RemoteTrial(e["trial_id"], e["hparams"], resp.n_phases)
                for e in resp.leases]

    def report(self, trial_id: int, phase: int, metric: float,
               t_start: float = 0.0, t_end: float = 0.0,
               node: Optional[int] = None, demote: bool = False,
               env_steps: Optional[int] = None,
               trace_t: Optional[float] = None) -> ReportReply:
        """The server's decision: ``"continue"``, ``"stop"``, or — bracket
        mode — ``"parked"`` (the report is withheld at the rung barrier;
        keep the trial's state and poll by re-sending the identical
        report). Returned as a ``ReportReply``: a plain decision string
        that additionally carries the PBT ``clone_from``/``perturb``
        payload when the scheduler issued a clone verdict."""
        resp = self._call(proto.ReportRequest(
            trial_id=trial_id, phase=phase, metric=float(metric),
            t_start=t_start, t_end=t_end, node=node,
            demote=True if demote else None,
            env_steps=int(env_steps) if env_steps is not None else None,
            trace=self._trace(trace_t), search=self.search))
        return ReportReply(resp.decision,
                           clone_from=getattr(resp, "clone_from", None),
                           perturb=getattr(resp, "perturb", None))

    def report_batch(self, reports: List[dict],
                     node: Optional[int] = None,
                     trace_t: Optional[float] = None) -> List[ReportReply]:
        """Send many reports in one round-trip (the ``report_batch``
        verb). Each entry is a dict with the :meth:`report` fields —
        ``trial_id``/``phase``/``metric`` required, ``t_start``/``t_end``/
        ``demote``/``env_steps``/``node`` optional. Returns one
        ``ReportReply`` per entry, index-aligned; an entry the server
        rejected (unknown trial, bad fields) maps to ``"stop"`` — the
        same abandon-the-trial signal the per-trial path turns errors
        into."""
        resp = self._call(proto.ReportBatchRequest(
            reports=reports, node=node, trace=self._trace(trace_t),
            search=self.search))
        out = []
        for rep in resp.replies:
            if "error" in rep:
                out.append(ReportReply("stop"))
            else:
                out.append(ReportReply(rep["decision"],
                                       clone_from=rep.get("clone_from"),
                                       perturb=rep.get("perturb")))
        return out

    def stats(self) -> dict:
        """The server's live telemetry snapshot (the optional ``stats``
        verb): the metrics-registry snapshot plus ``live_leases``. Raises
        ``ServiceError`` against a server that predates the verb."""
        return self._call(proto.StatsRequest(search=self.search)).stats

    def heartbeat(self, trial_id: int) -> bool:
        return self._call(proto.HeartbeatRequest(
            trial_id=trial_id, search=self.search)).ok

    def crash(self, trial_id: int, reason: str = "") -> None:
        self._call(proto.CrashRequest(trial_id=trial_id, reason=reason,
                                      search=self.search))

    def summary(self) -> dict:
        return self._call(proto.SummaryRequest(search=self.search)).summary

    def shutdown(self) -> None:
        """Stop the whole server (tenantless clients), or detach this
        client's search from a multi-tenant server, leaving it running
        for the others."""
        self._call(proto.ShutdownRequest(search=self.search))

    def detach_search(self) -> None:
        """Explicitly detach this client's search (requires ``search``)."""
        if self.search is None:
            raise ValueError("client is not bound to a search")
        self._call(proto.ShutdownRequest(search=self.search))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
