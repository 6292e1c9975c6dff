"""Wire protocol for the metaoptimization service (port of
``repro/distributed/protocol.py``, copied whole: the same bytes on the wire).

Framing: a 4-byte big-endian unsigned length followed by a UTF-8 JSON
payload. Every payload carries a ``type`` tag that maps to one of the typed
message dataclasses below — the same acquire / report / heartbeat / crash /
summary / shutdown verbs the in-process ``OptimizationService`` exposes,
made explicit so any transport (or language) can speak them.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Any, Dict, Optional

MAX_MESSAGE_BYTES = 16 << 20          # sanity bound on a single frame
_HEADER = struct.Struct(">I")


class ProtocolError(RuntimeError):
    """Malformed frame, unknown message type, or mid-message EOF."""


_REGISTRY: Dict[str, type] = {}


def message(type_name: str):
    """Register a dataclass as a wire message with the given type tag."""
    def wrap(cls):
        cls = dataclasses.dataclass(cls)
        cls.TYPE = type_name
        _REGISTRY[type_name] = cls
        return cls
    return wrap


# -- requests ---------------------------------------------------------------
# Multi-tenancy: every request may carry a ``search`` id naming the tenant
# (one OptimizationService + journal per search inside one server process).
# Omitted when None, so a single-search client's frames stay byte-identical
# to the pre-tenant wire and an old server ignores the field (evolution
# rule). An unknown search id answers `error` without dropping the
# connection.
@message("acquire")
class AcquireRequest:
    node: Optional[int] = None
    # multi-trial workers (population engine): lease up to this many trials
    # in one round-trip. Old clients simply omit the field (default 1).
    slots: int = 1
    # rung-aware acquire (bracket mode): the caller is refilling freed
    # bracket capacity, so the granted trials enroll in the server-side
    # rung barrier at grant time — the rung-0 cohort is sized to the freed
    # capacity before any park. Omitted when None: hint-less trials never
    # park (plain search, or a bracket-unaware worker sharing the server).
    rung: Optional[int] = None
    # distributed tracing (opt-in): {"ctx": <worker trace id>, "t": <the
    # worker's clock at send, same timebase as report t_start/t_end>}.
    # The server stamps granted trials with ctx (journal/track stitching)
    # and derives a worker→server clock offset from t. Omitted when the
    # client doesn't trace, so untraced frames stay byte-identical; an old
    # server drops the unknown field (evolution rule).
    trace: Optional[Dict[str, Any]] = None
    search: Optional[str] = None
    OMIT_IF_NONE = ("rung", "trace", "search")


@message("report")
class ReportRequest:
    trial_id: int
    phase: int
    metric: float
    t_start: float = 0.0              # worker-side wall-clock offsets
    t_end: float = 0.0
    node: Optional[int] = None
    # rung demotion (population engine --bracket): record the metric AND
    # kill the trial in one round-trip. Omitted when None so the frame is
    # byte-identical to a classic report; an old server that predates the
    # field ignores it (the trial merely survives the rung — degraded, not
    # broken).
    demote: Optional[bool] = None
    # telemetry: env transitions the reported phase consumed. Never affects
    # the verdict; surfaces as the ``env_steps`` journal field and the
    # `service.env_steps` counter. Omitted when None (scalar workers), so
    # classic frames stay byte-identical and old servers ignore it.
    env_steps: Optional[int] = None
    # distributed tracing: same shape as acquire.trace. ``t`` lets the
    # server map this report's worker-clock t_start/t_end onto its own
    # wall clock (offset = wall_now - t) and emit a stitched `trial.phase`
    # span. Omitted when the client doesn't trace (byte-identical frame);
    # old servers ignore it.
    trace: Optional[Dict[str, Any]] = None
    search: Optional[str] = None
    OMIT_IF_NONE = ("demote", "env_steps", "trace", "search")


@message("heartbeat")
class HeartbeatRequest:
    trial_id: int
    search: Optional[str] = None
    OMIT_IF_NONE = ("search",)


@message("crash")
class CrashRequest:
    trial_id: int
    reason: str = ""
    search: Optional[str] = None
    OMIT_IF_NONE = ("search",)


@message("summary")
class SummaryRequest:
    search: Optional[str] = None
    OMIT_IF_NONE = ("search",)


@message("shutdown")
class ShutdownRequest:
    # with a search id: detach just that tenant (its journal closes, its
    # leases drop) and leave the server running for the others; without
    # one: stop the whole server (the single-tenant wire, unchanged).
    search: Optional[str] = None
    OMIT_IF_NONE = ("search",)


@message("stats")
class StatsRequest:
    """Optional telemetry verb: ask the server for a metrics snapshot.
    Purely additive — old clients never send it, an old server drops the
    connection on the unknown type (evolution rule 4; tooling-only, so
    that is acceptable), and nothing in the search protocol depends on
    it. With a ``search`` id the snapshot is that tenant's registry."""
    search: Optional[str] = None
    OMIT_IF_NONE = ("search",)


@message("acquire_batch")
class AcquireBatchRequest:
    """Batched acquire: lease up to ``slots`` trials in one frame. Unlike
    ``acquire`` with slots>1 (whose reply splits primary + ``batch``), the
    reply is one uniform ``leases`` list — the shape a population host
    with hundreds of slots actually wants. New verb, so an old server
    drops the connection (evolution rule 4); batched clients are new code
    and the classic verb remains for old peers."""
    node: Optional[int] = None
    slots: int = 1
    rung: Optional[int] = None
    trace: Optional[Dict[str, Any]] = None
    search: Optional[str] = None
    OMIT_IF_NONE = ("rung", "trace", "search")


@message("report_batch")
class ReportBatchRequest:
    """Batched report: one frame carrying many per-trial reports — a
    population host reports a whole generation in one round-trip instead
    of one per slot. ``reports`` entries are dicts with the classic
    ``report`` fields (trial_id, phase, metric, t_start, t_end, and
    optionally demote / env_steps / node); frame-level ``node`` /
    ``trace`` / ``search`` apply to every entry. Replies come back in
    ``replies``, index-aligned; a bad entry yields an ``error`` reply at
    its index without failing the rest of the batch."""
    reports: list = dataclasses.field(default_factory=list)
    node: Optional[int] = None
    trace: Optional[Dict[str, Any]] = None
    search: Optional[str] = None
    OMIT_IF_NONE = ("trace", "search")


# -- responses --------------------------------------------------------------
@message("acquire_ok")
class AcquireResponse:
    trial_id: Optional[int]           # None -> search budget spent
    hparams: Optional[Dict[str, Any]]
    n_phases: int = 1
    # budget spent but leases outstanding: a reclaimed config may still be
    # requeued — poll again after this many seconds instead of exiting
    retry_after: Optional[float] = None
    # extra leases granted for a slots>1 request, beyond the primary one:
    # [{"trial_id": ..., "hparams": ...}, ...]; None for slots=1 requests.
    # Omitted from the wire when None so pre-slots clients (strict decode,
    # no batch field) keep working against an upgraded server.
    batch: Optional[list] = None
    # which scheduler bracket the primary lease joined (full Hyperband runs
    # several concurrently; the barrier keys cohorts by (bracket_id, rung)).
    # Omitted when the search has a single implicit bracket, so the frame
    # stays byte-identical for every pre-Hyperband search; batch entries
    # carry their own "bracket_id" key under the same rule.
    bracket_id: Optional[int] = None
    OMIT_IF_NONE = ("batch", "bracket_id")


@message("report_ok")
class ReportResponse:
    # "continue" | "stop" | "parked" — "parked" (bracket mode only) means
    # the report is withheld at the rung barrier: keep the trial's state,
    # keep heartbeating, and poll by re-sending the identical report
    decision: str
    # PBT exploit/explore (scheduler CLONE verdicts): continue the trial
    # as a clone of ``clone_from``'s learner state, under the ``perturb``
    # hyperparameters. The population engine executes the copy device-side
    # (weights never leave the device); scalar workers adopt ``perturb``
    # and keep their own state. Both omitted when None, so every
    # non-clone frame is byte-identical to a classic report_ok and an old
    # worker simply continues un-cloned (degraded, not broken).
    clone_from: Optional[int] = None
    perturb: Optional[Dict[str, Any]] = None
    OMIT_IF_NONE = ("clone_from", "perturb")


@message("heartbeat_ok")
class HeartbeatResponse:
    ok: bool = True                   # False -> lease lost, abandon trial


@message("crash_ok")
class CrashResponse:
    ok: bool = True


@message("summary_ok")
class SummaryResponse:
    summary: Dict[str, Any]


@message("shutdown_ok")
class ShutdownResponse:
    ok: bool = True


@message("stats_ok")
class StatsResponse:
    # ``telemetry.MetricsRegistry.snapshot()`` plus server-side extras
    # (live_leases) — see docs/telemetry.md for the metric vocabulary
    stats: Dict[str, Any]


@message("acquire_batch_ok")
class AcquireBatchResponse:
    # one dict per granted lease: {"trial_id", "hparams"} plus optional
    # "bracket_id". Empty when the budget is spent; ``retry_after`` then
    # carries the lease-outstanding poll hint (same rule as acquire_ok).
    leases: list = dataclasses.field(default_factory=list)
    n_phases: int = 1
    retry_after: Optional[float] = None
    OMIT_IF_NONE = ("retry_after",)


@message("report_batch_ok")
class ReportBatchResponse:
    # index-aligned with the request's reports: {"decision": ...} plus
    # optional "clone_from"/"perturb" (PBT), or {"error": ...} for an
    # entry the server rejected (unknown trial, bad fields).
    replies: list = dataclasses.field(default_factory=list)


@message("error")
class ErrorResponse:
    error: str


# -- framing ----------------------------------------------------------------
def json_default(obj):
    """Narrow non-native values (numpy scalars) instead of stringifying
    everything: a truly unserializable hparam should fail loudly at send
    time, not reach the worker as a string."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(
        f"unserializable value in message: {obj!r} ({type(obj).__name__})")


def encode(msg) -> bytes:
    payload = dataclasses.asdict(msg)
    for name in getattr(msg, "OMIT_IF_NONE", ()):
        if payload.get(name) is None:
            del payload[name]
    payload["type"] = msg.TYPE
    data = json.dumps(payload, sort_keys=True,
                      default=json_default).encode("utf-8")
    if len(data) > MAX_MESSAGE_BYTES:
        raise ProtocolError(f"message too large: {len(data)} bytes")
    return _HEADER.pack(len(data)) + data


def decode(data: bytes):
    try:
        obj = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad payload: {e}") from e
    if not isinstance(obj, dict) or "type" not in obj:
        raise ProtocolError("payload missing type tag")
    type_name = obj.pop("type")
    cls = _REGISTRY.get(type_name)
    if cls is None:
        raise ProtocolError(f"unknown message type {type_name!r}")
    # protobuf-style evolution rule: unknown fields are ignored, so an old
    # peer keeps working when the other side grows the message (e.g. the
    # ``slots``/``batch`` ACQUIRE extension); a missing required field is
    # still an error
    known = {f.name for f in dataclasses.fields(cls)}
    try:
        return cls(**{k: v for k, v in obj.items() if k in known})
    except TypeError as e:
        raise ProtocolError(f"bad fields for {type_name!r}: {e}") from e


def send_message(sock: socket.socket, msg) -> None:
    sock.sendall(encode(msg))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise ProtocolError("connection closed mid-message")
            return None
        buf += chunk
    return buf


def recv_message(sock: socket.socket):
    """Next message from the socket, or None on clean EOF."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_MESSAGE_BYTES:
        raise ProtocolError(f"frame too large: {length} bytes")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ProtocolError("connection closed before payload")
    return decode(payload)


class FrameBuffer:
    """Incremental decoder for a non-blocking socket: ``feed`` whatever
    bytes ``recv`` returned, get back every complete message they finish.
    Partial frames stay buffered across calls — the selector-core server's
    per-connection read state. Raises ``ProtocolError`` on an oversized
    frame or a bad payload (the caller drops the connection, exactly as
    the blocking ``recv_message`` path would)."""

    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list:
        self._buf += data
        msgs = []
        while True:
            if len(self._buf) < _HEADER.size:
                return msgs
            (length,) = _HEADER.unpack_from(self._buf)
            if length > MAX_MESSAGE_BYTES:
                raise ProtocolError(f"frame too large: {length} bytes")
            end = _HEADER.size + length
            if len(self._buf) < end:
                return msgs
            payload = bytes(self._buf[_HEADER.size:end])
            del self._buf[:end]
            msgs.append(decode(payload))

    def pending(self) -> int:
        """Bytes buffered but not yet forming a complete frame."""
        return len(self._buf)
