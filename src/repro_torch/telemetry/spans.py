"""Per-trial distributed tracing: spans in the journal (port of
``repro/telemetry/spans.py``, copied whole).

A *span* is one named interval of wall-clock time — a training phase, an
RPC, a park-wait — attached to the trial (or verb) it belongs to. Spans
ride the JSONL journal as one more event kind:

    {"ev": "span", "name": "trial.phase", "ts": <wall start, epoch s>,
     "dur": <seconds>, "trial_id": 37, "phase": 2, ...}

Journal replay skips unknown event kinds, so spans are purely additive.
The port's server (``distributed/server.py``) records its ``rpc.<verb>``
and stitched ``trial.phase`` spans through a ``SpanRecorder`` whose sink is
the search's ``Journal``; a journal-less search records through
``NULL_RECORDER``, which costs nothing. ``derive_spans`` reconstructs the
lifecycle, park-wait and cohort spans from the acquire / park / report /
status events the journal already carries.

The population engine (``population/engine.py``) records its ``engine.*``
spans through the recorder it is given, and ``telemetry/trace.py`` writes
``trial.phase`` spans with simulated stamps into the journal it is given.
Two tools read them: ``telemetry.export`` turns a journal into Chrome
trace-event JSON with per-trial and rung-cohort tracks, and
``telemetry.critical_path`` attributes each trial's wall-clock into
compile / step / rpc / park-wait / idle (rendered by
``telemetry.dashboard``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

EV_SPAN = "span"


@dataclass
class Span:
    """One wall-clock interval. ``ts`` is epoch seconds (simulated seconds
    in trace replay — any single consistent clock works), ``dur`` is
    seconds. ``args`` carries the attribution keys (trial_id, phase, node,
    ctx, verb, bracket, rung ...)."""
    name: str
    ts: float
    dur: float
    cat: str = ""
    args: Dict[str, Any] = field(default_factory=dict)

    def to_event(self) -> dict:
        ev = {"ev": EV_SPAN, "name": self.name, "ts": round(self.ts, 6),
              "dur": round(self.dur, 6)}
        if self.cat:
            ev["cat"] = self.cat
        ev.update(self.args)
        return ev

    @classmethod
    def from_event(cls, ev: dict) -> "Span":
        args = {k: v for k, v in ev.items()
                if k not in ("ev", "name", "ts", "dur", "cat")}
        return cls(str(ev["name"]), float(ev["ts"]), float(ev["dur"]),
                   cat=str(ev.get("cat", "")), args=args)


class SpanRecorder:
    """Appends complete spans to a sink (a ``Journal``, a list, ...).

    Only *complete* spans exist on the wire — there is no open-span state
    to leak across a crash, and a recorder is therefore as thread-safe as
    its sink (``Journal.append`` takes its own lock)."""

    __slots__ = ("sink", "clock")

    def __init__(self, sink, clock=time.time):
        self.sink = sink
        self.clock = clock

    @property
    def enabled(self) -> bool:
        return True

    def record(self, name: str, ts: float, dur: float, **args) -> None:
        """Record a span with an explicit start ``ts`` (same clock domain
        as the rest of the journal)."""
        if dur < 0:
            return
        ev = {"ev": EV_SPAN, "name": name, "ts": round(float(ts), 6),
              "dur": round(float(dur), 6)}
        for k, v in args.items():
            if v is not None:
                ev[k] = v
        self.sink.append(ev)

    def end(self, name: str, dur: float, **args) -> None:
        """Record a span that ends *now*: start = clock() - dur. The usual
        hot-path form — the caller already timed the interval with
        ``perf_counter`` and needs no extra state."""
        self.record(name, self.clock() - dur, dur, **args)


class _NullRecorder:
    """Zero-overhead twin (cf. ``metrics.NULL_REGISTRY``)."""

    __slots__ = ()

    @property
    def enabled(self) -> bool:
        return False

    def record(self, name: str, ts: float, dur: float, **args) -> None: ...
    def end(self, name: str, dur: float, **args) -> None: ...


NULL_RECORDER = _NullRecorder()

_TERMINAL = ("completed", "killed", "crashed")   # TrialStatus terminal set


def derive_spans(events: List[dict]) -> List[Span]:
    """All spans of a journal: the recorded ``span`` events verbatim, plus
    the spans the ordinary event stream already implies —

    * ``trial.lifecycle`` — acquire → terminal ``status`` (or the last
      event mentioning the trial, for trials still running at EOF);
    * ``trial.park`` — ``park`` → the report/status that released it
      (barrier resolution, demotion, or reaper crash);
    * ``cohort.rung`` — per ``(bracket, rung)`` barrier cohort: first
      member parked → last withheld report recorded (the resolution).

    Deriving instead of recording keeps every hot path free of extra
    journal writes; the price is that derivation needs the journal's
    ordinary events, which every server/trace journal already has."""
    spans: List[Span] = []
    acquired: Dict[int, dict] = {}          # tid -> {"ts", "node", "bracket"}
    last_seen: Dict[int, float] = {}        # tid -> newest event ts
    parked: Dict[int, dict] = {}            # tid -> {"ts", "phase", ...}
    cohorts: Dict[tuple, dict] = {}         # (bracket, rung) -> {t0, t1, n}

    def seen(tid, ts):
        last_seen[tid] = max(last_seen.get(tid, ts), ts)

    def unpark(tid: int, ts: float) -> None:
        p = parked.pop(tid, None)
        if p is None:
            return
        spans.append(Span("trial.park", p["ts"], max(0.0, ts - p["ts"]),
                          cat="trial",
                          args={"trial_id": tid, "phase": p["phase"],
                                "bracket": p["bracket"]}))
        key = (p["bracket"], p["phase"])
        c = cohorts.setdefault(key, {"t0": p["ts"], "t1": ts, "n": 0})
        c["t0"] = min(c["t0"], p["ts"])
        c["t1"] = max(c["t1"], ts)
        c["n"] += 1

    for ev in events:
        kind = ev.get("ev")
        ts = ev.get("ts", ev.get("t"))
        if ts is None:
            continue
        ts = float(ts)
        if kind == EV_SPAN:
            try:
                spans.append(Span.from_event(ev))
            except (KeyError, TypeError, ValueError):
                continue
            tid = ev.get("trial_id")
            if tid is not None:
                seen(tid, ts + float(ev.get("dur") or 0.0))
            continue
        tid = ev.get("trial_id")
        if kind == "acquire" and tid is not None:
            acquired[tid] = {"ts": ts, "node": ev.get("node"),
                             "bracket": ev.get("bracket", 0),
                             "ctx": ev.get("ctx")}
            seen(tid, ts)
        elif kind == "report" and tid is not None:
            unpark(tid, ts)
            seen(tid, ts)
        elif kind == "park" and tid is not None:
            bracket = acquired.get(tid, {}).get("bracket", 0)
            parked[tid] = {"ts": ts, "phase": ev.get("phase", 0),
                           "bracket": bracket}
            seen(tid, ts)
        elif kind == "status" and tid is not None:
            seen(tid, ts)
            if ev.get("status") in _TERMINAL:
                unpark(tid, ts)
                acq = acquired.get(tid)
                if acq is not None:
                    spans.append(Span(
                        "trial.lifecycle", acq["ts"],
                        max(0.0, ts - acq["ts"]), cat="trial",
                        args={"trial_id": tid, "status": ev.get("status"),
                              "node": acq.get("node"),
                              "bracket": acq.get("bracket", 0),
                              "ctx": acq.get("ctx")}))
                    del acquired[tid]

    # trials still running (or parked) when the journal ends: open-ended
    # lifecycle up to the last event that mentioned them
    for tid, acq in acquired.items():
        t1 = last_seen.get(tid, acq["ts"])
        spans.append(Span("trial.lifecycle", acq["ts"],
                          max(0.0, t1 - acq["ts"]), cat="trial",
                          args={"trial_id": tid, "status": "running",
                                "node": acq.get("node"),
                                "bracket": acq.get("bracket", 0),
                                "ctx": acq.get("ctx")}))
    for (bracket, rung), c in cohorts.items():
        spans.append(Span("cohort.rung", c["t0"],
                          max(0.0, c["t1"] - c["t0"]), cat="cohort",
                          args={"bracket": bracket, "rung": rung,
                                "members": c["n"]}))
    return spans


# ---------------------------------------------------------------------------
# the span vocabulary (docs/telemetry.md must name every entry — enforced
# by tests/test_docs.py, exactly like METRIC_SCHEMA)
# ---------------------------------------------------------------------------
SPAN_SCHEMA: Dict[str, str] = {
    # -- recorded by distributed/server.py (journal-backed servers) ---------
    "rpc.<verb>": ("per-request service time for acquire / report / crash "
                   "(heartbeat, stats, summary, shutdown are not spanned — "
                   "chatty or tooling-only)"),
    "trial.phase": ("one training phase, worker wall-clock, stitched onto "
                    "the server clock via the wire trace context "
                    "(also emitted by trace replay on the simulated clock)"),
    # -- recorded by population/engine.py -----------------------------------
    "engine.compile": "first-call trace+compile of a bucket step executable",
    "engine.phase": ("one slot's training phase as the engine saw it "
                     "(device side of `trial.phase`)"),
    "engine.clone": "device-side PBT slot copy (params + opt state)",
    "engine.park_stall": "a slot parked at the rung barrier, engine side",
    # -- derived from ordinary journal events by derive_spans ---------------
    "trial.lifecycle": "acquire to terminal status (one track per trial)",
    "trial.park": "park to barrier release, per parked report",
    "cohort.rung": ("one (bracket, rung) barrier cohort: first park to "
                    "resolution, with member count"),
}
