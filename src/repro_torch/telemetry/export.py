"""Journal → Chrome trace-event JSON (Perfetto / chrome://tracing); port of
``repro/telemetry/export.py``, copied whole.

    python -m repro_torch.telemetry.export --journal metaopt_journal.jsonl \\
        --out trace.json [--require-trials 1]

Stdlib only, plus the numpy that ``distributed.journal`` imports: no
torch, so it runs on a host with no card. The exporter consumes
``telemetry.spans.derive_spans`` — recorded ``span`` events plus the
lifecycle / park / cohort spans implied by ordinary journal events — and
lays them out as tracks:

* one **thread per trial** (process "trials"): lifecycle span underneath,
  training phases and park-waits nested inside it;
* one thread per **(bracket, rung) barrier cohort** (process "cohorts"):
  first park → resolution, member count in the args;
* RPC spans per verb (process "server"; the thread id is drawn from
  ``hash(verb)``, which Python salts per process unless
  ``PYTHONHASHSEED`` is set, so the server's tids differ between runs)
  and engine spans (process
  "engine", one thread per device slot's trial).

Timestamps are rebased to the journal's earliest span and written in
microseconds, as the trace-event format requires; the original epoch (or
simulated) start lands in ``otherData.ts0``. Works on simulated journals
(``replay_trace(journal=...)``) exactly as on live-server ones — the
clock domain just has to be self-consistent, which each journal's is.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from repro_torch.distributed.journal import read_events
from repro_torch.telemetry.spans import Span, derive_spans

_PID_TRIALS = 1
_PID_COHORTS = 2
_PID_SERVER = 3
_PID_ENGINE = 4

_PROCESS_NAMES = {_PID_TRIALS: "trials", _PID_COHORTS: "cohorts",
                  _PID_SERVER: "server", _PID_ENGINE: "engine"}


def _track_of(span: Span) -> Optional[tuple]:
    """(pid, tid, thread_label) for a span; None drops it from the trace.
    Perfetto nests same-track complete events by time containment, so
    everything about one trial goes on ONE thread — lifecycle outermost,
    phases/parks inside."""
    tid = span.args.get("trial_id")
    if span.name.startswith("rpc."):
        verb = span.name[4:]
        return _PID_SERVER, abs(hash(verb)) % 1000 + 1, f"rpc {verb}"
    if span.name.startswith("engine."):
        t = tid if tid is not None else 0
        return _PID_ENGINE, int(t) + 1, f"slot trial {t}"
    if span.name == "cohort.rung":
        bracket = int(span.args.get("bracket") or 0)
        rung = int(span.args.get("rung") or 0)
        return (_PID_COHORTS, bracket * 64 + rung + 1,
                f"bracket {bracket} rung {rung}")
    if tid is not None:
        return _PID_TRIALS, int(tid) + 1, f"trial {tid}"
    return None


def build_trace(events) -> Dict[str, Any]:
    """A Chrome trace-event document (dict) from journal events."""
    spans = derive_spans(list(events))
    out: List[dict] = []
    threads: Dict[tuple, str] = {}
    ts0 = min((s.ts for s in spans), default=0.0)
    for span in spans:
        track = _track_of(span)
        if track is None:
            continue
        pid, tid, label = track
        threads.setdefault((pid, tid), label)
        out.append({
            "name": span.name,
            "cat": span.cat or span.name.split(".", 1)[0],
            "ph": "X",
            "ts": round((span.ts - ts0) * 1e6, 3),
            "dur": round(span.dur * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": span.args,
        })
    # deterministic, and Perfetto renders nesting best when an enclosing
    # span precedes its children
    out.sort(key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"]))
    meta: List[dict] = []
    for pid in sorted({p for p, _ in threads}):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": _PROCESS_NAMES[pid]}})
    for (pid, tid), label in sorted(threads.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": label}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"ts0": round(ts0, 6), "n_spans": len(out)}}


def validate_chrome_trace(doc: Dict[str, Any]) -> Dict[str, int]:
    """Structural validation of a trace-event document. Raises
    ``ValueError`` on the first malformation; returns counts
    (``complete_events``, ``trial_tracks``, ...) for smoke assertions."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("not a trace-event document: no traceEvents list")
    n_complete = 0
    trial_tracks = set()
    cohort_tracks = set()
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            raise ValueError(f"traceEvents[{i}]: unexpected phase {ph!r}")
        if "pid" not in ev or "name" not in ev:
            raise ValueError(f"traceEvents[{i}]: missing pid/name")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"traceEvents[{i}]: bad ts {ts!r}")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}]: bad dur {dur!r}")
            n_complete += 1
            if ev["pid"] == _PID_TRIALS:
                trial_tracks.add(ev.get("tid"))
            elif ev["pid"] == _PID_COHORTS:
                cohort_tracks.add(ev.get("tid"))
    return {"events": len(doc["traceEvents"]), "complete_events": n_complete,
            "trial_tracks": len(trial_tracks),
            "cohort_tracks": len(cohort_tracks)}


def export_journal(journal_path: str, out_path: str) -> Dict[str, int]:
    doc = build_trace(read_events(journal_path))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.write("\n")
    return validate_chrome_trace(doc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="export a metaopt journal as Chrome trace-event JSON")
    ap.add_argument("--journal", required=True,
                    help="path to the JSONL journal")
    ap.add_argument("--out", required=True,
                    help="trace JSON output path (open in Perfetto)")
    ap.add_argument("--require-trials", type=int, default=0, metavar="N",
                    help="exit nonzero unless the trace has at least N "
                         "trial tracks with complete events (CI smoke)")
    args = ap.parse_args(argv)
    counts = export_journal(args.journal, args.out)
    print(f"wrote {args.out}: {counts['complete_events']} spans across "
          f"{counts['trial_tracks']} trial tracks + "
          f"{counts['cohort_tracks']} cohort tracks")
    if counts["trial_tracks"] < args.require_trials:
        print(f"FAIL: wanted >= {args.require_trials} trial tracks")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
