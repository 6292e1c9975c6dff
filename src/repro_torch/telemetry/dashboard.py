"""Journal-tailing live dashboard (port of ``repro/telemetry/dashboard.py``,
copied whole).

    python -m repro_torch.telemetry.dashboard --journal metaopt_journal.jsonl \\
        [--follow] [--interval 2] [--window 30]

Reconstructs a running search entirely from the server's JSONL journal —
no server changes, no extra verbs: per-search report and env-step rates,
trial statuses, best-score-vs-wall-clock, rung/cohort occupancy (from
``park`` events), cohort wait p50/p99, lease reaps, and worker churn
(``worker_exit`` events). ``--follow`` tails the file (torn in-flight
lines are skipped and picked up once completed — see
``telemetry.tailer``); ``--once`` renders the current state and exits
(the CI smoke path). Works on a finished journal too, as a post-mortem.

Stdlib only, so it runs anywhere the journal can be read — including
hosts with no card and no torch installed.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.telemetry.tailer import JournalTailer

_SPARK = " .:-=+*#%@"


def _sparkline(points: List[Tuple[float, float]], width: int = 32) -> str:
    """Best-vs-wall-clock as one character row (resampled to ``width``)."""
    if len(points) < 2:
        return ""
    t0, t1 = points[0][0], points[-1][0]
    if t1 <= t0:
        return ""
    lo = min(v for _, v in points)
    hi = max(v for _, v in points)
    cells = []
    j = 0
    for i in range(width):
        t = t0 + (t1 - t0) * (i + 1) / width
        while j + 1 < len(points) and points[j + 1][0] <= t:
            j += 1
        frac = 0.0 if hi <= lo else (points[j][1] - lo) / (hi - lo)
        cells.append(_SPARK[min(len(_SPARK) - 1,
                                int(frac * (len(_SPARK) - 1)))])
    return "".join(cells)


class SearchView:
    """Event-sourced state of ONE search, rebuilt from journal events.

    Timestamps: every event appended by this PR carries a wall-clock
    ``ts``; events from older journals fall back to the injected service
    clock ``t`` (monotonic — still consistent *within* one server
    incarnation, which is all rates need). Multi-host journals can carry
    *regressing* ``ts`` (NTP steps, cross-host clock skew): those are
    counted (``ts_regressions``, warned about in ``render``) and clamped
    onto a monotone event clock instead of silently poisoning the rate
    windows. In ``--follow`` mode the rate window runs on the reader's own
    ``time.monotonic()`` arrival clock, which no producer skew can move
    backwards at all."""

    def __init__(self, window_s: float = 30.0,
                 skew_tolerance_s: float = 0.05):
        self.window_s = window_s
        # regressions smaller than this are concurrent-writer jitter on
        # one host (stamp-then-lock in Journal.append), not clock skew
        self.skew_tolerance_s = skew_tolerance_s
        self.n_events = 0
        self.trials: Dict[int, dict] = {}
        self.by_status: Dict[str, int] = {}
        self.best: Optional[float] = None
        self.best_trial: Optional[int] = None
        self.best_curve: List[Tuple[float, float]] = []   # (t, best)
        self.reports: deque = deque(maxlen=100_000)  # (t, env_steps, mono)
        self.reaps = 0
        self.clones = 0
        self.parked: Dict[int, Tuple[float, int, int]] = {}  # tid->(t,ph,br)
        self.cohort_waits: deque = deque(maxlen=4096)
        self.nodes_seen: set = set()
        self.worker_exits: List[Tuple[float, Any, int]] = []
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.ts_regressions = 0          # events whose ts ran backwards
        self.max_regression_s = 0.0
        self._mono_first: Optional[float] = None

    # -- event intake -------------------------------------------------------
    def _time(self, ev: dict) -> float:
        ts = ev.get("ts")
        if ts is None:
            ts = ev.get("t")
        if ts is None:
            ts = self.t_last if self.t_last is not None else 0.0
        ts = float(ts)
        if ev.get("ev") == "span":
            # spans are retrospective: journaled at completion (possibly
            # long after — a parked phase lands at cohort resolution) but
            # stamped with their START. They carry history, not stream
            # time — keep them off the monotone event clock and the skew
            # counter entirely
            return ts + float(ev.get("dur") or 0.0)
        if self.t_first is None:
            self.t_first = ts
        if self.t_last is not None:
            if ts < self.t_last - self.skew_tolerance_s:
                # wall-clock skew across hosts / an NTP step: count it and
                # clamp onto the monotone event clock, so rate windows and
                # wait quantiles never see time run backwards
                self.ts_regressions += 1
                self.max_regression_s = max(self.max_regression_s,
                                            self.t_last - ts)
            ts = max(ts, self.t_last)
        self.t_last = ts
        return ts

    def apply(self, ev: dict, mono: Optional[float] = None) -> None:
        """Fold one event in. ``mono`` is the reader's ``time.monotonic()``
        arrival stamp (follow mode); None for post-mortem reads."""
        self.n_events += 1
        kind = ev.get("ev")
        t = self._time(ev)
        if mono is not None and self._mono_first is None:
            self._mono_first = mono
        if kind == "acquire":
            tid = ev["trial_id"]
            self.trials[tid] = {"status": "running",
                                "bracket": ev.get("bracket", 0),
                                "node": ev.get("node")}
            if ev.get("node") is not None:
                self.nodes_seen.add(ev["node"])
        elif kind == "report":
            tid = ev["trial_id"]
            self.reports.append((t, int(ev.get("env_steps") or 0), mono))
            parked = self.parked.pop(tid, None)
            if parked is not None:
                self.cohort_waits.append(max(0.0, t - parked[0]))
            m = float(ev["metric"])
            if self.best is None or m > self.best:
                self.best, self.best_trial = m, tid
                self.best_curve.append((t, m))
        elif kind == "status":
            tid = ev["trial_id"]
            rec = self.trials.setdefault(tid, {"bracket": 0, "node": None})
            rec["status"] = ev["status"]
            if ev["status"] != "running":
                self.parked.pop(tid, None)
        elif kind == "park":
            tid = ev["trial_id"]
            bracket = self.trials.get(tid, {}).get("bracket", 0)
            self.parked[tid] = (t, ev.get("phase", 0), bracket)
        elif kind == "requeue":
            self.reaps += 1
        elif kind == "perturb":
            self.clones += 1
        elif kind == "worker_exit":
            self.worker_exits.append((t, ev.get("node"),
                                      int(ev.get("exit_code") or 0)))

    def apply_all(self, events: List[dict],
                  mono: Optional[float] = None) -> None:
        for ev in events:
            self.apply(ev, mono=mono)

    # -- derived views ------------------------------------------------------
    def _window_rates(self) -> Tuple[float, float, float]:
        """(window_used_s, reports/s, env-steps/s) over the trailing
        window. Follow mode (events carry ``mono`` arrival stamps) windows
        on the reader's own ``time.monotonic()`` — immune to producer
        clock steps by construction. Post-mortem reads window on the
        (monotone-clamped) event clock, anchored at the newest event, so a
        finished journal still shows its closing rates."""
        if not self.reports or self.t_last is None:
            return self.window_s, 0.0, 0.0
        live = self.reports[-1][2] is not None
        if live:
            anchor, key = time.monotonic(), 2
            first = self._mono_first
        else:
            anchor, key = self.t_last, 0
            first = self.t_first
        cut = anchor - self.window_s
        n = steps = 0
        for item in reversed(self.reports):
            k = item[key]
            if k is None or k < cut:
                break
            n += 1
            steps += item[1]
        span = self.window_s
        if first is not None:
            span = min(span, max(anchor - first, 1e-9))
        return span, n / span, steps / span

    def status_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.trials.values():
            s = rec.get("status", "running")
            out[s] = out.get(s, 0) + 1
        return out

    def _quantile(self, data: List[float], q: float) -> float:
        if not data:
            return 0.0
        data = sorted(data)
        return data[min(len(data) - 1, int(q * len(data)))]

    def render(self, source: str = "", skipped: int = 0) -> str:
        span, rps, eps = self._window_rates()
        life = (max(self.t_last - self.t_first, 1e-9)
                if self.t_first is not None and self.t_last is not None
                else None)
        counts = self.status_counts()
        lines = []
        lines.append(f"journal: {source or '-'}  ({self.n_events} events, "
                     f"{skipped} undecodable skipped)")
        if self.ts_regressions:
            lines.append(
                f"WARNING: {self.ts_regressions} events with regressing "
                f"ts (max -{self.max_regression_s:.3f}s) — wall-clock "
                f"skew across hosts? rates use a clamped monotone clock")
        status = ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
        lines.append(f"trials: {len(self.trials)} acquired | "
                     f"{status or 'none yet'}")
        if self.best is not None:
            rel = (f" at +{self.best_curve[-1][0] - self.t_first:.1f}s"
                   if self.t_first is not None else "")
            lines.append(f"best score: {self.best:.6g} "
                         f"(trial {self.best_trial}{rel})")
            spark = _sparkline(self.best_curve)
            if spark:
                lines.append(f"best-vs-wall-clock: [{spark}]")
        lines.append(f"rates ({span:.0f}s window): {rps:.2f} reports/s | "
                     f"{eps:.0f} env-steps/s")
        if life is not None:
            lines.append(f"lifetime: {len(self.reports) / life:.2f} "
                         f"reports/s | "
                         f"{sum(r[1] for r in self.reports) / life:.0f} "
                         f"env-steps/s over {life:.1f}s")
        lines.append(f"leases: {self.reaps} reaps (requeues) | "
                     f"clones: {self.clones}")
        cohorts: Dict[Tuple[int, int], int] = {}
        for t, phase, bracket in self.parked.values():
            key = (bracket, phase)
            cohorts[key] = cohorts.get(key, 0) + 1
        waits = list(self.cohort_waits)
        lines.append(
            f"cohorts: {len(self.parked)} parked across {len(cohorts)} "
            f"(bracket,rung) cohorts | wait p50 "
            f"{self._quantile(waits, 0.5):.2f}s p99 "
            f"{self._quantile(waits, 0.99):.2f}s (n={len(waits)})")
        nonzero = sum(1 for _, _, rc in self.worker_exits if rc)
        lines.append(f"workers: {len(self.nodes_seen)} nodes seen | "
                     f"{len(self.worker_exits)} exits "
                     f"({nonzero} nonzero)")
        return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="journal-tailing metaopt dashboard")
    ap.add_argument("--journal", required=True,
                    help="path to the server's JSONL journal")
    ap.add_argument("--follow", action="store_true",
                    help="tail the journal live (ctrl-c to stop)")
    ap.add_argument("--once", action="store_true",
                    help="render the current state once and exit "
                         "(default when --follow is not given)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--follow refresh seconds (default 2)")
    ap.add_argument("--window", type=float, default=30.0,
                    help="trailing rate window in seconds (default 30)")
    args = ap.parse_args(argv)

    tailer = JournalTailer(args.journal)
    view = SearchView(window_s=args.window)
    if not args.follow:
        # drain the whole journal (polls are max_bytes-bounded now), keep
        # the raw events for the critical-path pass
        events: List[dict] = []
        while True:
            batch = tailer.poll()
            if not batch:
                break
            events.extend(batch)
        view.apply_all(events)
        out = view.render(args.journal, tailer.skipped)
        from repro_torch.telemetry.critical_path import critical_path_report
        table = critical_path_report(events)
        if table:
            out += "\n\n" + table
        print(out)
        return 0
    try:
        while True:
            view.apply_all(tailer.poll(), mono=time.monotonic())
            # clear + home, then one panel — readable on any ANSI terminal
            sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(view.render(args.journal, tailer.skipped))
            sys.stdout.write("\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
