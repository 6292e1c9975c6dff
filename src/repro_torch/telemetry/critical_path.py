"""Where did each trial's wall-clock actually go? (Port of
``repro/telemetry/critical_path.py``, copied whole.)

Attributes every trial's lifetime (acquire → terminal status) into
exclusive buckets, from the journal's span stream
(``telemetry.spans.derive_spans``):

* ``compile``   — its share of ``engine.compile`` spans (a bucket compile
  serves every trial stacked in the bucket, so the cost is split evenly
  across the ``trials`` the span names). The port's population engine
  stamps ``engine.compile`` as the host seconds of a bucket's first step,
  with no device sync (``population/engine.py``): there this bucket is
  host start-up (autograd's first graph, first launches), not device
  work;
* ``step``      — training phases (``trial.phase``; falls back to the
  engine-side ``engine.phase`` when a journal has only local spans; the
  port's engine closes ``engine.phase`` after reading the phase's counters
  back, so it holds the device's work);
* ``rpc``       — server-side request handling attributed to the trial;
* ``park_wait`` — parked at a rung barrier (``trial.park``);
* ``idle``      — the unexplained remainder (lease held, nothing
  attributable: verdict-poll gaps, admission queues, scheduler think
  time), clamped at zero.

``idle`` is a remainder, so the buckets sum to the trial's wall-clock by
construction — up to clamping when attributed spans overlap (an RPC
handled *during* a park-wait counts in both; such overlaps are
microseconds against multi-second walls, which is why the acceptance bar
is "within 1%", not exact). Stdlib only: the dashboard renders the
per-bracket table on a host with no torch.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from repro_torch.telemetry.spans import derive_spans

BUCKETS = ("compile", "step", "rpc", "park_wait", "idle")


def attribute(events: Iterable[dict]) -> Dict[int, Dict[str, float]]:
    """Per-trial wall-clock attribution. Returns
    ``{trial_id: {"wall": s, "bracket": b, "compile": s, "step": s,
    "rpc": s, "park_wait": s, "idle": s}}`` for every trial with a
    lifecycle span."""
    spans = derive_spans(list(events))
    out: Dict[int, Dict[str, float]] = {}
    phase_seen: Dict[int, bool] = {}    # tid -> has server-side trial.phase
    engine_phase: Dict[int, float] = {}

    def trial(tid: int) -> Dict[str, float]:
        return out.setdefault(int(tid), dict.fromkeys(
            ("wall", "bracket") + BUCKETS, 0.0))

    for s in spans:
        tid = s.args.get("trial_id")
        if s.name == "engine.compile":
            trials = s.args.get("trials") or []
            if trials:
                share = s.dur / len(trials)
                for t in trials:
                    trial(t)["compile"] += share
            continue
        if tid is None:
            continue
        rec = trial(tid)
        if s.name == "trial.lifecycle":
            rec["wall"] = s.dur
            rec["bracket"] = float(s.args.get("bracket") or 0)
        elif s.name == "trial.phase":
            rec["step"] += s.dur
            phase_seen[int(tid)] = True
        elif s.name == "engine.phase":
            engine_phase[int(tid)] = engine_phase.get(int(tid), 0.0) + s.dur
        elif s.name == "trial.park":
            rec["park_wait"] += s.dur
        elif s.name.startswith("rpc."):
            rec["rpc"] += s.dur
    for tid, dur in engine_phase.items():
        # device-side phases only stand in when no stitched server-side
        # phase spans exist for the trial (they describe the same time)
        if not phase_seen.get(tid):
            out[tid]["step"] += dur
    for rec in out.values():
        used = sum(rec[b] for b in BUCKETS if b != "idle")
        rec["idle"] = max(0.0, rec["wall"] - used)
    return out


def aggregate(per_trial: Dict[int, Dict[str, float]]
              ) -> Dict[int, Dict[str, float]]:
    """Sum the per-trial attribution into per-bracket totals."""
    out: Dict[int, Dict[str, float]] = {}
    for rec in per_trial.values():
        b = int(rec.get("bracket", 0))
        agg = out.setdefault(b, dict.fromkeys(("trials", "wall") + BUCKETS,
                                              0.0))
        agg["trials"] += 1
        agg["wall"] += rec["wall"]
        for k in BUCKETS:
            agg[k] += rec[k]
    return out


def format_table(per_bracket: Dict[int, Dict[str, float]]) -> str:
    """The "where did time go" panel: one row per bracket, buckets as
    percentages of that bracket's summed trial wall-clock."""
    if not per_bracket:
        return ""
    head = (f"{'bracket':>7} {'trials':>6} {'wall_s':>9} "
            + " ".join(f"{b + '%':>9}" for b in BUCKETS))
    lines = ["where did time go (per bracket):", head]
    for b in sorted(per_bracket):
        agg = per_bracket[b]
        wall = agg["wall"]
        pct = [(100.0 * agg[k] / wall if wall > 0 else 0.0)
               for k in BUCKETS]
        lines.append(f"{b:>7d} {int(agg['trials']):>6d} {wall:>9.1f} "
                     + " ".join(f"{p:>9.1f}" for p in pct))
    return "\n".join(lines)


def critical_path_report(events: List[dict]) -> str:
    """events → rendered table (empty string when nothing attributable)."""
    per_trial = attribute(events)
    per_trial = {t: r for t, r in per_trial.items() if r["wall"] > 0}
    if not per_trial:
        return ""
    return format_table(aggregate(per_trial))
