"""Durable write-ahead journal for the metaoptimization knowledge DB (port
of ``repro/distributed/journal.py``, copied whole).

Every acquire / report / status / requeue event the server handles is
appended as one JSON line *before* the response leaves the socket, so a
restarted server can ``replay_journal`` the file and resume the search with
the exact trial records it died with — the metaopt-state analogue of
``checkpoint/checkpointer.py``. Trials that were RUNNING at crash time have
lost their worker; replay marks them CRASHED and requeues their
configuration so the search still completes (strictly local effect, §3.2).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, List, Optional

from repro_torch.core.service import OptimizationService, TrialStatus
from repro_torch.distributed.protocol import json_default


class Journal:
    """Append-only JSONL event log (thread-safe, flushed per event)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self._fsync = fsync
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def append(self, event: dict) -> None:
        # wall-clock stamp on every event: the injected service clock `t`
        # is monotonic (meaningless across restarts/hosts), `ts` is epoch
        # seconds — what the dashboard plots against. Added only when the
        # caller did not set one; replay treats it as optional, so journals
        # that predate the field still replay identically.
        if "ts" not in event:
            event = dict(event, ts=round(time.time(), 6))
        line = json.dumps(event, sort_keys=True, default=json_default)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())

    def compact(self, state: dict, archive: bool = True) -> int:
        """Replace the journal with one ``snapshot`` event carrying
        ``state`` (``OptimizationService.state_snapshot()``), so restart
        replay is O(live trials) instead of O(history). The swap is
        crash-safe: the snapshot is written to a temp file, fsynced, and
        ``os.replace``d over the journal — a crash mid-compaction leaves
        either the old journal or the new one, never a torn mix.

        With ``archive`` (default), the compacted-away lines are first
        appended to ``<path>.history`` so nothing is lost to offline
        consumers: ``read_full_history`` concatenates history + current
        and reproduces the exact original event stream (dashboards,
        ``derive_spans``, Perfetto export all keep working). Returns the
        number of lines compacted away."""
        with self._lock:
            self._f.flush()
            with open(self.path, encoding="utf-8") as f:
                old_lines = f.readlines()
            if archive and old_lines:
                with open(self.path + ".history", "a",
                          encoding="utf-8") as hist:
                    hist.writelines(old_lines)
                    hist.flush()
                    os.fsync(hist.fileno())
            snap = {"ev": "snapshot", "state": state,
                    "ts": round(time.time(), 6)}
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(snap, sort_keys=True,
                                   default=json_default) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", encoding="utf-8")
        return len(old_lines)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> Iterator[dict]:
    """Yield journal events; a torn final line (crash mid-write) is skipped."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def read_full_history(path: str) -> Iterator[dict]:
    """Yield the complete event stream across compactions: the archived
    ``<path>.history`` lines (in order), then the live journal. Snapshot
    events are filtered out — the concatenation is byte-for-byte the
    stream an uncompacted journal would hold, which is what offline
    consumers (``derive_spans``, export, the dashboard's backfill) want."""
    hist = path + ".history"
    if os.path.exists(hist):
        for ev in read_events(hist):
            # a second compaction archives the previous snapshot line too
            if ev.get("ev") != "snapshot":
                yield ev
    if os.path.exists(path):
        for ev in read_events(path):
            if ev.get("ev") != "snapshot":
                yield ev


def replay_journal(path: str, service: OptimizationService,
                   journal: Optional[Journal] = None,
                   reclaim_running: bool = True) -> int:
    """Rebuild ``service`` (db + id counter + policy budget accounting +
    requeue queue) from the journal at ``path``. Returns the number of
    events applied; 0 if the file does not exist.

    If ``journal`` is given, the reclamation of orphaned RUNNING trials is
    itself journaled, so a second restart replays identically.
    """
    if not os.path.exists(path):
        return 0
    events: List[dict] = list(read_events(path))
    if not events:
        return 0
    reclaimed = service.replay(events, reclaim_running=reclaim_running)
    if journal is not None:
        for rec in reclaimed:
            journal.append({"ev": "status", "trial_id": rec.trial_id,
                            "status": TrialStatus.CRASHED.value, "t": None})
            journal.append({"ev": "requeue", "hparams": rec.hparams})
    return len(events)
