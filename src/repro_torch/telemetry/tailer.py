"""Incremental reader for a journal that is still being appended (port of
``repro/telemetry/tailer.py``, copied whole but for ``size``, the
journal's size as the last poll measured it).

``distributed.journal.read_events`` reads a finished journal and skips a
torn final line (crash mid-write). A *tailer* reads a LIVE journal, so the
torn-line rule has to become positional: a final line with no trailing
newline is not torn garbage — it is a write in progress. The tailer
therefore only ever consumes up to the last newline it can see; the
partial tail is left un-consumed and picked up whole on a later poll, once
the writer finishes it. A COMPLETE line that still fails to decode (a
crash exactly at the newline of a half-written record, or corruption) is
skipped and counted, same as replay.

Each ``poll()`` reads at most ``max_bytes`` (default 8 MiB), so pointing
``dashboard --follow`` at a multi-hundred-MB journal costs a few bounded
polls instead of one giant read that stalls a render cycle — the backlog
drains across consecutive polls. The one exception is a single line longer
than ``max_bytes`` (a pathological event): the read grows until its
newline is found, because returning nothing forever would wedge the
tailer.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional


class JournalTailer:
    """Byte-offset tailer over an append-only JSONL file. Each ``poll()``
    returns the events completed since the previous poll (possibly none).
    Safe against a concurrently appending writer: frames are only consumed
    at newline boundaries, so a torn in-flight line is never half-read."""

    def __init__(self, path: str, max_bytes: Optional[int] = 8 << 20):
        self.path = path
        self.max_bytes = max_bytes   # per-poll read budget; None = unbounded
        self.offset = 0          # bytes consumed (always at a \n boundary)
        self.skipped = 0         # complete-but-undecodable lines dropped
        self.size = 0            # the journal's size as the last poll saw it

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []            # not created yet (server still starting)
        self.size = size
        if size < self.offset:
            # the file shrank: a fresh (non-resume) run truncated/replaced
            # the journal — start over rather than read garbage offsets
            self.offset = 0
        if size == self.offset:
            return []
        unread = size - self.offset
        budget = unread if self.max_bytes is None else min(unread,
                                                           self.max_bytes)
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read(budget)
            # a single line longer than the budget: grow until its newline
            # shows up (or we hit the size we measured) — a bounded poll
            # must never turn an oversized line into a permanent stall
            while (b"\n" not in data and len(data) < unread):
                more = f.read(min(unread - len(data),
                                  self.max_bytes or unread))
                if not more:
                    break
                data += more
        end = data.rfind(b"\n")
        if end < 0:
            return []            # only a torn line so far — wait for it
        chunk, self.offset = data[:end + 1], self.offset + end + 1
        events = []
        for line in chunk.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line.decode("utf-8")))
            except (UnicodeDecodeError, json.JSONDecodeError):
                self.skipped += 1
        return events
