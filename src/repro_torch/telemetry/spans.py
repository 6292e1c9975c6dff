"""Span recording (port of ``repro/telemetry/spans.py``, its no-op
recorder only). Nothing in the port records spans yet: the population
engine takes no recorder until the one that sinks spans to a journal, and
the trace tools that read them, come with the control plane (ROADMAP
queue 1 item 7c), which wires the engine's ``engine.*`` spans to it."""
from __future__ import annotations


class _NullRecorder:
    """Zero-overhead twin (cf. ``metrics.NULL_REGISTRY``)."""

    __slots__ = ()

    @property
    def enabled(self) -> bool:
        return False

    def record(self, name: str, ts: float, dur: float, **args) -> None: ...
    def end(self, name: str, dur: float, **args) -> None: ...


NULL_RECORDER = _NullRecorder()
