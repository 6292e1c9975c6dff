"""Launch counters of the kernel ops, exact when several threads launch.

Each op (``rmsnorm``, ``flash_attention``, ``gmm``, ``selective_scan``)
keeps its counters as plain int attributes: ``launches`` and one
``launches_<kernel>`` for each kernel behind its dispatch. ``fn.attr += 1``
is a read, an add and a write, and a thread switch between them loses a
count; a search trains its trials on several threads at once. So every
count goes through ``count_launch``, under one lock. Reading or resetting
an attribute needs no lock.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()


def count_launch(op, launched) -> None:
    """One more launch of kernel ``launched`` on ``op``'s counters:
    ``op.launches`` and ``op.launches_<launched>``. ``launched`` None (the
    call launched nothing) moves none."""
    if launched is None:
        return
    name = f"launches_{launched}"
    with _LOCK:
        served = getattr(op, name)
        op.launches += 1
        setattr(op, name, served + 1)
