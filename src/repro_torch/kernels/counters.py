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


def count_launch(op, launched, *cases) -> None:
    """One more launch of kernel ``launched`` on ``op``'s counters:
    ``op.launches``, ``op.launches_<launched>`` and ``op.launches_<case>``
    for each of ``cases`` (a case of that kernel, e.g. RMSNorm's
    ``slots``). ``launched`` None (the call launched nothing) moves none."""
    if launched is None:
        return
    names = [f"launches_{name}" for name in (launched, *cases)]
    with _LOCK:
        served = [getattr(op, name) for name in names]   # an unknown kernel raises here
        op.launches += 1
        for name, n in zip(names, served):
            setattr(op, name, n + 1)
