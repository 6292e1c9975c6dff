"""Distributed metaoptimization service (port of ``repro/distributed/``:
paper §3.1–3.2 over real sockets, numpy and the standard library only).

The in-process ``OptimizationService`` becomes a client–server system:

* ``protocol``  — length-prefixed JSON wire format with typed messages,
                  byte for byte the reference's.
* ``server``    — selector-driven TCP server with per-trial leases and a
                  reaper thread (worker failure has strictly local effect).
* ``journal``   — durable append-only write-ahead log + replay, so a
                  restarted server resumes the search where it died.
* ``client``    — the SDK workers use to talk to the server.
* ``worker``    — the worker-agent entrypoint
                  (``python -m repro_torch.distributed.worker``), whose
                  trials train on the card through the port's kernels.
"""
from repro_torch.distributed.client import (Pending, RemoteTrial, ServiceClient,
                                            ServiceError)
from repro_torch.distributed.journal import Journal, read_events, replay_journal
from repro_torch.distributed.server import MetaoptServer

__all__ = [
    "Journal", "MetaoptServer", "Pending", "RemoteTrial", "ServiceClient",
    "ServiceError", "read_events", "replay_journal",
]
