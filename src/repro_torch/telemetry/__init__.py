"""Live telemetry for the metaoptimization stack (port of
``repro/telemetry/__init__.py``, copied whole: the same re-exports).

Three surfaces over one vocabulary (``METRIC_SCHEMA``):

* ``metrics``   — the in-process registry (counters / gauges / windowed
  histograms, no external deps) threaded through the service, server, and
  population-engine hot paths;
* ``dashboard`` — a journal-tailing CLI (``python -m
  repro_torch.telemetry.dashboard --journal ... [--follow]``) that reconstructs
  live per-search rates, cohort occupancy, and best-vs-wall-clock from the
  JSONL journal alone (no server changes required);
* ``trace``     — synthetic 1000-host traces driven through the REAL
  ``core.scheduler`` + ``core.service.RungBarrier``, emitting the same
  metric schema, so scheduler policies are regression-tested at a scale no
  CI box can run.

None of these imports torch (only the stdlib, and the numpy that
``distributed.journal`` pulls in through ``core.service``), so the readers
run on a host with no card and no torch.

Plus per-trial distributed tracing over a second vocabulary
(``SPAN_SCHEMA``): ``spans`` (the recorder + journal event kind, with a
trace context propagated through the wire protocol), ``export`` (journal →
Chrome trace-event JSON for Perfetto), and ``critical_path`` (per-trial
wall-clock attribution into compile / step / rpc / park-wait / idle).
"""
from repro_torch.telemetry.metrics import (METRIC_SCHEMA, MetricsRegistry,
                                           NULL_REGISTRY, NullRegistry)
from repro_torch.telemetry.spans import (NULL_RECORDER, SPAN_SCHEMA, Span,
                                         SpanRecorder, derive_spans)

__all__ = ["METRIC_SCHEMA", "MetricsRegistry", "NULL_REGISTRY",
           "NullRegistry", "NULL_RECORDER", "SPAN_SCHEMA", "Span",
           "SpanRecorder", "derive_spans"]
