"""Telemetry of the port (counterpart of ``dmlc_core_tpu/telemetry``).

Ported:

* :mod:`.trace` — ``TraceContext`` / ``span()`` propagation and the
  process-global span ring buffer, records field for field the JAX
  package's (the serving wire carries the ids from client to server),
  and ``record_span``, a leaf span its caller timed (the engine's);
* :mod:`.chrome_trace` — recorded spans as Chrome trace-event JSON (open
  in Perfetto), and :func:`dump_artifacts`, the registry snapshot and
  that trace side by side;
* :mod:`.anomaly` — :class:`~.anomaly.StreamingStat` and
  :class:`~.anomaly.StallDetector`, for the ingest worker and the
  autotuner's freeze signal.

The device side of a trace is ``utils.metrics.profile_trace`` (a
``torch.profiler`` capture of the card) and ``trace_span`` (a named range
on it).  Not ported yet (ROADMAP queue A.12): the ``/metrics`` ``/spans``
``/events`` exporter, the SLO monitor, tail sampling, wide events, the
flight recorder, the straggler board and diagnosis.
"""

from __future__ import annotations

import json
import os

from .anomaly import StallDetector, StreamingStat
from .chrome_trace import to_chrome_trace, write_chrome_trace
from .trace import (Span, SpanRecorder, TraceContext, activate, add_event,
                    current, current_trace_id, format_id, from_wire,
                    get_sampler, new_trace_id, record_span, recorder,
                    set_sampler, span, start_span, wire_ids)

__all__ = [
    "TraceContext", "Span", "SpanRecorder", "recorder", "span",
    "start_span", "record_span", "activate", "add_event", "current", "current_trace_id",
    "new_trace_id", "format_id", "wire_ids", "from_wire", "set_sampler",
    "get_sampler", "to_chrome_trace", "write_chrome_trace",
    "dump_artifacts", "StreamingStat", "StallDetector",
]


def dump_artifacts(prefix: str, registry=None) -> dict:
    """Write ``<prefix>.metrics.json`` (the registry's snapshot) and
    ``<prefix>.trace.json`` (a Chrome trace of the recorded spans).
    Returns ``{"metrics": path, "trace": path}``."""
    if registry is None:
        from ..utils.metrics import metrics as registry
    metrics_path = f"{prefix}.metrics.json"
    tmp = f"{metrics_path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"snapshot": registry.snapshot()}, f, indent=2,
                  sort_keys=True, default=str)
    os.replace(tmp, metrics_path)
    trace_path = write_chrome_trace(f"{prefix}.trace.json")
    return {"metrics": metrics_path, "trace": trace_path}
