"""Telemetry of the port (counterpart of ``dmlc_core_tpu/telemetry``).

Ported:

* :mod:`.trace` — ``TraceContext`` / ``span()`` propagation and the
  process-global span ring buffer, records field for field the JAX
  package's (the serving wire carries the ids from client to server),
  and ``record_span``, a leaf span its caller timed (the engine's);
* :mod:`.sampling` — tail-based trace sampling: whole traces buffered,
  errors, slow roots, SLO-breach windows and debug traces kept plus a
  consistent-hash floor (``DMLC_TRACE_SAMPLE``), the JAX verdicts bit for
  bit;
* :mod:`.wide_events` — one canonical wide event per served request, in
  a ring served at ``/events``;
* :mod:`.flight` — the always-on flight recorder: incident bundles on an
  injected fault, an SLO breach, an engine failure, a fatal signal, an
  unhandled exception or ``/flight`` (``DMLC_FLIGHT_DIR`` arms it);
* :mod:`.chrome_trace` — recorded spans as Chrome trace-event JSON (open
  in Perfetto), and :func:`dump_artifacts`, the registry snapshot and
  that trace side by side;
* :mod:`.exposition` — Prometheus text (0.0.4) and OpenMetrics rendering
  and :class:`TelemetryServer`, the HTTP exporter of ``/metrics``,
  ``/healthz``, ``/spans``, ``/timeline``, ``/events``, ``/flight``,
  ``/profile``, ``/analyze`` and ``/diagnose``; the prediction server
  mounts one on ``metrics_port=`` / ``DMLC_METRICS_PORT``;
* :mod:`.aggregate` — rank-tagged registry states merged into one fleet
  view, with the counter-reset guard;
* :mod:`.timeseries` — the tiered metric history behind ``/timeline``,
  sampled by a thread the first exporter starts;
* :mod:`.anomaly` — :class:`~.anomaly.StreamingStat` and
  :class:`~.anomaly.StallDetector` (the ingest worker's and the
  autotuner's freeze signal), :class:`~.anomaly.StragglerBoard`, and the
  ``DMLC_SLO_SPEC`` rules and monitor; :mod:`.slo` adds the burn-rate
  rules over the history.  A breach holds ``slo.active_breaches`` above
  0, which degrades the serving health and freezes the autotuner;
* :mod:`.profiling` — the stdlib sampling stack profiler behind
  ``/profile`` and the flight recorder's incident attachment, plus
  collapsed-stack profile diffing (``/profile?diff=1``);
* :mod:`.critical_path` — the critical path of the slowest traces in the
  span ring, with each span's self time (``/analyze``);
* :mod:`.diagnose` — automated incident diagnosis: wide-event
  differencing, timeline lead/lag correlation, critical-path regression
  diff and fleet attribution merged into one ranked suspect report at
  ``/diagnose``, run by the SLO monitor on a breach before its dump and
  attached to every flight bundle;
* :mod:`.graph_introspect` — the capture watchdog (the engine's CUDA
  graph captures counted per bucket, and recaptures and ladder misses
  alerted, under the JAX watchdog's ``xla.*`` names) and the device
  memory gauges.

The device side of a trace is ``utils.metrics.profile_trace`` (a
``torch.profiler`` capture of the card) and ``trace_span`` (a named range
on it).
"""

from __future__ import annotations

import json
import os

from .aggregate import merge_states, render_fleet, state_to_snapshot
from .anomaly import (SloMonitor, SloRule, SloSpecError, StallDetector,
                      StragglerBoard, StreamingStat, maybe_monitor_from_env,
                      parse_slo_spec)
from .chrome_trace import to_chrome_trace, write_chrome_trace
# NOTE: the submodule's convenience function is exported as
# run_diagnosis — binding the package attribute ``diagnose`` to a
# function would shadow the *module* for every ``from . import
# diagnose`` site (exposition/flight/anomaly lazy imports)
from .diagnose import DIAGNOSIS_SCHEMA, DiagnosisEngine, incident_diagnosis
from .diagnose import diagnose as run_diagnosis
from .diagnose import render_text as render_diagnosis
from .exposition import (TelemetryServer, maybe_start_from_env,
                         render_openmetrics, render_prometheus,
                         render_series)
from .flight import (FlightRecorder, dump_incident, flight_recorder,
                     maybe_arm_from_env, register_contributor,
                     unregister_contributor)
from .graph_introspect import RetraceWatchdog, sample_memory, watchdog
from .profiling import (SamplingProfiler, diff_collapsed, incident_profile,
                        profile_for)
from .sampling import (TailSampler, TraceBuffer, debug_trace_id, hash_keep,
                       is_debug, mark_debug, maybe_install_from_env,
                       was_kept)
from .sampling import install as install_sampler
from .sampling import uninstall as uninstall_sampler
from .trace import (Span, SpanRecorder, TraceContext, activate, add_event,
                    current, current_trace_id, format_id, from_wire,
                    get_sampler, new_trace_id, record_span, recorder,
                    set_sampler, span, start_span, wire_ids)
from .wide_events import FIELDS as WIDE_EVENT_FIELDS
from .wide_events import WideEventLog, events_doc, wide_event, wide_log

__all__ = [
    "TraceContext", "Span", "SpanRecorder", "recorder", "span",
    "start_span", "record_span", "activate", "add_event", "current", "current_trace_id",
    "new_trace_id", "format_id", "wire_ids", "from_wire", "set_sampler",
    "get_sampler", "to_chrome_trace", "write_chrome_trace",
    "render_prometheus", "render_series", "render_openmetrics",
    "TelemetryServer", "maybe_start_from_env",
    "TailSampler", "TraceBuffer", "hash_keep", "is_debug", "mark_debug",
    "debug_trace_id", "was_kept", "maybe_install_from_env",
    "install_sampler", "uninstall_sampler",
    "WideEventLog", "wide_log", "wide_event", "events_doc",
    "WIDE_EVENT_FIELDS",
    "FlightRecorder", "flight_recorder", "dump_incident",
    "maybe_arm_from_env", "register_contributor", "unregister_contributor",
    "merge_states", "state_to_snapshot", "render_fleet",
    "dump_artifacts",
    "SamplingProfiler", "profile_for", "incident_profile",
    "diff_collapsed",
    "DiagnosisEngine", "run_diagnosis", "incident_diagnosis",
    "render_diagnosis", "DIAGNOSIS_SCHEMA",
    "StreamingStat", "StallDetector", "StragglerBoard",
    "SloRule", "SloMonitor", "SloSpecError", "parse_slo_spec",
    "maybe_monitor_from_env",
    "RetraceWatchdog", "watchdog", "sample_memory",
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
