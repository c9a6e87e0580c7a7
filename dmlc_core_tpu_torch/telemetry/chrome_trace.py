"""Chrome trace-event export of recorded spans (Perfetto-loadable).

Counterpart of ``dmlc_core_tpu/telemetry/chrome_trace.py``.  Converts
:mod:`.trace` ring-buffer records into the Chrome Trace Event JSON object
format (``{"traceEvents": [...]}``), the interchange format both
``chrome://tracing`` and https://ui.perfetto.dev load directly.

Each span record becomes two views of the same data:

* a per-thread complete event (``ph: "X"``) — shows wall-clock nesting
  on the thread that ran the work;
* a nestable async pair (``ph: "b"`` / ``"e"``) keyed by the hex
  ``trace_id`` — Perfetto groups all spans of one request tree onto a
  single async track, which is what makes the cross-process
  client→server→engine nesting visible even though each hop ran on a
  different thread (or machine).

Point events (retries, breaker trips) become instant events
(``ph: "i"``).  Timestamps/durations are microseconds, per the spec.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from . import trace as _trace

__all__ = ["to_chrome_trace", "write_chrome_trace"]


def _args(rec: Dict[str, Any]) -> Dict[str, Any]:
    args = dict(rec.get("attrs") or {})
    for k in ("trace_id", "span_id", "parent_id"):
        if rec.get(k):
            args[k] = rec[k]
    return args


def to_chrome_trace(records: Optional[Sequence[Dict[str, Any]]] = None,
                    ) -> Dict[str, Any]:
    """Render span records (default: the global recorder's snapshot) as a
    Chrome trace-event JSON object."""
    if records is None:
        records = _trace.recorder.snapshot()
    events: List[Dict[str, Any]] = []
    for rec in records:
        pid = rec.get("pid", 0)
        tid = rec.get("tid", 0)
        if rec.get("kind") == "span":
            ts = rec["ts_us"]
            dur = rec.get("dur_us", 0)
            events.append({
                "name": rec["name"], "cat": "span", "ph": "X",
                "ts": ts, "dur": dur, "pid": pid, "tid": tid,
                "args": _args(rec),
            })
            if rec.get("trace_id"):
                # async nestable pair: one track per trace_id in Perfetto
                common = {"name": rec["name"], "cat": "trace",
                          "id": rec["trace_id"], "pid": pid, "tid": tid}
                events.append({**common, "ph": "b", "ts": ts,
                               "args": _args(rec)})
                events.append({**common, "ph": "e", "ts": ts + dur})
            for ev in rec.get("events") or ():
                events.append({
                    "name": ev["name"], "cat": "span_event", "ph": "i",
                    "ts": ev["ts_us"], "pid": pid, "tid": tid, "s": "t",
                    "args": dict(ev.get("attrs") or {}),
                })
        else:  # standalone instant event
            events.append({
                "name": rec["name"], "cat": "event", "ph": "i",
                "ts": rec["ts_us"], "pid": pid, "tid": tid, "s": "p",
                "args": _args(rec),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       records: Optional[Sequence[Dict[str, Any]]] = None,
                       ) -> str:
    """Dump :func:`to_chrome_trace` to ``path``; returns the path."""
    doc = to_chrome_trace(records)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
