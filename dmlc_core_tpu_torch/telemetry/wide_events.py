"""Wide events: one canonical JSON line per unit of served work.

Counterpart of ``dmlc_core_tpu/telemetry/wide_events.py``, copied so
that the port never imports the JAX package: the same closed field set
(:data:`FIELDS`), schema, ring, cursor arithmetic and audit file, so a
consumer of either package's ``/events`` reads the other's.

Spans answer *where did this request go*; metrics answer *how much*.
Neither survives an incident post-mortem on its own: the span ring is
lossy by design (and tail-sampled), and histograms cannot say which
model or replica produced their tail.  The wide event is the canonical-
log-line answer — **one** bounded-cardinality record per serving
request, carrying every dimension an analyst would group by (model,
rows/nnz, queue wait, batch size, outcome, trace id, sampling verdict)
— so post-hoc analytics never depend on what the span ring happened to
retain.

The vocabulary is closed: :data:`FIELDS` is the complete field set (the
JAX package's, which also names its data-service lease fields).  Unknown
fields are dropped and counted (``telemetry.wide_events.unknown_fields``),
never silently admitted — cardinality stays bounded by construction.

Events land in a process-global ring (``DMLC_WIDE_EVENTS_CAP``, default
2048) served at ``/events?since=<seq>`` by every telemetry exporter,
optionally appended as JSON lines to ``DMLC_WIDE_EVENTS`` (the durable
audit file), and ride flight bundles via a lazily-registered
contributor.  Emission is :func:`wide_event`.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.logging import log_warning
from ..utils.metrics import metrics
from ..utils.parameter import get_env
from . import trace as _trace

__all__ = ["FIELDS", "WideEventLog", "wide_log", "wide_event",
           "events_doc"]

WIDE_EVENTS_SCHEMA = "dmlc.telemetry.wide_events/1"

#: the closed field vocabulary (the JAX package's)
FIELDS = frozenset({
    "kind", "seq", "ts", "model", "replica", "conn", "req_id", "rows",
    "nnz", "batch_rows", "batch_nnz", "queue_ms", "dur_ms", "attempts",
    "retries", "hedges", "failovers", "outcome", "trace_id", "sampled",
    "debug", "worker", "part", "key", "lease_epoch", "epoch", "frames",
    "bytes", "endpoint", "qos",
})


class WideEventLog:
    """Bounded ring + optional append-only file of wide events.

    ``emit`` filters fields against :data:`FIELDS`, stamps ``seq``/
    ``ts`` and the ambient trace identity (``trace_id``/``debug``, plus
    the tail-sampling verdict as ``sampled`` when one is known), and
    appends.  The file path is append-only JSON lines — an audit log,
    not an artifact, so a write error disables the file (counted in
    ``telemetry.wide_events.file_errors``) instead of failing requests.
    """

    def __init__(self, capacity: Optional[int] = None,
                 path: Optional[str] = None) -> None:
        if capacity is None:
            capacity = int(get_env("DMLC_WIDE_EVENTS_CAP", 2048))
        if path is None:
            path = get_env("DMLC_WIDE_EVENTS", None)
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=max(1, int(capacity)))
        self._seq = 0
        self._dropped = 0
        self._path = path
        self._file = None
        self._file_dead = False
        self._registered = False

    # -- write path ------------------------------------------------------
    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        unknown = [k for k in fields if k not in FIELDS]
        if unknown:
            metrics.counter("telemetry.wide_events.unknown_fields").add(
                len(unknown))
            for k in unknown:
                fields.pop(k)
        ev: Dict[str, Any] = {"kind": str(kind),
                              "ts": round(time.time(), 6)}
        if "trace_id" not in fields:
            ctx = _trace.current()
            if ctx is not None:
                fields["trace_id"] = _trace.format_id(ctx.trace_id)
                fields.setdefault("debug",
                                  bool(ctx.trace_id & (1 << 63)))
        if "sampled" not in fields and fields.get("trace_id"):
            fields["sampled"] = self._verdict(fields["trace_id"])
        ev.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(ev)
            line = self._line_for_file(ev)
        metrics.counter("telemetry.wide_events.emitted").add(1)
        if line is not None:
            self._append(line)
        self._register_contributor()
        return ev

    @staticmethod
    def _verdict(trace_hex: str) -> Optional[bool]:
        # the port's sampler, by the port's module name: a process that
        # also loaded the JAX package must not read the JAX verdicts
        s = sys.modules.get("dmlc_core_tpu_torch.telemetry.sampling")
        if s is None:
            return None
        return s.was_kept(trace_hex)

    def _line_for_file(self, ev: Dict[str, Any]) -> Optional[str]:
        if self._path is None or self._file_dead:
            return None
        return json.dumps(ev, sort_keys=True, separators=(",", ":"))

    def _append(self, line: str) -> None:
        try:
            with self._lock:
                if self._file is None:
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(line + "\n")
                self._file.flush()
        except OSError as e:
            with self._lock:
                self._file_dead = True
                self._file = None
            metrics.counter("telemetry.wide_events.file_errors").add(1)
            log_warning("wide events: disabling %r after write error: %s",
                        self._path, e)

    def _register_contributor(self) -> None:
        # lazy: only processes that actually emit wide events grow the
        # flight-bundle section, so bundles elsewhere are unchanged
        if self._registered:
            return
        self._registered = True
        try:
            from . import flight as _flight
            _flight.register_contributor(
                "wide_events", lambda: self.doc())
        except Exception as e:     # flight is optional at this layer
            log_warning("wide events: flight contributor not "
                        "registered: %s", e)

    # -- read path -------------------------------------------------------
    def snapshot(self, since: int = 0) -> List[Dict[str, Any]]:
        """Events with ``seq > since`` (the ``/events?since=`` cursor)."""
        with self._lock:
            if since <= 0:
                return list(self._buf)
            return [e for e in self._buf if e.get("seq", 0) > since]

    def doc(self, since: int = 0) -> Dict[str, Any]:
        """The ``/events`` response body / flight-bundle section.

        ``dropped`` is the cumulative ring-overflow count since the last
        :meth:`reset`.  ``missed`` is *this cursor's* loss: how many
        events with ``seq > since`` are gone from the ring (overflowed,
        or cleared by a reset — ``seq`` itself never restarts, so the
        arithmetic stays honest across both).  A resuming reader that
        sees ``missed == 0`` is guaranteed a gap-free, duplicate-free
        continuation of its previous read.
        """
        events = self.snapshot(since)
        with self._lock:
            last_seq, dropped = self._seq, self._dropped
            oldest = self._buf[0].get("seq", 0) if self._buf else None
        since = max(0, int(since))
        if oldest is not None:
            missed = max(0, oldest - 1 - since)
        else:
            missed = max(0, last_seq - since)
        return {"schema": WIDE_EVENTS_SCHEMA, "events": events,
                "last_seq": last_seq, "dropped": dropped,
                "missed": missed, "file": self._path}

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def reset(self, capacity: Optional[int] = None,
              path: Optional[str] = None) -> None:
        """Re-point the log (tests; long-lived processes after env
        changes).  Drops buffered events and closes any open file.
        ``seq`` is deliberately *not* restarted: cursors held by
        ``/events?since=`` readers must stay strictly monotonic, so a
        reader resuming across a reset reports the cleared events as
        ``missed`` instead of silently skipping (or re-reading) lines."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = None
            self._file_dead = False
            self._buf = deque(maxlen=max(1, int(
                capacity if capacity is not None
                else get_env("DMLC_WIDE_EVENTS_CAP", 2048))))
            self._dropped = 0
            self._path = path if path is not None \
                else get_env("DMLC_WIDE_EVENTS", None)


#: process-global log — what /events serves and flight bundles attach
wide_log = WideEventLog()


def wide_event(kind: str, **fields: Any) -> Dict[str, Any]:
    """Emit one wide event into the global log (the one call spelling,
    as in the JAX package)."""
    return wide_log.emit(kind, **fields)


def events_doc(since: int = 0) -> Dict[str, Any]:
    """The global log's ``/events`` document (exposition default fn)."""
    return wide_log.doc(since)
