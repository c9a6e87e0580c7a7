"""Flight recorder: an always-on, bounded black box per process.

Counterpart of ``dmlc_core_tpu/telemetry/flight.py``, copied so that the
port never imports the JAX package: the same rings, triggers, rate
limit, sections, bundle layout, files and schema, the incident-time
profile (``profile_collapsed``, ``profile.txt``), the critical path
(``critical_path.txt``), the differential profile (``profile_diff.txt``)
and the diagnosis (``diagnosis.json``, ``diagnosis.txt``) among them.  A
bundle reads host state only (the registry, the rings, the span ring,
the metric history, Python's stacks), never the device, so a dump after
a CUDA error (a failed graph replay leaves the context's error set, and
any CUDA call raises it again) still writes.

A production incident is usually diagnosed from evidence that no longer
exists by the time anyone looks — the spans scrolled off, the logs
rotated, the metrics page shows *now*, not *then*.  This module keeps
the last few minutes of everything in bounded rings and, on trigger,
dumps one **self-contained incident bundle**:

``incident.json``
    schema ``dmlc.flight.incident/1``: the trigger (reason + detail,
    e.g. the breached SLO rule), process identity (pid/host/rank), the
    active ``DMLC_SLO_SPEC`` / ``DMLC_FAULT_SPEC``, the full registry
    snapshot, counter deltas against the oldest ring snapshot, and the
    recorder's note ring (injected faults, SLO breaches, stage stalls,
    retrace alerts).
``trace.json``
    Chrome trace-event JSON of the span ring buffer — drop it on
    https://ui.perfetto.dev and see what the process was doing when it
    died.
``log_tail.txt``
    the last N log lines (``utils.logging``'s in-process tail ring).

Triggers (all funnel into :meth:`FlightRecorder.dump`):

* **SLO breach** — ``telemetry.anomaly.SloMonitor`` dumps with the
  breached rule in the detail.
* **Engine failure** — the serving micro-batcher notes and dumps an
  engine call that raised.
* **Injected fault** — ``utils/faults.py`` calls :func:`note_fault` on
  every injected error (via ``sys.modules``, by the port's module name:
  a process that also loaded the JAX package never reaches the JAX
  recorder), so a chaos run
  leaves bundles behind exactly like a real incident would.
* **Fatal signal / unhandled exception** — :meth:`FlightRecorder.install`
  chains onto ``sys.excepthook`` / ``threading.excepthook`` and the
  catchable fatal signals (SIGTERM, SIGABRT).
* **Explicit** — ``GET /flight`` on any exposition server returns the
  bundle inline (and writes it to disk when armed).

The recorder itself is always on — the rings exist regardless — but
writing to disk requires **arming** with a directory (``DMLC_FLIGHT_DIR``
or :meth:`arm`).  Dumps are rate-limited (``DMLC_FLIGHT_MIN_INTERVAL``)
so a breach storm produces one bundle per window, not a disk full.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import get_log_tail, log_info, log_warning
from ..utils.metrics import MetricsRegistry, metrics
from ..utils.parameter import get_env
from . import trace as _trace
from .chrome_trace import to_chrome_trace

__all__ = ["FlightRecorder", "flight_recorder", "dump_incident", "note",
           "note_fault", "maybe_arm_from_env", "register_contributor",
           "unregister_contributor", "INCIDENT_SCHEMA"]

INCIDENT_SCHEMA = "dmlc.flight.incident/1"

#: pluggable bundle sections: name → zero-arg callable returning a
#: JSON-ready value, snapshotted into every bundle under that key.
#: Subsystems owning per-process state the recorder cannot reach register
#: here (the data-service dispatcher contributes its lease ledger); a
#: failing contributor degrades to an error string, never kills the dump.
_contrib_lock = threading.Lock()
_contributors: Dict[str, Callable[[], Any]] = {}


def register_contributor(name: str, fn: Callable[[], Any]) -> None:
    """Attach a named section to every future incident bundle (last
    registration per name wins — a restarted dispatcher re-registers)."""
    with _contrib_lock:
        _contributors[name] = fn


def unregister_contributor(name: str) -> None:
    with _contrib_lock:
        _contributors.pop(name, None)


def _counter_deltas(old: Dict[str, Dict[str, Any]],
                    new: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """What moved between two snapshots: counter/throughput totals and
    stage count/total deltas.  Gauges and quantiles are point-in-time —
    both endpoints already ride the bundle."""
    out: Dict[str, Any] = {}
    for name, snap in new.items():
        prev = old.get(name)
        if not isinstance(prev, dict) or prev.get("type") != snap.get("type"):
            continue
        t = snap.get("type")
        if t == "counter":
            d = snap.get("value", 0) - prev.get("value", 0)
        elif t == "throughput":
            d = snap.get("total", 0) - prev.get("total", 0)
        elif t == "stage":
            d = {"count": snap.get("count", 0) - prev.get("count", 0),
                 "total_sec": (snap.get("total_sec", 0.0)
                               - prev.get("total_sec", 0.0))}
        elif t == "histogram":
            d = snap.get("count", 0) - prev.get("count", 0)
        else:
            continue
        if d not in (0, 0.0):
            out[name] = d
    return out


class FlightRecorder:
    """Bounded black box + incident dumper (see module doc)."""

    def __init__(self, snapshot_capacity: int = 32,
                 note_capacity: int = 256) -> None:
        self._lock = threading.Lock()
        self._snaps: deque = deque(maxlen=max(2, int(snapshot_capacity)))
        self._notes: deque = deque(maxlen=max(1, int(note_capacity)))
        self._dir: Optional[str] = get_env("DMLC_FLIGHT_DIR", None) or None
        self._min_interval = get_env("DMLC_FLIGHT_MIN_INTERVAL", 30.0)
        self._last_dump = -float("inf")
        self._dump_seq = 0
        self._installed = False
        self._prev_excepthook = None
        self._prev_thread_hook = None

    # -- arming ----------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._dir is not None

    def arm(self, directory: str) -> "FlightRecorder":
        """Enable disk dumps into ``directory`` (created on first dump)."""
        self._dir = directory
        return self

    def disarm(self) -> None:
        self._dir = None

    # -- feeding the rings ----------------------------------------------
    def note(self, kind: str, **attrs: Any) -> None:
        """Record a notable event (injected fault, SLO breach, stall,
        retrace alert) into the bounded note ring."""
        rec = {"kind": kind, "ts": time.time(), **attrs}
        with self._lock:
            self._notes.append(rec)

    def note_snapshot(self, registry: Optional[MetricsRegistry] = None
                      ) -> None:
        """Add a registry snapshot to the delta ring (SLO monitor ticks
        and telemetry pushes call this on their cadence)."""
        reg = registry if registry is not None else metrics
        snap = reg.snapshot()
        with self._lock:
            self._snaps.append((time.time(), snap))

    def notes(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._notes)

    # -- bundling --------------------------------------------------------
    def bundle(self, reason: str,
               registry: Optional[MetricsRegistry] = None,
               **detail: Any) -> Dict[str, Any]:
        """The in-memory incident bundle (what ``/flight`` returns and
        what :meth:`dump` writes, minus the file layout)."""
        reg = registry if registry is not None else metrics
        now_snap = reg.snapshot()
        with self._lock:
            oldest = self._snaps[0] if self._snaps else None
            notes = list(self._notes)
        delta = None
        if oldest is not None:
            delta = {"since_ts": oldest[0],
                     "deltas": _counter_deltas(oldest[1], now_snap)}
        # the port's modules, by the port's names (never the JAX ones)
        anomaly_mod = sys.modules.get("dmlc_core_tpu_torch.telemetry.anomaly")
        faults_mod = sys.modules.get("dmlc_core_tpu_torch.utils.faults")
        rank = get_env("DMLC_RANK", None)
        with _contrib_lock:
            contribs = dict(_contributors)
        sections: Dict[str, Any] = {}
        for name, fn in contribs.items():
            try:
                sections[name] = fn()
            except Exception as e:   # a contributor must not kill the dump
                sections[name] = f"<contributor failed: {e}>"
        # incident-time stacks: what every thread was doing when the
        # trigger fired (short bounded window; DMLC_FLIGHT_PROFILE_S=0
        # opts out)
        try:
            from . import profiling as _profiling
            sections["profile_collapsed"] = _profiling.incident_profile()
        except Exception as e:
            sections["profile_collapsed"] = f"<profiler failed: {e}>"
        # the before/after the snapshot can't give: the surrounding
        # timeline slice and where the slow requests actually spent
        # their time (both skipped when empty — a bundle from a process
        # with no sampler or no spans stays lean)
        try:
            from . import timeseries as _timeseries
            tl = _timeseries.history.snapshot_doc()
            if tl.get("series"):
                sections["timeline"] = tl
        except Exception as e:
            sections["timeline"] = f"<timeline failed: {e}>"
        try:
            from . import critical_path as _critical_path
            breakdown = _critical_path.incident_breakdown()
            if breakdown:
                sections["critical_path"] = breakdown
        except Exception as e:
            sections["critical_path"] = f"<critical path failed: {e}>"
        # the differential profile (r20): incident-window stacks vs the
        # last healthy /profile scrape — only when a baseline exists
        try:
            from . import profiling as _profiling_diff
            prof_text = sections.get("profile_collapsed")
            if isinstance(prof_text, str) and prof_text \
                    and not prof_text.startswith("<"):
                pdiff = _profiling_diff.incident_profile_diff(prof_text)
                if pdiff:
                    sections["profile_diff"] = pdiff
        except Exception as e:
            sections["profile_diff"] = f"<profile diff failed: {e}>"
        # the ranked root-cause verdict (r20): breach-scoped when a burn
        # rule just fired, default-window otherwise (DMLC_DIAGNOSE=0
        # opts out; skipped-when-None keeps unrelated bundles lean)
        try:
            from . import diagnose as _diagnose
            ddoc = _diagnose.incident_diagnosis()
            if ddoc is not None:
                sections["diagnosis"] = ddoc
        except Exception as e:
            sections["diagnosis"] = f"<diagnosis failed: {e}>"
        return {
            **sections,
            "schema": INCIDENT_SCHEMA,
            "reason": reason,
            "detail": detail,
            "ts": time.time(),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "rank": int(rank) if rank and rank.lstrip("-").isdigit()
                    else None,
            "slo_spec": (anomaly_mod.active_slo_spec()
                         if anomaly_mod is not None else None),
            "fault_spec": (faults_mod.active_spec()
                           if faults_mod is not None else None),
            "metrics": now_snap,
            "metrics_delta": delta,
            "notes": notes,
            "span_count": len(_trace.recorder),
        }

    # -- dumping ---------------------------------------------------------
    def dump(self, reason: str, directory: Optional[str] = None,
             registry: Optional[MetricsRegistry] = None,
             force: bool = False, **detail: Any) -> Optional[str]:
        """Write an incident bundle; returns its directory, or None when
        not armed / rate-limited.  ``force`` bypasses the rate limit
        (explicit ``/flight`` hits and fatal paths use it — the last
        dump before death must never be suppressed)."""
        out_root = directory or self._dir
        if out_root is None:
            return None
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_dump < self._min_interval:
                return None
            self._last_dump = now
            self._dump_seq += 1
            seq = self._dump_seq
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                              for c in reason) or "incident"
        path = os.path.join(out_root,
                            f"incident-{stamp}-{seq:03d}-{safe_reason}")
        try:
            os.makedirs(path, exist_ok=True)
            doc = self.bundle(reason, registry=registry, **detail)
            tail = get_log_tail()
            doc["files"] = {"incident": "incident.json",
                            "trace": "trace.json",
                            "log_tail": "log_tail.txt"}
            prof = doc.get("profile_collapsed")
            if isinstance(prof, str) and prof:
                doc["files"]["profile"] = "profile.txt"
            tl = doc.get("timeline")
            if isinstance(tl, dict) and tl.get("series"):
                doc["files"]["timeline"] = "timeline.json"
            cpath = doc.get("critical_path")
            if isinstance(cpath, str) and cpath:
                doc["files"]["critical_path"] = "critical_path.txt"
            pdiff = doc.get("profile_diff")
            if isinstance(pdiff, str) and pdiff:
                doc["files"]["profile_diff"] = "profile_diff.txt"
            diag = doc.get("diagnosis")
            if isinstance(diag, dict):
                doc["files"]["diagnosis"] = "diagnosis.json"
                doc["files"]["diagnosis_text"] = "diagnosis.txt"
            # tmp + rename per file: a crash mid-dump (likely — this IS
            # the crash path) must not leave a half-written bundle that
            # post-mortem tooling then chokes on
            def _put(name: str, write) -> None:
                tmp = os.path.join(path, f".{name}.tmp")
                with open(tmp, "w", encoding="utf-8") as f:
                    write(f)
                os.replace(tmp, os.path.join(path, name))

            _put("incident.json",
                 lambda f: json.dump(doc, f, indent=2, sort_keys=True,
                                     default=str))
            _put("trace.json", lambda f: json.dump(to_chrome_trace(), f))
            _put("log_tail.txt",
                 lambda f: f.write("\n".join(tail) + ("\n" if tail else "")))
            if isinstance(prof, str) and prof:
                # collapsed stacks as their own file: flamegraph.pl and
                # speedscope read the format directly, no JSON unwrapping
                _put("profile.txt", lambda f: f.write(prof + "\n"))
            if isinstance(tl, dict) and tl.get("series"):
                _put("timeline.json",
                     lambda f: json.dump(tl, f, indent=2, sort_keys=True,
                                         default=str))
            if isinstance(cpath, str) and cpath:
                _put("critical_path.txt", lambda f: f.write(cpath))
            if isinstance(pdiff, str) and pdiff:
                _put("profile_diff.txt", lambda f: f.write(pdiff + "\n"))
            if isinstance(diag, dict):
                _put("diagnosis.json",
                     lambda f: json.dump(diag, f, indent=2,
                                         sort_keys=True, default=str))
                from . import diagnose as _diagnose
                _put("diagnosis.txt",
                     lambda f: f.write(_diagnose.render_text(diag)))
        except OSError as e:
            # the black box must never become the crash: report and move on
            log_warning("flight recorder dump to %s failed: %s", path, e)
            return None
        log_info("flight recorder: incident bundle at %s (reason=%s)",
                 path, reason)
        return path

    # -- fatal-path installation ----------------------------------------
    def install(self, signals: bool = True, excepthook: bool = True) -> None:
        """Chain onto the process's fatal paths: unhandled exceptions in
        the main thread and worker threads, plus the catchable fatal
        signals (SIGTERM/SIGABRT — SIGKILL/SIGSEGV are not interceptable
        from Python; crash-loop coverage for those comes from the ring
        dumps of the PREVIOUS trigger).  Previous hooks/handlers keep
        running after the dump."""
        if self._installed:
            return
        self._installed = True
        if excepthook:
            self._prev_excepthook = sys.excepthook

            def _hook(tp, val, tb):
                self.dump("unhandled_exception", force=True,
                          error=f"{tp.__name__}: {val}")
                (self._prev_excepthook or sys.__excepthook__)(tp, val, tb)

            sys.excepthook = _hook
            self._prev_thread_hook = threading.excepthook

            def _thread_hook(args):
                if args.exc_type is not SystemExit:
                    self.dump("unhandled_thread_exception", force=True,
                              error=f"{args.exc_type.__name__}: "
                                    f"{args.exc_value}",
                              thread=getattr(args.thread, "name", "?"))
                (self._prev_thread_hook
                 or threading.__excepthook__)(args)

            threading.excepthook = _thread_hook
        if signals:
            for signame in ("SIGTERM", "SIGABRT"):
                signum = getattr(signal, signame, None)
                if signum is None:
                    continue
                try:
                    prev = signal.getsignal(signum)

                    def _handler(num, frame, prev=prev, name=signame):
                        self.dump("fatal_signal", force=True, signal=name)
                        if callable(prev):
                            prev(num, frame)
                        else:
                            signal.signal(num, signal.SIG_DFL)
                            signal.raise_signal(num)

                    signal.signal(signum, _handler)
                except (ValueError, OSError) as e:
                    # not the main thread, or an exotic platform: the
                    # other hooks stand, and the gap is said aloud
                    log_warning("flight recorder: no %s handler (%s)",
                                signame, e)


#: process-global recorder (triggers from faults/anomaly/serving feed it)
flight_recorder = FlightRecorder()


def dump_incident(reason: str, registry: Optional[MetricsRegistry] = None,
                  **detail: Any) -> Optional[str]:
    """Module-level dump on the global recorder (rate-limited, no-op when
    unarmed) — the one-liner trigger sites call."""
    return flight_recorder.dump(reason, registry=registry, **detail)


def note(kind: str, **attrs: Any) -> None:
    """Record a notable event on the global recorder (the one-liner the
    anomaly detectors call via sys.modules)."""
    flight_recorder.note(kind, **attrs)


def note_fault(site: str) -> None:
    """Called by ``utils.faults`` (via sys.modules — no import edge) on
    every injected error: record it, and when armed leave a bundle so the
    chaos run's evidence trail matches a real incident's."""
    flight_recorder.note("fault_injected", site=site)
    metrics.counter("flight.fault_triggers").add(1)
    flight_recorder.dump("injected_fault", site=site)


def maybe_arm_from_env(install: bool = True) -> Optional[FlightRecorder]:
    """Arm the global recorder when ``DMLC_FLIGHT_DIR`` is set; also
    install the fatal-path hooks (``DMLC_FLIGHT_HOOKS=0`` opts out).
    Unset → None, exact no-op — the faults/SLO env convention."""
    directory = get_env("DMLC_FLIGHT_DIR", None) or None
    if directory is None:
        return None
    flight_recorder.arm(directory)
    if install and get_env("DMLC_FLIGHT_HOOKS", 1):
        flight_recorder.install()
    return flight_recorder
