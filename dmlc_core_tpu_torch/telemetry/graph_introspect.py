"""Graph-capture introspection: capture watchdog + device-memory gauges.

Counterpart of ``dmlc_core_tpu/telemetry/xla_introspect.py``.  The JAX
serving engine compiles one executable per shape bucket ahead of time;
the port's captures one CUDA graph per bucket (on the CPU it prepares a
bucket with one dummy forward).  Either way the engine's performance
rests on the **no-recapture ladder**: every request shape is padded up
to a bucket whose graph already exists, so steady-state traffic never
captures.  That property is invisible until it breaks (a second engine
that captures lazily, a request too large for any bucket), and then p99
jumps by a capture with nothing in the metrics naming the culprit.

:class:`RetraceWatchdog` makes the property observable, under the JAX
watchdog's metric names, so that an SLO spec or a dashboard written for
the JAX server reads the port's unchanged: a capture is a "compile"
(``xla.compiles``, ``xla.compile.<bucket>``, ``xla.compile_seconds``),
a replay of a graph that was already there a hit (``xla.cache_hits``),
a capture for a bucket that was already steady a retrace alert
(``xla.retrace_alerts``, the latched gauge ``xla.retrace_alert``, a note
and a dump in the flight recorder), and a request too large for the
ladder a ladder miss (``xla.ladder_misses``, which latches the alert
too).  Bucket keys are the JAX engine's: ``r{rows}x{nnz}`` and
``ragged-r{rows}x{nnz}``.  :meth:`RetraceWatchdog.note_hit` runs on the
serving thread for every call: it adds to a counter whose handle it
keeps, builds nothing and makes no system call.

:func:`sample_memory` publishes the caching allocator's gauges, per
device, under the JAX names: ``xla.mem.<device>.bytes_in_use``
(``allocated_bytes.all.current``), ``.peak_bytes_in_use``
(``allocated_bytes.all.peak``), ``.bytes_limit`` (the device's total
memory, from ``torch.cuda.mem_get_info``), ``xla.live_buffers`` (the
allocator's active blocks) and ``xla.mem.sampled_ts``.  It reads only
devices whose allocator has reserved memory, and it is a no-op that
returns False until CUDA is initialised in the process: it is never the
call that initialises CUDA, and never creates a context on another
device.

The flight recorder is found through ``sys.modules`` by the port's name
(this module never imports it, and never reaches the JAX recorder).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, Optional

from ..utils.logging import log_warning
from ..utils.metrics import MetricsRegistry, metrics

__all__ = ["RetraceWatchdog", "watchdog", "sample_memory", "bucket_key"]


def _flight_mod():
    return sys.modules.get("dmlc_core_tpu_torch.telemetry.flight")


def bucket_key(rows: int, nnz: int, ragged: bool) -> str:
    """A bucket's watchdog key, as the JAX engine spells it."""
    return f"ragged-r{rows}x{nnz}" if ragged else f"r{rows}x{nnz}"


class RetraceWatchdog:
    """Capture/recapture accounting per shape bucket (see module doc)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self._reg = registry if registry is not None else metrics
        self._lock = threading.Lock()
        # bucket -> {"compiles": n, "wall_s": total, "steady": bool}
        self._buckets: Dict[str, Dict[str, Any]] = {}
        self._alerted = False
        self._hits_gen = -1
        self._m_hits = None

    def _bucket(self, key: str) -> Dict[str, Any]:
        b = self._buckets.get(key)
        if b is None:
            b = {"compiles": 0, "wall_s": 0.0, "steady": False}
            self._buckets[key] = b
        return b

    # -- feed points (the engine calls these) ----------------------------
    def note_compile(self, bucket: str, wall_s: float) -> bool:
        """A capture happened for ``bucket``; returns True when it was a
        recapture (a capture after the bucket went steady): the alert."""
        with self._lock:
            b = self._bucket(bucket)
            b["compiles"] += 1
            b["wall_s"] += wall_s
            retrace = b["steady"]
            if retrace:
                self._alerted = True
        self._reg.counter("xla.compiles").add(1)
        self._reg.counter(f"xla.compile.{bucket}").add(1)
        self._reg.histogram("xla.compile_seconds").observe(wall_s)
        if retrace:
            self._reg.counter("xla.retrace_alerts").add(1)
            self._reg.gauge("xla.retrace_alert").set(1)
            log_warning("retrace alert: bucket %s recaptured after steady "
                        "state (%.3fs) — requests fell off the no-recapture "
                        "ladder", bucket, wall_s)
            fl = _flight_mod()
            if fl is not None:
                fl.flight_recorder.note("retrace_alert", bucket=bucket,
                                        wall_s=wall_s)
                fl.dump_incident("retrace_alert", registry=self._reg,
                                 bucket=bucket, wall_s=wall_s)
        return retrace

    def note_hit(self, bucket: str) -> None:
        """A call replayed the bucket's graph (on the CPU: ran a prepared
        bucket).  The first hit proves the graph exists, so the bucket is
        steady even if warm-up was skipped."""
        if self._hits_gen != self._reg.generation:
            self._hits_gen = self._reg.generation
            self._m_hits = self._reg.counter("xla.cache_hits")
        self._m_hits.add(1)
        b = self._buckets.get(bucket)
        if b is None or not b["steady"]:
            with self._lock:
                self._bucket(bucket)["steady"] = True

    def note_ladder_miss(self, detail: str = "") -> None:
        """A request did not fit any bucket (``RequestTooLarge``)."""
        self._reg.counter("xla.ladder_misses").add(1)
        self._reg.gauge("xla.retrace_alert").set(1)
        with self._lock:
            self._alerted = True
        fl = _flight_mod()
        if fl is not None:
            fl.flight_recorder.note("ladder_miss", detail=detail)

    def mark_steady(self, bucket: Optional[str] = None) -> None:
        """Declare bucket(s) warmed: captures from here on are
        recaptures.  ``warmup_all`` calls this with no argument after the
        sweep."""
        with self._lock:
            if bucket is None:
                for b in self._buckets.values():
                    b["steady"] = True
            else:
                self._bucket(bucket)["steady"] = True

    def begin_warmup(self) -> None:
        """Open a declared capture window: a fresh engine (a second
        replica in-process) captures every bucket, and those captures are
        expected, not recaptures."""
        with self._lock:
            for b in self._buckets.values():
                b["steady"] = False

    # -- reading ---------------------------------------------------------
    @property
    def alerted(self) -> bool:
        with self._lock:
            return self._alerted

    def reset_alert(self) -> None:
        with self._lock:
            self._alerted = False
        self._reg.gauge("xla.retrace_alert").set(0)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"alerted": self._alerted,
                    "buckets": {k: dict(v)
                                for k, v in self._buckets.items()}}


#: process-global watchdog (the serving engine feeds it)
watchdog = RetraceWatchdog()

_mem_warned = False


def sample_memory(registry: Optional[MetricsRegistry] = None) -> bool:
    """Publish ``xla.live_buffers`` and per-device ``xla.mem.<id>.*``
    gauges from the caching allocator; returns False (and stays silent)
    while CUDA is not initialised in this process.  Safe to call on any
    cadence: it reads the allocator's counters, it does not walk the
    heap."""
    global _mem_warned
    reg = registry if registry is not None else metrics
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return False
    live = 0
    try:
        for dev in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(dev)
            if not stats.get("reserved_bytes.all.current"):
                continue           # no memory there: no context to read
            live += int(stats.get("active.all.current", 0))
            reg.gauge(f"xla.mem.{dev}.bytes_in_use").set(
                stats.get("allocated_bytes.all.current", 0))
            reg.gauge(f"xla.mem.{dev}.peak_bytes_in_use").set(
                stats.get("allocated_bytes.all.peak", 0))
            reg.gauge(f"xla.mem.{dev}.bytes_limit").set(
                torch.cuda.mem_get_info(dev)[1])
        reg.gauge("xla.live_buffers").set(live)
    except Exception as e:     # pragma: no cover - a CUDA runtime error
        if not _mem_warned:
            _mem_warned = True
            log_warning("device memory sampling unavailable: %s", e)
        return False
    reg.gauge("xla.mem.sampled_ts").set(time.time())
    return True
