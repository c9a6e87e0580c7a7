"""Telemetry time machine: bounded tiered history of any registry.

Counterpart of ``dmlc_core_tpu/telemetry/timeseries.py``, copied so
that the port never imports the JAX package.  Importing it makes the
process-global :data:`history` but starts no thread: the sampler
starts with the first exporter (or burn-rate monitor) and runs until
:meth:`HistoryStore.stop`; stopping an exporter does not stop it.

Every other telemetry surface is point-in-time: ``/metrics`` is *now*,
``/fleet`` is the latest heartbeat, a flight bundle freezes the moment
of the trigger.  The ROADMAP's next moves (backlog-trend autoscaling,
a denoised autotuner objective, burn-rate SLOs) all need *history* —
this module is that substrate, all stdlib, bounded by construction.

:class:`HistoryStore` samples any snapshot source (a
``MetricsRegistry``, or the tracker/dispatcher's merged fleet view) on
a fixed cadence into per-series rings with **tiered downsampling**:
tier 0 keeps every sample (default 1 s × 5 min), higher tiers keep
bucket means (default 10 s × 1 h), so the memory bound is
``series × Σ tier capacities`` regardless of uptime.  Snapshot fields
are flattened into scalar series per metric type:

* counter      → ``<name>.rate``  (delta/interval; restarts re-baseline
  instead of emitting a huge negative spike, counted in
  ``telemetry.counter_resets``)
* gauge        → ``<name>``
* histogram    → ``<name>.p50`` / ``<name>.p95`` / ``<name>.p99`` /
  ``<name>.rate``
* throughput   → ``<name>.rate`` (the meter's windowed rate)
* stage        → ``<name>.mean_s`` (incremental: Δtotal/Δcount, so a
  late regression is not diluted by healthy history) + ``<name>.rate``

Every :class:`~.exposition.TelemetryServer` serves the store at
``/timeline?metric=&since=&format=json|text``; the process-global
:data:`history` (over the global registry) starts lazily with the
first exporter unless ``DMLC_TIMELINE=0``.  The tracker and the
data-service dispatcher run a second store over their *merged* fleet
state, so one query answers "what did fleet ingest MB/s do over the
last hour".

Knobs: ``DMLC_TIMELINE`` (default 1), ``DMLC_TIMELINE_INTERVAL``
(sample cadence seconds, default 1.0), ``DMLC_TIMELINE_TIERS``
(``step_sxcount`` list, default ``1x300,10x360``),
``DMLC_TIMELINE_MAX_SERIES`` (default 512 — overflow series are
dropped and counted in ``telemetry.timeline.dropped_series``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import DMLCError, log_warning
from ..utils.metrics import metrics
from ..utils.parameter import get_env

__all__ = ["HistoryStore", "parse_tiers", "render_timeline_text",
           "history", "maybe_start_sampler", "TIMELINE_SCHEMA"]

TIMELINE_SCHEMA = "dmlc.telemetry.timeline/1"

#: (step_seconds, capacity) — tier 0 must be the finest
_DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = ((1.0, 300), (10.0, 360))


class TierSpecError(DMLCError):
    """Malformed ``DMLC_TIMELINE_TIERS`` — raised loudly at parse time."""


def parse_tiers(spec: str) -> List[Tuple[float, int]]:
    """``"1x300,10x360"`` → ``[(1.0, 300), (10.0, 360)]`` (step seconds
    × ring capacity per tier, finest first)."""
    tiers: List[Tuple[float, int]] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        step, sep, count = clause.partition("x")
        if not sep:
            raise TierSpecError(f"tier {clause!r} is not STEPxCOUNT")
        try:
            tiers.append((float(step), int(count)))
        except ValueError:
            raise TierSpecError(f"bad tier {clause!r}") from None
    if not tiers:
        raise TierSpecError(f"empty tier spec {spec!r}")
    if any(s <= 0 or c <= 0 for s, c in tiers):
        raise TierSpecError(f"tiers must be positive: {spec!r}")
    if sorted(tiers) != tiers:
        raise TierSpecError(f"tiers must be finest-first: {spec!r}")
    return tiers


class _Series:
    """One scalar series: a ring per tier + the open downsample buckets."""

    __slots__ = ("rings", "buckets")

    def __init__(self, tiers: List[Tuple[float, int]]) -> None:
        self.rings: List[deque] = [deque(maxlen=cap) for _, cap in tiers]
        # per tier > 0: [bucket_id, sum, count] of the open bucket
        self.buckets: List[List[float]] = [[-1, 0.0, 0.0]
                                           for _ in tiers[1:]]

    def append(self, ts: float, value: float,
               tiers: List[Tuple[float, int]]) -> None:
        self.rings[0].append((ts, value))
        for i, (step, _cap) in enumerate(tiers[1:]):
            b = self.buckets[i]
            bucket = int(ts // step)
            if bucket != b[0]:
                if b[2] > 0:   # close the previous bucket as its mean
                    self.rings[i + 1].append((b[0] * step, b[1] / b[2]))
                b[0], b[1], b[2] = bucket, 0.0, 0.0
            b[1] += value
            b[2] += 1


class HistoryStore:
    """Bounded tiered time-series store over a snapshot source.

    ``snapshot_fn`` returns a snapshot-form dict (``{name: {"type": ...,
    ...}}``) — the global registry's :meth:`snapshot` by default, or the
    tracker/dispatcher's merged fleet view.  :meth:`sample_once` is the
    whole write path (the daemon thread just calls it on a cadence), so
    tests drive the store deterministically with an injected ``now``.
    """

    def __init__(self,
                 snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 tiers: Optional[List[Tuple[float, int]]] = None,
                 max_series: Optional[int] = None) -> None:
        if snapshot_fn is None:
            snapshot_fn = metrics.snapshot
        if tiers is None:
            tiers = parse_tiers(str(get_env("DMLC_TIMELINE_TIERS",
                                            "1x300,10x360")))
        if max_series is None:
            max_series = int(get_env("DMLC_TIMELINE_MAX_SERIES", 512))
        self.snapshot_fn = snapshot_fn
        self.tiers = list(tiers)
        self.max_series = int(max_series)
        self._series: Dict[str, _Series] = {}
        self._lock = threading.Lock()
        # counter/stage baselines for rate conversion (previous sample)
        self._prev: Dict[str, Tuple[float, float]] = {}   # name → (ts, val)
        self._prev_stage: Dict[str, Tuple[float, float]] = {}
        self._dropped: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- write path ------------------------------------------------------
    def _rate(self, key: str, now: float, value: float) -> Optional[float]:
        """Counter → per-second rate against the previous sample; a
        counter that went BACKWARDS (process restart behind a merged
        view) re-baselines at the new value instead of emitting a huge
        negative spike."""
        prev = self._prev.get(key)
        self._prev[key] = (now, value)
        if prev is None:
            return None
        pts, pval = prev
        dt = now - pts
        if dt <= 0:
            return None
        if value < pval:
            metrics.counter("telemetry.counter_resets").add(1)
            pval = 0.0
        return (value - pval) / dt

    def _stage_mean(self, name: str, count: float, total: float
                    ) -> Optional[float]:
        prev = self._prev_stage.get(name)
        self._prev_stage[name] = (count, total)
        if prev is None:
            return None
        pc, pt = prev
        if count < pc:          # restarted worker: incremental from zero
            pc, pt = 0.0, 0.0
        if count <= pc:
            return None         # no new calls this interval — no point
        return (total - pt) / (count - pc)

    def _extract(self, now: float, snapshot: Dict[str, Any]
                 ) -> Dict[str, float]:
        points: Dict[str, float] = {}
        for name, snap in snapshot.items():
            if not isinstance(snap, dict):
                continue
            t = snap.get("type")
            if t == "counter":
                r = self._rate(name, now, float(snap.get("value", 0)))
                if r is not None:
                    points[f"{name}.rate"] = r
            elif t == "gauge":
                v = snap.get("value")
                if isinstance(v, (int, float)):
                    points[name] = float(v)
            elif t == "histogram":
                # p95 joined p50/p99 for the tail sampler's adaptive
                # keep-slow threshold (live p95 of the root span name)
                for f in ("p50", "p95", "p99"):
                    v = snap.get(f)
                    if isinstance(v, (int, float)):
                        points[f"{name}.{f}"] = float(v)
                r = self._rate(f"{name}.count", now,
                               float(snap.get("count", 0)))
                if r is not None:
                    points[f"{name}.rate"] = r
            elif t == "throughput":
                v = snap.get("windowed_rate")
                if isinstance(v, (int, float)):
                    points[f"{name}.rate"] = float(v)
            elif t == "stage":
                m = self._stage_mean(name, float(snap.get("count", 0)),
                                     float(snap.get("total_sec", 0.0)))
                if m is not None:
                    points[f"{name}.mean_s"] = m
                r = self._rate(f"{name}.calls", now,
                               float(snap.get("count", 0)))
                if r is not None:
                    points[f"{name}.rate"] = r
        return points

    def sample_once(self, now: Optional[float] = None) -> int:
        """One sampling pass; returns the number of points recorded.
        The thread calls this on the cadence; tests call it directly
        with a synthetic clock."""
        if now is None:
            now = time.time()
        try:
            snapshot = self.snapshot_fn()
        except Exception as e:   # sampling must never kill the process
            log_warning("timeline sampler: snapshot failed: %s", e)
            return 0
        points = self._extract(now, snapshot)
        metrics.counter("telemetry.timeline.samples").add(1)
        with self._lock:
            for name, value in points.items():
                series = self._series.get(name)
                if series is None:
                    if len(self._series) >= self.max_series:
                        if name not in self._dropped:
                            self._dropped.add(name)
                            metrics.counter(
                                "telemetry.timeline.dropped_series").add(1)
                        continue
                    series = self._series[name] = _Series(self.tiers)
                series.append(now, value, self.tiers)
        return len(points)

    # -- read path -------------------------------------------------------
    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, since: Optional[float] = None,
              now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points of one series covering the last ``since`` seconds, from
        the finest tier whose span covers the window (burn-rate rules
        read through this, so an hour-long window transparently lands on
        the downsampled tier)."""
        if now is None:
            now = time.time()
        cutoff = None if since is None else now - float(since)
        with self._lock:
            series = self._series.get(name)
            if series is None:
                return []
            tier = len(self.tiers) - 1
            if since is not None:
                for i, (step, cap) in enumerate(self.tiers):
                    if step * cap >= float(since):
                        tier = i
                        break
            pts = list(series.rings[tier])
        if cutoff is None:
            return pts
        return [(ts, v) for ts, v in pts if ts >= cutoff]

    def timeline(self, metric: Optional[str] = None,
                 since: Optional[float] = None) -> Dict[str, Any]:
        """The ``/timeline`` document.  Without ``metric``: the index
        (series names + tier config).  With ``metric``: every series of
        that metric (exact name or ``metric.<field>``), all tiers,
        filtered to the last ``since`` seconds."""
        now = time.time()
        doc: Dict[str, Any] = {
            "schema": TIMELINE_SCHEMA, "now": now,
            "tiers": [{"step_s": s, "capacity": c} for s, c in self.tiers],
        }
        with self._lock:
            names = sorted(self._series)
            if metric is None:
                doc["series"] = names
                doc["series_count"] = len(names)
                return doc
            matched = [n for n in names
                       if n == metric or n.startswith(metric + ".")]
            cutoff = None if since is None else now - float(since)
            out: Dict[str, Any] = {}
            for n in matched:
                tiers_out = []
                for i, (step, _cap) in enumerate(self.tiers):
                    pts = list(self._series[n].rings[i])
                    if cutoff is not None:
                        pts = [p for p in pts if p[0] >= cutoff]
                    tiers_out.append({"step_s": step,
                                      "points": [[ts, v] for ts, v in pts]})
                out[n] = {"tiers": tiers_out}
        doc["metric"] = metric
        doc["series"] = out
        return doc

    def snapshot_doc(self, since: Optional[float] = None) -> Dict[str, Any]:
        """Every series, every tier — what a flight bundle attaches as
        ``timeline.json`` (bounded by the ring capacities, so the slice
        is the whole store)."""
        now = time.time()
        cutoff = None if since is None else now - float(since)
        with self._lock:
            series: Dict[str, Any] = {}
            for n in sorted(self._series):
                tiers_out = []
                for i, (step, _cap) in enumerate(self.tiers):
                    pts = list(self._series[n].rings[i])
                    if cutoff is not None:
                        pts = [p for p in pts if p[0] >= cutoff]
                    tiers_out.append({"step_s": step,
                                      "points": [[ts, v] for ts, v in pts]})
                series[n] = {"tiers": tiers_out}
        return {"schema": TIMELINE_SCHEMA, "now": now,
                "tiers": [{"step_s": s, "capacity": c}
                          for s, c in self.tiers],
                "series": series}

    # -- lifecycle -------------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> "HistoryStore":
        """Start the daemon sampler (idempotent)."""
        if self._thread is not None:
            return self
        if interval_s is None:
            interval_s = float(get_env("DMLC_TIMELINE_INTERVAL", 1.0))
        interval_s = max(0.01, float(interval_s))

        def _run() -> None:
            while not self._stop.wait(interval_s):
                self.sample_once()

        self._stop.clear()
        self._thread = threading.Thread(target=_run, name="dmlc-timeline",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    @property
    def running(self) -> bool:
        return self._thread is not None


_SPARK = " .:-=+*#%@"


def _sparkline(values: List[float]) -> str:
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK[1] * len(values)
    return "".join(_SPARK[1 + int((v - lo) / span * (len(_SPARK) - 2))]
                   for v in values)


def render_timeline_text(doc: Dict[str, Any]) -> str:
    """``/timeline?format=text``: one line per series — last value,
    min/max over the window, and an ASCII sparkline of the finest tier
    (legible through ``curl``, no tooling required)."""
    series = doc.get("series")
    if isinstance(series, list):         # index document
        lines = ["timeline series:"]
        lines.extend(f"  {n}" for n in series)
        return "\n".join(lines) + "\n"
    lines = []
    for name in sorted(series or {}):
        tiers = (series[name] or {}).get("tiers", [])
        pts = tiers[0].get("points", []) if tiers else []
        vals = [v for _ts, v in pts]
        if not vals:
            lines.append(f"{name}: (no samples in window)")
            continue
        lines.append(f"{name}: last={vals[-1]:g} min={min(vals):g} "
                     f"max={max(vals):g} n={len(vals)} "
                     f"[{_sparkline(vals[-60:])}]")
        for t in tiers[1:]:
            tv = [v for _ts, v in t.get("points", [])]
            if tv:
                lines.append(f"  @{t.get('step_s', 0):g}s: n={len(tv)} "
                             f"[{_sparkline(tv[-60:])}]")
    if not lines:
        lines = ["timeline: no matching series"]
    return "\n".join(lines) + "\n"


#: process-global store over the global registry — what every default
#: ``TelemetryServer`` serves at ``/timeline`` and what flight bundles
#: attach as ``timeline.json``
history = HistoryStore()


def maybe_start_sampler() -> Optional[HistoryStore]:
    """Start the global sampler unless ``DMLC_TIMELINE=0``.  Idempotent —
    every exporter start funnels through here, matching the
    ``maybe_*_from_env`` convention of flight/anomaly."""
    if not get_env("DMLC_TIMELINE", True):
        return None
    return history.start()
