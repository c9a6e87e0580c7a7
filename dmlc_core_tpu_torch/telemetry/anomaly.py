"""Streaming anomaly & straggler detection + declarative SLO rules.

Counterpart of ``dmlc_core_tpu/telemetry/anomaly.py``, copied so that
the port never imports the JAX package:

* :class:`StreamingStat` (EWMA mean and EWMA absolute deviation, robust
  z-scores) and :class:`StallDetector`, which flags a duration whose z
  clears ``DMLC_STALL_Z`` (default 8; <= 0 turns flagging off) after a
  warm-up, in the gauge ``anomaly.stall_z.<name>`` and the counter
  ``anomaly.stalls.<name>``.  The autotuner (:mod:`..pipeline.autotune`)
  freezes its search while any ``anomaly.stalls.*`` counter moves.

* :class:`StragglerBoard` — cross-RANK comparison over rank-tagged
  registry states: for every stage metric it derives each rank's
  *incremental* mean (delta total / delta count between pushes, so a
  late-onset straggler is not diluted by its healthy history), smooths
  it with an EWMA, and flags ranks whose smoothed time sits a robust
  z-score (``DMLC_STRAGGLER_Z``, floored at ``DMLC_STRAGGLER_REL_FLOOR``
  of the median) above the fleet median.

* :class:`SloMonitor` + the ``DMLC_SLO_SPEC`` grammar — declarative
  service-level objectives over any registry snapshot, mirroring the
  ``DMLC_FAULT_SPEC`` site grammar (same clause shape, same loud parse
  errors, same exact-no-op-when-unset contract)::

      spec  := rule (',' rule)*
      rule  := metric (':' key '=' value)*

      keys:
        max=V     breach when the observed field exceeds V
        min=V     breach when the observed field falls below V
                  (V takes ms/s duration suffixes: "50ms", "1.5s")
        field=F   snapshot field to test; defaults by metric type:
                  gauge/counter → value, histogram → p99,
                  throughput → windowed_rate, stage → mean_sec
        for=N     consecutive breached evaluations before firing
                  (default 1 — a single bad sample is a page)

  Example::

      DMLC_SLO_SPEC='serving.latency_s:field=p99:max=50ms,serving.batcher.queue_depth:max=192'

  A firing rule bumps ``slo.breaches`` and holds ``slo.active_breaches``
  at the number of currently-breached rules (the serving health
  degrades on it, and the autotuner freezes).  Clauses with ``budget=``
  are burn-rate rules over the metric history (:mod:`.slo`).

A stall or a breach is also noted in the flight recorder, and a breach
dumps an incident bundle, where a recorder is loaded (:mod:`.flight`):
the lookup is by the port's module name in ``sys.modules``, never the
JAX package's, as in :mod:`..utils.faults`.  Before that dump the
monitor runs the breach-scoped diagnosis (:func:`.diagnose.on_breach`),
so the bundle's ``diagnosis.json`` is the verdict on that breach.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import DMLCError, log_warning
from ..utils.metrics import MetricsRegistry, metrics
from ..utils.parameter import get_env

__all__ = [
    "StreamingStat", "StallDetector", "StragglerBoard",
    "SloRule", "SloSpecError", "SloMonitor", "parse_slo_spec",
    "maybe_monitor_from_env", "active_slo_spec",
]

SLO_ENV_VAR = "DMLC_SLO_SPEC"


def _flight_mod():
    """The port's flight recorder, if loaded — via sys.modules so this
    module never hard-imports it.  The name is the port's: a process that
    also loaded the JAX package must not dump through the JAX
    recorder."""
    return sys.modules.get("dmlc_core_tpu_torch.telemetry.flight")


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class StreamingStat:
    """EWMA mean + EWMA absolute-deviation scale, with robust z-scores.

    MAD-style: the deviation estimate tracks ``|x - mean|`` rather than
    squared error, so one huge outlier cannot inflate the scale enough
    to hide the next one.  ``1.4826`` converts a MAD to a Gaussian
    sigma-equivalent so thresholds read in familiar units.
    """

    __slots__ = ("alpha", "mean", "dev", "n")

    def __init__(self, alpha: float = 0.25) -> None:
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.dev = 0.0
        self.n = 0

    def zscore(self, x: float, rel_floor: float = 0.0) -> float:
        """Robust z of ``x`` against the CURRENT estimate (call before
        :meth:`update` so a sample is judged by its history, not itself).
        ``rel_floor`` sets a minimum scale as a fraction of the mean so
        tiny absolute jitter on a quiet stream can't produce huge z."""
        if self.mean is None or self.n < 1:
            return 0.0
        scale = max(1.4826 * self.dev, rel_floor * abs(self.mean), 1e-12)
        return (x - self.mean) / scale

    def update(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.mean is None:
            self.mean = x
            return
        self.dev += self.alpha * (abs(x - self.mean) - self.dev)
        self.mean += self.alpha * (x - self.mean)


class StallDetector:
    """Per-stage stall flagging from a stream of durations.

    ``observe(dur_s)`` is the whole API: compute the robust z against the
    stage's own history, update the estimate, and when the z clears the
    threshold after a warm-up count, flag it (gauge + counter + flight
    note).  ``DMLC_STALL_Z`` <= 0 disables flagging (observation still
    updates, so re-enabling doesn't start cold).
    """

    def __init__(self, name: str, z_threshold: Optional[float] = None,
                 min_samples: int = 16, alpha: float = 0.25,
                 rel_floor: float = 0.5) -> None:
        self.name = name
        if z_threshold is None:
            z_threshold = get_env("DMLC_STALL_Z", 8.0)
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self.rel_floor = float(rel_floor)
        self._stat = StreamingStat(alpha=alpha)
        self._lock = threading.Lock()
        self._m_gen = -1
        self._bind()

    def _bind(self) -> None:
        self._m_gen = metrics.generation
        self._m_z = metrics.gauge(f"anomaly.stall_z.{self.name}")
        self._m_stalls = metrics.counter(f"anomaly.stalls.{self.name}")

    def observe(self, dur_s: float) -> float:
        """Feed one duration; returns the z-score it was judged at."""
        with self._lock:
            z = self._stat.zscore(dur_s, rel_floor=self.rel_floor)
            self._stat.update(dur_s)
            n = self._stat.n
        if self._m_gen != metrics.generation:
            self._bind()
        self._m_z.set(z)
        if (self.z_threshold > 0 and n > self.min_samples
                and z > self.z_threshold):
            self._m_stalls.add(1)
            log_warning("anomaly: stage %r stalled (%.4fs, z=%.1f over "
                        "EWMA %.4fs)", self.name, dur_s, z,
                        self._stat.mean or 0.0)
            fl = _flight_mod()
            if fl is not None:
                fl.note("stage_stall", stage=self.name,
                        dur_s=float(dur_s), z=float(z))
        return z


class StragglerBoard:
    """Tracker-side cross-rank straggler detection over telemetry pushes.

    ``update(rank, state)`` ingests one rank-tagged registry state (the
    ``cmd=telemetry`` payload).  For each stage-type metric it computes
    the incremental mean since that rank's previous push and folds it
    into a per-(rank, stage) EWMA.  ``evaluate()`` compares ranks: for
    each stage reported by at least ``min_ranks`` ranks, a rank whose
    EWMA sits more than ``z_threshold`` robust z-scores above the fleet
    median (MAD across ranks, floored at ``rel_floor`` of the median) is
    a straggler suspect.
    """

    def __init__(self, z_threshold: Optional[float] = None,
                 min_ranks: int = 3, alpha: float = 0.4,
                 rel_floor: Optional[float] = None) -> None:
        if z_threshold is None:
            z_threshold = get_env("DMLC_STRAGGLER_Z", 4.0)
        if rel_floor is None:
            rel_floor = get_env("DMLC_STRAGGLER_REL_FLOOR", 0.1)
        self.z_threshold = float(z_threshold)
        self.min_ranks = int(min_ranks)
        self.rel_floor = float(rel_floor)
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        # rank → stage → EWMA of incremental mean seconds
        self._ewma: Dict[str, Dict[str, StreamingStat]] = {}
        # rank → stage → (count, total_sec) at the previous push
        self._prev: Dict[str, Dict[str, Tuple[int, float]]] = {}

    def update(self, rank: Any, state: Dict[str, Dict[str, Any]]) -> None:
        rank = str(rank)
        with self._lock:
            prev = self._prev.setdefault(rank, {})
            ewma = self._ewma.setdefault(rank, {})
            for name, s in (state or {}).items():
                if not isinstance(s, dict) or s.get("type") != "stage":
                    continue
                count = int(s.get("count", 0))
                total = float(s.get("total_sec", 0.0))
                pc, pt = prev.get(name, (0, 0.0))
                if count < pc:          # rank restarted: counters reset
                    pc, pt = 0, 0.0
                prev[name] = (count, total)
                if count <= pc:
                    continue            # no new work since the last push
                inc_mean = (total - pt) / (count - pc)
                ewma.setdefault(name, StreamingStat(self._alpha)) \
                    .update(inc_mean)

    def evaluate(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """``{stage: {rank: {"mean_s", "z", "straggler"}}}`` for every
        stage with at least ``min_ranks`` reporting ranks."""
        with self._lock:
            by_stage: Dict[str, Dict[str, float]] = {}
            for rank, stages in self._ewma.items():
                for stage, stat in stages.items():
                    if stat.mean is not None:
                        by_stage.setdefault(stage, {})[rank] = stat.mean
        out: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for stage, per_rank in by_stage.items():
            if len(per_rank) < self.min_ranks:
                continue
            means = list(per_rank.values())
            med = _median(means)
            mad = _median([abs(m - med) for m in means])
            scale = max(1.4826 * mad, self.rel_floor * abs(med), 1e-12)
            out[stage] = {
                rank: {"mean_s": m, "z": (m - med) / scale,
                       "straggler": (m - med) / scale > self.z_threshold}
                for rank, m in per_rank.items()}
        return out

    def suspects(self) -> List[str]:
        """Ranks flagged on at least one stage, sorted."""
        flagged = {rank
                   for per_rank in self.evaluate().values()
                   for rank, d in per_rank.items() if d["straggler"]}
        return sorted(flagged, key=str)

    def snapshot(self) -> Dict[str, Any]:
        """JSON body of the tracker's ``/stragglers`` endpoint."""
        stages = self.evaluate()
        return {
            "z_threshold": self.z_threshold,
            "min_ranks": self.min_ranks,
            "stages": stages,
            "stragglers": sorted(
                {r for pr in stages.values()
                 for r, d in pr.items() if d["straggler"]}, key=str),
        }

    def series(self) -> List[Tuple[Optional[Dict[str, str]],
                                   Dict[str, Dict[str, Any]]]]:
        """Per-rank gauge rows for the tracker ``/metrics`` page:
        ``straggler_z`` (worst stage z) and ``straggler_suspect`` (0/1)
        labeled ``rank="N"``."""
        worst: Dict[str, float] = {}
        flagged: Dict[str, bool] = {}
        for per_rank in self.evaluate().values():
            for rank, d in per_rank.items():
                worst[rank] = max(worst.get(rank, float("-inf")), d["z"])
                flagged[rank] = flagged.get(rank, False) or d["straggler"]
        rows: List[Tuple[Optional[Dict[str, str]],
                         Dict[str, Dict[str, Any]]]] = []
        for rank in sorted(worst, key=str):
            rows.append(({"rank": rank}, {
                "straggler_z": {"type": "gauge", "value": worst[rank]},
                "straggler_suspect": {"type": "gauge",
                                      "value": 1 if flagged[rank] else 0},
            }))
        return rows


# ---------------------------------------------------------------------------
# SLO rules
# ---------------------------------------------------------------------------

class SloSpecError(DMLCError):
    """Malformed ``DMLC_SLO_SPEC`` — raised at parse time, loudly: a
    deployment with a typo'd SLO must not silently watch nothing."""


#: default snapshot field tested per metric type
_DEFAULT_FIELD = {"gauge": "value", "counter": "value", "histogram": "p99",
                  "throughput": "windowed_rate", "stage": "mean_sec"}


def _parse_value(text: str) -> float:
    t = text.strip().lower()
    try:
        if t.endswith("ms"):
            return float(t[:-2]) / 1e3
        if t.endswith("s") and not t[:-1].endswith("m"):
            return float(t[:-1])
        return float(t)
    except ValueError:
        raise SloSpecError(f"bad value {text!r}") from None


class SloRule:
    """One compiled rule: ``metric[.field]`` compared against a bound."""

    __slots__ = ("metric", "field", "max_v", "min_v", "for_count", "_hits")

    def __init__(self, metric: str, field: Optional[str], max_v: Optional[float],
                 min_v: Optional[float], for_count: int) -> None:
        self.metric = metric
        self.field = field          # None = resolve from the metric type
        self.max_v = max_v
        self.min_v = min_v
        self.for_count = max(1, int(for_count))
        self._hits = 0              # consecutive breached evaluations

    @property
    def name(self) -> str:
        parts = [self.metric]
        if self.field:
            parts.append(f"field={self.field}")
        if self.max_v is not None:
            parts.append(f"max={self.max_v:g}")
        if self.min_v is not None:
            parts.append(f"min={self.min_v:g}")
        return ":".join(parts)

    def check(self, snapshot: Dict[str, Dict[str, Any]]
              ) -> Optional[Dict[str, Any]]:
        """Evaluate against one snapshot; a firing breach (consecutive
        count reached) returns its description dict, else None.  A metric
        absent from the snapshot is not a breach — the workload that
        would populate it simply hasn't run."""
        snap = snapshot.get(self.metric)
        if not isinstance(snap, dict):
            self._hits = 0
            return None
        field = self.field or _DEFAULT_FIELD.get(snap.get("type"), "value")
        v = snap.get(field)
        if not isinstance(v, (int, float)):
            self._hits = 0
            return None
        breached = ((self.max_v is not None and v > self.max_v)
                    or (self.min_v is not None and v < self.min_v))
        if not breached:
            self._hits = 0
            return None
        self._hits += 1
        if self._hits < self.for_count:
            return None
        return {"rule": self.name, "metric": self.metric, "field": field,
                "value": float(v), "max": self.max_v, "min": self.min_v,
                "consecutive": self._hits}


def parse_slo_spec(spec: str) -> List[SloRule]:
    """Compile a ``DMLC_SLO_SPEC`` string (grammar in the module doc)."""
    rules: List[SloRule] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        metric = parts[0].strip()
        if not metric:
            raise SloSpecError(f"clause {clause!r} has no metric name")
        kv: Dict[str, str] = {}
        for p in parts[1:]:
            if "=" not in p:
                raise SloSpecError(f"bad key=value {p!r} in {clause!r}")
            k, v = p.split("=", 1)
            kv[k.strip()] = v.strip()
        unknown = set(kv) - {"max", "min", "field", "for"}
        if unknown:
            raise SloSpecError(
                f"unknown keys {sorted(unknown)} in clause {clause!r}")
        if "max" not in kv and "min" not in kv:
            raise SloSpecError(f"clause {clause!r} has neither max nor min")
        try:
            rules.append(SloRule(
                metric,
                field=kv.get("field"),
                max_v=_parse_value(kv["max"]) if "max" in kv else None,
                min_v=_parse_value(kv["min"]) if "min" in kv else None,
                for_count=int(kv.get("for", 1))))
        except ValueError as e:
            raise SloSpecError(f"bad value in clause {clause!r}: {e}") \
                from None
    if not rules:
        raise SloSpecError(f"empty SLO spec {spec!r}")
    return rules


#: the spec the most recently constructed monitor runs (incident metadata)
_active_spec: Optional[str] = None


def active_slo_spec() -> Optional[str]:
    return _active_spec


class SloMonitor:
    """Periodic SLO evaluation over a registry.

    One daemon thread snapshots the registry every ``interval_s``
    (``DMLC_SLO_INTERVAL``), checks every rule, and on a firing breach:
    bumps ``slo.breaches``, holds ``slo.active_breaches`` at the live
    breach count (the serving health property degrades on > 0), logs,
    and triggers a flight-recorder dump naming the rule.  Each tick also
    feeds the flight recorder's metric-snapshot ring, so an incident
    bundle carries the before/after delta.
    """

    def __init__(self, rules: List[SloRule],
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: Optional[float] = None,
                 spec: Optional[str] = None,
                 on_breach: Optional[Callable[[Dict[str, Any]], None]]
                 = None) -> None:
        global _active_spec
        self.rules = list(rules)
        self.registry = registry if registry is not None else metrics
        if interval_s is None:
            interval_s = get_env("DMLC_SLO_INTERVAL", 5.0)
        self.interval_s = float(interval_s)
        self.spec = spec
        self.on_breach = on_breach
        self.breaches: List[Dict[str, Any]] = []   # most recent firing set
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _active_spec = spec

    def evaluate_once(self) -> List[Dict[str, Any]]:
        """One evaluation pass (what the thread runs; tests call it
        directly for determinism).  Returns the breaches that FIRED."""
        snapshot = self.registry.snapshot()
        fl = _flight_mod()
        if fl is not None:
            fl.flight_recorder.note_snapshot(registry=self.registry)
        fired = [b for b in (rule.check(snapshot) for rule in self.rules)
                 if b is not None]
        fired.extend(self._extra_checks(snapshot))
        self.registry.gauge("slo.active_breaches").set(len(fired))
        if fired:
            self.breaches = fired
            self.registry.counter("slo.breaches").add(len(fired))
            for b in fired:
                log_warning("SLO breach: %s observed %.6g", b["rule"],
                            b["value"])
                if self.on_breach is not None:
                    self.on_breach(b)
                if fl is not None:
                    fl.flight_recorder.note("slo_breach", **{
                        k: v for k, v in b.items() if v is not None})
            # auto-diagnosis BEFORE the dump, so the bundle's
            # diagnosis.json is the breach-scoped verdict, not a generic
            # window (lazy import: diagnose imports this module's
            # StreamingStat; the edge must stay one-way at import time)
            try:
                from . import diagnose as _diagnose
                _diagnose.on_breach(fired[0])
            except Exception as e:  # noqa: BLE001 — diagnosis must
                # never block the incident dump it decorates
                log_warning("breach diagnosis failed: %s", e)
            if fl is not None:
                fl.dump_incident("slo_breach", registry=self.registry,
                                 breaches=fired)
        return fired

    def _extra_checks(self, snapshot: Dict[str, Any]
                      ) -> List[Dict[str, Any]]:
        """Hook for subclasses adding non-snapshot checks (the burn-rate
        monitor in :mod:`~dmlc_core_tpu_torch.telemetry.slo` evaluates its
        rules against the history store here)."""
        return []

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:  # noqa: BLE001 — the watchdog must
                # outlive any single bad evaluation
                log_warning("SLO monitor evaluation failed: %s", e)

    def start(self) -> "SloMonitor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="dmlc-slo", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


#: the monitor maybe_monitor_from_env started, so repeated env
#: activations (server + exporter both calling it) reuse one thread
_env_monitor: Optional[SloMonitor] = None


def maybe_monitor_from_env(registry: Optional[MetricsRegistry] = None,
                           autostart: bool = True) -> Optional[SloMonitor]:
    """Build (and by default start) an :class:`SloMonitor` when
    ``DMLC_SLO_SPEC`` is set.  Unset → None, exact no-op — matching the
    ``DMLC_FAULT_SPEC`` convention.  Malformed specs raise loudly.
    Idempotent per spec value: a second call while the same spec's
    monitor is live returns it instead of stacking threads."""
    global _env_monitor
    spec = get_env(SLO_ENV_VAR, None) or None
    if not spec:
        return None
    if (_env_monitor is not None and _env_monitor.spec == spec
            and _env_monitor._thread is not None):
        return _env_monitor
    # route through the superset grammar: clauses with budget= become
    # burn-rate rules over the history store (telemetry.slo), plain
    # clauses behave exactly as before
    from . import slo as _slo
    plain, burn = _slo.parse_slo_spec(spec)
    if burn:
        mon: SloMonitor = _slo.BurnRateMonitor(plain, burn,
                                               registry=registry, spec=spec)
    else:
        mon = SloMonitor(plain, registry=registry, spec=spec)
    _env_monitor = mon
    return mon.start() if autostart else mon
