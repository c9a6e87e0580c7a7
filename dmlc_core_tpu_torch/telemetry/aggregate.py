"""Tracker-side merging of rank-tagged registry states.

Counterpart of ``dmlc_core_tpu/telemetry/aggregate.py``, copied so that
the port never imports the JAX package; the merges themselves are the
port's ``utils.metrics`` types' ``merge``.

Workers push ``MetricsRegistry.state()`` dicts (histograms carry their
reservoir samples) to the tracker over the tracker protocol; this module
folds a ``{rank: state}`` map into one fleet snapshot and renders the
combined ``/metrics`` page: merged series first (unlabeled — the scrape
target for dashboards), then every contributing rank re-rendered with a
``rank="N"`` label for drill-down.

Merge semantics live with the metric classes (``Counter.merge``,
``Histogram.merge`` over serialized reservoirs, ...); this module only
groups by name/type and skips conflicting types rather than guessing.

A restarted worker re-registers from zero, so its next push carries
counters BELOW what the fleet already banked — naive merging would drive
merged totals backwards and turn every rate derived from them negative.
:class:`ResetGuard` sits at the ingestion point (tracker telemetry
handler, dispatcher heartbeat): it keeps a per-``(rank, metric)``
baseline, detects any monotonic field going backwards, re-baselines so
the merged view stays monotonic, and counts each event in
``telemetry.counter_resets``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils.metrics import (Counter, Gauge, Histogram, StageTimer,
                             ThroughputMeter, metrics)
from .exposition import render_series

__all__ = ["merge_states", "state_to_snapshot", "render_fleet",
           "ResetGuard"]

_MERGERS = {
    "counter": Counter.merge,
    "gauge": Gauge.merge,
    "histogram": Histogram.merge,
    "throughput": ThroughputMeter.merge,
    "stage": StageTimer.merge,
}


def merge_states(per_rank: Dict[str, Dict[str, Dict[str, Any]]]
                 ) -> Dict[str, Dict[str, Any]]:
    """``{rank: {metric_name: state}}`` → merged snapshot-form dict.

    A metric name reported with different types by different ranks (a
    version skew symptom) is dropped from the merged view — the per-rank
    sections still show both sides of the skew.
    """
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for state in per_rank.values():
        for name, s in (state or {}).items():
            if isinstance(s, dict):
                by_name.setdefault(name, []).append(s)
    merged: Dict[str, Dict[str, Any]] = {}
    for name, states in sorted(by_name.items()):
        types = {s.get("type") for s in states}
        if len(types) != 1:
            continue
        merger = _MERGERS.get(next(iter(types)))
        if merger is not None:
            merged[name] = merger(states)
    return merged


#: per-type fields that must never go backwards for one live process
_MONOTONIC = {
    "counter": ("value",),
    "throughput": ("total",),
    "stage": ("count", "total_sec"),
    "histogram": ("count",),
}


class ResetGuard:
    """Counter-reset detection at the fleet ingestion point.

    ``fold(rank, state)`` returns an adjusted copy of one rank's pushed
    state: every monotonic field is re-based so that a restart (the
    field goes BACKWARDS) banks the pre-reset value into the baseline
    instead of subtracting it from the fleet.  Each reset event bumps
    ``telemetry.counter_resets`` once per metric, on the host registry.
    """

    def __init__(self, registry: Optional[Any] = None) -> None:
        self._registry = registry if registry is not None else metrics
        self._lock = threading.Lock()
        # (rank, metric) -> {field: (banked_base, last_raw)}
        self._bases: Dict[Tuple[str, str],
                          Dict[str, Tuple[float, float]]] = {}

    def fold(self, rank: Any, state: Dict[str, Dict[str, Any]]
             ) -> Dict[str, Dict[str, Any]]:
        resets = 0
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, s in (state or {}).items():
                if not isinstance(s, dict):
                    continue
                fields = _MONOTONIC.get(s.get("type"))
                if not fields:
                    out[name] = s
                    continue
                bases = self._bases.setdefault((str(rank), name), {})
                adj = dict(s)
                was_reset = False
                for f in fields:
                    try:
                        raw = float(s.get(f, 0.0))
                    except (TypeError, ValueError):
                        continue
                    base, last = bases.get(f, (0.0, None))
                    if last is not None and raw < last:
                        # restart: bank what the old process reached, so
                        # base + raw keeps climbing from where it left off
                        base += last
                        was_reset = True
                    bases[f] = (base, raw)
                    if base:
                        adj[f] = base + raw
                out[name] = adj
                if was_reset:
                    resets += 1
        if resets:
            self._registry.counter("telemetry.counter_resets").add(resets)
        return out

    def forget(self, rank: Any) -> None:
        """Drop a rank's baselines (the tracker calls this when a rank
        is admitted fresh under a recycled id, where "lower than before"
        is a new worker, not a restart to re-base)."""
        rk = str(rank)
        with self._lock:
            for key in [k for k in self._bases if k[0] == rk]:
                del self._bases[key]


def state_to_snapshot(state: Dict[str, Dict[str, Any]]
                      ) -> Dict[str, Dict[str, Any]]:
    """Make one rank's serialized state renderable: histogram reservoir
    states become quantile snapshots (a merge of one); everything else is
    already in snapshot form."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, s in (state or {}).items():
        if isinstance(s, dict) and s.get("type") == "histogram" \
                and "samples" in s:
            out[name] = Histogram.merge([s])
        elif isinstance(s, dict):
            out[name] = s
    return out


def render_fleet(per_rank: Dict[str, Dict[str, Dict[str, Any]]],
                 own_snapshot: Optional[Dict[str, Dict[str, Any]]] = None,
                 prefix: str = "dmlc") -> str:
    """The tracker's ``/metrics`` page: merged fleet series, then
    per-rank ``rank="N"`` drill-down series, then (optionally) the
    tracker's own registry labeled ``rank="tracker"``."""
    series: List[Tuple[Optional[Dict[str, str]],
                       Dict[str, Dict[str, Any]]]] = []
    series.append((None, merge_states(per_rank)))
    for rank in sorted(per_rank, key=str):
        series.append(({"rank": str(rank)},
                       state_to_snapshot(per_rank[rank])))
    if own_snapshot:
        series.append(({"rank": "tracker"}, own_snapshot))
    return render_series(series, prefix=prefix)
