"""Error budgets + multi-window burn-rate SLO rules over the store.

Counterpart of ``dmlc_core_tpu/telemetry/slo.py``, copied so that the
port never imports the JAX package.

The plain ``DMLC_SLO_SPEC`` rule judges one snapshot at a time: ``for=N`` is a
consecutive-sample debounce, not an objective.  This module upgrades
the same grammar to Google-SRE-style **error budgets**: a clause that
carries ``budget=`` becomes a burn-rate rule evaluated against the
:mod:`~dmlc_core_tpu_torch.telemetry.timeseries` history instead of the
instantaneous snapshot::

    rule  := metric (':' key '=' value)*

    keys (superset of the plain grammar — plain specs parse unchanged):
      max=V / min=V   the per-sample objective ("a good sample keeps
                      p99 under 50ms"); ms/s suffixes as before
      field=F         snapshot field (defaults by type, as before)
      for=N           plain-rule debounce (burn rules ignore it)
      budget=F        error budget as a fraction of samples allowed to
                      violate the objective (e.g. 0.01); presence makes
                      the clause a burn-rate rule
      fast=W/R        fast-burn window and rate: fire at severity
                      "fast" when the bad-sample fraction over the last
                      W (ms/s/m/h suffixes) reaches R × budget AND the
                      latest sample is still bad (the still-burning
                      check standing in for the companion short window
                      at our second-scale horizons).  Default 60s/14.
      slow=W/R        slow-burn window and rate (no still-burning
                      requirement — a sustained simmer should page even
                      between flare-ups).  Default 10m/6.

Example::

    DMLC_SLO_SPEC='serving.latency_s:field=p99:max=50ms:budget=0.02:fast=30s/14:slow=5m/6'

A firing burn rule feeds the same machinery as a plain breach — bumps
``slo.breaches``, holds ``slo.active_breaches`` (``/healthz`` degrades
on > 0), notes + dumps to the flight recorder where one is loaded
(:mod:`.flight`) — and the bundle carries
the surrounding timeline slice (``timeline.json``) so the breach
window rides with the evidence.

:func:`~dmlc_core_tpu_torch.telemetry.anomaly.maybe_monitor_from_env` routes
through :func:`parse_slo_spec` here, so any process that sets
``DMLC_SLO_SPEC`` gets burn-rate support without new wiring.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from .anomaly import SloMonitor, SloRule, SloSpecError, _parse_value
from . import timeseries as _timeseries

__all__ = ["BurnRateRule", "BurnRateMonitor", "parse_slo_spec",
           "parse_duration"]

_DUR_SUFFIX = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(text: str) -> float:
    """``"30s"``/``"5m"``/``"250ms"``/``"1h"``/bare seconds → seconds."""
    t = text.strip().lower()
    for suffix in ("ms", "s", "m", "h"):
        if t.endswith(suffix) and t[:-len(suffix)]:
            try:
                return float(t[:-len(suffix)]) * _DUR_SUFFIX[suffix]
            except ValueError:
                break
    try:
        return float(t)
    except ValueError:
        raise SloSpecError(f"bad duration {text!r}") from None


def _parse_window(text: str, clause: str) -> Tuple[float, float]:
    """``"30s/14"`` → (30.0, 14.0) — window seconds / burn-rate bound."""
    w, sep, r = text.partition("/")
    if not sep:
        raise SloSpecError(f"window {text!r} in {clause!r} is not "
                           f"WINDOW/RATE (e.g. 30s/14)")
    try:
        rate = float(r)
    except ValueError:
        raise SloSpecError(f"bad burn rate {r!r} in {clause!r}") from None
    window = parse_duration(w)
    if window <= 0 or rate <= 0:
        raise SloSpecError(f"window and rate must be positive in {clause!r}")
    return window, rate


class BurnRateRule:
    """One compiled burn-rate clause, evaluated against a history store."""

    __slots__ = ("metric", "field", "max_v", "min_v", "budget",
                 "fast_w", "fast_r", "slow_w", "slow_r")

    def __init__(self, metric: str, field: Optional[str],
                 max_v: Optional[float], min_v: Optional[float],
                 budget: float,
                 fast: Tuple[float, float] = (60.0, 14.0),
                 slow: Tuple[float, float] = (600.0, 6.0)) -> None:
        self.metric = metric
        self.field = field
        self.max_v = max_v
        self.min_v = min_v
        self.budget = float(budget)
        self.fast_w, self.fast_r = fast
        self.slow_w, self.slow_r = slow

    @property
    def name(self) -> str:
        bound = (f"max={self.max_v:g}" if self.max_v is not None
                 else f"min={self.min_v:g}")
        return (f"{self.metric}:{bound}:budget={self.budget:g}"
                f":fast={self.fast_w:g}s/{self.fast_r:g}"
                f":slow={self.slow_w:g}s/{self.slow_r:g}")

    def _bad(self, v: float) -> bool:
        return ((self.max_v is not None and v > self.max_v)
                or (self.min_v is not None and v < self.min_v))

    def _series_name(self, history: "_timeseries.HistoryStore") -> str:
        """Resolve the store series for this clause: ``metric.field``
        when the sampler flattened a field out, bare ``metric`` for
        gauges."""
        field = self.field
        if field is None:
            # without a live snapshot the type is unknown; prefer the
            # flattened candidates the sampler actually produced
            names = set(history.series_names())
            for f in ("p99", "rate", "mean_s", "value"):
                if f"{self.metric}.{f}" in names:
                    return f"{self.metric}.{f}"
            return self.metric
        if field == "value":
            return self.metric
        # the sampler stores histogram p99/p50 and *.rate under dotted
        # names; anything else falls back to the dotted form too
        mapped = {"windowed_rate": "rate", "mean_sec": "mean_s",
                  "count": "rate"}.get(field, field)
        return f"{self.metric}.{mapped}"

    def check(self, history: "_timeseries.HistoryStore",
              now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Evaluate both windows; returns the breach dict of the most
        severe firing window ("fast" over "slow"), else None.  An empty
        window is not a breach — no traffic burns no budget."""
        if now is None:
            now = time.time()
        series = self._series_name(history)
        fired: Optional[Dict[str, Any]] = None
        for severity, window, rate in (("slow", self.slow_w, self.slow_r),
                                       ("fast", self.fast_w, self.fast_r)):
            pts = history.query(series, since=window, now=now)
            if not pts:
                continue
            bad = sum(1 for _ts, v in pts if self._bad(v))
            frac = bad / len(pts)
            burn = frac / self.budget if self.budget > 0 else float("inf")
            if burn < rate:
                continue
            if severity == "fast" and not self._bad(pts[-1][1]):
                continue        # still-burning check (module doc)
            fired = {"rule": self.name, "metric": self.metric,
                     "series": series, "severity": severity,
                     "window_s": window, "burn_rate": round(burn, 3),
                     "burn_threshold": rate, "budget": self.budget,
                     "bad_fraction": round(frac, 4), "samples": len(pts),
                     "value": float(pts[-1][1]),
                     "max": self.max_v, "min": self.min_v}
        return fired


def parse_slo_spec(spec: str) -> Tuple[List[SloRule], List[BurnRateRule]]:
    """Compile a ``DMLC_SLO_SPEC`` into (plain rules, burn rules).
    Strict superset of the plain grammar: clauses without ``budget=``
    compile to the same :class:`SloRule` objects as before."""
    plain: List[SloRule] = []
    burn: List[BurnRateRule] = []
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
        unknown = set(kv) - {"max", "min", "field", "for",
                             "budget", "fast", "slow"}
        if unknown:
            raise SloSpecError(
                f"unknown keys {sorted(unknown)} in clause {clause!r}")
        if "max" not in kv and "min" not in kv:
            raise SloSpecError(f"clause {clause!r} has neither max nor min")
        max_v = _parse_value(kv["max"]) if "max" in kv else None
        min_v = _parse_value(kv["min"]) if "min" in kv else None
        if "budget" not in kv:
            if "fast" in kv or "slow" in kv:
                raise SloSpecError(
                    f"clause {clause!r} has burn windows but no budget=")
            try:
                plain.append(SloRule(metric, field=kv.get("field"),
                                     max_v=max_v, min_v=min_v,
                                     for_count=int(kv.get("for", 1))))
            except ValueError as e:
                raise SloSpecError(
                    f"bad value in clause {clause!r}: {e}") from None
            continue
        try:
            budget = float(kv["budget"])
        except ValueError:
            raise SloSpecError(
                f"bad budget {kv['budget']!r} in {clause!r}") from None
        if not 0 < budget <= 1:
            raise SloSpecError(
                f"budget must be in (0, 1] in clause {clause!r}")
        burn.append(BurnRateRule(
            metric, field=kv.get("field"), max_v=max_v, min_v=min_v,
            budget=budget,
            fast=_parse_window(kv["fast"], clause) if "fast" in kv
            else (60.0, 14.0),
            slow=_parse_window(kv["slow"], clause) if "slow" in kv
            else (600.0, 6.0)))
    if not plain and not burn:
        raise SloSpecError(f"empty SLO spec {spec!r}")
    return plain, burn


class BurnRateMonitor(SloMonitor):
    """An :class:`SloMonitor` that also evaluates burn-rate rules
    against a history store (the process-global one by default).
    Starting the monitor starts the sampler — a burn rule over an empty
    store would otherwise silently watch nothing."""

    def __init__(self, rules: List[SloRule],
                 burn_rules: List[BurnRateRule],
                 history: Optional["_timeseries.HistoryStore"] = None,
                 **kw: Any) -> None:
        super().__init__(rules, **kw)
        self.burn_rules = list(burn_rules)
        self.history = history if history is not None \
            else _timeseries.history

    def _extra_checks(self, snapshot: Dict[str, Any]
                      ) -> List[Dict[str, Any]]:
        return [b for b in (rule.check(self.history)
                            for rule in self.burn_rules) if b is not None]

    def start(self) -> "BurnRateMonitor":
        if not self.history.running:
            self.history.start()
        super().start()
        return self
