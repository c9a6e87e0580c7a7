"""Automated incident diagnosis: from "a breach fired" to "here is who".

Counterpart of ``dmlc_core_tpu/telemetry/diagnose.py``, copied so that
the port never imports the JAX package: the same four analyzers, merger,
document (schema ``dmlc.diagnosis/1``), text and knobs, so that the same
evidence gives the same ranked suspects in either package.

Every surface the telemetry plane has (wide events, the tiered
timeline, critical-path analytics, the straggler board) still needs a
human to *correlate* them after a page.  This module mechanizes it:
given an incident window (an SLO/burn-rate breach, a flight trigger, or
an explicit ``?since=/until=``), four independent analyzers each
produce scored suspects and a merger folds them into one ranked report:

1. **Wide-event dimension differencing** (BubbleUp-style): split the
   wide-event ring into a *bad* population (errored outcomes, or
   robustly-slow ``dur_ms``, inside the window) and a baseline (all
   other buffered events) and rank every dimension value by how much
   more often it appears among the bad — "all slow requests carry
   ``replica=host:7013``" surfaces as the top row, no grouping query
   written by hand.
2. **Timeline lead/lag correlation**: scan every
   :class:`~.timeseries.HistoryStore` series for its deviation onset
   (EWMA + MAD robust z, the :class:`~.anomaly.StreamingStat`
   machinery) and rank series that deviated *before* the breached series
   by lead time × deviation magnitude — the upstream cause usually moves
   first.
3. **Critical-path regression diff**: re-run
   :func:`~.critical_path.analyze` over the breach-window span records
   and over a pre-incident baseline window, and rank spans whose share
   of critical-path self time *grew*.
4. **Fleet attribution**: fold a :class:`~.anomaly.StragglerBoard`
   snapshot and the per-worker/replica rows of a merged ``/fleet`` doc
   into entity suspects, corroborated against the wide-event verdict
   when both name the same replica/worker.

Every source is injectable (``events_fn``, ``history``, ``records_fn``,
``stragglers_fn``, ``fleet_fn``): a process-local exporter uses the
defaults, and a host with merged stores (the tracker, the data-service
dispatcher, the fleet registry) hands in its own.  Served at
``/diagnose`` on every exporter, attached to every flight bundle as
``diagnosis.json`` + ``diagnosis.txt``, and run by the SLO monitor on a
breach before its dump (``DMLC_DIAGNOSE_ON_BREACH=0`` opts out), so the
bundle of the page that woke you already holds the ranked verdict.

Knobs: ``DMLC_DIAGNOSE`` (master gate for the automatic paths, default
1), ``DMLC_DIAGNOSE_WINDOW`` (incident window seconds when no breach /
explicit window scopes it, default 60), ``DMLC_DIAGNOSE_BASELINE``
(pre-incident baseline seconds, default 300), ``DMLC_DIAGNOSE_TOP``
(suspects kept per analyzer and overall, default 5),
``DMLC_DIAGNOSE_SLOW_MS`` (wide-event slow threshold; 0 = adaptive
median + 4·MAD).  Accounting: ``telemetry.diagnose.runs`` /
``telemetry.diagnose.wall_ms`` / ``telemetry.diagnose.suspects``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.metrics import metrics
from ..utils.parameter import get_env
from . import critical_path as _critical_path
from . import timeseries as _timeseries
from . import trace as _trace
from . import wide_events as _wide
from .anomaly import StreamingStat, _median

__all__ = ["DiagnosisEngine", "diagnose", "render_text", "on_breach",
           "incident_diagnosis", "default_engine", "DIAGNOSIS_SCHEMA"]

DIAGNOSIS_SCHEMA = "dmlc.diagnosis/1"

#: wide-event fields that are *measures* (continuous magnitudes) — they
#: feed the slowness classifier, not the dimension differencer.  Every
#: name here is in ``wide_events.FIELDS`` (the tests check it).
MEASURE_FIELDS = frozenset({
    "dur_ms", "queue_ms", "rows", "nnz", "batch_rows", "batch_nnz",
    "bytes", "frames",
})

#: per-event-unique identity fields — differencing them would ring the
#: cardinality alarm BubbleUp exists to avoid (also checked).
IDENTITY_FIELDS = frozenset({"seq", "ts", "trace_id", "req_id"})

#: the entity-valued fields fleet attribution corroborates against
#: (checked like the sets above).
ENTITY_FIELDS = frozenset({"replica", "worker"})

#: the metric names this module owns
DIAG_METRICS = ("telemetry.diagnose.runs", "telemetry.diagnose.wall_ms",
                "telemetry.diagnose.suspects")

#: series whose movement is an *effect* of the breach machinery itself —
#: never lead/lag suspects
_SELF_SERIES_PREFIXES = ("slo.", "telemetry.diagnose", "flight.",
                        "telemetry.timeline", "anomaly.")

#: robust-z threshold for a series' deviation onset, and the minimum
#: baseline points before a z is trusted
_ONSET_Z = 3.0
_ONSET_MIN_N = 5
_Z_CAP = 1e3


def event_field(ev: Dict[str, Any], name: str) -> Any:
    """The one spelling for reading a wide-event field inside the
    analyzers (the JAX package's lint rule keys on this call name to
    check every referenced field against ``FIELDS``)."""
    return ev.get(name)


def _robust_slow_ms(durs: List[float]) -> float:
    """Adaptive slow threshold: median + 4·(1.4826·MAD), floored at half
    the median — a bimodal window (one slow replica among healthy ones)
    puts the threshold between the modes; an all-healthy window keeps
    ordinary jitter below it."""
    med = _median(durs)
    mad = _median([abs(d - med) for d in durs])
    return med + max(4.0 * 1.4826 * mad, 0.5 * med, 1e-3)


class DiagnosisEngine:
    """Four analyzers + the merger over injectable evidence sources.

    Every source is a zero-arg callable so the same engine serves a
    process-local exporter (defaults: the global wide-event ring, the
    global history store, the global span recorder) or a control plane's
    *merged* fleet view (the tracker injects its fleet history store and
    straggler board; dispatcher/registry inject theirs).  Tests inject
    synthetic populations and a synthetic clock.
    """

    def __init__(self, *,
                 events_fn: Optional[Callable[[], List[Dict[str, Any]]]]
                 = None,
                 history: Optional["_timeseries.HistoryStore"] = None,
                 records_fn: Optional[Callable[[], List[Dict[str, Any]]]]
                 = None,
                 stragglers_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None,
                 fleet_fn: Optional[Callable[[], Dict[str, Any]]] = None
                 ) -> None:
        self._events_fn = events_fn or (lambda: _wide.wide_log.snapshot())
        self._history = history
        self._records_fn = records_fn or _trace.recorder.snapshot
        self._stragglers_fn = stragglers_fn
        self._fleet_fn = fleet_fn

    @property
    def history(self) -> "_timeseries.HistoryStore":
        return self._history if self._history is not None \
            else _timeseries.history

    # -- analyzer 1: wide-event dimension differencing -------------------
    def _diff_wide_events(self, since: float, until: float, top: int,
                          slow_ms: float) -> Dict[str, Any]:
        events = self._events_fn()
        in_window = [e for e in events
                     if since <= float(event_field(e, "ts") or 0) <= until]
        durs = [float(event_field(e, "dur_ms"))
                for e in in_window
                if isinstance(event_field(e, "dur_ms"), (int, float))]
        if slow_ms <= 0:
            slow_ms = _robust_slow_ms(durs) if durs else float("inf")

        def _is_bad(e: Dict[str, Any]) -> bool:
            outcome = event_field(e, "outcome")
            if outcome is not None and str(outcome).upper() != "OK":
                return True
            d = event_field(e, "dur_ms")
            return isinstance(d, (int, float)) and float(d) > slow_ms

        bad = [e for e in in_window if _is_bad(e)]
        bad_ids = {id(e) for e in bad}
        base = [e for e in events if id(e) not in bad_ids]
        doc: Dict[str, Any] = {
            "events": len(events), "in_window": len(in_window),
            "bad": len(bad), "baseline": len(base),
            "slow_ms": None if slow_ms == float("inf")
            else round(slow_ms, 3),
            "suspects": [],
        }
        if not bad or not base:
            return doc
        dims = _wide.FIELDS - MEASURE_FIELDS - IDENTITY_FIELDS

        def _counts(pop: List[Dict[str, Any]]
                    ) -> Dict[Tuple[str, str], int]:
            out: Dict[Tuple[str, str], int] = {}
            for e in pop:
                for f in dims:
                    v = e.get(f)
                    if v is not None:
                        key = (f, str(v))
                        out[key] = out.get(key, 0) + 1
            return out

        bad_counts = _counts(bad)
        base_counts = _counts(base)
        nb, nz = len(bad), len(base)
        suspects = []
        for (f, v), cb in bad_counts.items():
            if cb < min(2, nb):
                continue            # one stray event is not a pattern
            p_bad = cb / nb
            p_base = base_counts.get((f, v), 0) / nz
            score = (p_bad - p_base) * p_bad
            if score <= 0:
                continue
            suspects.append({"field": f, "value": v,
                             "bad": cb, "bad_frac": round(p_bad, 4),
                             "base_frac": round(p_base, 4),
                             "score": round(score, 6)})
        suspects.sort(key=lambda s: (-s["score"], s["field"], s["value"]))
        doc["suspects"] = suspects[:top]
        return doc

    # -- analyzer 2: timeline lead/lag correlation -----------------------
    @staticmethod
    def _onset(pts: List[Tuple[float, float]]
               ) -> Tuple[Optional[float], float]:
        """First timestamp where a series leaves its own EWMA+MAD band
        (``(onset_ts, max_abs_z)``); ``(None, 0)`` when it never does.
        The estimate is frozen at onset so the magnitude is measured
        against the pre-deviation baseline, not a corrupted one."""
        stat = StreamingStat(alpha=0.25)
        onset: Optional[float] = None
        mag = 0.0
        for ts, v in pts:
            z = stat.zscore(v, rel_floor=0.25)
            if onset is None:
                if stat.n >= _ONSET_MIN_N and abs(z) > _ONSET_Z:
                    onset = ts
                    mag = abs(z)
                else:
                    stat.update(v)
            else:
                mag = max(mag, abs(z))
        return onset, min(mag, _Z_CAP)

    def _correlate_timeline(self, since: float, until: float, top: int,
                            breach_series: Optional[str]
                            ) -> Dict[str, Any]:
        history = self.history
        baseline_s = float(get_env("DMLC_DIAGNOSE_BASELINE", 300.0))
        span = (until - since) + baseline_s
        ref_onset = since
        if breach_series:
            pts = [(ts, v) for ts, v in history.query(
                breach_series, since=span, now=until) if ts <= until]
            onset, _mag = self._onset(pts)
            if onset is not None:
                ref_onset = onset
        doc: Dict[str, Any] = {"breach_series": breach_series,
                               "breach_onset": round(ref_onset, 3),
                               "series_scanned": 0, "suspects": []}
        step = history.tiers[0][0] if history.tiers else 1.0
        suspects = []
        for name in history.series_names():
            if name == breach_series or \
                    name.startswith(_SELF_SERIES_PREFIXES):
                continue
            pts = [(ts, v) for ts, v in history.query(
                name, since=span, now=until) if ts <= until]
            doc["series_scanned"] += 1
            onset, mag = self._onset(pts)
            # leaders only: a series that moved after the breach is an
            # effect, not a cause (step of slack absorbs sampler phase)
            if onset is None or onset > ref_onset + step:
                continue
            lead_s = max(0.0, ref_onset - onset)
            suspects.append({"series": name,
                             "onset": round(onset, 3),
                             "lead_s": round(lead_s, 3),
                             "magnitude": round(mag, 3),
                             "score": round((lead_s + step) * mag, 6)})
        suspects.sort(key=lambda s: (-s["score"], s["series"]))
        doc["suspects"] = suspects[:top]
        return doc

    # -- analyzer 3: critical-path regression diff -----------------------
    def _diff_critical_path(self, since: float, until: float, top: int
                            ) -> Dict[str, Any]:
        baseline_s = float(get_env("DMLC_DIAGNOSE_BASELINE", 300.0))
        base_start = since - baseline_s
        records = [r for r in self._records_fn()
                   if r.get("kind") == "span"]

        def _end_s(r: Dict[str, Any]) -> float:
            return (float(r.get("ts_us", 0))
                    + float(r.get("dur_us", 0))) / 1e6

        inc = [r for r in records if since <= _end_s(r) <= until]
        base = [r for r in records if base_start <= _end_s(r) < since]
        doc: Dict[str, Any] = {"incident_spans": len(inc),
                               "baseline_spans": len(base), "suspects": []}
        if not inc:
            return doc

        def _shares(recs: List[Dict[str, Any]]) -> Dict[str, float]:
            st = _critical_path.analyze(top=max(top, 10),
                                        records=recs)["self_time_us"]
            total = sum(st.values()) or 1
            return {k: v / total for k, v in st.items()}

        inc_sh = _shares(inc)
        base_sh = _shares(base) if base else {}
        suspects = []
        for name, share in inc_sh.items():
            growth = share - base_sh.get(name, 0.0)
            if growth <= 0:
                continue
            suspects.append({"span": name,
                             "share_incident": round(share, 4),
                             "share_baseline": round(
                                 base_sh.get(name, 0.0), 4),
                             "score": round(growth, 6)})
        suspects.sort(key=lambda s: (-s["score"], s["span"]))
        doc["suspects"] = suspects[:top]
        doc["baseline_missing"] = not base
        return doc

    # -- analyzer 4: fleet attribution -----------------------------------
    def _attribute_fleet(self, top: int) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"sources": [], "suspects": []}
        suspects: List[Dict[str, Any]] = []
        if self._stragglers_fn is not None:
            try:
                snap = self._stragglers_fn() or {}
                doc["sources"].append("stragglers")
                worst: Dict[str, float] = {}
                for per_rank in (snap.get("stages") or {}).values():
                    for rank, d in per_rank.items():
                        if d.get("straggler"):
                            worst[rank] = max(worst.get(rank, 0.0),
                                              float(d.get("z", 0.0)))
                for rank, z in worst.items():
                    suspects.append({"entity": "rank", "id": str(rank),
                                     "reason": "straggler",
                                     "score": round(min(z, _Z_CAP), 3)})
            except Exception as e:
                doc["stragglers_error"] = str(e)
        if self._fleet_fn is not None:
            try:
                fleet = self._fleet_fn() or {}
                doc["sources"].append("fleet")
                for kind in ("replicas", "workers"):
                    for key, row in (fleet.get(kind) or {}).items():
                        if not isinstance(row, dict):
                            continue
                        entity = kind[:-1]
                        # wide events carry host:port addrs while fleet
                        # rows key on jobids — keep both spellings so
                        # corroboration matches either
                        ident = {"entity": entity, "id": str(key),
                                 "addr": str(row.get("addr") or "")}
                        if not row.get("alive", True):
                            suspects.append({**ident, "reason": "dead",
                                             "score": 10.0})
                        elif row.get("straggler"):
                            suspects.append({**ident,
                                             "reason": "straggler",
                                             "score": 6.0})
                        elif str(row.get("health", "ok")) not in (
                                "ok", "?"):
                            suspects.append({
                                **ident,
                                "reason": str(row.get("health")),
                                "score": 4.0 + float(
                                    row.get("queue_fraction", 0.0))})
            except Exception as e:
                doc["fleet_error"] = str(e)
        suspects.sort(key=lambda s: (-s["score"], s["entity"], s["id"]))
        doc["suspects"] = suspects[:top]
        return doc

    # -- the merger ------------------------------------------------------
    @staticmethod
    def _merge(analyzers: Dict[str, Dict[str, Any]], top: int
               ) -> List[Dict[str, Any]]:
        """Normalize each analyzer's scores to [0, 1] (its top suspect
        scores 1.0) and rank the union; a fleet entity also named by the
        wide-event differ is corroborated and boosted — two independent
        analyzers agreeing beats either one alone."""
        entity_values = {s["value"]
                         for s in analyzers["wide_events"]["suspects"]
                         if s["field"] in ENTITY_FIELDS}
        merged: List[Dict[str, Any]] = []
        subjects = {"wide_events": lambda s: f"{s['field']}={s['value']}",
                    "timeline": lambda s: s["series"],
                    "critical_path": lambda s: f"span {s['span']}",
                    "fleet": lambda s: f"{s['entity']} {s['id']}"}
        for name, doc in analyzers.items():
            sus = doc.get("suspects") or []
            if not sus:
                continue
            peak = max(float(s["score"]) for s in sus) or 1.0
            for s in sus:
                entry = {"analyzer": name,
                         "subject": subjects[name](s),
                         "score": round(float(s["score"]) / peak, 4),
                         "detail": {k: v for k, v in s.items()
                                    if k != "score"}}
                if name == "fleet" and (
                        s["id"] in entity_values
                        or s.get("addr") in entity_values):
                    entry["corroborated"] = True
                    entry["score"] = round(min(1.0, entry["score"] + 0.25),
                                           4)
                merged.append(entry)
        merged.sort(key=lambda e: (-e["score"], e["analyzer"],
                                   e["subject"]))
        out = merged[:top]
        for i, e in enumerate(out, start=1):
            e["rank"] = i
        return out

    # -- entry points ----------------------------------------------------
    def run(self, since: Optional[float] = None,
            until: Optional[float] = None,
            top: Optional[int] = None,
            breach: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One diagnosis pass → the ``dmlc.diagnosis/1`` document.
        ``since``/``until`` are unix timestamps bounding the incident
        window; a ``breach`` dict (a burn/SLO firing) scopes the window
        and names the reference series when ``since`` is not given."""
        t0 = time.perf_counter()
        if until is None:
            until = time.time()
        if top is None:
            top = max(1, int(get_env("DMLC_DIAGNOSE_TOP", 5)))
        if since is None:
            window = float(get_env("DMLC_DIAGNOSE_WINDOW", 60.0))
            if breach and breach.get("window_s"):
                window = float(breach["window_s"])
            since = until - window
        breach_series = (breach or {}).get("series")
        slow_ms = float(get_env("DMLC_DIAGNOSE_SLOW_MS", 0.0))
        analyzers = {
            "wide_events": self._diff_wide_events(since, until, top,
                                                  slow_ms),
            "timeline": self._correlate_timeline(since, until, top,
                                                 breach_series),
            "critical_path": self._diff_critical_path(since, until, top),
            "fleet": self._attribute_fleet(top),
        }
        suspects = self._merge(analyzers, top)
        wall_ms = (time.perf_counter() - t0) * 1e3
        metrics.counter("telemetry.diagnose.runs").add(1)
        metrics.histogram("telemetry.diagnose.wall_ms").observe(wall_ms)
        metrics.gauge("telemetry.diagnose.suspects").set(len(suspects))
        return {
            "schema": DIAGNOSIS_SCHEMA,
            "ts": time.time(),
            "window": {"since": since, "until": until,
                       "baseline_s": float(
                           get_env("DMLC_DIAGNOSE_BASELINE", 300.0))},
            "trigger": ({"kind": "breach", "breach": breach}
                        if breach else {"kind": "explicit"}),
            "analyzers": analyzers,
            "suspects": suspects,
            "wall_ms": round(wall_ms, 3),
        }

    def endpoint_doc(self, since_s: Optional[float] = None,
                     until_s: Optional[float] = None,
                     top: Optional[int] = None) -> Dict[str, Any]:
        """``GET /diagnose`` body.  ``since_s``/``until_s`` are seconds
        back from now; with neither given, a recent breach (if any)
        scopes the window so a bare ``/diagnose`` after a page answers
        about *that* incident."""
        now = time.time()
        until = now - float(until_s) if until_s else now
        since = until - float(since_s) if since_s else None
        breach = _recent_breach() if since is None else None
        return self.run(since=since, until=until, top=top, breach=breach)


# ---------------------------------------------------------------------------
# process-global engine + breach auto-trigger
# ---------------------------------------------------------------------------

_engine_lock = threading.Lock()
_default_engine: Optional[DiagnosisEngine] = None

#: (breach dict, unix ts) of the most recent burn/SLO firing, and the
#: diagnosis it triggered — what bare ``/diagnose`` hits and flight
#: bundles attach
_last_breach: Optional[Tuple[Dict[str, Any], float]] = None
_last_doc: Optional[Dict[str, Any]] = None


def default_engine() -> DiagnosisEngine:
    """The process-global engine over the global ring/store/recorder."""
    global _default_engine
    with _engine_lock:
        if _default_engine is None:
            _default_engine = DiagnosisEngine()
        return _default_engine


def diagnose(since: Optional[float] = None, until: Optional[float] = None,
             top: Optional[int] = None,
             breach: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One diagnosis pass on the process-global engine."""
    return default_engine().run(since=since, until=until, top=top,
                                breach=breach)


def _recent_breach() -> Optional[Dict[str, Any]]:
    """The last recorded breach, while it is still fresher than twice
    its own window (after that a bare /diagnose means "now", not "then")."""
    got = _last_breach
    if got is None:
        return None
    breach, ts = got
    horizon = 2.0 * float(breach.get("window_s")
                          or get_env("DMLC_DIAGNOSE_WINDOW", 60.0))
    return breach if time.time() - ts <= horizon else None


def on_breach(breach: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The SLO-monitor hook: record the breach and run a breach-scoped
    diagnosis (``DMLC_DIAGNOSE=0`` / ``DMLC_DIAGNOSE_ON_BREACH=0`` opt
    out) so the flight bundle dumped moments later carries the verdict."""
    global _last_breach, _last_doc
    if not get_env("DMLC_DIAGNOSE", True) \
            or not get_env("DMLC_DIAGNOSE_ON_BREACH", True):
        return None
    _last_breach = (dict(breach), time.time())
    _last_doc = default_engine().run(breach=breach)
    return _last_doc


def incident_diagnosis() -> Optional[Dict[str, Any]]:
    """The flight-recorder hook: the breach-scoped diagnosis when one is
    fresh, else a fresh default-window run.  ``DMLC_DIAGNOSE=0`` opts
    the bundle section out entirely (None → no file)."""
    if not get_env("DMLC_DIAGNOSE", True):
        return None
    breach = _recent_breach()
    if breach is not None and _last_doc is not None:
        return _last_doc
    return default_engine().run(breach=breach)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render_text(doc: Dict[str, Any]) -> str:
    """``diagnosis.txt`` / ``/diagnose?format=text``: the merged ranking
    first (the headline), then each analyzer's own table."""
    w = doc.get("window", {})
    lines = [f"diagnosis @ {doc.get('ts', 0):.0f} "
             f"window={w.get('since', 0):.0f}..{w.get('until', 0):.0f} "
             f"({doc.get('wall_ms', 0):.1f} ms)"]
    trig = doc.get("trigger", {})
    if trig.get("kind") == "breach":
        b = trig.get("breach") or {}
        lines.append(f"trigger: breach {b.get('rule', '?')} "
                     f"severity={b.get('severity', '-')}")
    sus = doc.get("suspects") or []
    lines.append("ranked suspects:" if sus
                 else "ranked suspects: (none — quiet window)")
    for s in sus:
        flag = " [corroborated]" if s.get("corroborated") else ""
        lines.append(f"  #{s['rank']} [{s['analyzer']}] {s['subject']} "
                     f"score={s['score']:.3f}{flag}")
    az = doc.get("analyzers", {})
    we = az.get("wide_events", {})
    lines.append(f"wide events: {we.get('bad', 0)} bad / "
                 f"{we.get('baseline', 0)} baseline "
                 f"(slow>{we.get('slow_ms', '-')}ms)")
    for s in we.get("suspects") or []:
        lines.append(f"  {s['field']}={s['value']}  "
                     f"bad {s['bad_frac'] * 100:.0f}% vs base "
                     f"{s['base_frac'] * 100:.0f}%")
    tl = az.get("timeline", {})
    lines.append(f"timeline: {tl.get('series_scanned', 0)} series vs "
                 f"{tl.get('breach_series') or '(window start)'}")
    for s in tl.get("suspects") or []:
        lines.append(f"  {s['series']}  lead={s['lead_s']:.1f}s "
                     f"|z|={s['magnitude']:.1f}")
    cp = az.get("critical_path", {})
    lines.append(f"critical path: {cp.get('incident_spans', 0)} incident "
                 f"vs {cp.get('baseline_spans', 0)} baseline span(s)")
    for s in cp.get("suspects") or []:
        lines.append(f"  {s['span']}  share "
                     f"{s['share_baseline'] * 100:.1f}% -> "
                     f"{s['share_incident'] * 100:.1f}%")
    fl = az.get("fleet", {})
    if fl.get("sources"):
        lines.append(f"fleet ({'+'.join(fl['sources'])}):")
        for s in fl.get("suspects") or []:
            lines.append(f"  {s['entity']} {s['id']}  {s['reason']} "
                         f"score={s['score']:.1f}")
    return "\n".join(lines) + "\n"
