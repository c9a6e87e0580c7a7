"""Prometheus text exposition + stdlib HTTP exporter.

Counterpart of ``dmlc_core_tpu/telemetry/exposition.py``, copied so that
the port never imports the JAX package: the renderers are the JAX ones
byte for byte, and :class:`TelemetryServer` keeps the JAX constructor,
routes, content types and status codes, ``/profile``, ``/analyze`` and
``/diagnose`` among them.

:func:`render_prometheus` turns any ``MetricsRegistry.snapshot()`` into
Prometheus text format 0.0.4 — no client library, just the format:

* counter      → ``dmlc_<name>_total``
* gauge        → ``dmlc_<name>``
* histogram    → summary-style ``{quantile="0.5|0.95|0.99"}`` series plus
  ``_sum`` / ``_count`` (reservoir quantiles are pre-computed, which is a
  summary, not a Prometheus histogram's cumulative buckets)
* throughput   → ``_total`` counter + ``_rate`` / ``_windowed_rate`` gauges
* stage        → ``_seconds_total`` counter + ``_count`` + ``_mean_seconds``

:func:`render_series` renders several labeled snapshots (e.g. one per
rank plus a merged fleet view) into one page with each ``# TYPE`` header
emitted once per family, which is what the tracker's ``/metrics`` serves.

:func:`render_openmetrics` is the OpenMetrics 1.0 sibling
(``/metrics?format=openmetrics``): histograms become native cumulative
buckets (synthesised at the reservoir's p50/p95/p99 edges) so retained
exemplars — ``(value, trace_id, ts)`` triples captured by
``Histogram.observe`` — can ride the ``_bucket`` lines in standard
``# {trace_id="..."}`` syntax.  When a tail sampler is installed only
exemplars whose traces were *kept* are rendered, so every exemplar on
the page is followable into ``/spans``.

:class:`TelemetryServer` is a daemon-thread ``ThreadingHTTPServer``
mounting ``/metrics``, ``/healthz``, ``/spans``, ``/timeline``,
``/events`` (the wide-event log), ``/flight`` (an incident bundle),
``/profile`` (a sampling profile), ``/analyze`` (the critical path) and
``/diagnose`` (the ranked incident diagnosis).
The serving server mounts one when ``metrics_port`` /
``DMLC_METRICS_PORT`` is set, and :func:`maybe_start_from_env` lets any
process self-serve its registry.
"""

from __future__ import annotations

import json
import os
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.logging import log_info, log_warning
from ..utils.parameter import get_env
from . import trace as _trace

__all__ = ["render_prometheus", "render_series", "render_openmetrics",
           "render_fleet_board", "TelemetryServer", "maybe_start_from_env"]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: health states a health_fn may return, with their HTTP mapping
_HEALTH_HTTP = {"ok": 200, "degraded": 200, "overloaded": 503}

#: route table: URL path → TelemetryServer handler method name.  Every
#: endpoint is declared through :func:`_endpoint` so the set is one
#: greppable table (the JAX exporter's, path for path).
_ROUTES: Dict[str, str] = {}


def _endpoint(path: str):
    """Register a ``TelemetryServer`` method as the handler for ``path``
    (handlers return ``(status, content_type, body)``)."""

    def deco(fn):
        _ROUTES[path] = fn.__name__
        return fn

    return deco


#: metric-name → one-line help text, lazily loaded from the committed
#: ``docs/inventory.json`` catalog (``# HELP`` sourcing); missing or
#: unreadable inventory degrades to no HELP lines, never an error
_HELP_CACHE: Optional[Dict[str, str]] = None


def _help_catalog() -> Dict[str, str]:
    global _HELP_CACHE
    if _HELP_CACHE is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "docs", "inventory.json")
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            helps = doc.get("help", {})
            _HELP_CACHE = {k: str(v) for k, v in helps.items()
                           if isinstance(v, str)}
        except (OSError, ValueError):
            _HELP_CACHE = {}
    return _HELP_CACHE


def _escape_help(text: str) -> str:
    """Text-format 0.0.4 HELP escaping: backslash and newline only."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _sanitize(name: str) -> str:
    """``serving.client.retries`` → ``serving_client_retries``."""
    name = _NAME_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label_value(v: Any) -> str:
    """Text-format 0.0.4 label-value escaping: backslash first (so the
    escapes it introduces aren't re-escaped), then newline and quote."""
    return (str(v).replace("\\", "\\\\")
                  .replace("\n", "\\n")
                  .replace('"', '\\"'))


def _fmt_labels(labels: Optional[Dict[str, str]],
                extra: Optional[Dict[str, str]] = None) -> str:
    merged: Dict[str, str] = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_val(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _family_samples(name: str, snap: Dict[str, Any],
                    labels: Optional[Dict[str, str]], prefix: str
                    ) -> List[Tuple[str, str, List[str]]]:
    """One snapshot entry → list of (family_name, prom_type, sample_lines)."""
    base = f"{prefix}_{_sanitize(name)}" if prefix else _sanitize(name)
    t = snap.get("type")
    lab = lambda extra=None: _fmt_labels(labels, extra)  # noqa: E731
    if t == "counter":
        return [(f"{base}_total", "counter",
                 [f"{base}_total{lab()} {_fmt_val(snap.get('value', 0))}"])]
    if t == "gauge":
        return [(base, "gauge",
                 [f"{base}{lab()} {_fmt_val(snap.get('value', 0.0))}"])]
    if t == "histogram":
        count = int(snap.get("count", 0))
        mean = float(snap.get("mean", 0.0))
        lines = [
            f"{base}{lab({'quantile': q})} {_fmt_val(snap.get(p, 0.0))}"
            for q, p in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))
        ]
        lines.append(f"{base}_sum{lab()} {_fmt_val(mean * count)}")
        lines.append(f"{base}_count{lab()} {count}")
        return [(base, "summary", lines)]
    if t == "throughput":
        return [
            (f"{base}_total", "counter",
             [f"{base}_total{lab()} {_fmt_val(snap.get('total', 0))}"]),
            (f"{base}_rate", "gauge",
             [f"{base}_rate{lab()} {_fmt_val(snap.get('rate', 0.0))}"]),
            (f"{base}_windowed_rate", "gauge",
             [f"{base}_windowed_rate{lab()} "
              f"{_fmt_val(snap.get('windowed_rate', 0.0))}"]),
        ]
    if t == "stage":
        return [
            (f"{base}_seconds_total", "counter",
             [f"{base}_seconds_total{lab()} "
              f"{_fmt_val(snap.get('total_sec', 0.0))}"]),
            (f"{base}_count", "counter",
             [f"{base}_count{lab()} {_fmt_val(snap.get('count', 0))}"]),
            (f"{base}_mean_seconds", "gauge",
             [f"{base}_mean_seconds{lab()} "
              f"{_fmt_val(snap.get('mean_sec', 0.0))}"]),
        ]
    return []   # unknown type: skip rather than emit malformed text


def render_series(series: Sequence[Tuple[Optional[Dict[str, str]],
                                         Dict[str, Dict[str, Any]]]],
                  prefix: str = "dmlc",
                  help_map: Optional[Dict[str, str]] = None) -> str:
    """Render labeled snapshots into one exposition page.

    ``series`` is ``[(labels_or_None, snapshot), ...]``; samples of the
    same family from different label sets share a single ``# TYPE``
    header (duplicated headers are invalid exposition format).  Each
    family whose source metric has a row in the ``docs/inventory.json``
    help catalog gets a ``# HELP`` line (``help_map`` overrides the
    catalog; pass ``{}`` to disable).
    """
    if help_map is None:
        help_map = _help_catalog()
    families: Dict[str, Tuple[str, List[str]]] = {}
    order: List[str] = []
    sources: Dict[str, str] = {}      # family → source metric name
    for labels, snapshot in series:
        for name in sorted(snapshot):
            for fam, ptype, lines in _family_samples(
                    name, snapshot[name], labels, prefix):
                if fam not in families:
                    families[fam] = (ptype, [])
                    order.append(fam)
                    sources[fam] = name
                families[fam][1].extend(lines)
    out: List[str] = []
    for fam in order:
        ptype, lines = families[fam]
        help_text = help_map.get(sources.get(fam, ""))
        if help_text:
            out.append(f"# HELP {fam} {_escape_help(help_text)}")
        out.append(f"# TYPE {fam} {ptype}")
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")


def render_prometheus(snapshot: Dict[str, Dict[str, Any]],
                      labels: Optional[Dict[str, str]] = None,
                      prefix: str = "dmlc",
                      help_map: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text format 0.0.4 for one registry snapshot."""
    return render_series([(labels, snapshot)], prefix=prefix,
                         help_map=help_map)


def _exemplar_kept(trace_hex: Optional[str]) -> bool:
    """Should this exemplar's trace be shown?  With no tail sampler
    installed everything is recorded, so every trace is followable;
    with one, only a kept verdict (not drop, not unknown) qualifies."""
    if not trace_hex:
        return False
    from . import sampling as _sampling
    s = _sampling.get_sampler()
    if s is None:
        return True
    was = getattr(s, "was_kept", None)
    if was is None:
        return True
    return was(trace_hex) is True


def _registry_exemplars(metric: Optional[str] = None
                        ) -> Dict[str, List[Dict[str, Any]]]:
    """Kept-trace exemplars held by live registry histograms, keyed by
    metric name (optionally restricted to one metric)."""
    from ..utils.metrics import metrics as _registry
    out: Dict[str, List[Dict[str, Any]]] = {}
    for name, snap in _registry.snapshot().items():
        if metric is not None and name != metric:
            continue
        exs = [e for e in (snap.get("exemplars") or [])
               if _exemplar_kept(e.get("trace_id"))]
        if exs:
            out[name] = exs
    return out


def _openmetrics_histogram(base: str, snap: Dict[str, Any],
                           lab: Callable[..., str]) -> List[str]:
    """Native-histogram lines with exemplars.  The reservoir stores
    quantiles, not buckets, so cumulative buckets are synthesised at the
    p50/p95/p99 edges — coarse, but enough structure for exemplars to
    attach where the spec allows them (``_bucket`` samples only)."""
    count = int(snap.get("count", 0))
    mean = float(snap.get("mean", 0.0))
    exs = [e for e in (snap.get("exemplars") or [])
           if _exemplar_kept(e.get("trace_id"))]
    exs.sort(key=lambda e: float(e.get("value", 0.0)))
    lines: List[str] = []
    idx = 0
    for hi, frac in ((float(snap.get("p50", 0.0)), 0.50),
                     (float(snap.get("p95", 0.0)), 0.95),
                     (float(snap.get("p99", 0.0)), 0.99),
                     (None, 1.0)):
        c = count if hi is None else int(round(count * frac))
        le = "+Inf" if hi is None else _fmt_val(hi)
        line = f"{base}_bucket{lab({'le': le})} {c}"
        if idx < len(exs) and (hi is None or
                               float(exs[idx].get("value", 0.0)) <= hi):
            e = exs[idx]
            idx += 1
            tid = _escape_label_value(e.get("trace_id", ""))
            line += (f' # {{trace_id="{tid}"}}'
                     f' {_fmt_val(e.get("value", 0.0))}'
                     f' {_fmt_val(e.get("ts", 0.0))}')
        lines.append(line)
    lines.append(f"{base}_sum{lab()} {_fmt_val(mean * count)}")
    lines.append(f"{base}_count{lab()} {count}")
    return lines


def render_openmetrics(snapshot: Dict[str, Dict[str, Any]],
                       labels: Optional[Dict[str, str]] = None,
                       prefix: str = "dmlc",
                       help_map: Optional[Dict[str, str]] = None) -> str:
    """OpenMetrics 1.0 text for one registry snapshot, ``# EOF``
    terminated.  Counters drop the ``_total`` suffix from the *family*
    name (the sample keeps it, per spec); histograms render as native
    cumulative buckets carrying kept-trace exemplars."""
    if help_map is None:
        help_map = _help_catalog()
    lab = lambda extra=None: _fmt_labels(labels, extra)  # noqa: E731
    out: List[str] = []
    for name in sorted(snapshot):
        snap = snapshot[name]
        help_text = help_map.get(name)
        if snap.get("type") == "histogram":
            base = (f"{prefix}_{_sanitize(name)}" if prefix
                    else _sanitize(name))
            if help_text:
                out.append(f"# HELP {base} {_escape_help(help_text)}")
            out.append(f"# TYPE {base} histogram")
            out.extend(_openmetrics_histogram(base, snap, lab))
            continue
        for fam, ptype, lines in _family_samples(name, snap, labels,
                                                 prefix):
            om_fam = (fam[:-len("_total")]
                      if ptype == "counter" and fam.endswith("_total")
                      else fam)
            if help_text:
                out.append(f"# HELP {om_fam} {_escape_help(help_text)}")
            out.append(f"# TYPE {om_fam} {ptype}")
            out.extend(lines)
    out.append("# EOF")
    return "\n".join(out) + "\n"


def _text_table(headers: List[str], rows: List[List[str]]) -> List[str]:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    out.extend(fmt.format(*r) for r in rows)
    return out


def render_fleet_board(doc: Dict[str, Any], html: bool = False) -> str:
    """Zero-dependency status board over a dispatcher ``/fleet`` doc.

    Plain aligned text (also legible in a terminal via ``curl``); with
    ``html=True`` the same text is wrapped in a minimal self-refreshing
    page — no JS, no CSS framework, nothing to vendor.
    """
    replicas = doc.get("replicas", {}) or {}
    lines: List[str] = ["serving fleet" if replicas
                        else "data-service fleet"]
    workers = doc.get("workers", {}) or {}
    if workers or not replicas:
        rows = []
        for jobid in sorted(workers):
            w = workers[jobid]
            rows.append([
                jobid,
                str(w.get("addr", "?")),
                "DEAD" if not w.get("alive", True) else
                ("straggler" if w.get("straggler") else "up"),
                f"{w.get('heartbeat_age_s', 0.0):.1f}s",
                f"{w.get('mb_s', 0.0):.1f}",
                str(w.get("live_leases", 0)),
                str(w.get("shards", 0)),
            ])
        lines.append("")
        lines.extend(_text_table(
            ["worker", "addr", "state", "hb_age", "MB/s", "leases",
             "shards"], rows))
    if replicas:
        # serving-fleet console (registry or router /fleet docs): one
        # row per replica, health word + the balancer's load facts
        rows = []
        for jobid in sorted(replicas):
            r = replicas[jobid]
            hb = r.get("heartbeat_age_s")
            rows.append([
                jobid,
                str(r.get("model_id", "?")),
                str(r.get("addr", "?")),
                "DEAD" if not r.get("alive", True) else
                ("straggler" if r.get("straggler")
                 else str(r.get("health", "?"))),
                f"{hb:.1f}s" if isinstance(hb, (int, float)) else "-",
                f"{r.get('queue_fraction', 0.0):.2f}",
                str(r.get("inflight", 0)),
                str(r.get("step", "-")),
            ])
        lines.append("")
        lines.extend(_text_table(
            ["replica", "model", "addr", "state", "hb_age", "q_frac",
             "inflight", "step"], rows))
        models = doc.get("models", {}) or {}
        if models:
            lines.append("")
            lines.extend(_text_table(
                ["model", "stable_ckpt", "step", "replicas"],
                [[m, str(d.get("ckpt_dir", "-")), str(d.get("step", "-")),
                  str(len(d.get("replicas", [])))]
                 for m, d in sorted(models.items())]))
    consumers = doc.get("consumers", {}) or {}
    if consumers:
        lines.append("")
        lines.extend(_text_table(
            ["consumer", "backlog", "age"],
            [[k, str(c.get("backlog", 0)), f"{c.get('age_s', 0.0):.1f}s"]
             for k, c in sorted(consumers.items())]))
    datasets = doc.get("datasets", {}) or {}
    if datasets:
        lines.append("")
        lines.extend(_text_table(
            ["dataset", "epoch", "pending", "granted", "completed"],
            [[k, str(d.get("epoch", 0)), str(d.get("pending", 0)),
              str(d.get("granted", 0)), str(d.get("completed", 0))]
             for k, d in sorted(datasets.items())]))
    text = "\n".join(lines) + "\n"
    if not html:
        return text
    import html as _html
    return ("<!doctype html><html><head>"
            "<meta http-equiv=\"refresh\" content=\"2\">"
            "<title>dmlc fleet</title></head><body><pre>"
            + _html.escape(text) + "</pre></body></html>\n")


class TelemetryServer:
    """Daemon-thread HTTP exporter: ``/metrics`` (Prometheus text;
    ``?format=openmetrics`` adds exemplar-bearing OpenMetrics),
    ``/healthz`` (JSON status, 503 when overloaded), ``/spans`` (recent
    span records as JSON, with the ring's eviction count), ``/events``
    (the wide-event log, ``?since=<seq>`` cursor), ``/flight`` (an
    incident bundle from the flight recorder, written to disk too when
    it is armed),
    ``/profile?seconds=N`` (collapsed-stack sampling profile of this
    process; plain scrapes double as the baseline recorder and
    ``?diff=1`` serves the differential profile against that baseline),
    ``/stragglers`` (tracker only — cross-rank straggler board JSON),
    ``/timeline?metric=&since=&format=json|text`` (the
    time-machine history store — process-local by default, or a store
    the host injects), ``/analyze?top=N`` (critical-path breakdown of
    the slowest traces in the span ring),
    ``/diagnose?since=&until=&top=&format=json|text`` (the automated
    incident diagnosis: four analyzers merged into one ranked suspect
    report — over merged stores on a host that injects them), and — when
    the hosting process injects them — ``/leases``
    (dispatcher lease-lifecycle ledger), ``/fleet`` (dispatcher worker
    or serving replica console; ``?format=text|html`` renders the
    status board instead of JSON) and ``/rollouts`` (serving-fleet
    canary rollout ledger).

    All content callbacks are injectable so the same class serves a
    process-local registry (serving server, standalone exporter) or the
    tracker's merged fleet view.  ``port=0`` binds an ephemeral port —
    read it back from :attr:`port` (tests and same-host discovery).
    """

    def __init__(self, port: int = 0, host: str = "0.0.0.0", *,
                 metrics_fn: Optional[Callable[[], str]] = None,
                 health_fn: Optional[Callable[[], str]] = None,
                 spans_fn: Optional[Callable[[], List[Dict[str, Any]]]] = None,
                 flight_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 stragglers_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 leases_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 fleet_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 profile_fn: Optional[Callable[[float], str]] = None,
                 rollouts_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 timeline_fn: Optional[Callable[[Optional[str],
                                                 Optional[float]],
                                                Dict[str, Any]]] = None,
                 analyze_fn: Optional[Callable[[int],
                                               Dict[str, Any]]] = None,
                 diagnose_fn: Optional[Callable[[Optional[float],
                                                 Optional[float],
                                                 Optional[int]],
                                                Dict[str, Any]]] = None,
                 ) -> None:
        if metrics_fn is None:
            from ..utils.metrics import metrics as _registry
            metrics_fn = lambda: render_prometheus(_registry.snapshot())  # noqa: E731
        if health_fn is None:
            health_fn = self._default_health
        if spans_fn is None:
            spans_fn = _trace.recorder.snapshot
        if flight_fn is None:
            flight_fn = self._default_flight
        if profile_fn is None:
            profile_fn = self._default_profile
        if analyze_fn is None:
            analyze_fn = self._default_analyze
        if diagnose_fn is None:
            diagnose_fn = self._default_diagnose
        self._metrics_fn = metrics_fn
        self._health_fn = health_fn
        self._spans_fn = spans_fn
        self._flight_fn = flight_fn
        self._stragglers_fn = stragglers_fn
        self._leases_fn = leases_fn
        self._fleet_fn = fleet_fn
        self._profile_fn = profile_fn
        self._rollouts_fn = rollouts_fn
        # None → the process-global history store, resolved (and its
        # sampler started, DMLC_TIMELINE permitting) at start()
        self._timeline_fn = timeline_fn
        self._analyze_fn = analyze_fn
        self._diagnose_fn = diagnose_fn
        self._requested = (host, int(port))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_health() -> str:
        """Standalone exporters report the serving health gauge when the
        process runs a server (0 ok / 1 degraded / 2 overloaded); a
        process with no server still degrades on live SLO breaches
        (``slo.active_breaches`` > 0 — the burn-rate engine's handle on
        ``/healthz``), else ok."""
        from ..utils.metrics import metrics as _registry
        v = _registry.gauge("serving.server.health").value
        status = {0: "ok", 1: "degraded", 2: "overloaded"}.get(int(v), "ok")
        if status == "ok" and \
                _registry.gauge("slo.active_breaches").value > 0:
            return "degraded"
        return status

    @staticmethod
    def _default_flight() -> Dict[str, Any]:
        """``GET /flight``: build (and, when armed, dump to disk) an
        incident bundle from the process-global flight recorder."""
        from . import flight as _flight
        path = _flight.flight_recorder.dump("endpoint", force=True)
        doc = _flight.flight_recorder.bundle("endpoint")
        if path is not None:
            doc["dumped_to"] = path
        return doc

    @staticmethod
    def _default_profile(seconds: float) -> str:
        """``GET /profile?seconds=N``: one bounded sampling window of
        every thread in this process, collapsed-stack text."""
        from . import profiling as _profiling
        return _profiling.profile_for(seconds)

    @staticmethod
    def _default_analyze(top: int) -> Dict[str, Any]:
        """``GET /analyze?top=N``: critical-path breakdown of the N
        slowest traces in this process's span ring."""
        from . import critical_path as _critical_path
        return _critical_path.analyze(top=top)

    @staticmethod
    def _default_diagnose(since_s: Optional[float],
                          until_s: Optional[float],
                          top: Optional[int]) -> Dict[str, Any]:
        """``GET /diagnose``: automated incident diagnosis over this
        process's wide-event ring, history store and span ring.  Hosts
        with merged fleet stores (tracker/dispatcher/registry) inject a
        fleet-scoped engine instead."""
        from . import diagnose as _diagnose
        return _diagnose.default_engine().endpoint_doc(
            since_s=since_s, until_s=until_s, top=top)

    @property
    def port(self) -> int:
        """The bound port (resolves ``port=0`` ephemeral binds)."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._requested[1]

    # -- endpoint handlers -------------------------------------------------
    # Each returns (status, content_type, body-str); registration via
    # @_endpoint keeps the route vocabulary a single greppable table.

    @staticmethod
    def _json(doc: Any, code: int = 200) -> Tuple[int, str, str]:
        return code, "application/json", json.dumps(doc, default=str)

    @_endpoint("/metrics")
    def _ep_metrics(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        if query.get("format") == "openmetrics":
            # exemplar-bearing rendering needs the raw snapshot, so this
            # branch serves the process-local registry (a tracker's
            # injected merged view stays on the default format)
            from ..utils.metrics import metrics as _registry
            return (200, "application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8",
                    render_openmetrics(_registry.snapshot()))
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                self._metrics_fn())

    @_endpoint("/healthz")
    def _ep_healthz(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        # a health_fn may return the bare status word or a full JSON doc
        # with a "status" key (serving replicas add queue_fraction/
        # inflight so load balancers weight off this one endpoint)
        status = self._health_fn()
        doc = status if isinstance(status, dict) else {"status": status}
        return self._json(doc, _HEALTH_HTTP.get(str(doc.get("status")), 200))

    @_endpoint("/spans")
    def _ep_spans(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        # the ring is lossy: stamp how many records it has evicted so a
        # consumer can tell a quiet process from a saturated window
        return self._json({"spans": self._spans_fn(),
                           "dropped": _trace.recorder.dropped})

    @_endpoint("/events")
    def _ep_events(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        try:
            since = int(query.get("since", "0") or 0)
        except ValueError:
            since = 0
        from . import wide_events as _wide
        return self._json(_wide.events_doc(since))

    @_endpoint("/flight")
    def _ep_flight(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        return self._json(self._flight_fn())

    @_endpoint("/stragglers")
    def _ep_stragglers(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        if self._stragglers_fn is None:
            # worker exporters have no cross-rank view — only the
            # tracker mounts a straggler board
            return (404, "text/plain",
                    "no straggler board here (tracker-only endpoint)\n")
        return self._json(self._stragglers_fn())

    @_endpoint("/leases")
    def _ep_leases(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        if self._leases_fn is None:
            # only the data-service dispatcher owns a lease table
            return (404, "text/plain",
                    "no lease ledger here (dispatcher-only endpoint)\n")
        return self._json(self._leases_fn())

    @_endpoint("/fleet")
    def _ep_fleet(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        if self._fleet_fn is None:
            return (404, "text/plain",
                    "no fleet console here (dispatcher-only endpoint)\n")
        doc = self._fleet_fn()
        fmt = query.get("format", "json")
        if fmt == "html":
            return (200, "text/html; charset=utf-8",
                    render_fleet_board(doc, html=True))
        if fmt == "text":
            return 200, "text/plain; charset=utf-8", render_fleet_board(doc)
        return self._json(doc)

    @_endpoint("/rollouts")
    def _ep_rollouts(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        if self._rollouts_fn is None:
            # only a replica registry (or a router proxying one) owns a
            # rollout ledger
            return (404, "text/plain",
                    "no rollout ledger here (registry/router endpoint)\n")
        return self._json(self._rollouts_fn())

    @_endpoint("/profile")
    def _ep_profile(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        try:
            seconds = float(query.get("seconds", "1"))
        except ValueError:
            seconds = 1.0
        text = self._profile_fn(seconds)
        from . import profiling as _profiling
        if query.get("diff") in ("1", "true", "yes"):
            # fresh window diffed against the last plain scrape — the
            # plain scrape IS the baseline recorder, so any periodic
            # profile collection arms this for free
            got = _profiling.baseline()
            if got is None:
                return (404, "text/plain; charset=utf-8",
                        "no baseline profile recorded yet — scrape "
                        "/profile (without diff=1) during a healthy "
                        "window first\n")
            return (200, "text/plain; charset=utf-8",
                    _profiling.incident_profile_diff(text))
        _profiling.record_baseline(text)
        return 200, "text/plain; charset=utf-8", text

    @_endpoint("/timeline")
    def _ep_timeline(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        from . import timeseries as _timeseries
        fn = self._timeline_fn or _timeseries.history.timeline
        metric = query.get("metric") or None
        since: Optional[float] = None
        raw_since = query.get("since")
        if raw_since:
            from .slo import parse_duration
            since = parse_duration(raw_since)   # "300", "5m", "90s" all ok
        doc = fn(metric, since)
        if query.get("format") == "text":
            return (200, "text/plain; charset=utf-8",
                    _timeseries.render_timeline_text(doc))
        exs = _registry_exemplars(metric)
        if exs:
            # exemplar trace ids bridge the aggregate view to /spans:
            # "the p99 spiked" → "this trace is the p99"
            doc = dict(doc)
            doc["exemplars"] = exs
        return self._json(doc)

    @_endpoint("/analyze")
    def _ep_analyze(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        try:
            top = int(query.get("top", "5"))
        except ValueError:
            top = 5
        doc = self._analyze_fn(top)
        if query.get("format") == "text":
            from . import critical_path as _critical_path
            return (200, "text/plain; charset=utf-8",
                    _critical_path.render_text(doc))
        exs = _registry_exemplars()
        if exs:
            doc = dict(doc)
            doc["exemplars"] = exs
        return self._json(doc)

    @_endpoint("/diagnose")
    def _ep_diagnose(self, query: Dict[str, str]) -> Tuple[int, str, str]:
        from .slo import parse_duration
        since_s = until_s = None
        raw = query.get("since")
        if raw:
            since_s = parse_duration(raw)     # "60", "5m", "90s" all ok
        raw = query.get("until")
        if raw:
            until_s = parse_duration(raw)
        top: Optional[int] = None
        try:
            top = int(query["top"]) if query.get("top") else None
        except ValueError:
            top = None
        doc = self._diagnose_fn(since_s, until_s, top)
        if query.get("format") == "text":
            from . import diagnose as _diagnose
            return (200, "text/plain; charset=utf-8",
                    _diagnose.render_text(doc))
        return self._json(doc)

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        # default /timeline serves the process-global history store;
        # mounting an exporter is the "observability on" gesture, so it
        # also starts the sampler (DMLC_TIMELINE=0 opts out).  Hosts
        # that inject a fleet store (tracker/dispatcher) own its
        # lifecycle themselves.
        if self._timeline_fn is None:
            from . import timeseries as _timeseries
            _timeseries.maybe_start_sampler()
            self._timeline_fn = _timeseries.history.timeline
        # same gesture arms tail sampling (exact no-op unless
        # DMLC_TRACE_SAMPLE is set) so every tier that mounts an
        # exporter shares one coordination-free sampling config
        from . import sampling as _sampling
        _sampling.maybe_install_from_env()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # route into our logger
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):   # noqa: N802 (http.server API)
                path, _, rawq = self.path.partition("?")
                query = {k: vs[-1] for k, vs
                         in urllib.parse.parse_qs(rawq).items()}
                handler = _ROUTES.get(path)
                try:
                    if handler is None:
                        code, ctype, body = 404, "text/plain", "not found\n"
                    else:
                        code, ctype, body = getattr(outer, handler)(query)
                except Exception as e:   # scrape must never kill the server
                    code, ctype, body = (500, "text/plain",
                                         f"exporter error: {e}\n")
                self._send(code, ctype, body.encode("utf-8")
                           if isinstance(body, str) else body)

        self._httpd = ThreadingHTTPServer(self._requested, Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dmlc-telemetry",
            daemon=True)
        self._thread.start()
        log_info("telemetry exporter listening on %s:%d (%s)",
                 self._requested[0], self.port,
                 " ".join(sorted(_ROUTES)))
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def maybe_start_from_env() -> Optional[TelemetryServer]:
    """Start a process-local exporter when ``DMLC_METRICS_PORT`` is set
    (0 = ephemeral).  Returns the running server or None.  Startup
    failures (port in use) are logged, not raised — telemetry must not
    take the workload down.

    Also activates the env-driven observability companions — the flight
    recorder (``DMLC_FLIGHT_DIR``), the SLO monitor (``DMLC_SLO_SPEC``)
    and tail sampling (``DMLC_TRACE_SAMPLE``) — each an exact no-op when
    its env is unset, so one call is the whole "observability on" switch
    for any process.
    """
    from . import anomaly as _anomaly
    from . import flight as _flight
    from . import sampling as _sampling
    _flight.maybe_arm_from_env()
    _anomaly.maybe_monitor_from_env()
    _sampling.maybe_install_from_env()
    port = get_env("DMLC_METRICS_PORT", -1)
    if port < 0:
        return None
    try:
        return TelemetryServer(port=port).start()
    except OSError as e:
        log_warning("telemetry exporter failed to bind port %d: %s", port, e)
        return None
