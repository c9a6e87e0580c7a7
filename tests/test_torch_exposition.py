"""The port's exporter (``telemetry/exposition.py``) and fleet aggregation
(``telemetry/aggregate.py``), held against the JAX package's.

* The renderers are byte-equal (``==``) on one snapshot fed to both
  packages: the golden, sanitised, hostile-label, single-``# TYPE`` and
  conformance cases of the JAX ``tests/test_telemetry.py`` and
  ``tests/test_timeline.py``, the HELP catalog, the OpenMetrics page
  with exemplars, a live registry's page, and ``render_fleet_board`` as
  text and html.
* ``merge_states``, ``state_to_snapshot``, ``render_fleet`` and
  ``ResetGuard`` give equal results on equal rank states (exact).
* Over HTTP, ``TelemetryServer`` serves ``/metrics`` (both formats),
  ``/healthz`` (each health word at the JAX status code, 503 when
  overloaded), ``/spans`` with ``dropped``, ``/timeline`` as json and
  text, the four host-injected endpoints' 404s with the JAX bodies, and
  ``/profile`` (the 404 before a baseline, the plain and the diff
  windows), ``/analyze`` and ``/diagnose`` (json and text) at the JAX
  statuses, content types and document keys, and no route at 501; each
  injected callback (``flight_fn``, ``profile_fn``, ``analyze_fn``,
  ``diagnose_fn``) serves its endpoint as the JAX exporter's does
  (``/events`` and ``/flight`` are held against the JAX exporter in
  ``tests/test_torch_wide_events.py`` and ``tests/test_torch_flight.py``).
* ``maybe_start_from_env`` starts an exporter on ``DMLC_METRICS_PORT``,
  logs and returns None on a failed bind, and arms the flight recorder
  on ``DMLC_FLIGHT_DIR`` and the tail sampler on ``DMLC_TRACE_SAMPLE``.

Every exporter a test starts starts the process-wide history sampler;
the ``history`` fixture stops both packages' samplers around each test,
empties both history stores before it (:func:`clear_history`), forgets
both packages' last breach, baseline profile and watchdog buckets
(:func:`clear_incident_memory`), and puts back the process-wide incident state (:func:`incident_state`:
both packages' installed tail samplers and flight recorders, the
exception hooks and the SIGTERM and SIGABRT handlers).
:func:`scrape` bounds each connect and retries one that timed out (a
loopback connect can hang).  Inputs come from seeded numpy generators.
"""

import contextlib
import http.client
import importlib
import json
import signal
import socket
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.telemetry import aggregate as jaggregate  # noqa: E402
from dmlc_core_tpu.telemetry import anomaly as janomaly  # noqa: E402
from dmlc_core_tpu.telemetry import diagnose as jdiagnose  # noqa: E402
from dmlc_core_tpu.telemetry import exposition as jexposition  # noqa: E402
from dmlc_core_tpu.telemetry import flight as jflight  # noqa: E402
from dmlc_core_tpu.telemetry import profiling as jprofiling  # noqa: E402
from dmlc_core_tpu.telemetry import timeseries as jtimeseries  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.telemetry import xla_introspect as jxla  # noqa: E402
from dmlc_core_tpu_torch.telemetry import aggregate  # noqa: E402
from dmlc_core_tpu_torch.telemetry import anomaly  # noqa: E402
from dmlc_core_tpu_torch.telemetry import diagnose  # noqa: E402
from dmlc_core_tpu_torch.telemetry import exposition  # noqa: E402
from dmlc_core_tpu_torch.telemetry import flight  # noqa: E402
from dmlc_core_tpu_torch.telemetry import graph_introspect  # noqa: E402
from dmlc_core_tpu_torch.telemetry import profiling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import sampling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import timeseries  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

#: the endpoints of ROADMAP A.12.e (the profiler, the critical path and the
#: diagnosis), each request with the keys its JSON document carries
A12E = {"/profile?diff=1": None, "/profile?seconds=0.05": None,
        "/profile?seconds=0.05&diff=1": None,
        "/analyze?top=3": {"schema", "ts", "traces_seen", "top",
                           "self_time_us"},
        "/analyze?top=3&format=text": None,
        "/diagnose?since=1": {"schema", "ts", "window", "trigger",
                              "analyzers", "suspects", "wall_ms"},
        "/diagnose?since=5m&top=2&format=text": None}
INJECTED = ("/stragglers", "/leases", "/fleet", "/rollouts")


def scrape(port, path, host="127.0.0.1", timeout=30.0, connect_s=2.0,
           tries=8):
    """``GET http://host:port/path`` → (status, content type, body).  The
    connect is bounded apart and made again when it times out; a refused
    connect raises at once."""
    for _ in range(tries):
        conn = http.client.HTTPConnection(host, port, timeout=connect_s)
        try:
            conn.connect()
        except (socket.timeout, TimeoutError):
            conn.close()
            continue
        try:
            conn.sock.settimeout(timeout)
            conn.request("GET", path)
            r = conn.getresponse()
            return r.status, r.getheader("Content-Type"), \
                r.read().decode("utf-8")
        finally:
            conn.close()
    raise TimeoutError(f"{tries} connects to {host}:{port} timed out")


def clear_history():
    """Empty both packages' process-wide history stores: their series and
    the previous samples their counter rates are taken against.  A store
    sampled by an earlier test otherwise counts the registry resets since
    as ``telemetry.counter_resets``, and serves its ``root_ms`` p95 to a
    tail sampler's adaptive slow threshold."""
    for store in (timeseries.history, jtimeseries.history):
        with store._lock:
            store._series.clear()
            store._prev.clear()
            store._prev_stage.clear()
            store._dropped.clear()


def clear_incident_memory():
    """Forget, in both packages, what an earlier test left for a later
    diagnosis, profile diff or capture to read: the last breach and its
    diagnosis, the baseline profile, and the watchdog's buckets and
    alert."""
    for mod in (diagnose, jdiagnose):
        mod._last_breach = mod._last_doc = None
    for mod in (profiling, jprofiling):
        mod._baseline = None
    for wd in (graph_introspect.watchdog, jxla.watchdog):
        with wd._lock:
            wd._buckets.clear()
            wd._alerted = False


def stop_samplers():
    """Stop both packages' process-wide history samplers and SLO
    monitors, and clear the breach gauges a monitor may have left set."""
    timeseries.history.stop()
    jtimeseries.history.stop()
    for m in (tmetrics.metrics, jmetrics.metrics):
        m.gauge("slo.active_breaches").set(0)
    for mod in (anomaly, janomaly):
        if mod._env_monitor is not None:
            mod._env_monitor.stop()


#: what a flight recorder's arming and install() change on the instance
_RECORDER_STATE = ("_dir", "_installed", "_prev_excepthook",
                   "_prev_thread_hook", "_min_interval", "_last_dump")


@contextlib.contextmanager
def incident_state():
    """Put back, after the block, the process-wide state that arming a
    flight recorder or installing a tail sampler changes, in both
    packages: each trace module's sampler, each global recorder's arming,
    hooks, rate limit and rings, ``sys.excepthook``,
    ``threading.excepthook`` and the SIGTERM and SIGABRT handlers (the
    signal handlers only from the main thread, where pytest runs)."""
    signums = [getattr(signal, n) for n in ("SIGTERM", "SIGABRT")
               if hasattr(signal, n)]
    hooks = (sys.excepthook, threading.excepthook)
    handlers = {n: signal.getsignal(n) for n in signums}
    samplers = {mod: mod._sampler for mod in (teltrace, jtrace)}
    recorders = {rec: {k: getattr(rec, k) for k in _RECORDER_STATE}
                 for rec in (flight.flight_recorder, jflight.flight_recorder)}
    try:
        yield
    finally:
        sys.excepthook, threading.excepthook = hooks
        for n, h in handlers.items():
            signal.signal(n, h)
        for mod, s in samplers.items():
            mod._sampler = s
        for rec, state in recorders.items():
            for k, v in state.items():
                setattr(rec, k, v)
            rec._notes.clear()
            rec._snaps.clear()


@pytest.fixture(autouse=True)
def history():
    stop_samplers()
    clear_history()
    clear_incident_memory()
    with incident_state():
        yield timeseries.history
    stop_samplers()
    clear_incident_memory()


@pytest.fixture()
def no_samplers(monkeypatch):
    """No tail sampler in either package, so every exemplar with a trace
    id is rendered by both."""
    monkeypatch.setattr(teltrace, "_sampler", None)
    monkeypatch.setattr(jtrace, "_sampler", None)


# ---------------------------------------------------------------------------
# the renderers, byte for byte
# ---------------------------------------------------------------------------

def _golden(reg):
    reg.counter("reqs.total").add(7)
    reg.gauge("queue.depth").set(3)
    h = reg.histogram("lat_s")
    for v in [0.1] * 99 + [1.0]:
        h.observe(v)


def _conformance(reg):
    """Every metric type, with seeded values (tests/test_timeline.py's
    conformance golden, widened)."""
    rng = np.random.default_rng(1)
    reg.counter("telemetry.counter_resets").add(2)
    reg.gauge("slo.active_breaches").set(1)
    reg.gauge("x.level").set(float(rng.normal()))
    h = reg.histogram("x.lat_s")
    for v in rng.exponential(0.01, 500):
        h.observe(float(v))
    reg.throughput("x.bytes").add(int(rng.integers(1, 10_000)))
    with reg.stage("x.step").time():
        pass
    reg.counter("weird-name.1").add(int(rng.integers(1, 100)))
    reg.counter("9lives").add(1)


SNAPSHOTS = {
    "golden": _golden,
    "sanitised": lambda reg: reg.counter("weird-name.1").add(1),
    "hostile": lambda reg: reg.counter("c").add(1),
    "conformance": _conformance,
}
LABELS = {
    "golden": None,
    "sanitised": {"rank": "3"},
    "hostile": {"path": 'C:\\tmp\n"x"', "host": "plain"},
    "conformance": None,
}


def _snapshot(case):
    reg = tmetrics.MetricsRegistry()
    SNAPSHOTS[case](reg)
    return reg.snapshot()


@pytest.mark.parametrize("help_map", [None, {}], ids=["catalog", "no_help"])
@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_render_prometheus_is_byte_equal(case, help_map):
    snap = _snapshot(case)
    got = exposition.render_prometheus(snap, labels=LABELS[case],
                                       help_map=help_map)
    assert got == jexposition.render_prometheus(snap, labels=LABELS[case],
                                                help_map=help_map)
    assert got.endswith("\n")


def test_golden_lines_and_escapes():
    """The JAX golden's lines, on the port's renderer."""
    lines = exposition.render_prometheus(_snapshot("golden")).splitlines()
    for want in ("# TYPE dmlc_reqs_total_total counter",
                 "dmlc_reqs_total_total 7", "dmlc_queue_depth 3",
                 "# TYPE dmlc_lat_s summary", 'dmlc_lat_s{quantile="0.5"} 0.1',
                 "dmlc_lat_s_count 100"):
        assert want in lines
    text = exposition.render_prometheus(_snapshot("sanitised"),
                                        labels=LABELS["sanitised"])
    assert 'dmlc_weird_name_1_total{rank="3"} 1' in text
    text = exposition.render_prometheus(_snapshot("hostile"),
                                        labels=LABELS["hostile"])
    assert ('dmlc_c_total{host="plain",path="C:\\\\tmp\\n\\"x\\""} 1'
            in text.splitlines())


def test_render_series_single_type_header_is_byte_equal():
    r0, r1 = tmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    r0.counter("c").add(1)
    r1.counter("c").add(2)
    _conformance(r1)
    series = [({"rank": "0"}, r0.snapshot()), ({"rank": "1"}, r1.snapshot()),
              (None, r1.snapshot())]
    got = exposition.render_series(series)
    assert got == jexposition.render_series(series)
    assert got.count("# TYPE dmlc_c_total counter") == 1
    assert exposition.render_series(series, prefix="") == \
        jexposition.render_series(series, prefix="")
    assert exposition.render_series(series, prefix="x", help_map={}) == \
        jexposition.render_series(series, prefix="x", help_map={})


def test_help_lines_come_from_the_inventory():
    helps = exposition._help_catalog()
    assert helps == jexposition._help_catalog()
    assert "slo.active_breaches" in helps
    page = exposition.render_prometheus(_snapshot("conformance"))
    assert ("# HELP dmlc_slo_active_breaches "
            + exposition._escape_help(helps["slo.active_breaches"])) in page


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_render_openmetrics_is_byte_equal(case, no_samplers):
    snap = _snapshot(case)
    got = exposition.render_openmetrics(snap, labels=LABELS[case])
    assert got == jexposition.render_openmetrics(snap, labels=LABELS[case])
    assert got.endswith("# EOF\n")


def test_openmetrics_exemplars_are_byte_equal(no_samplers):
    """Exemplars of observations made inside the port's traces ride the
    ``_bucket`` lines, identically in both renderers."""
    reg = tmetrics.MetricsRegistry()
    h = reg.histogram("ex.lat_ms")
    rng = np.random.default_rng(2)
    ids = []
    for v in rng.exponential(10.0, 40):
        with teltrace.span("ex-op") as sp:
            h.observe(float(v))
        ids.append(teltrace.format_id(sp.trace_id))
    h.observe(1.0)                       # untraced: no exemplar
    snap = reg.snapshot()
    assert snap["ex.lat_ms"]["exemplars"]
    got = exposition.render_openmetrics(snap)
    assert got == jexposition.render_openmetrics(snap)
    ex_lines = [ln for ln in got.splitlines() if " # {trace_id=" in ln]
    assert ex_lines and all(ln.startswith("dmlc_ex_lat_ms_bucket")
                            for ln in ex_lines)
    assert all(any(i in ln for i in ids) for ln in ex_lines)


def test_an_exemplar_without_a_kept_trace_is_not_rendered(monkeypatch):
    """With a tail sampler installed only a kept trace's exemplar shows
    (any object in the trace module's hook with a ``was_kept``)."""
    class Verdicts:
        def was_kept(self, hexid):
            return hexid == "00000000000000aa"
    monkeypatch.setattr(teltrace, "_sampler", Verdicts())
    assert exposition._exemplar_kept("00000000000000aa")
    assert not exposition._exemplar_kept("00000000000000bb")
    assert not exposition._exemplar_kept(None)
    monkeypatch.setattr(teltrace, "_sampler", None)
    assert exposition._exemplar_kept("00000000000000bb")


def test_a_live_registry_page_is_byte_equal(no_samplers):
    """The port's own registry after spans, histograms and counters:
    one snapshot, both renderers, both formats."""
    rng = np.random.default_rng(3)
    for v in rng.random(64):
        with teltrace.span("live-op"):
            tmetrics.metrics.histogram("test.exposition.live_s").observe(
                float(v))
    tmetrics.metrics.counter("test.exposition.hits").add(5)
    snap = tmetrics.metrics.snapshot()
    assert exposition.render_prometheus(snap) == \
        jexposition.render_prometheus(snap)
    assert exposition.render_openmetrics(snap) == \
        jexposition.render_openmetrics(snap)


FLEET_DOCS = {
    "data": {"workers": {"w1": {"addr": "10.0.0.1:9000", "alive": True,
                                "heartbeat_age_s": 0.42, "mb_s": 123.45,
                                "live_leases": 3, "shards": 8},
                         "w0": {"addr": "10.0.0.2:9000", "alive": False,
                                "heartbeat_age_s": 31.0, "mb_s": 0.0},
                         "w2": {"addr": "10.0.0.3:9000", "straggler": True,
                                "heartbeat_age_s": 1.5, "mb_s": 7.25}},
             "consumers": {"c0": {"backlog": 12, "age_s": 3.25}},
             "datasets": {"ds": {"epoch": 2, "pending": 5, "granted": 3,
                                 "completed": 40}}},
    "serving": {"replicas": {"r0": {"model_id": "ctr", "addr": "h:1",
                                    "health": "ok", "heartbeat_age_s": 0.2,
                                    "queue_fraction": 0.125, "inflight": 3,
                                    "step": 7},
                             "r1": {"model_id": "ctr", "alive": False},
                             "r2": {"model_id": "ctr", "straggler": True,
                                    "heartbeat_age_s": "?"}},
                "models": {"ctr": {"ckpt_dir": "s3://b/ck", "step": 7,
                                   "replicas": ["r0", "r1"]}}},
    "empty": {},
}


@pytest.mark.parametrize("html", [False, True], ids=["text", "html"])
@pytest.mark.parametrize("doc", sorted(FLEET_DOCS))
def test_render_fleet_board_is_byte_equal(doc, html):
    got = exposition.render_fleet_board(FLEET_DOCS[doc], html=html)
    assert got == jexposition.render_fleet_board(FLEET_DOCS[doc], html=html)
    if html:
        assert got.startswith("<!doctype html>") and "&lt;" not in got[:20]


# ---------------------------------------------------------------------------
# fleet aggregation on equal rank states
# ---------------------------------------------------------------------------

def _rank_states(seed=4, ranks=3):
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(ranks):
        reg = tmetrics.MetricsRegistry()
        reg.counter("reqs").add(int(rng.integers(1, 100)))
        reg.gauge("health").set(int(rng.integers(0, 3)))
        h = reg.histogram("lat_s")
        for v in rng.exponential(0.01, int(rng.integers(10, 200))):
            h.observe(float(v))
        reg.throughput("bytes").add(int(rng.integers(1, 1 << 20)))
        st = reg.stage("step")
        for _ in range(int(rng.integers(1, 5))):
            with st.time():
                pass
        # a type skew across ranks: dropped from the merged view
        if r % 2:
            reg.counter("skewed").add(1)
        else:
            reg.gauge("skewed").set(1)
        out[str(r)] = reg.state()
    return out


def test_merge_states_and_snapshots_equal_the_jax_ones():
    per_rank = _rank_states()
    merged = aggregate.merge_states(per_rank)
    assert merged == jaggregate.merge_states(per_rank)
    assert "skewed" not in merged
    assert merged["reqs"]["value"] == sum(s["reqs"]["value"]
                                          for s in per_rank.values())
    for state in per_rank.values():
        assert aggregate.state_to_snapshot(state) == \
            jaggregate.state_to_snapshot(state)


def test_render_fleet_is_byte_equal():
    per_rank = _rank_states(seed=5, ranks=4)
    own = _snapshot("golden")
    got = aggregate.render_fleet(per_rank, own_snapshot=own)
    assert got == jaggregate.render_fleet(per_rank, own_snapshot=own)
    assert 'rank="tracker"' in got and 'rank="3"' in got
    assert aggregate.render_fleet(per_rank) == \
        jaggregate.render_fleet(per_rank)


def test_reset_guard_equals_the_jax_one():
    """Pushes of three ranks with restarts (counters falling), a
    forgotten rank, and non-monotonic gauges: every folded state and the
    reset counts are equal."""
    rng = np.random.default_rng(6)
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    guards = (aggregate.ResetGuard(registry=regs[0]),
              jaggregate.ResetGuard(registry=regs[1]))
    level = {r: [0.0, 0, 0.0, 0] for r in "012"}
    for push in range(30):
        rank = "012"[push % 3]
        lv = level[rank]
        if rng.random() < 0.15:          # the rank restarted
            lv[:] = [0.0, 0, 0.0, 0]
        lv[0] += float(rng.integers(0, 10))
        lv[1] += int(rng.integers(0, 5))
        lv[2] += float(rng.random())
        lv[3] += int(rng.integers(0, 50))
        state = {"c": {"type": "counter", "value": lv[0]},
                 "st": {"type": "stage", "count": lv[1],
                        "total_sec": lv[2], "mean_sec": 0.0},
                 "tp": {"type": "throughput", "total": lv[3], "rate": 1.0},
                 "h": {"type": "histogram", "count": lv[1], "p50": 0.1},
                 "g": {"type": "gauge", "value": float(rng.normal())},
                 "junk": 3}
        if push == 20:
            for g in guards:
                g.forget("1")
        assert guards[0].fold(rank, state) == guards[1].fold(rank, state)
    resets = [r.counter("telemetry.counter_resets").value for r in regs]
    assert resets[0] == resets[1] > 0


# ---------------------------------------------------------------------------
# the exporter over HTTP
# ---------------------------------------------------------------------------

def _servers(**kw):
    return (exposition.TelemetryServer(port=0, host="127.0.0.1",
                                       **kw).start(),
            jexposition.TelemetryServer(port=0, host="127.0.0.1",
                                        **kw).start())


def test_exporter_serves_metrics_spans_and_timeline():
    tmetrics.metrics.counter("telemetry.test.hits").add(2)
    with teltrace.span("exporter-smoke"):
        pass
    srv, jsrv = _servers()
    try:
        assert timeseries.history.running        # start() started it
        code, ctype, body = scrape(srv.port, "/metrics")
        jcode, jctype, _ = scrape(jsrv.port, "/metrics")
        assert (code, ctype) == (jcode, jctype) == (
            200, "text/plain; version=0.0.4; charset=utf-8")
        assert "dmlc_telemetry_test_hits_total 2" in body
        got = [scrape(p, "/metrics?format=openmetrics")
               for p in (srv.port, jsrv.port)]
        assert got[0][:2] == got[1][:2]
        assert got[0][2].endswith("# EOF\n")
        code, ctype, body = scrape(srv.port, "/spans")
        assert (code, ctype) == (200, "application/json")
        doc = json.loads(body)
        assert set(doc) == set(json.loads(scrape(jsrv.port, "/spans")[2]))
        assert doc["dropped"] == teltrace.recorder.dropped
        assert any(s["name"] == "exporter-smoke" for s in doc["spans"])
        # the timeline: the index, one metric as json and as text
        timeseries.history.sample_once()
        timeseries.history.sample_once()
        index = json.loads(scrape(srv.port, "/timeline")[2])
        jindex = json.loads(scrape(jsrv.port, "/timeline")[2])
        # (exemplars ride along where a registry histogram holds some)
        assert set(index) - {"exemplars"} == set(jindex) - {"exemplars"}
        assert "telemetry.test.hits.rate" in index["series"]
        code, ctype, body = scrape(
            srv.port, "/timeline?metric=telemetry.test.hits&since=5m")
        doc = json.loads(body)
        assert code == 200 and doc["metric"] == "telemetry.test.hits"
        assert doc["series"]["telemetry.test.hits.rate"]["tiers"]
        code, ctype, body = scrape(
            srv.port, "/timeline?metric=telemetry.test.hits&format=text")
        assert (code, ctype) == (200, "text/plain; charset=utf-8")
        assert body.startswith("telemetry.test.hits.rate: last=")
    finally:
        srv.stop()
        jsrv.stop()


@pytest.mark.parametrize("status", ["ok", "degraded", "overloaded", "doc"])
def test_healthz_codes_equal_the_jax_exporter(status):
    def health():
        if status == "doc":
            return {"status": "overloaded", "queue_fraction": 1.0}
        return status
    srv, jsrv = _servers(health_fn=health)
    try:
        got = scrape(srv.port, "/healthz")
        assert got == scrape(jsrv.port, "/healthz")
        assert got[0] == (503 if status in ("overloaded", "doc") else 200)
        assert json.loads(got[2])["status"] == \
            ("overloaded" if status == "doc" else status)
    finally:
        srv.stop()
        jsrv.stop()


def test_default_healthz_degrades_on_a_breach():
    srv = exposition.TelemetryServer(port=0, host="127.0.0.1").start()
    try:
        tmetrics.metrics.gauge("serving.server.health").set(0)
        assert json.loads(scrape(srv.port, "/healthz")[2]) == \
            {"status": "ok"}
        tmetrics.metrics.gauge("slo.active_breaches").set(1)
        assert json.loads(scrape(srv.port, "/healthz")[2]) == \
            {"status": "degraded"}
        tmetrics.metrics.gauge("serving.server.health").set(2)
        assert scrape(srv.port, "/healthz")[0] == 503
    finally:
        tmetrics.metrics.gauge("serving.server.health").set(0)
        srv.stop()


def test_not_found_and_not_ported_endpoints():
    """The 404s are the JAX exporter's; A.12.e's endpoints answer at the
    JAX statuses and types, with the JAX document keys (each package
    reads its own span ring and stores), and no route answers 501."""
    for m in (tmetrics.metrics, jmetrics.metrics):
        m.reset()       # no exemplar for /analyze to attach
    srv, jsrv = _servers()
    try:
        for path in INJECTED + ("/nope",):
            got = scrape(srv.port, path)
            assert got[0] == 404
            assert got == scrape(jsrv.port, path)
        with teltrace.span("a12e.root"):
            with teltrace.span("a12e.child"):
                pass
        with jtrace.span("a12e.root"):
            with jtrace.span("a12e.child"):
                pass
        for path, keys in A12E.items():
            got, jgot = scrape(srv.port, path), scrape(jsrv.port, path)
            assert got[:2] == jgot[:2], path
            assert got[0] == (404 if path == "/profile?diff=1" else 200)
            if keys is not None:
                doc, jdoc = json.loads(got[2]), json.loads(jgot[2])
                assert set(doc) == set(jdoc) == keys
                assert doc["schema"] == jdoc["schema"]
            elif got[0] == 404:
                assert got == jgot
            elif "diff=1" in path:
                assert got[2].startswith("# profile diff: baseline @ ")
                assert jgot[2].startswith("# profile diff: baseline @ ")
        assert json.loads(scrape(srv.port, "/diagnose?since=1")[2])[
            "trigger"] == {"kind": "explicit"}
        assert scrape(srv.port, "/analyze?top=3&format=text")[2].startswith(
            "critical path over top ")
        assert set(exposition._ROUTES) == set(jexposition._ROUTES)
        for path in exposition._ROUTES:
            assert scrape(srv.port, path + "?seconds=0.05")[0] != 501, path
    finally:
        srv.stop()
        jsrv.stop()


def test_injected_fleet_endpoints_serve_as_the_jax_ones():
    doc = FLEET_DOCS["serving"]
    kw = dict(fleet_fn=lambda: doc, leases_fn=lambda: {"leases": [1]},
              rollouts_fn=lambda: {"rollouts": []},
              stragglers_fn=lambda: {"stragglers": ["3"]})
    srv, jsrv = _servers(**kw)
    try:
        for path in ("/fleet", "/fleet?format=text", "/fleet?format=html",
                     "/leases", "/rollouts", "/stragglers"):
            got = scrape(srv.port, path)
            assert got[0] == 200 and got == scrape(jsrv.port, path)
    finally:
        srv.stop()
        jsrv.stop()


#: each injectable callback: the request that reaches it and what it
#: returns (``profile_fn`` takes the window, ``analyze_fn`` the top,
#: ``diagnose_fn`` since, until and top)
CALLBACKS = {
    "flight_fn": ("/flight", lambda: {"schema": "injected"}),
    "profile_fn": ("/profile?seconds=2", lambda seconds: f"a;b {seconds}"),
    "analyze_fn": ("/analyze?top=7",
                   lambda top: {"schema": "injected", "top": top}),
    "diagnose_fn": ("/diagnose?since=5m&until=30&top=2",
                    lambda since_s, until_s, top: {
                        "schema": "injected",
                        "args": [since_s, until_s, top]}),
}


@pytest.mark.parametrize("kw,item", [("flight_fn", "A.12.d"),
                                     ("profile_fn", "A.12.e"),
                                     ("analyze_fn", "A.12.e"),
                                     ("diagnose_fn", "A.12.e")])
def test_unported_callbacks_are_refused(kw, item):
    """Each callback (``flight_fn`` of A.12.d; ``profile_fn``,
    ``analyze_fn`` and ``diagnose_fn`` of A.12.e) is taken and serves its
    endpoint as the JAX exporter's does, byte for byte."""
    path, fn = CALLBACKS[kw]
    for m in (tmetrics.metrics, jmetrics.metrics):
        m.reset()       # no exemplar for /analyze to attach
    srv, jsrv = _servers(**{kw: fn})
    try:
        got = scrape(srv.port, path)
        assert got[0] == 200 and got == scrape(jsrv.port, path), item
        if kw == "profile_fn":
            assert got[2] == "a;b 2.0" == profiling.baseline()[0]
        elif kw == "diagnose_fn":
            assert json.loads(got[2])["args"] == [300.0, 30.0, 2]
        elif kw == "analyze_fn":
            assert json.loads(got[2]) == {"schema": "injected", "top": 7}
    finally:
        srv.stop()
        jsrv.stop()


def test_maybe_start_from_env(monkeypatch):
    for key in ("DMLC_METRICS_PORT", "DMLC_SLO_SPEC", "DMLC_FLIGHT_DIR",
                "DMLC_TRACE_SAMPLE"):
        monkeypatch.delenv(key, raising=False)
    assert exposition.maybe_start_from_env() is None
    monkeypatch.setenv("DMLC_METRICS_PORT", "0")
    srv = exposition.maybe_start_from_env()
    assert srv is not None
    try:
        assert scrape(srv.port, "/metrics")[0] == 200
        # a port in use: logged, None, the workload goes on
        monkeypatch.setenv("DMLC_METRICS_PORT", str(srv.port))
        assert exposition.maybe_start_from_env() is None
    finally:
        srv.stop()


def test_maybe_start_from_env_arms_the_slo_monitor(monkeypatch):
    monkeypatch.delenv("DMLC_METRICS_PORT", raising=False)
    monkeypatch.setenv("DMLC_SLO_SPEC", "q.depth:max=1")
    assert exposition.maybe_start_from_env() is None
    mon = anomaly._env_monitor
    assert mon is not None and mon._thread is not None
    assert [r.name for r in mon.rules] == ["q.depth:max=1"]


@pytest.mark.parametrize("env", ["DMLC_FLIGHT_DIR", "DMLC_TRACE_SAMPLE"])
def test_maybe_start_from_env_refuses_what_is_not_ported(monkeypatch, env,
                                                         tmp_path):
    """Ported now (A.12.d): ``DMLC_FLIGHT_DIR`` arms the flight recorder
    and installs its hooks, ``DMLC_TRACE_SAMPLE`` installs the tail
    sampler at that floor; the exporter starts either way, and the JAX
    call does the same to the JAX package's."""
    for key in ("DMLC_FLIGHT_DIR", "DMLC_TRACE_SAMPLE", "DMLC_SLO_SPEC"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DMLC_METRICS_PORT", "0")
    monkeypatch.setenv(env, str(tmp_path) if env == "DMLC_FLIGHT_DIR"
                       else "0.5")
    flight.flight_recorder.disarm()
    jflight.flight_recorder.disarm()
    sampling.uninstall()
    jtrace.set_sampler(None)
    srv = exposition.maybe_start_from_env()
    jsrv = jexposition.maybe_start_from_env()
    try:
        assert srv is not None and jsrv is not None
        assert scrape(srv.port, "/metrics")[0] == 200
        if env == "DMLC_FLIGHT_DIR":
            for rec in (flight.flight_recorder, jflight.flight_recorder):
                assert rec.armed and rec._dir == str(tmp_path)
                assert rec._installed
            assert sampling.get_sampler() is None
        else:
            s, js = sampling.get_sampler(), jtrace.get_sampler()
            assert isinstance(s, sampling.TailSampler)
            assert s.floor == js.floor == 0.5
            assert not flight.flight_recorder.armed
    finally:
        srv.stop()
        jsrv.stop()
