"""The port's SLO rules and monitors (``telemetry/anomaly.py``,
``telemetry/slo.py``), its straggler board, and the prediction server
with the exporter and ``DMLC_SLO_SPEC``, held against the JAX package.

* ``parse_slo_spec`` gives equal rule names in both grammars (plain, and
  the burn-rate superset), and each bad spec raises in both (exact).
* ``SloRule.check``, ``SloMonitor.evaluate_once``, ``BurnRateRule.check``
  and ``BurnRateMonitor.evaluate_once`` fire the same breaches, and set
  the same ``slo.active_breaches`` / ``slo.breaches``, on the same seeded
  registries and series (exact).
* ``StragglerBoard`` flags the same ranks with the same z-scores (exact).
* The port's monitor dumps through the port's flight recorder, looked up
  by the port's module name, never through the JAX one.
* ``PredictionServer(metrics_port=0)`` of both packages on the same
  requests: equal ``/healthz`` keys and status; the port's ``/metrics``
  families are the JAX server's (:data:`NOT_PORTED_FAMILIES` is empty),
  the compile watchdog's ``dmlc_xla_*`` among them, plus
  :data:`PORT_ONLY_FAMILIES`.
* A rule that must fire degrades ``/healthz`` and ``health`` and freezes
  the serving autotuner, in both packages.

The ``history`` fixture stops both packages' history samplers and
clears their breach gauges around each test.
"""

import importlib
import json
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.serving import client as jclient  # noqa: E402
from dmlc_core_tpu.serving import server as jserver  # noqa: E402
from dmlc_core_tpu.telemetry import anomaly as janomaly  # noqa: E402
from dmlc_core_tpu.telemetry import slo as jslo  # noqa: E402
from dmlc_core_tpu.telemetry import timeseries as jts  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu_torch.serving import client as tclient  # noqa: E402
from dmlc_core_tpu_torch.serving import server as tserver  # noqa: E402
from dmlc_core_tpu_torch.telemetry import anomaly  # noqa: E402
from dmlc_core_tpu_torch.telemetry import slo  # noqa: E402
from dmlc_core_tpu_torch.telemetry import timeseries as ts  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from test_torch_exposition import history, scrape  # noqa: E402,F401

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

#: families the JAX serving process exports and the port's does not yet,
#: by the ROADMAP item that brings them: none since the capture watchdog
#: (graph_introspect.py, A.12.e) exports the JAX compile watchdog's
NOT_PORTED_FAMILIES = {}
#: the compile watchdog's families for a ladder of (16, 512), (64, 2048),
#: in both servers' pages
XLA_FAMILIES = {"dmlc_xla_cache_hits_total", "dmlc_xla_compile_r16x512_total",
                "dmlc_xla_compile_r64x2048_total", "dmlc_xla_compile_seconds",
                "dmlc_xla_compiles_total"}
#: the port's client bounds its first connect and counts the retries; the
#: JAX client has no such counter
PORT_ONLY_FAMILIES = {"dmlc_retry_serving_connect_retries_total"}

F_LR = 5000
LADDER = [(16, 512), (64, 2048)]
SLO_FIRES = "serving.latency_s:max=0"


# ---------------------------------------------------------------------------
# the grammar
# ---------------------------------------------------------------------------

SPECS = [
    "serving.latency_s:field=p99:max=50ms",
    "serving.latency_s:field=p99:max=50ms,q.depth:max=192,rate:min=1.5:for=3",
    " a:max=1.5s , b:min=2:field=count ",
    "g:max=0",
]
BURN_SPECS = [
    "a.lat_s:field=p99:max=50ms,b.q:min=1:budget=0.02:fast=30s/14:slow=5m/6",
    "serving.latency_s:max=20ms:budget=0.5:fast=2s/1:slow=4s/1",
    "x:max=1:budget=1",
    "y:min=250ms:budget=0.001:slow=1h/2",
]


def _rule_view(r):
    return (r.name, r.metric, r.field, r.max_v, r.min_v,
            getattr(r, "for_count", None), getattr(r, "budget", None),
            getattr(r, "fast_w", None), getattr(r, "fast_r", None),
            getattr(r, "slow_w", None), getattr(r, "slow_r", None))


@pytest.mark.parametrize("spec", SPECS)
def test_plain_spec_compiles_to_the_jax_rules(spec):
    assert [_rule_view(r) for r in anomaly.parse_slo_spec(spec)] == \
        [_rule_view(r) for r in janomaly.parse_slo_spec(spec)]


@pytest.mark.parametrize("spec", SPECS + BURN_SPECS)
def test_superset_spec_compiles_to_the_jax_rules(spec):
    plain, burn = slo.parse_slo_spec(spec)
    jplain, jburn = jslo.parse_slo_spec(spec)
    assert [_rule_view(r) for r in plain] == [_rule_view(r) for r in jplain]
    assert [_rule_view(r) for r in burn] == [_rule_view(r) for r in jburn]
    assert plain or burn


@pytest.mark.parametrize("bad", [
    "", "   ", ":max=1", "m:max", "m:nope=1", "m:field=p99", "m:max=abc",
    "m:max=1:for=x", "m:max=1ns", "m:max=1h",
])
def test_bad_plain_specs_raise_in_both(bad):
    with pytest.raises(anomaly.SloSpecError):
        anomaly.parse_slo_spec(bad)
    with pytest.raises(janomaly.SloSpecError):
        janomaly.parse_slo_spec(bad)


@pytest.mark.parametrize("bad", [
    "a:max=1:fast=30s/14", "a:max=1:budget=2", "a:max=1:budget=x",
    "a:max=1:budget=0.1:fast=30s", "a:max=1:budget=0.1:slow=30s/0",
    "a:budget=0.1", "a:max=1:bogus=2", "a:max=1:budget=0",
    "a:max=1:budget=0.1:fast=x/2",
])
def test_bad_burn_specs_raise_in_both(bad):
    with pytest.raises(anomaly.SloSpecError):
        slo.parse_slo_spec(bad)
    with pytest.raises(janomaly.SloSpecError):
        jslo.parse_slo_spec(bad)


# ---------------------------------------------------------------------------
# plain rules and the monitor
# ---------------------------------------------------------------------------

def _fill(reg, rng, i):
    """One seeded state of a registry: a gauge, a histogram and a counter
    (no clock-driven type: each registry must read the same)."""
    reg.gauge("q.depth").set(float(rng.integers(0, 300)))
    h = reg.histogram("lat_s")
    for v in rng.exponential(0.03 if i % 4 else 0.2, 20):
        h.observe(float(v))
    reg.counter("errors").add(int(rng.integers(0, 3)))


def _registries(seed, n):
    """Both packages' registries driven through the same ``n`` states;
    yields after each."""
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    rng = np.random.default_rng(seed)
    for i in range(n):
        state = rng.bit_generator.state
        for reg in regs:
            rng.bit_generator.state = state
            _fill(reg, rng, i)
        yield regs


MONITOR_SPEC = ("q.depth:max=192:for=2,lat_s:field=p99:max=150ms,"
                "lat_s:field=p50:max=40ms:for=3,errors:max=20,"
                "q.depth:min=10")


@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_fires_the_jax_breaches(seed):
    fired = []
    mons = None
    for regs in _registries(seed, 24):
        if mons is None:
            mons = (anomaly.SloMonitor(anomaly.parse_slo_spec(MONITOR_SPEC),
                                       registry=regs[0], interval_s=3600),
                    janomaly.SloMonitor(janomaly.parse_slo_spec(MONITOR_SPEC),
                                        registry=regs[1], interval_s=3600))
        got = [m.evaluate_once() for m in mons]
        assert got[0] == got[1]
        fired.append(len(got[0]))
        for name in ("slo.active_breaches",):
            assert regs[0].gauge(name).value == regs[1].gauge(name).value \
                == len(got[0])
        assert regs[0].counter("slo.breaches").value == \
            regs[1].counter("slo.breaches").value == sum(fired)
    assert 0 < sum(fired) and min(fired) < max(fired)


def test_rule_checks_equal_the_jax_ones():
    """Default fields by type (each rule of both packages on one snapshot),
    ``for=N`` debounce and its reset, a metric that is absent, a value
    that is not a number."""
    specs = ("q.depth:max=100:for=2", "lat_s:max=0.05", "rows:min=1e9",
             "step:max=0", "errors:max=1", "missing:max=0",
             "lat_s:field=exemplars:max=0")
    rules = [(anomaly.parse_slo_spec(s), janomaly.parse_slo_spec(s))
             for s in specs]
    for regs in _registries(3, 8):
        regs[0].throughput("rows").add(5)
        with regs[0].stage("step").time():
            pass
        snap = regs[0].snapshot()
        for port, jax_ in rules:
            assert [r.check(snap) for r in port] == \
                [r.check(snap) for r in jax_]


def test_a_breach_dumps_through_the_ports_flight_recorder(monkeypatch):
    """The lookup is by the port's module name: a recorder loaded under
    the JAX name is never called by the port's monitor."""
    calls = []

    class Recorder:
        def __init__(self, who):
            self.who = who

        def note_snapshot(self, registry=None):
            calls.append((self.who, "note_snapshot"))

        def note(self, kind, **kw):
            calls.append((self.who, kind))

    class Flight:
        def __init__(self, who):
            self.flight_recorder = Recorder(who)
            self.who = who

        def dump_incident(self, kind, **kw):
            calls.append((self.who, "dump:" + kind))

        def note(self, kind, **kw):
            calls.append((self.who, kind))

    monkeypatch.setitem(sys.modules, "dmlc_core_tpu.telemetry.flight",
                        Flight("jax"))
    reg = tmetrics.MetricsRegistry()
    reg.gauge("q.depth").set(500)
    mon = anomaly.SloMonitor(anomaly.parse_slo_spec("q.depth:max=100"),
                             registry=reg, interval_s=3600)
    assert len(mon.evaluate_once()) == 1
    assert calls == []
    monkeypatch.setitem(sys.modules, "dmlc_core_tpu_torch.telemetry.flight",
                        Flight("port"))
    assert len(mon.evaluate_once()) == 1
    assert calls == [("port", "note_snapshot"), ("port", "slo_breach"),
                     ("port", "dump:slo_breach")]
    # the stall detector's note goes the same way
    det = anomaly.StallDetector("test.slo.stage", z_threshold=2.0,
                                min_samples=2)
    for v in (0.01, 0.01, 0.01, 0.01, 5.0):
        det.observe(v)
    assert calls[-1] == ("port", "stage_stall")


def test_monitor_thread_evaluates_and_stops():
    reg = tmetrics.MetricsRegistry()
    reg.gauge("g").set(9)
    seen = []
    mon = anomaly.SloMonitor(anomaly.parse_slo_spec("g:max=1"),
                             registry=reg, interval_s=0.01,
                             on_breach=seen.append).start()
    try:
        for _ in range(500):
            if seen:
                break
            time.sleep(0.01)
    finally:
        mon.stop()
    assert seen and seen[0]["rule"] == "g:max=1"
    assert reg.gauge("slo.active_breaches").value == 1


# ---------------------------------------------------------------------------
# burn-rate rules over the history
# ---------------------------------------------------------------------------

def _stores(values, now, step=1.0):
    """One store of each package over one gauge fed ``values`` ending at
    ``now``."""
    out = []
    for mod in (ts, jts):
        vals = {"v": 0.0}
        store = mod.HistoryStore(
            snapshot_fn=lambda vals=vals: {"lat": {"type": "gauge",
                                                   "value": vals["v"]}},
            tiers=[(step, 600)])
        t0 = now - (len(values) - 1) * step
        for i, v in enumerate(values):
            vals["v"] = v
            store.sample_once(now=t0 + i * step)
        out.append(store)
    return out


BURN_CASES = {
    "fast": [0.01] * 50 + [1.0] * 11,
    "recovered": [0.01] * 50 + [1.0] * 10 + [0.01],
    "slow": [1.0] * 30 + [0.01] * 31,
    "under_budget": [0.01] * 40 + [1.0],
    "empty": [],
}


@pytest.mark.parametrize("budget", [0.1, 0.5])
@pytest.mark.parametrize("case", sorted(BURN_CASES))
def test_burn_rules_fire_the_jax_breaches(case, budget):
    now = time.time()
    stores = _stores(BURN_CASES[case], now)
    kw = dict(max_v=0.1, min_v=None, budget=budget, fast=(10.0, 5.0),
              slow=(60.0, 4.0))
    got = slo.BurnRateRule("lat", None, **kw).check(stores[0], now=now)
    assert got == jslo.BurnRateRule("lat", None, **kw).check(stores[1],
                                                             now=now)
    if case in ("fast", "slow") and budget == 0.1:
        assert got is not None and got["severity"] == case
    if case in ("empty", "under_budget", "recovered"):
        assert got is None or case == "recovered" and budget == 0.1


def test_burn_rules_on_seeded_series_and_min_bounds():
    rng = np.random.default_rng(8)
    now = time.time()
    for _ in range(20):
        values = list(rng.exponential(0.05, int(rng.integers(1, 120))))
        stores = _stores(values, now)
        for spec in ("lat:max=0.08:budget=0.2:fast=15s/2:slow=90s/1.5",
                     "lat:min=0.01:budget=0.05:fast=5s/3",
                     "lat:field=value:max=0.2:budget=0.5"):
            (r,), (jr,) = slo.parse_slo_spec(spec)[1], \
                jslo.parse_slo_spec(spec)[1]
            assert r.check(stores[0], now=now) == \
                jr.check(stores[1], now=now)


def test_burn_series_resolution_equals_the_jax_one():
    stores = []
    for mod in (ts, jts):
        s = mod.HistoryStore(
            snapshot_fn=lambda: {"m": {"type": "histogram", "count": 3,
                                       "p50": 0.1, "p99": 0.5,
                                       "mean": 0.2},
                                 "t": {"type": "throughput",
                                       "windowed_rate": 4.0},
                                 "st": {"type": "stage", "count": 1,
                                        "total_sec": 0.5}},
            tiers=[(1.0, 10)])
        s.sample_once(now=1_000_000.0)
        stores.append(s)
    for field in (None, "p99", "p50", "value", "windowed_rate", "mean_sec",
                  "count", "other"):
        for metric in ("m", "t", "st", "absent"):
            a = slo.BurnRateRule(metric, field, 1.0, None, budget=0.1)
            b = jslo.BurnRateRule(metric, field, 1.0, None, budget=0.1)
            assert a._series_name(stores[0]) == b._series_name(stores[1])


def test_burn_rate_monitor_evaluates_the_jax_way():
    now = time.time()
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    spec = "lat:max=0.1:budget=0.1:fast=10s/5,q:max=3"
    mons = []
    for mod, reg, store in zip((slo, jslo), regs, _stores([1.0] * 30, now)):
        reg.gauge("q").set(7)
        plain, burn = mod.parse_slo_spec(spec)
        mons.append(mod.BurnRateMonitor(plain, burn, history=store,
                                        registry=reg, interval_s=3600))
    got = [m.evaluate_once() for m in mons]
    assert got[0] == got[1] and len(got[0]) == 2
    assert [r.gauge("slo.active_breaches").value for r in regs] == [2, 2]
    for m, store in zip(mons, _stores([0.01] * 30, now)):
        m.history = store
    for reg in regs:
        reg.gauge("q").set(0)
    assert [m.evaluate_once() for m in mons] == [[], []]
    assert [r.gauge("slo.active_breaches").value for r in regs] == [0, 0]


# ---------------------------------------------------------------------------
# the environment switch
# ---------------------------------------------------------------------------

def test_monitor_from_env(monkeypatch, history):
    monkeypatch.delenv("DMLC_SLO_SPEC", raising=False)
    assert anomaly.maybe_monitor_from_env() is None
    monkeypatch.setenv("DMLC_SLO_SPEC", "g:max=1")
    mon = anomaly.maybe_monitor_from_env(autostart=False)
    assert type(mon) is anomaly.SloMonitor and mon._thread is None
    mon = anomaly.maybe_monitor_from_env()
    assert mon._thread is not None
    assert anomaly.maybe_monitor_from_env() is mon       # one thread a spec
    assert anomaly.active_slo_spec() == "g:max=1"
    monkeypatch.setenv("DMLC_SLO_SPEC", "g:max=1:budget=0.5")
    burn = anomaly.maybe_monitor_from_env()
    try:
        assert isinstance(burn, slo.BurnRateMonitor) and burn is not mon
        assert burn.history is ts.history and history.running
    finally:
        mon.stop()
        burn.stop()
    monkeypatch.setenv("DMLC_SLO_SPEC", "g:nope=1")
    with pytest.raises(anomaly.SloSpecError):
        anomaly.maybe_monitor_from_env()


# ---------------------------------------------------------------------------
# the straggler board
# ---------------------------------------------------------------------------

def _stage_state(count, total_sec):
    return {"train.step": {"type": "stage", "count": count,
                           "total_sec": total_sec},
            "other": {"type": "counter", "value": count}}


def _boards(**kw):
    return anomaly.StragglerBoard(**kw), janomaly.StragglerBoard(**kw)


def _same(boards):
    a, b = boards
    assert a.evaluate() == b.evaluate()
    assert a.suspects() == b.suspects()
    assert a.snapshot() == b.snapshot()
    assert a.series() == b.series()
    return a


def test_straggler_board_flags_the_slow_rank_in_both():
    boards = _boards(z_threshold=4.0, min_ranks=3)
    for push in range(1, 4):
        for rank in range(4):
            per = 0.100 if rank == 3 else 0.010
            for b in boards:
                b.update(rank, _stage_state(push * 50, push * 50 * per))
    assert _same(boards).suspects() == ["3"]


def test_straggler_board_restart_and_min_ranks_in_both():
    boards = _boards(min_ranks=3)
    for rank in range(3):
        for b in boards:
            b.update(rank, _stage_state(100, 1.0))
            b.update(rank, _stage_state(200, 2.0))
    for b in boards:
        b.update(0, _stage_state(10, 0.1))      # rank 0 restarted
    assert _same(boards).suspects() == []
    boards = _boards(min_ranks=3)
    for push in range(1, 3):
        for b in boards:
            b.update(0, _stage_state(push * 10, push * 0.1))
            b.update(1, _stage_state(push * 10, push * 1.0))
    assert _same(boards).evaluate() == {}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_straggler_board_on_seeded_pushes(seed, monkeypatch):
    """Eight ranks, some slow, pushes in a random order with restarts;
    the thresholds from ``DMLC_STRAGGLER_Z`` and
    ``DMLC_STRAGGLER_REL_FLOOR``."""
    monkeypatch.setenv("DMLC_STRAGGLER_Z", "3.5")
    monkeypatch.setenv("DMLC_STRAGGLER_REL_FLOOR", "0.05")
    rng = np.random.default_rng(seed)
    boards = _boards()
    assert boards[0].z_threshold == 3.5 and boards[0].rel_floor == 0.05
    per = 0.01 * (1 + 4 * (rng.random(8) < 0.25)) * rng.uniform(0.9, 1.1, 8)
    counts = np.zeros(8, np.int64)
    totals = np.zeros(8)
    for _ in range(60):
        r = int(rng.integers(0, 8))
        if rng.random() < 0.05:
            counts[r], totals[r] = 0, 0.0
        n = int(rng.integers(0, 40))
        counts[r] += n
        totals[r] += n * per[r] * float(rng.uniform(0.8, 1.2))
        for b in boards:
            b.update(r, _stage_state(int(counts[r]), float(totals[r])))
    _same(boards)


# ---------------------------------------------------------------------------
# the prediction server with the exporter and the SLO monitor
# ---------------------------------------------------------------------------

def _engines():
    import jax.numpy as jnp
    from dmlc_core_tpu.models import SparseLogReg as JLR
    from dmlc_core_tpu.serving import engine as jengine
    from dmlc_core_tpu_torch.models import SparseLogReg
    from dmlc_core_tpu_torch.serving import BucketLadder, InferenceEngine
    w = np.arange(F_LR, dtype=np.float32) / F_LR
    return {
        "jax": jengine.InferenceEngine(
            JLR(num_features=F_LR), {"w": jnp.asarray(w),
                                     "b": jnp.float32(0.25)},
            buckets=jengine.BucketLadder(LADDER)),
        "port": InferenceEngine(
            SparseLogReg(F_LR, device="cpu"), {"w": w, "b": np.float32(0.25)},
            buckets=BucketLadder(LADDER), device="cpu"),
    }


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = int(rng.integers(1, 12))
        counts = rng.integers(1, 9, rows)
        ids = rng.integers(0, F_LR, int(counts.sum())).astype(np.int32)
        out.append((ids, rng.random(len(ids), dtype=np.float32),
                    np.concatenate([[0], np.cumsum(counts)]).astype(
                        np.int64)))
    return out


PACKAGES = {"jax": (jserver, jclient, jmetrics, jtrace),
            "port": (tserver, tclient, tmetrics, teltrace)}


def _families(page):
    return {ln.split()[2] for ln in page.splitlines()
            if ln.startswith("# TYPE ")}


def test_servers_export_the_jax_families_and_health(monkeypatch):
    """Both packages' servers with ``metrics_port=0`` on the same
    requests, each through its own client, each registry and span ring
    emptied first."""
    monkeypatch.setenv("DMLC_TIMELINE_INTERVAL", "0.02")
    for key in ("DMLC_SLO_SPEC", "DMLC_METRICS_PORT", "DMLC_AUTOTUNE",
                "DMLC_FAULT_SPEC"):
        monkeypatch.delenv(key, raising=False)
    engines = _engines()
    reqs = _requests(9, 24)
    pages, health = {}, {}
    for name, (srvmod, climod, mmod, trmod) in PACKAGES.items():
        mmod.metrics.reset()
        trmod.recorder.clear()
        srv = srvmod.PredictionServer(engines[name], metrics_port=0).start()
        try:
            assert srv.telemetry.port != srv.port
            with climod.PredictClient(srv.host, srv.port) as c:
                answers = [c.predict(*r) for r in reqs]
            assert all(a.shape == (len(r[2]) - 1,)
                       for a, r in zip(answers, reqs))
            # one sample of the history at least, on each side
            for _ in range(500):
                if "telemetry.timeline.samples" in mmod.metrics.snapshot():
                    break
                time.sleep(0.01)
            code, ctype, pages[name] = scrape(srv.telemetry.port, "/metrics")
            assert (code, ctype) == (
                200, "text/plain; version=0.0.4; charset=utf-8")
            code, _, body = scrape(srv.telemetry.port, "/healthz")
            health[name] = (code, json.loads(body))
        finally:
            srv.stop()
    assert health["port"][0] == health["jax"][0] == 200
    assert health["port"][1] == health["jax"][1]
    assert health["port"][1]["status"] == "ok"
    port, jax_ = _families(pages["port"]), _families(pages["jax"])
    assert jax_ - port == set(NOT_PORTED_FAMILIES) == set()
    assert port - jax_ == PORT_ONLY_FAMILIES
    assert {f for f in port if f.startswith("dmlc_xla_")} == \
        {f for f in jax_ if f.startswith("dmlc_xla_")} == XLA_FAMILIES
    assert "dmlc_telemetry_timeline_samples_total" in port
    assert "dmlc_serving_latency_s" in port
    for line in ("dmlc_serving_batcher_requests_total 24",
                 "dmlc_serving_latency_s_count 24"):
        assert line in pages["port"].splitlines()
        assert line in pages["jax"].splitlines()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_a_fired_rule_degrades_health_and_freezes_the_tuner(
        package, monkeypatch, tmp_path):
    srvmod, climod, mmod, _ = PACKAGES[package]
    m = mmod.metrics
    monkeypatch.setenv("DMLC_SLO_SPEC", SLO_FIRES)
    monkeypatch.setenv("DMLC_SLO_INTERVAL", "0.05")
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / "tuned.json"))
    monkeypatch.delenv("DMLC_AUTOTUNE", raising=False)
    monkeypatch.delenv("DMLC_METRICS_PORT", raising=False)
    m.gauge("slo.active_breaches").set(0)
    srv = srvmod.PredictionServer(_engines()[package], metrics_port=0,
                                  max_delay_s=0.001).start()
    stop = threading.Event()
    reqs = _requests(10, 8)

    def traffic():
        with climod.PredictClient(srv.host, srv.port) as c:
            while not stop.is_set():
                for r in reqs:
                    c.predict(*r)
    th = threading.Thread(target=traffic, daemon=True)
    try:
        b0 = m.counter("slo.breaches").value
        assert srv.health == "ok"
        th.start()
        deadline = time.monotonic() + 30
        while (json.loads(scrape(srv.telemetry.port, "/healthz")[2])
               ["status"] != "degraded"):
            assert time.monotonic() < deadline, "the rule never fired"
            time.sleep(0.02)
        assert srv.health == "degraded"
        assert m.gauge("serving.server.health").value == 1
        assert m.counter("slo.breaches").value > b0
        monkeypatch.setenv("DMLC_AUTOTUNE", "1")
        f0 = m.counter("autotune.freezes").value
        mut0 = m.counter("autotune.mutations").value
        assert srv.serve_forever(window_s=0.15, max_windows=3) == 3
        assert m.counter("autotune.freezes").value > f0
        assert m.counter("autotune.mutations").value == mut0
    finally:
        stop.set()
        th.join(timeout=30)
        srv.stop()
    # the monitor stopped with the server; the breach gauge is its last
    # reading until something clears it
    assert srv.slo_monitor._thread is None


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_rules_that_cannot_fire_keep_health_ok(package, monkeypatch):
    srvmod, climod, mmod, _ = PACKAGES[package]
    monkeypatch.setenv("DMLC_SLO_SPEC",
                       "serving.latency_s:max=3600s,serving.latency_s:"
                       "max=3600s:budget=0.5:fast=1s/1:slow=2s/1")
    monkeypatch.setenv("DMLC_SLO_INTERVAL", "0.02")
    monkeypatch.setenv("DMLC_TIMELINE_INTERVAL", "0.02")
    mmod.metrics.gauge("slo.active_breaches").set(0)
    srv = srvmod.PredictionServer(_engines()[package], metrics_port=0).start()
    try:
        with climod.PredictClient(srv.host, srv.port) as c:
            for r in _requests(11, 20):
                c.predict(*r)
        time.sleep(0.3)
        code, _, body = scrape(srv.telemetry.port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        assert type(srv.slo_monitor).__name__ == "BurnRateMonitor"
    finally:
        srv.stop()
