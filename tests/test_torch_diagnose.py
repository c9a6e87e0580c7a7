"""The port's incident diagnosis (``telemetry/diagnose.py``), held against
the JAX package's on the CPU.

The cases of the JAX ``tests/test_diagnose.py``, each fed to both
packages' ``DiagnosisEngine`` through injected sources (the same seeded
wide events, span records, straggler boards and fleet docs; the same
metric snapshots sampled into each package's ``HistoryStore``), give
equal documents (``ts`` and ``wall_ms`` aside, exact):

* the adaptive slow threshold splits a bimodal window between its modes;
* dimension differencing ranks the bad replica and outcome, by errors or
  by slowness alone, never differences a measure or an identity, and
  gives the empty document on empty windows;
* onsets freeze their baseline, and the timeline analyzer ranks leaders
  only, the breach machinery's own series excluded;
* the critical-path diff ranks the span whose share grew;
* fleet attribution is corroborated by the wide-event verdict and the
  merged ranking is the JAX one, as is the text;
* the endpoint's window is scoped to a recent breach and no longer to a
  stale one;
* ``on_breach`` and ``incident_diagnosis`` are gated by ``DMLC_DIAGNOSE``
  and ``DMLC_DIAGNOSE_ON_BREACH`` alike.

The field sets are the JAX ones and lie in the port's
``wide_events.FIELDS``.  One ``PredictionServer`` of each package, with
``DMLC_FLIGHT_DIR`` and ``DMLC_SLO_SPEC``, fed the same untraced frames
of which an admission fault sheds two: the SLO monitor's breach runs the
diagnosis before its dump, and the two bundles' ranked suspects are
equal.  The ``history`` fixture (``tests/test_torch_exposition.py``)
forgets each package's last breach and baseline profile around each
test.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.serving import server as jserver  # noqa: E402
from dmlc_core_tpu.telemetry import diagnose as jdiagnose  # noqa: E402
from dmlc_core_tpu.telemetry import flight as jflight  # noqa: E402
from dmlc_core_tpu.telemetry import timeseries as jts  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.telemetry import wide_events as jwide  # noqa: E402
from dmlc_core_tpu.utils import faults as jfaults  # noqa: E402
from dmlc_core_tpu_torch.serving import BucketLadder  # noqa: E402
from dmlc_core_tpu_torch.serving import server as tserver  # noqa: E402
from dmlc_core_tpu_torch.telemetry import diagnose  # noqa: E402
from dmlc_core_tpu_torch.telemetry import flight  # noqa: E402
from dmlc_core_tpu_torch.telemetry import timeseries as ts  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.telemetry import wide_events  # noqa: E402
from dmlc_core_tpu_torch.utils import faults as tfaults  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401
from test_torch_server import (LADDER, _fm_params, _jax_fm,  # noqa: E402
                               _port_fm, _req)
from test_torch_wide_events import _one_by_one  # noqa: E402

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

#: fixed synthetic epoch (a multiple of every tier step below)
T0 = 1_000_000.0
#: (diagnose module, timeseries module) of each package
PACKAGES = {"port": (diagnose, ts), "jax": (jdiagnose, jts)}


def _engines(snapshots=None, tiers=((1.0, 16),), **kw):
    """One engine of each package over the same injected sources; the
    history is each package's store, sampled from the same snapshots
    (``[(now, snapshot), ...]``) when given."""
    out = {}
    for name, (dmod, tsmod) in PACKAGES.items():
        feed = iter(snapshots or [])
        store = tsmod.HistoryStore(snapshot_fn=lambda f=feed: next(f)[1],
                                   tiers=list(tiers))
        for now, _ in snapshots or []:
            store.sample_once(now=now)
        args = {"events_fn": lambda: [], "records_fn": lambda: [],
                "history": store, **kw}
        out[name] = dmod.DiagnosisEngine(**args)
    return out


def _stable(doc):
    """A document less its clock (``ts``, ``wall_ms``)."""
    return {k: v for k, v in doc.items() if k not in ("ts", "wall_ms")}


def _route_events(n=60, bad_replica="10.0.0.9:7013", bad_every=3,
                  outcome="UNAVAILABLE", ts_at=T0 - 5.0, seed=0):
    rng = np.random.default_rng(seed)
    evs = []
    for i in range(n):
        bad = i % bad_every == 0
        evs.append({"kind": "serving.route", "seq": i + 1, "ts": ts_at,
                    "model": "m", "trace_id": f"{i:016x}",
                    "replica": bad_replica if bad
                    else f"10.0.0.{i % 2}:7011",
                    "outcome": outcome if bad else "OK",
                    "dur_ms": float((25.0 if bad else 1.0)
                                    + rng.random() * 0.1)})
    return evs


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------

def test_field_sets_are_the_jax_ones_and_in_fields():
    for name in ("MEASURE_FIELDS", "IDENTITY_FIELDS", "ENTITY_FIELDS",
                 "DIAG_METRICS", "DIAGNOSIS_SCHEMA", "_SELF_SERIES_PREFIXES",
                 "_ONSET_Z", "_ONSET_MIN_N", "_Z_CAP"):
        assert getattr(diagnose, name) == getattr(jdiagnose, name), name
    for fields in (diagnose.MEASURE_FIELDS, diagnose.IDENTITY_FIELDS,
                   diagnose.ENTITY_FIELDS):
        assert fields <= wide_events.FIELDS
    assert diagnose._wide is wide_events      # the port's ring, never JAX's


# ---------------------------------------------------------------------------
# analyzer 1: wide-event dimension differencing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_robust_slow_threshold_equals_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    durs = list(1.0 + rng.random(50) * 0.2) + list(20.0 + rng.random(10))
    thr = diagnose._robust_slow_ms(durs)
    assert thr == jdiagnose._robust_slow_ms(durs)
    assert 1.2 < thr < 20.0      # between the modes, not inside either
    flat = list(rng.exponential(5.0, 40))
    assert diagnose._robust_slow_ms(flat) == jdiagnose._robust_slow_ms(flat)


@pytest.mark.parametrize("case", ["errors", "slow", "empty", "outside",
                                  "explicit_slow"])
def test_wide_event_differencing_equals_the_jax_one(case):
    evs = {"errors": _route_events(),
           "slow": _route_events(outcome="OK"),
           "empty": [],
           "outside": _route_events(ts_at=T0 - 500.0),
           "explicit_slow": _route_events(outcome="OK", seed=3)}[case]
    slow_ms = 10.0 if case == "explicit_slow" else 0.0
    engs = _engines(events_fn=lambda: evs)
    docs = {n: e._diff_wide_events(T0 - 60, T0, top=5, slow_ms=slow_ms)
            for n, e in engs.items()}
    assert docs["port"] == docs["jax"]
    doc = docs["port"]
    if case == "empty":
        assert doc == {"events": 0, "in_window": 0, "bad": 0, "baseline": 0,
                       "slow_ms": None, "suspects": []}
    elif case == "outside":
        assert doc["in_window"] == 0 and doc["bad"] == 0
    else:
        assert doc["in_window"] == 60 and doc["bad"] == 20
        top = {(s["field"], s["value"]) for s in doc["suspects"][:2]}
        assert ("replica", "10.0.0.9:7013") in top
        banned = diagnose.MEASURE_FIELDS | diagnose.IDENTITY_FIELDS
        assert all(s["field"] not in banned for s in doc["suspects"])


# ---------------------------------------------------------------------------
# analyzer 2: timeline lead/lag correlation
# ---------------------------------------------------------------------------

def test_onset_detection_equals_the_jax_one():
    flat = [(T0 + i, 1.0) for i in range(20)]
    step = flat[:10] + [(T0 + 10 + i, 50.0) for i in range(5)]
    climb = flat[:10] + [(T0 + 10 + i, 50.0 * (i + 1)) for i in range(5)]
    rng = np.random.default_rng(5)
    noisy = [(T0 + i, float(v)) for i, v in
             enumerate(np.concatenate([rng.normal(10, 1, 15),
                                       rng.normal(40, 2, 5)]))]
    got = [diagnose.DiagnosisEngine._onset(p)
           for p in (flat, step, climb, noisy)]
    assert got == [jdiagnose.DiagnosisEngine._onset(p)
                   for p in (flat, step, climb, noisy)]
    assert got[0] == (None, 0.0)
    assert got[1][0] == T0 + 10 and got[1][1] > 3.0
    assert got[2][1] > got[1][1] and got[2][1] <= diagnose._Z_CAP


def _timeline_snapshots():
    vals = {"cause": 1.0, "victim": 2.0, "effect": 3.0, "flat": 4.0,
            "slo.decoy": 5.0}
    out = []
    for i in range(30):
        if i == 6:
            vals["slo.decoy"] = 500.0   # earliest mover, but self-series
        if i == 10:
            vals["cause"] = 50.0        # the upstream cause
        if i == 15:
            vals["victim"] = 80.0       # the breached series
        if i == 25:
            vals["effect"] = 90.0       # moved after the breach: effect
        out.append((T0 + i, {k: {"type": "gauge", "value": v}
                             for k, v in vals.items()}))
    return out


@pytest.mark.parametrize("breach_series", ["victim", None])
def test_timeline_leaders_equal_the_jax_ones(breach_series):
    engs = _engines(_timeline_snapshots(), tiers=((1.0, 64),))
    docs = {n: e._correlate_timeline(T0 + 20, T0 + 30, top=5,
                                     breach_series=breach_series)
            for n, e in engs.items()}
    assert docs["port"] == docs["jax"]
    doc = docs["port"]
    names = [s["series"] for s in doc["suspects"]]
    assert "slo.decoy" not in names and "effect" not in names
    if breach_series:
        assert doc["breach_onset"] == T0 + 15 and names == ["cause"]
        assert doc["suspects"][0]["lead_s"] == 5.0
    else:
        assert doc["breach_onset"] == T0 + 20 and "cause" in names


# ---------------------------------------------------------------------------
# analyzer 3: critical-path regression diff
# ---------------------------------------------------------------------------

def _span(name, i, ts_s, dur_us):
    return {"kind": "span", "name": name, "trace_id": f"t{i}",
            "span_id": f"s{i}", "parent_id": None,
            "ts_us": int(ts_s * 1e6), "dur_us": int(dur_us)}


def test_critical_path_diff_equals_the_jax_one():
    records = []
    for i in range(5):      # baseline: db dominates the critical path
        records.append(_span("db", f"b{i}", T0 - 100 - i, 1000))
    for i in range(3):      # incident: lock_wait displaces it
        records.append(_span("db", f"i{i}", T0 - 10 - i, 1000))
        records.append(_span("lock_wait", f"j{i}", T0 - 10 - i, 5000))
    engs = _engines(records_fn=lambda: records)
    for window in ((T0 - 30, T0), (T0 + 50, T0 + 60), (T0 - 200, T0)):
        docs = {n: e._diff_critical_path(*window, top=5)
                for n, e in engs.items()}
        assert docs["port"] == docs["jax"], window
    doc = engs["port"]._diff_critical_path(T0 - 30, T0, top=5)
    assert doc["incident_spans"] == 6 and doc["baseline_spans"] == 5
    assert doc["suspects"][0]["span"] == "lock_wait"
    assert all(s["span"] != "db" for s in doc["suspects"])
    assert engs["port"]._diff_critical_path(T0 + 50, T0 + 60, top=5)[
        "suspects"] == []


# ---------------------------------------------------------------------------
# analyzer 4 + merger: fleet attribution, corroboration, ranking, text
# ---------------------------------------------------------------------------

FLEET = {"replicas": {"job:3": {"addr": "10.0.0.9:7013", "alive": True,
                                "straggler": True},
                      "job:1": {"addr": "10.0.0.0:7011", "alive": True},
                      "job:2": {"addr": "10.0.0.1:7011", "alive": True,
                                "health": "degraded",
                                "queue_fraction": 0.5}},
         "workers": {"w:9": {"addr": "10.0.0.8:9000", "alive": False},
                     "w:1": "not a row"}}
STRAGGLERS = {"stages": {"step": {"2": {"straggler": True, "z": 7.5},
                                  "0": {"straggler": False, "z": 0.1}},
                         "read": {"2": {"straggler": True, "z": 9.0}}}}


@pytest.mark.parametrize("top", [3, 8])
def test_fleet_attribution_and_ranking_equal_the_jax_ones(top):
    evs = _route_events()
    engs = _engines(events_fn=lambda: evs, fleet_fn=lambda: FLEET,
                    stragglers_fn=lambda: STRAGGLERS)
    docs = {n: e.run(since=T0 - 60, until=T0, top=top)
            for n, e in engs.items()}
    assert _stable(docs["port"]) == _stable(docs["jax"])
    doc = docs["port"]
    assert set(doc["analyzers"]["fleet"]["sources"]) == {"stragglers",
                                                         "fleet"}
    if top == 8:
        rep = next(s for s in doc["suspects"]
                   if s["subject"] == "replica job:3")
        assert rep["corroborated"] and rep["score"] == pytest.approx(0.85)
    assert [s["rank"] for s in doc["suspects"]] == list(
        range(1, len(doc["suspects"]) + 1))
    # the text, on equal clocks, byte for byte
    for d in docs.values():
        d["ts"], d["wall_ms"] = 1e9, 1.5
    text = diagnose.render_text(docs["port"])
    assert text == jdiagnose.render_text(docs["jax"])
    assert "ranked suspects" in text and "fleet (stragglers+fleet)" in text


def test_failing_fleet_sources_equal_the_jax_ones():
    def boom():
        raise RuntimeError("source down")

    engs = _engines(fleet_fn=boom, stragglers_fn=boom)
    docs = {n: e.run(since=T0 - 60, until=T0) for n, e in engs.items()}
    assert _stable(docs["port"]) == _stable(docs["jax"])
    fl = docs["port"]["analyzers"]["fleet"]
    assert fl["fleet_error"] == fl["stragglers_error"] == "source down"


def test_run_document_metrics_and_quiet_text():
    runs0 = tmetrics.metrics.counter("telemetry.diagnose.runs").value
    engs = _engines(events_fn=lambda: _route_events())
    doc = engs["port"].run(since=T0 - 60, until=T0, top=3)
    jdoc = engs["jax"].run(since=T0 - 60, until=T0, top=3)
    assert _stable(doc) == _stable(jdoc)
    assert doc["schema"] == "dmlc.diagnosis/1"
    assert doc["window"]["since"] == T0 - 60
    assert doc["trigger"] == {"kind": "explicit"}
    assert len(doc["suspects"]) <= 3 and doc["wall_ms"] >= 0
    m = tmetrics.metrics
    assert m.counter("telemetry.diagnose.runs").value == runs0 + 1
    assert m.gauge("telemetry.diagnose.suspects").value == \
        len(doc["suspects"])
    assert m.histogram("telemetry.diagnose.wall_ms").snapshot()["count"] >= 1
    quiet = {n: e.run(since=T0 - 60, until=T0)
             for n, e in _engines().items()}
    for d in quiet.values():
        d["ts"], d["wall_ms"] = 1e9, 0.5
    assert diagnose.render_text(quiet["port"]) == \
        jdiagnose.render_text(quiet["jax"])
    assert "(none — quiet window)" in diagnose.render_text(quiet["port"])


# ---------------------------------------------------------------------------
# breach scoping and gating
# ---------------------------------------------------------------------------

BREACH = {"rule": "r:burn", "series": "x.p99", "window_s": 30.0}


def test_endpoint_doc_scopes_to_a_recent_breach(monkeypatch):
    evs = _route_events(ts_at=time.time())
    engs = _engines(events_fn=lambda: evs)
    got = {}
    for name, (dmod, _) in PACKAGES.items():
        eng = engs[name]
        explicit = eng.endpoint_doc(since_s=10.0)
        monkeypatch.setattr(dmod, "_last_breach", (BREACH, time.time()))
        scoped = eng.endpoint_doc()
        monkeypatch.setattr(dmod, "_last_breach",
                            (BREACH, time.time() - 1000.0))
        stale = eng.endpoint_doc()
        got[name] = [(d["trigger"], round(d["window"]["until"]
                                          - d["window"]["since"], 6),
                      d["suspects"]) for d in (explicit, scoped, stale)]
    assert got["port"] == got["jax"]
    (t1, w1, _), (t2, w2, _), (t3, _, _) = got["port"]
    assert t1 == {"kind": "explicit"} and w1 == 10.0
    assert t2 == {"kind": "breach", "breach": BREACH} and w2 == 30.0
    assert t3 == {"kind": "explicit"}


def test_on_breach_and_incident_diagnosis_gating(monkeypatch):
    evs = _route_events(ts_at=time.time())
    engs = _engines(events_fn=lambda: evs)
    got = {}
    for name, (dmod, _) in PACKAGES.items():
        monkeypatch.setattr(dmod, "_default_engine", engs[name])
        monkeypatch.delenv("DMLC_DIAGNOSE", raising=False)
        monkeypatch.delenv("DMLC_DIAGNOSE_ON_BREACH", raising=False)
        doc = dmod.on_breach(BREACH)
        reused = dmod.incident_diagnosis() is doc
        monkeypatch.setenv("DMLC_DIAGNOSE", "0")
        gated = (dmod.on_breach(BREACH), dmod.incident_diagnosis())
        monkeypatch.delenv("DMLC_DIAGNOSE")
        monkeypatch.setenv("DMLC_DIAGNOSE_ON_BREACH", "0")
        monkeypatch.setattr(dmod, "_last_breach", None)
        no_breach = dmod.on_breach(BREACH)
        fresh = dmod.incident_diagnosis()
        got[name] = (_stable(doc), reused, gated, no_breach,
                     fresh is not None and fresh["trigger"])
    assert got["port"][0]["window"].keys() == got["jax"][0]["window"].keys()
    for part in range(1, 5):
        assert got["port"][part] == got["jax"][part]
    assert got["port"][0]["trigger"] == got["jax"][0]["trigger"] == \
        {"kind": "breach", "breach": BREACH}
    assert got["port"][0]["suspects"] == got["jax"][0]["suspects"]
    assert got["port"][1:] == (True, (None, None), None, {"kind": "explicit"})


# ---------------------------------------------------------------------------
# both servers through one breach
# ---------------------------------------------------------------------------

def _untraced_frames(seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids, vals, row_ptr = _req(rng, int(rng.integers(1, 9)), 6)
        rp = np.asarray(row_ptr, np.int32)
        out.append(tserver.REQ_HEADER.pack(200 + i, 0, 0, len(rp) - 1,
                                           len(ids))
                   + rp.tobytes() + ids.tobytes() + vals.tobytes())
    return out


def test_servers_diagnose_one_breach_alike(monkeypatch, tmp_path):
    """Untraced frames (each engine call its own one-span trace), two
    shed by an admission fault; the monitor's breach (evaluated once the
    traffic is in) runs the diagnosis, then dumps: both bundles rank the
    same suspects, the shed outcome and the engine's forward span."""
    params = _fm_params(5)
    frames = _untraced_frames(13)
    for key in ("DMLC_METRICS_PORT", "DMLC_AUTOTUNE", "DMLC_WIDE_EVENTS",
                "DMLC_TRACE_SAMPLE", "DMLC_DIAGNOSE",
                "DMLC_DIAGNOSE_ON_BREACH"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DMLC_SLO_SPEC", "serving.server.shed:max=0")
    monkeypatch.setenv("DMLC_SLO_INTERVAL", "3600")
    monkeypatch.setenv("DMLC_DIAGNOSE_SLOW_MS", "1e9")   # errors only
    monkeypatch.setenv("DMLC_FLIGHT_HOOKS", "0")
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "serving.server.admit:error=1:times=2:after=6")
    packages = {
        "port": (lambda: tserver.PredictionServer(
            _port_fm(params, buckets=BucketLadder(LADDER))),
            wide_events, teltrace, tmetrics.metrics, flight),
        "jax": (lambda: jserver.PredictionServer(_jax_fm(params, LADDER)),
                jwide, jtrace, jmetrics.metrics, jflight)}
    docs = {}
    for name, (make, wide, tr, m, fl) in packages.items():
        tr.recorder.clear()
        wide.wide_log.reset()
        m.reset()
        fdir = tmp_path / name
        monkeypatch.setenv("DMLC_FLIGHT_DIR", str(fdir))
        monkeypatch.setattr(fl.flight_recorder, "_min_interval", 0.0)
        for mod in (tfaults, jfaults):
            mod.clear_faults()
        srv = make().start()
        try:
            assert srv.slo_monitor is not None
            statuses = _one_by_one((srv.host, srv.port), frames,
                                   wide.wide_log)
            assert statuses.count(tserver.STATUS_OVERLOADED) == 2
            fired = srv.slo_monitor.evaluate_once()
            assert [b["rule"] for b in fired] == ["serving.server.shed:max=0"]
        finally:
            srv.stop()
            for mod in (tfaults, jfaults):
                mod.clear_faults()
        (b,) = sorted(d for d in os.listdir(fdir) if d.endswith("slo_breach"))
        with open(fdir / b / "diagnosis.json") as f:
            docs[name] = json.load(f)
        with open(fdir / b / "incident.json") as f:
            assert json.load(f)["files"]["diagnosis"] == "diagnosis.json"
        assert (fdir / b / "diagnosis.txt").read_text().startswith(
            "diagnosis @ ")
    port, jax_ = docs["port"], docs["jax"]
    assert port["trigger"]["kind"] == jax_["trigger"]["kind"] == "breach"
    assert port["trigger"]["breach"]["rule"] == \
        jax_["trigger"]["breach"]["rule"]
    assert port["suspects"] == jax_["suspects"]
    assert {s["subject"] for s in port["suspects"]} == \
        {"outcome=OVERLOADED", "span serving.engine.forward"}
