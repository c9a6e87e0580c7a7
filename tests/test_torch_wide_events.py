"""The port's wide events (``telemetry/wide_events.py``) and the
prediction server's ``serving.request`` events, held against the JAX
package on the CPU.

* ``FIELDS`` and the schema are the JAX package's.
* The JAX cases of ``tests/test_trace_sampling.py`` (closed vocabulary
  and ``seq``, the trace identity and the sampling verdict stamped, the
  JSON-lines audit file, ``/events?since=``), run on each package.
* The same seeded ``emit`` calls into a log of each package give the
  same events and the same ``doc`` (``ts`` aside), the same unknown-field
  and overflow counts (exact).
* The verdict an event carries is the port's sampler's, looked up by the
  port's module name, never the JAX one's.
* One ``PredictionServer`` of each package, with ``DMLC_FLIGHT_DIR`` and
  ``DMLC_TRACE_SAMPLE`` set, a ``metrics_port`` and an admission fault,
  fed the same seeded frames (untraced, traced under seeded ids, one
  debug-marked, two shed by the fault): ``/events`` serves equal docs,
  ``ts``, ``dur_ms``, ``queue_ms`` and ``conn`` aside and ``seq``
  counted from the first; ``/flight`` answers 200 with a bundle, and
  ``/profile``, ``/analyze`` and ``/diagnose`` answer with the JAX
  statuses, content types and document keys; each package's flight
  directory holds one ``injected_fault`` bundle.

The ``history`` fixture (from ``tests/test_torch_exposition.py``) stops
both history samplers and puts back both packages' installed samplers,
flight recorders, exception hooks and signal handlers.
"""

import importlib
import json
import os
import socket
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.serving import server as jserver  # noqa: E402
from dmlc_core_tpu.telemetry import exposition as jexposition  # noqa: E402
from dmlc_core_tpu.telemetry import sampling as jsampling  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.telemetry import wide_events as jwide  # noqa: E402
from dmlc_core_tpu.utils import faults as jfaults  # noqa: E402
from dmlc_core_tpu_torch.serving import BucketLadder  # noqa: E402
from dmlc_core_tpu_torch.serving import server as tserver  # noqa: E402
from dmlc_core_tpu_torch.telemetry import exposition  # noqa: E402
from dmlc_core_tpu_torch.telemetry import sampling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.telemetry import wide_events  # noqa: E402
from dmlc_core_tpu_torch.utils import faults as tfaults  # noqa: E402
from test_torch_exposition import history, scrape  # noqa: E402,F401
from test_torch_server import (LADDER, _fm_params, _jax_fm,  # noqa: E402
                               _port_fm, _recv, _req)

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

PACKAGES = {
    "port": (wide_events, sampling, teltrace, tmetrics.metrics, exposition),
    "jax": (jwide, jsampling, jtrace, jmetrics.metrics, jexposition),
}
#: what differs between two runs of one server: times and the connection
VOLATILE = ("ts", "dur_ms", "queue_ms", "conn")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    wide, samp, tr, m, expo = PACKAGES[request.param]
    samp.uninstall()
    wide.wide_log.reset()
    yield wide, samp, tr, m, expo
    samp.uninstall()
    wide.wide_log.reset()


def _c(m, name):
    return m.counter(name).value


def test_fields_and_schema_are_the_jax_ones():
    assert wide_events.FIELDS == jwide.FIELDS
    assert wide_events.WIDE_EVENTS_SCHEMA == jwide.WIDE_EVENTS_SCHEMA


# ---------------------------------------------------------------------------
# the JAX cases, on each package
# ---------------------------------------------------------------------------

def test_wide_event_closed_vocabulary_and_seq(pkg):
    wide, _, _, m, _ = pkg
    wide.wide_log.reset(capacity=4)
    u0 = _c(m, "telemetry.wide_events.unknown_fields")
    e0 = _c(m, "telemetry.wide_events.emitted")
    ev = wide.wide_event("serving.request", model="m", bogus=1, rows=4)
    assert "bogus" not in ev
    assert set(ev) <= wide.FIELDS
    assert _c(m, "telemetry.wide_events.unknown_fields") - u0 == 1
    ev2 = wide.wide_event("serving.request", model="m")
    assert ev2["seq"] == ev["seq"] + 1
    assert _c(m, "telemetry.wide_events.emitted") - e0 == 2
    assert wide.wide_log.snapshot(since=ev["seq"]) == [ev2]
    for _ in range(6):
        wide.wide_event("serving.request", model="m")
    doc = wide.wide_log.doc()
    assert len(doc["events"]) == 4
    assert doc["dropped"] >= 2
    assert doc["schema"] == "dmlc.telemetry.wide_events/1"


def test_wide_event_stamps_trace_identity_and_verdict(pkg):
    wide, samp, tr, _, _ = pkg
    s = samp.install(samp.TailSampler(
        floor=0.0, keep_per_s=0.0, keep_slow_ms=1e9, decide_timeout_s=60.0,
        recorder=tr.SpanRecorder(capacity=64)))
    with tr.span("we-op") as sp:
        ev = wide.wide_event("serving.request", model="m")
    assert ev["trace_id"] == tr.format_id(sp.trace_id)
    assert ev.get("debug") is False
    ctx = samp.mark_debug(tr.TraceContext(tr.new_trace_id(),
                                          tr.new_trace_id()))
    with tr.activate(ctx):
        ev = wide.wide_event("serving.request", model="m")
    assert ev["debug"] is True
    tid = tr.new_trace_id()
    s.on_start(tid)
    s.on_end(tid, {"kind": "span", "name": "op",
                   "trace_id": tr.format_id(tid), "span_id": "s1",
                   "parent_id": None, "dur_us": 10,
                   "attrs": {"status": "FAILED"}, "events": []})
    ev = wide.wide_event("serving.request", model="m",
                         trace_id=tr.format_id(tid))
    assert ev["sampled"] is True


def test_wide_event_file_mirror(pkg, tmp_path):
    wide = pkg[0]
    path = tmp_path / "audit.jsonl"
    wide.wide_log.reset(capacity=64, path=str(path))
    wide.wide_event("serving.request", model="m", rows=4, outcome="OK")
    wide.wide_event("data_service.lease", worker="w0", part=1, outcome="OK")
    docs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [d["kind"] for d in docs] == ["serving.request",
                                         "data_service.lease"]
    assert all(set(d) <= wide.FIELDS for d in docs)


def test_events_endpoint_serves_since_cursor(pkg):
    wide, _, _, _, expo = pkg
    srv = expo.TelemetryServer(port=0, host="127.0.0.1").start()
    try:
        evs = [wide.wide_event("serving.request", model="m", req_id=i)
               for i in range(3)]
        code, ctype, body = scrape(srv.port, "/events")
        doc = json.loads(body)
        assert (code, ctype) == (200, "application/json")
        assert [e["req_id"] for e in doc["events"]] == [0, 1, 2]
        assert doc["last_seq"] == evs[-1]["seq"]
        doc = json.loads(scrape(srv.port,
                                f"/events?since={evs[1]['seq']}")[2])
        assert [e["req_id"] for e in doc["events"]] == [2]
        doc = json.loads(scrape(srv.port, "/events?since=junk")[2])
        assert len(doc["events"]) == 3
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the same calls, both logs
# ---------------------------------------------------------------------------

def _emits(seed, n):
    rng = np.random.default_rng(seed)
    fields = sorted(wide_events.FIELDS - {"kind", "seq", "ts", "sampled"})
    out = []
    for i in range(n):
        kw = {}
        for f in rng.choice(fields, size=int(rng.integers(1, 8)),
                            replace=False):
            kw[str(f)] = [int(rng.integers(0, 1000)), "x", None, 1.5,
                          True][int(rng.integers(0, 5))]
        if rng.random() < 0.2:
            kw["bogus_" + str(int(rng.integers(0, 3)))] = 1
        if rng.random() < 0.3:
            kw["trace_id"] = f"{int(rng.integers(1, 1 << 62)):016x}"
        out.append((["serving.request", "data_service.lease"][i % 2], kw))
    return out


@pytest.mark.parametrize("capacity", [8, 2048])
def test_same_emits_give_the_jax_events(capacity, tmp_path):
    calls = _emits(capacity, 300)
    got = {}
    for name, (wide, samp, *_rest, m, _) in PACKAGES.items():
        samp.uninstall()
        m.reset()
        path = tmp_path / f"{name}.jsonl"
        log = wide.WideEventLog(capacity=capacity, path=str(path))
        evs = [log.emit(kind, **dict(kw)) for kind, kw in calls]
        doc = log.doc(since=evs[100]["seq"])
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        got[name] = ([{k: v for k, v in e.items() if k != "ts"}
                      for e in evs],
                     {k: v for k, v in doc.items() if k not in
                      ("events", "file")},
                     [{k: v for k, v in e.items() if k != "ts"}
                      for e in doc["events"]],
                     [{k: v for k, v in e.items() if k != "ts"}
                      for e in lines],
                     {k: v for k, v in m.snapshot().items()
                      if k.startswith("telemetry.wide_events.")})
    assert got["port"] == got["jax"]
    assert got["port"][4]["telemetry.wide_events.unknown_fields"]["value"] > 0


def test_the_verdict_is_the_ports_sampler_s():
    """A JAX sampler that keeps everything and a port sampler that drops
    a healthy trace: the port's event carries the port's verdict."""
    keep_all = jsampling.TailSampler(floor=1.0, keep_per_s=0.0,
                                     recorder=jtrace.SpanRecorder(8))
    drop = sampling.TailSampler(floor=0.0, keep_per_s=0.0, keep_slow_ms=1e9,
                                recorder=teltrace.SpanRecorder(8))
    jsampling.install(keep_all)
    sampling.install(drop)
    tid = teltrace.new_trace_id()
    rec = {"kind": "span", "name": "op", "trace_id": teltrace.format_id(tid),
           "span_id": "s", "parent_id": None, "dur_us": 1,
           "attrs": {"status": "OK"}, "events": []}
    for s in (keep_all, drop):
        s.on_start(tid)
        s.on_end(tid, dict(rec))
    ev = wide_events.wide_event("serving.request",
                                trace_id=teltrace.format_id(tid))
    assert ev["sampled"] is False
    jev = jwide.wide_event("serving.request",
                           trace_id=teltrace.format_id(tid))
    assert jev["sampled"] is True


# ---------------------------------------------------------------------------
# the servers' serving.request events
# ---------------------------------------------------------------------------

def _frames(seed):
    """Seeded request frames: (frame, expect an answer).  Untraced,
    traced under seeded ids, and one with the debug bit."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        ids, vals, row_ptr = _req(rng, int(rng.integers(1, 9)), 6)
        tid = sid = 0
        if i % 3:
            tid = int(rng.integers(1, 1 << 63, dtype=np.int64))
            sid = int(rng.integers(1, 1 << 63, dtype=np.int64))
            if i == 5:
                tid |= sampling.DEBUG_BIT
        rp = np.asarray(row_ptr, np.int32)
        out.append(tserver.REQ_HEADER.pack(100 + i, tid, sid, len(rp) - 1,
                                           len(ids))
                   + rp.tobytes() + ids.tobytes() + vals.tobytes())
    return out


def _one_by_one(addr, frames, log):
    """Each frame sent once the last answer came back (one request a
    batch) and its wide event is in ``log``, on one connection; returns
    the statuses.  A server emits a request's event just after its
    answer, so without the wait a shed request's event (emitted on the
    reader's thread at once) could land before its predecessor's."""
    statuses = []
    with socket.create_connection(addr, timeout=30) as s:
        for frame in frames:
            req_id = tserver.REQ_HEADER.unpack_from(frame)[0]
            since = log.doc()["last_seq"]
            s.sendall(frame)
            head = _recv(s, tserver.RSP_HEADER.size)
            _, status, k = tserver.RSP_HEADER.unpack(head)
            _recv(s, 4 * k if status == 0 else k)
            statuses.append(status)
            deadline = time.monotonic() + 30.0
            while not any(e.get("req_id") == req_id
                          for e in log.snapshot(since=since)):
                assert time.monotonic() < deadline, f"no event for {req_id}"
                time.sleep(0.001)
    return statuses


def _bundles(path):
    return sorted(d for d in os.listdir(path) if d.startswith("incident-"))


def test_servers_serve_equal_events(monkeypatch, tmp_path):
    params = _fm_params(3)
    frames = _frames(11)
    for key in ("DMLC_SLO_SPEC", "DMLC_METRICS_PORT", "DMLC_AUTOTUNE",
                "DMLC_WIDE_EVENTS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DMLC_TRACE_SAMPLE", "0.5")
    monkeypatch.setenv("DMLC_FLIGHT_HOOKS", "0")
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "serving.server.admit:error=1:times=2:after=6")
    servers = {"port": lambda: tserver.PredictionServer(
                   _port_fm(params, buckets=BucketLadder(LADDER)),
                   metrics_port=0),
               "jax": lambda: jserver.PredictionServer(
                   _jax_fm(params, LADDER), metrics_port=0)}
    docs, statuses, a12e = {}, {}, {}
    for name, make in servers.items():
        wide, samp, tr, m, _ = PACKAGES[name]
        samp.uninstall()
        tr.recorder.clear()
        # what earlier tests of the process left: events that would be
        # evicted (``dropped``) and root latencies that would set the
        # sampler's adaptive slow threshold (``sampled``)
        wide.wide_log.reset()
        m.reset()
        flight_dir = tmp_path / name
        monkeypatch.setenv("DMLC_FLIGHT_DIR", str(flight_dir))
        rec = importlib.import_module(
            samp.__name__.rsplit(".", 1)[0] + ".flight").flight_recorder
        monkeypatch.setattr(rec, "_last_dump", -float("inf"))
        first = wide.wide_log.doc()["last_seq"]
        for mod in (tfaults, jfaults):
            mod.clear_faults()         # the spec compiles afresh
        srv = make().start()
        try:
            assert samp.get_sampler() is not None and rec.armed
            statuses[name] = _one_by_one((srv.host, srv.port), frames,
                                         wide.wide_log)
            port = srv.telemetry.port
            code, ctype, body = scrape(port, f"/events?since={first}")
            assert (code, ctype) == (200, "application/json")
            docs[name] = json.loads(body)
            code, _, body = scrape(port, "/flight")
            assert code == 200
            bundle = json.loads(body)
            assert bundle["schema"] == "dmlc.flight.incident/1"
            assert bundle["reason"] == "endpoint"
            assert bundle["dumped_to"].startswith(str(flight_dir))
            for path in ("/profile?seconds=0.05", "/analyze", "/diagnose"):
                code, ctype, body = scrape(port, path)
                a12e[name, path] = (code, ctype, None if path.startswith(
                    "/profile") else sorted(json.loads(body)))
        finally:
            srv.stop()
            for mod in (tfaults, jfaults):
                mod.clear_faults()
        reasons = [b.rsplit("-", 1)[-1] for b in _bundles(flight_dir)]
        # the fault's bundle, then the endpoint's (forced)
        assert sorted(reasons) == ["endpoint", "injected_fault"], reasons
    assert statuses["port"] == statuses["jax"]
    assert statuses["port"].count(tserver.STATUS_OVERLOADED) == 2
    for path in ("/profile?seconds=0.05", "/analyze", "/diagnose"):
        assert a12e["port", path] == a12e["jax", path]
        assert a12e["port", path][0] == 200

    def norm(doc):
        evs = doc["events"]
        seq0 = evs[0]["seq"]
        return [{**{k: v for k, v in e.items() if k not in VOLATILE},
                 "seq": e["seq"] - seq0} for e in evs]

    port, jax_ = norm(docs["port"]), norm(docs["jax"])
    assert port == jax_
    assert len(port) == len(frames)
    assert [e["outcome"] for e in port].count("OVERLOADED") == 2
    assert all(set(e) <= wide_events.FIELDS for e in docs["port"]["events"])
    traced = [e for e in port if "trace_id" in e]
    assert len(traced) == 8 and any(e.get("debug") for e in traced)
    # a trace this server roots has its verdict when its event is made
    assert all("sampled" in e for e in traced if e["outcome"] == "OK")
    for k in ("missed", "dropped", "schema"):
        assert docs["port"][k] == docs["jax"][k]
