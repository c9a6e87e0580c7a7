"""The port's flight recorder (``telemetry/flight.py``), its triggers and
the log tail it bundles, held against the JAX package on the CPU.

* A bundle dumped by each package's recorder from the same notes,
  snapshots, spans, history and baseline profile: the port's files and
  ``incident.json`` keys (``files`` among them) are the JAX package's,
  the four sections of A.12.e (``profile_collapsed``, ``critical_path``,
  ``profile_diff``, ``diagnosis``) and their five files among them; the
  counter deltas, the critical path (byte for byte, over seeded span
  records) and the diagnosis (``ts``, ``wall_ms`` and the window's clock
  aside) are equal; the schema is ``dmlc.flight.incident/1``;
  ``_counter_deltas`` equals the JAX one on seeded snapshots (exact).
* The JAX cases of ``tests/test_flight.py`` (the golden bundle, unarmed
  and rate-limited dumps, the bounded note ring, an injected fault's
  evidence, ``/flight``, the end-to-end incident drill less its tracker,
  which is ROADMAP A.7.b), run on the port, and the unit ones on each
  package.
* Each package's triggers reach only its own recorder: a port fault, a
  port SLO breach or a port engine failure never the JAX recorder, and a
  JAX fault never the port's.
* The fatal paths: ``sys.excepthook`` and ``threading.excepthook`` dump
  and chain; SIGTERM in a process that armed the recorder (and in
  ``serve_main``'s, the server on the CPU) leaves a ``fatal_signal``
  bundle and still ends the process by the signal.
* An engine failure in the micro-batcher notes and dumps
  ``engine_failure`` as the JAX batcher does, and the bundle touches no
  CUDA call (every one raises in that test).

The ``history`` fixture (from ``tests/test_torch_exposition.py``) stops
both history samplers and puts back both packages' installed samplers,
flight recorders, exception hooks and signal handlers.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.serving import server as jserver  # noqa: E402
from dmlc_core_tpu.telemetry import anomaly as janomaly  # noqa: E402
from dmlc_core_tpu.telemetry import exposition as jexposition  # noqa: E402
from dmlc_core_tpu.telemetry import diagnose as jdiagnose  # noqa: E402
from dmlc_core_tpu.telemetry import flight as jflight  # noqa: E402
from dmlc_core_tpu.telemetry import profiling as jprofiling  # noqa: E402
from dmlc_core_tpu.telemetry import timeseries as jtimeseries  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.telemetry import wide_events as jwide  # noqa: E402
from dmlc_core_tpu.utils import faults as jfaults  # noqa: E402
from dmlc_core_tpu.utils import logging as jlogging  # noqa: E402
from dmlc_core_tpu_torch.serving import server as tserver  # noqa: E402
from dmlc_core_tpu_torch.telemetry import anomaly  # noqa: E402
from dmlc_core_tpu_torch.telemetry import diagnose  # noqa: E402
from dmlc_core_tpu_torch.telemetry import exposition  # noqa: E402
from dmlc_core_tpu_torch.telemetry import flight  # noqa: E402
from dmlc_core_tpu_torch.telemetry import profiling  # noqa: E402
from dmlc_core_tpu_torch.telemetry import timeseries  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.telemetry import wide_events  # noqa: E402
from dmlc_core_tpu_torch.utils import faults as tfaults  # noqa: E402
from dmlc_core_tpu_torch.utils import logging as tlogging  # noqa: E402
from test_torch_exposition import history, scrape  # noqa: E402,F401
from test_torch_server import _answers, _frame, _Stub  # noqa: E402

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "port": SimpleNamespace(fl=flight, tr=teltrace, m=tmetrics.metrics,
                            faults=tfaults, anomaly=anomaly,
                            ts=timeseries, wide=wide_events,
                            exposition=exposition, server=tserver,
                            profiling=profiling, diagnose=diagnose,
                            name="dmlc_core_tpu_torch"),
    "jax": SimpleNamespace(fl=jflight, tr=jtrace, m=jmetrics.metrics,
                           faults=jfaults, anomaly=janomaly,
                           ts=jtimeseries, wide=jwide,
                           exposition=jexposition, server=jserver,
                           profiling=jprofiling, diagnose=jdiagnose,
                           name="dmlc_core_tpu"),
}
#: the JAX bundle's sections from the profiler, the critical path and the
#: diagnosis (ROADMAP A.12.e), by key and by file
A12E_KEYS = {"profile_collapsed", "critical_path", "profile_diff",
             "diagnosis"}
A12E_FILES = {"profile": "profile.txt", "critical_path": "critical_path.txt",
              "profile_diff": "profile_diff.txt",
              "diagnosis": "diagnosis.json",
              "diagnosis_text": "diagnosis.txt"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fresh spans, wide events and faults; each global recorder
    disarmed, free of its rate limit, its rings empty (``history``
    restores the rest)."""
    for p in PACKAGES.values():
        p.tr.recorder.clear()
        p.wide.wide_log.reset()
        p.faults.clear_faults()
        rec = p.fl.flight_recorder
        monkeypatch.setattr(rec, "_dir", None)
        monkeypatch.setattr(rec, "_min_interval", 0.0)
        monkeypatch.setattr(rec, "_last_dump", -float("inf"))
        rec._snaps.clear()
        rec._notes.clear()
    for key in ("DMLC_FAULT_SPEC", "DMLC_SLO_SPEC", "DMLC_FLIGHT_DIR"):
        monkeypatch.delenv(key, raising=False)
    yield
    for p in PACKAGES.values():
        p.tr.recorder.clear()
        p.faults.clear_faults()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _assert_chrome_trace_valid(doc):
    assert isinstance(doc, dict) and isinstance(doc["traceEvents"], list)
    for ev in doc["traceEvents"]:
        assert isinstance(ev["name"], str)
        assert ev["ph"] in ("X", "b", "e", "i", "M")
        assert isinstance(ev["pid"], int)
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float)) and ev["dur"] >= 0


def _bundles(path, reason=None):
    return sorted(d for d in os.listdir(path) if d.startswith("incident-")
                  and (reason is None or d.endswith("-" + reason)))


# ---------------------------------------------------------------------------
# the bundle, against the JAX one
# ---------------------------------------------------------------------------

def _golden_dump(p, directory):
    """The JAX golden's inputs, on one package: a note, a registry
    snapshot between two counter bumps, a span, two history samples."""
    rec = p.fl.FlightRecorder()
    rec._min_interval = 0.0
    rec.note("fault_injected", site="x.y")
    p.m.counter("drill.work").add(1)
    p.ts.history.sample_once()
    rec.note_snapshot()
    p.m.counter("drill.work").add(3)
    with p.tr.span("drill.step"):
        pass
    p.wide.wide_event("serving.request", model="m", rows=1)
    p.ts.history.sample_once()
    return rec.arm(str(directory)).dump("unit_test", why="golden")


def _span_records(seed, n=8):
    """Seeded finished-span records: ``n`` traces of a root, two children
    and a grandchild, milliseconds long, in 2001 (outside any live
    diagnosis window)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        tid = f"{t + 1:016x}"
        t0 = 10 ** 15 + t * 10 ** 6
        dur = int(rng.integers(5_000, 50_000))
        a = int(rng.integers(0, dur // 2))
        b = int(rng.integers(a + 1, dur))
        spans = [("root", None, t0, dur), ("stage.a", "root", t0 + a // 4, a),
                 ("stage.b", "root", t0 + a, b - a),
                 ("leaf", "stage.b", t0 + a + 1, (b - a) // 3)]
        for name, parent, ts, d in spans:
            out.append({"kind": "span", "name": name, "trace_id": tid,
                        "span_id": f"{tid}{name}", "ts_us": ts, "dur_us": d,
                        "parent_id": f"{tid}{parent}" if parent else None,
                        "attrs": {}, "events": []})
    return out


def _stable_diagnosis(doc):
    """A diagnosis document less its clock: ``ts``, ``wall_ms``, the
    window's ends and the timeline's onset when no breach names one."""
    doc = json.loads(json.dumps(doc))
    for k in ("ts", "wall_ms"):
        doc.pop(k)
    for k in ("since", "until"):
        doc["window"].pop(k)
    doc["analyzers"]["timeline"].pop("breach_onset")
    return doc


def test_bundle_keys_and_files_equal_the_jax_ones(monkeypatch, tmp_path):
    paths, docs = {}, {}
    for name, p in PACKAGES.items():
        p.m.reset()
        # only the wide-event section contributes, in both processes' view
        monkeypatch.setattr(p.fl, "_contributors", {})
        monkeypatch.setattr(p.wide.wide_log, "_registered", False)
        for rec in _span_records(4):
            p.tr.recorder.record(rec)
        p.profiling.record_baseline("base;idle 3\nbase;work 1", ts=1.0)
        paths[name] = _golden_dump(p, tmp_path / name)
        docs[name] = json.load(open(os.path.join(paths[name],
                                                 "incident.json")))
    port, jax_ = docs["port"], docs["jax"]
    assert set(port) == set(jax_)
    assert set(port) >= A12E_KEYS           # the four sections, in both
    assert port["files"] == jax_["files"]
    assert set(port["files"].items()) >= set(A12E_FILES.items())
    assert sorted(os.listdir(paths["port"])) == sorted(
        os.listdir(paths["jax"]))
    assert port["critical_path"] == jax_["critical_path"]
    for n, p in PACKAGES.items():
        with open(os.path.join(paths[n], "critical_path.txt")) as f:
            assert f.read() == docs[n]["critical_path"]
        with open(os.path.join(paths[n], "diagnosis.txt")) as f:
            assert f.read() == p.diagnose.render_text(docs[n]["diagnosis"])
    assert _stable_diagnosis(port["diagnosis"]) == \
        _stable_diagnosis(jax_["diagnosis"])
    assert port["diagnosis"]["trigger"] == {"kind": "explicit"}
    for doc in (port, jax_):
        lines = doc["profile_collapsed"].splitlines()
        assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
        assert doc["profile_diff"].startswith(
            "# profile diff: baseline @ 1 (")
    for key in ("schema", "reason", "detail", "notes", "metrics_delta",
                "span_count"):
        if key == "notes":
            assert [{k: v for k, v in n.items() if k != "ts"}
                    for n in port[key]] == \
                [{k: v for k, v in n.items() if k != "ts"}
                 for n in jax_[key]]
        elif key == "metrics_delta":
            assert port[key]["deltas"] == jax_[key]["deltas"]
        else:
            assert port[key] == jax_[key], key
    assert port["wide_events"]["schema"] == jax_["wide_events"]["schema"]


def test_incident_bundle_schema_golden(tmp_path):
    path = _golden_dump(PACKAGES["port"], tmp_path)
    assert path is not None and os.path.isdir(path)
    assert sorted(os.listdir(path)) == ["critical_path.txt",
                                        "diagnosis.json", "diagnosis.txt",
                                        "incident.json", "log_tail.txt",
                                        "profile.txt", "timeline.json",
                                        "trace.json"]
    doc = json.load(open(os.path.join(path, "incident.json")))
    for key in ("schema", "reason", "detail", "ts", "pid", "host", "rank",
                "slo_spec", "fault_spec", "metrics", "metrics_delta",
                "notes", "span_count", "files", "timeline"):
        assert key in doc, key
    # no baseline profile recorded: no diff, the other three sections
    assert set(doc) & A12E_KEYS == A12E_KEYS - {"profile_diff"}
    assert doc["schema"] == flight.INCIDENT_SCHEMA == "dmlc.flight.incident/1"
    assert doc["reason"] == "unit_test"
    assert doc["detail"] == {"why": "golden"}
    assert doc["notes"][0]["kind"] == "fault_injected"
    assert doc["metrics"]["drill.work"]["value"] >= 4
    assert doc["metrics_delta"]["deltas"]["drill.work"] == 3
    assert doc["files"] == {"incident": "incident.json",
                            "trace": "trace.json",
                            "log_tail": "log_tail.txt",
                            "timeline": "timeline.json",
                            "profile": "profile.txt",
                            "critical_path": "critical_path.txt",
                            "diagnosis": "diagnosis.json",
                            "diagnosis_text": "diagnosis.txt"}
    assert "drill.step" in doc["critical_path"]
    assert doc["profile_collapsed"].strip()
    tl = json.load(open(os.path.join(path, "timeline.json")))
    assert "drill.work.rate" in tl["series"]
    trace_doc = json.load(open(os.path.join(path, "trace.json")))
    _assert_chrome_trace_valid(trace_doc)
    assert "drill.step" in {ev["name"] for ev in trace_doc["traceEvents"]}


def _snapshots(seed):
    rng = np.random.default_rng(seed)
    regs = [tmetrics.MetricsRegistry() for _ in range(2)]
    for reg in regs:
        for i in range(12):
            reg.counter(f"c{i}").add(int(rng.integers(0, 5)))
            reg.gauge(f"g{i}").set(float(rng.random()))
            reg.throughput(f"t{i}").add(int(rng.integers(0, 100)))
            with reg.stage(f"s{i}").time():
                pass
            for v in rng.random(int(rng.integers(0, 4))):
                reg.histogram(f"h{i}").observe(float(v))
    regs[1].counter("only.new").add(1)
    old, new = regs[0].snapshot(), regs[1].snapshot()
    old["type.changed"] = {"type": "counter", "value": 1}
    new["type.changed"] = {"type": "gauge", "value": 2.0}
    return old, new


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_deltas_equal_the_jax_ones(seed):
    old, new = _snapshots(seed)
    got = flight._counter_deltas(old, new)
    assert got == jflight._counter_deltas(old, new)
    assert got


# ---------------------------------------------------------------------------
# the JAX unit cases, on each package
# ---------------------------------------------------------------------------

def test_dump_unarmed_is_none_and_rate_limited(pkg, tmp_path):
    rec = pkg.fl.FlightRecorder()
    assert rec.dump("nope") is None
    rec.arm(str(tmp_path))
    rec._min_interval = 3600.0
    assert rec.dump("first") is not None
    assert rec.dump("suppressed") is None
    assert rec.dump("forced", force=True) is not None
    assert [b.rsplit("-", 1)[-1] for b in _bundles(tmp_path)] == \
        ["first", "forced"]


def test_min_interval_comes_from_the_environment(pkg, monkeypatch):
    monkeypatch.setenv("DMLC_FLIGHT_MIN_INTERVAL", "2.5")
    assert pkg.fl.FlightRecorder()._min_interval == 2.5


def test_note_ring_is_bounded(pkg):
    rec = pkg.fl.FlightRecorder(note_capacity=8)
    for i in range(50):
        rec.note("n", i=i)
    notes = rec.notes()
    assert len(notes) == 8 and notes[-1]["i"] == 49


def test_injected_error_fault_leaves_flight_evidence(pkg, tmp_path):
    pkg.fl.flight_recorder.arm(str(tmp_path))
    c0 = pkg.m.counter("flight.fault_triggers").value
    with pkg.faults.inject_faults("drill.boom:error=1"):
        with pytest.raises(Exception):
            pkg.faults.fault_point("drill.boom")
    kinds = [n["kind"] for n in pkg.fl.flight_recorder.notes()]
    assert "fault_injected" in kinds
    assert _bundles(tmp_path, "injected_fault")
    assert pkg.m.counter("flight.fault_triggers").value - c0 == 1
    doc = json.load(open(os.path.join(
        tmp_path, _bundles(tmp_path)[0], "incident.json")))
    assert doc["fault_spec"] == "drill.boom:error=1"


def test_flight_endpoint_returns_bundle(pkg, tmp_path):
    pkg.fl.flight_recorder.arm(str(tmp_path))
    pkg.fl.flight_recorder.note("unit", marker="endpoint-test")
    srv = pkg.exposition.TelemetryServer(port=0, host="127.0.0.1").start()
    try:
        code, ctype, body = scrape(srv.port, "/flight")
        assert (code, ctype) == (200, "application/json")
        doc = json.loads(body)
        assert doc["schema"] == "dmlc.flight.incident/1"
        assert doc["reason"] == "endpoint"
        assert any(n["kind"] == "unit" for n in doc["notes"])
        assert doc["dumped_to"].startswith(str(tmp_path))
    finally:
        srv.stop()


def test_maybe_arm_from_env(pkg, monkeypatch, tmp_path):
    rec = pkg.fl.flight_recorder
    monkeypatch.setattr(rec, "_installed", False)
    assert pkg.fl.maybe_arm_from_env() is None and not rec.armed
    monkeypatch.setenv("DMLC_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DMLC_FLIGHT_HOOKS", "0")
    assert pkg.fl.maybe_arm_from_env() is rec
    assert rec.armed and not rec._installed
    monkeypatch.setenv("DMLC_FLIGHT_HOOKS", "1")
    hooks = (sys.excepthook, threading.excepthook)
    assert pkg.fl.maybe_arm_from_env() is rec and rec._installed
    assert (sys.excepthook, threading.excepthook) != hooks


def test_excepthooks_dump_and_chain(pkg, tmp_path):
    rec = pkg.fl.FlightRecorder().arm(str(tmp_path))
    seen = []
    sys.excepthook = lambda *a: seen.append(("main", a[0]))
    threading.excepthook = lambda args: seen.append(("thread",
                                                     args.exc_type))
    rec.install(signals=False)
    try:
        raise KeyError("boom")
    except KeyError:
        sys.excepthook(*sys.exc_info())

    def fail():
        raise ValueError("thread boom")

    t = threading.Thread(target=fail, name="flight-test-thread")
    t.start()
    t.join()
    assert seen == [("main", KeyError), ("thread", ValueError)]
    docs = [json.load(open(os.path.join(tmp_path, d, "incident.json")))
            for d in _bundles(tmp_path)]
    assert [(d["reason"], d["detail"].get("thread")) for d in docs] == \
        [("unhandled_exception", None),
         ("unhandled_thread_exception", "flight-test-thread")]
    assert docs[1]["detail"]["error"] == "ValueError: thread boom"


_SIGTERM_CHILD = r"""
import os, signal, sys
sys.path.insert(0, {repo!r})
from {pkg}.telemetry import flight
from {pkg}.utils.logging import log_info
flight.flight_recorder.arm({out!r}).install()
log_info("child armed")
os.kill(os.getpid(), signal.SIGTERM)
print("not reached")
"""


def test_sigterm_leaves_a_fatal_signal_bundle(pkg, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _SIGTERM_CHILD.format(
            repo=REPO, pkg=pkg.name, out=str(tmp_path))],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGTERM, out.stderr
    assert "not reached" not in out.stdout
    (b,) = _bundles(tmp_path, "fatal_signal")
    doc = json.load(open(os.path.join(tmp_path, b, "incident.json")))
    assert doc["detail"] == {"signal": "SIGTERM"}
    tail = open(os.path.join(tmp_path, b, "log_tail.txt")).read()
    assert "child armed" in tail


def test_serve_main_sigterm_leaves_a_fatal_signal_bundle(tmp_path):
    """The port's CLI server on the CPU with ``DMLC_FLIGHT_DIR``: SIGTERM
    after ``serving on`` leaves a ``fatal_signal`` bundle, and the process
    ends by the signal."""
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               DMLC_FLIGHT_DIR=str(tmp_path / "flight"),
               DMLC_TRACE_SAMPLE="0.5")
    for key in ("DMLC_METRICS_PORT", "DMLC_SLO_SPEC", "DMLC_FAULT_SPEC"):
        env.pop(key, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serving.server",
         f"ckpt_dir={ckpt}", "features=64", "model=fm", "dim=4",
         "host=127.0.0.1", "port=0", "device=cpu", "watch_s=3600"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on "), proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    (b,) = _bundles(tmp_path / "flight", "fatal_signal")
    doc = json.load(open(tmp_path / "flight" / b / "incident.json"))
    assert doc["detail"] == {"signal": "SIGTERM"}
    assert doc["metrics"]["serving.server.connections"]["value"] == 0


# ---------------------------------------------------------------------------
# each package's triggers reach only its own recorder
# ---------------------------------------------------------------------------

class _Failing(_Stub):
    """An engine whose every call raises, as a failed graph replay does."""

    def __init__(self, exc):
        super().__init__()
        self.exc = exc

    def predict(self, ids, vals, row_ptr):
        raise self.exc


def test_a_port_fault_reaches_only_the_ports_recorder(tmp_path):
    dirs = {n: tmp_path / n for n in PACKAGES}
    for n, p in PACKAGES.items():
        p.fl.flight_recorder.arm(str(dirs[n]))
    for n, p in PACKAGES.items():
        other = "jax" if n == "port" else "port"
        with p.faults.inject_faults("drill.only:error=1:times=1"):
            with pytest.raises(OSError):
                p.faults.fault_point("drill.only")
        assert [x["kind"] for x in p.fl.flight_recorder.notes()] == \
            ["fault_injected"]
        assert len(_bundles(dirs[n], "injected_fault")) == 1
        if n == "port":
            assert not PACKAGES[other].fl.flight_recorder.notes()
            assert not dirs[other].exists()
    # a port SLO breach and a port engine failure: the port's only
    jflight.flight_recorder._notes.clear()
    reg = tmetrics.MetricsRegistry()
    reg.gauge("q.depth").set(9)
    anomaly.SloMonitor(anomaly.parse_slo_spec("q.depth:max=1"),
                       registry=reg, interval_s=3600).evaluate_once()
    srv = tserver.PredictionServer(_Failing(RuntimeError("replay")),
                                   warmup=False).start()
    try:
        _answers((srv.host, srv.port), [(_frame(1, [1], [1.0], [0, 1]), 0)],
                 1)
    finally:
        srv.stop()
    kinds = [x["kind"] for x in flight.flight_recorder.notes()]
    assert "slo_breach" in kinds and "engine_failure" in kinds
    assert not jflight.flight_recorder.notes()
    assert len(_bundles(dirs["jax"])) == 1
    assert {b.rsplit("-", 1)[-1] for b in _bundles(dirs["port"])} == \
        {"injected_fault", "slo_breach", "engine_failure"}


@pytest.mark.parametrize("exc", ["RuntimeError", "RequestTooLarge"])
def test_engine_failure_is_noted_as_the_jax_batcher_does(monkeypatch,
                                                         tmp_path, exc):
    """Both servers over an engine that raises: the same answers and the
    same ``engine_failure`` note (``RequestTooLarge``: none).  The port's
    bundle calls nothing of ``torch.cuda`` (each call raises here), as a
    bundle after a sticky CUDA error must not."""
    def no_cuda(*a, **k):
        raise AssertionError("a bundle touched torch.cuda")

    for fn in ("synchronize", "is_available", "current_stream",
               "device_count", "get_device_name", "memory_allocated",
               "max_memory_allocated", "Event", "Stream"):
        monkeypatch.setattr(torch.cuda, fn, no_cuda)
    notes, answers = {}, {}
    for name, p in PACKAGES.items():
        errors = {"RuntimeError": RuntimeError("CUDA error: an illegal "
                                               "memory access"),
                  "RequestTooLarge": importlib.import_module(
                      p.name + ".serving.engine").RequestTooLarge("big")}
        p.fl.flight_recorder.arm(str(tmp_path / name))
        srv = p.server.PredictionServer(_Failing(errors[exc]),
                                        warmup=False).start()
        try:
            answers[name] = _answers(
                (srv.host, srv.port),
                [(_frame(1, [1, 2], [1.0, 1.0], [0, 1, 2]), 0)], 1)
        finally:
            srv.stop()
        notes[name] = [{k: v for k, v in n.items() if k != "ts"}
                       for n in p.fl.flight_recorder.notes()]
    assert answers["port"] == answers["jax"]
    assert notes["port"] == notes["jax"]
    if exc == "RequestTooLarge":
        assert notes["port"] == [] and not (tmp_path / "port").exists()
        return
    assert notes["port"] == [{"kind": "engine_failure",
                              "error": "RuntimeError: CUDA error: an "
                                       "illegal memory access",
                              "requests": 1, "rows": 2}]
    (b,) = _bundles(tmp_path / "port", "engine_failure")
    doc = json.load(open(tmp_path / "port" / b / "incident.json"))
    assert doc["detail"] == {"error": "RuntimeError: CUDA error: an illegal "
                                      "memory access"}


# ---------------------------------------------------------------------------
# the log tail, and the incident drill
# ---------------------------------------------------------------------------

def test_log_tail_keeps_the_last_lines(monkeypatch):
    for i in range(3):
        tlogging.log_info("tail line %d", i)
    tlogging.log_warning("tail warning")
    tail = tlogging.get_log_tail()
    assert [ln.split(" ", 1)[1] for ln in tail if " tail " in ln][-4:] == \
        ["INFO tail line 0", "INFO tail line 1", "INFO tail line 2",
         "WARNING tail warning"]
    assert len(tail) <= tlogging._log_tail.maxlen
    monkeypatch.setenv("DMLC_LOG_FORMAT", "json")
    with teltrace.span("tail-op") as sp:
        tlogging.log_info("json line")
    rec = json.loads(tlogging.get_log_tail()[-1])
    assert rec["msg"] == "json line" and rec["level"] == "INFO"
    assert rec["trace_id"] == teltrace.format_id(sp.trace_id)
    # the JAX tail: the same line shapes
    jlogging.log_info("json line")
    assert set(json.loads(jlogging.get_log_tail()[-1])) >= set(rec) - \
        {"trace_id"}


def test_log_tail_copies_while_threads_log():
    """A bundle copies the tail on one thread while others log: every copy
    completes and stays within the ring's bound.  Once all have stopped,
    each thread logs one last line, so the tail's last lines are one a
    thread whichever ran last (a thread that holds the interpreter for a
    switch interval logs a whole ring of lines)."""
    stop = threading.Event()
    stopped = threading.Barrier(4)

    def chatter(k):
        while not stop.is_set():
            tlogging.log_info("chatter %d", k)
        stopped.wait(timeout=60)
        tlogging.log_info("chatter %d", k)

    threads = [threading.Thread(target=chatter, args=(k,)) for k in range(4)]
    root = tlogging._logger.level
    tlogging._logger.setLevel("WARNING")      # the tail, not stderr
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 1.0
        copies = 0
        while time.monotonic() < deadline:
            assert len(tlogging.get_log_tail()) <= tlogging._log_tail.maxlen
            copies += 1
    finally:
        stop.set()
        for t in threads:
            t.join()
        tlogging._logger.setLevel(root)
    assert copies > 10
    assert any(ln.endswith("chatter 0") for ln in tlogging.get_log_tail())


def test_end_to_end_incident_drill(tmp_path, monkeypatch):
    """The JAX drill on the port, less the tracker (ROADMAP A.7.b): a
    ``DMLC_FAULT_SPEC`` stall hits a monitored stage, the stall breaches
    a ``DMLC_SLO_SPEC`` rule, and the bundle names the rule, the specs
    and the stall, with a loadable Chrome trace and a log tail."""
    monkeypatch.setenv("DMLC_SLO_SPEC", "anomaly.stalls.drill.stage:max=0")
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "drill.stage:latency=80ms:lp=1:after=30")
    assert flight.maybe_arm_from_env() is None
    flight.flight_recorder.arm(str(tmp_path))
    tmetrics.metrics.reset()
    det = anomaly.StallDetector("drill.stage", z_threshold=6.0,
                                min_samples=16, rel_floor=0.5)
    with teltrace.span("drill.run"):
        for _ in range(32):
            t0 = time.monotonic()
            with teltrace.span("drill.stage.step"):
                tfaults.fault_point("drill.stage")
            det.observe(time.monotonic() - t0)
    assert tmetrics.metrics.counter("anomaly.stalls.drill.stage").value >= 1
    mon = anomaly.maybe_monitor_from_env(autostart=False)
    fired = mon.evaluate_once()
    assert len(fired) == 1
    assert fired[0]["rule"].startswith("anomaly.stalls.drill.stage")
    assert tmetrics.metrics.gauge("slo.active_breaches").value == 1
    (b,) = _bundles(tmp_path, "slo_breach")
    doc = json.load(open(os.path.join(tmp_path, b, "incident.json")))
    assert doc["schema"] == "dmlc.flight.incident/1"
    assert doc["detail"]["breaches"][0]["rule"].startswith(
        "anomaly.stalls.drill.stage")
    assert doc["slo_spec"] == "anomaly.stalls.drill.stage:max=0"
    assert doc["fault_spec"] == "drill.stage:latency=80ms:lp=1:after=30"
    assert any(n["kind"] == "stage_stall" for n in doc["notes"])
    trace_doc = json.load(open(os.path.join(tmp_path, b, "trace.json")))
    _assert_chrome_trace_valid(trace_doc)
    assert "drill.stage.step" in {ev["name"]
                                  for ev in trace_doc["traceEvents"]}
    assert os.path.getsize(os.path.join(tmp_path, b, "log_tail.txt")) > 0
