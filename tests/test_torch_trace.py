"""The port's spans and traces, held against the JAX package on the CPU.

* Each trace test of ``tests/test_telemetry.py`` (nesting, ``activate``
  across threads, errors and events, the instant event, the bounded ring
  and ``telemetry.spans_dropped``, retry events, the Chrome schema) on
  the port's modules.
* One script of ``span`` / ``start_span`` / ``activate`` / ``add_event``
  calls through both packages: the records are equal once ids and times
  are mapped (names, parent structure, attributes, events, status), and
  so are their Chrome traces.  The same for the retry and circuit
  breaker events.
* A log record inside a span carries its trace id (text and JSON), and a
  histogram observed in a span holds the exemplar, as in the JAX
  package.
* ``profile_trace`` writes a Chrome trace that names a ``trace_span``
  range (the card's kernels: ``tests/test_torch_cuda.py``).
"""

import importlib
import json
import logging
import os
import threading

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.telemetry import chrome_trace as jchrome  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.utils import retry as jretry  # noqa: E402
from dmlc_core_tpu_torch import telemetry  # noqa: E402
from dmlc_core_tpu_torch.telemetry import chrome_trace  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.utils import retry  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import (log_info,  # noqa: E402
                                               log_warning)

# the modules (the packages' utils export the registries as `metrics`)
jmetrics_mod = importlib.import_module("dmlc_core_tpu.utils.metrics")
metrics_mod = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

PACKAGES = {"port": (teltrace, chrome_trace, retry, metrics_mod),
            "jax": (jtrace, jchrome, jretry, jmetrics_mod)}


@pytest.fixture(autouse=True)
def _clean_recorders():
    teltrace.recorder.clear()
    jtrace.recorder.clear()
    yield
    teltrace.recorder.clear()
    jtrace.recorder.clear()


# -- the JAX trace tests, on the port -----------------------------------------

def test_span_nesting_shares_trace_id():
    with teltrace.span("outer") as outer:
        with teltrace.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            assert teltrace.current() == inner.context
    assert teltrace.current() is None
    recs = {r["name"]: r for r in teltrace.recorder.snapshot()}
    assert recs["inner"]["trace_id"] == recs["outer"]["trace_id"]
    assert recs["inner"]["parent_id"] == recs["outer"]["span_id"]
    assert recs["outer"]["parent_id"] is None


def test_activate_crosses_threads():
    """A context re-activated on another thread parents that thread's
    spans (the contract the loader's threads and the batcher use)."""
    with teltrace.span("consumer") as root:
        ctx = teltrace.current()
    got = {}

    def other():
        got["before"] = teltrace.current()
        with teltrace.activate(ctx):
            with teltrace.span("child") as child:
                got["child"] = child
        got["after"] = teltrace.current()
    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert got["before"] is None and got["after"] is None
    assert got["child"].trace_id == root.trace_id
    assert got["child"].parent_id == root.span_id
    with teltrace.activate(None):        # None is a no-op, not an error
        assert teltrace.current() is None


def test_span_records_error_and_events():
    with pytest.raises(ValueError):
        with teltrace.span("boom") as s:
            s.event("checkpoint", step=3)
            raise ValueError("nope")
    (rec,) = teltrace.recorder.snapshot()
    assert rec["attrs"]["error"].startswith("ValueError")
    assert rec["events"][0]["name"] == "checkpoint"
    assert rec["events"][0]["attrs"]["step"] == 3


def test_add_event_without_span_records_instant():
    teltrace.add_event("orphan", detail="x")
    (rec,) = teltrace.recorder.snapshot()
    assert rec["kind"] == "event" and rec["name"] == "orphan"
    assert rec["trace_id"] is None


def test_recorder_ring_is_bounded_and_counts_evictions():
    before = metrics_mod.metrics.counter("telemetry.spans_dropped").value
    r = teltrace.SpanRecorder(capacity=4)
    for i in range(10):
        r.record({"name": str(i)})
    assert [x["name"] for x in r.snapshot()] == ["6", "7", "8", "9"]
    assert r.dropped == 6 and len(r) == 4
    assert (metrics_mod.metrics.counter("telemetry.spans_dropped").value
            - before) == 6
    r.clear()
    assert r.dropped == 0 and len(r) == 0
    # after a registry reset the evictions count on the new counter
    metrics_mod.metrics.reset()
    for i in range(6):
        r.record({"name": str(i)})
    assert metrics_mod.metrics.counter("telemetry.spans_dropped").value == 2


class _ZeroFirst:
    """An id source whose first two draws are 0."""

    def __init__(self):
        self.draws = [0, 0, 7]

    def getrandbits(self, k):
        assert k == 63
        return self.draws.pop(0)


def test_ids_are_63_bit_and_never_zero(monkeypatch):
    ids = [teltrace.new_trace_id() for _ in range(2000)]
    assert all(0 < i < (1 << 63) for i in ids)
    assert len(set(ids)) == len(ids)
    with monkeypatch.context() as m:
        m.setattr(teltrace, "_id_rng", _ZeroFirst())
        assert teltrace.new_trace_id() == 7      # zero is drawn again
    assert teltrace.format_id(5) == "0000000000000005"
    assert teltrace.wire_ids() == (0, 0)
    assert teltrace.from_wire(0, 7) is None
    assert teltrace.from_wire("x", 1) is None
    assert teltrace.from_wire(3, 4) == teltrace.TraceContext(3, 4)
    with teltrace.span("w") as s:
        assert teltrace.wire_ids() == (s.trace_id, s.span_id)
        assert teltrace.current_trace_id() == teltrace.format_id(s.trace_id)


def test_record_span_is_the_record_a_span_makes():
    """``record_span`` (the engine's leaf span, timed by its caller) gives
    the record a ``span`` over the same block gives: a child of the
    ambient context, or a new root, with its attributes, its time and
    its error; with a sampler it is a full span the sampler sees (the
    finished span itself, rendered only when its record is asked for)."""
    import time
    with teltrace.span("request") as req:
        t0w, t0 = time.time(), time.monotonic()
        time.sleep(0.002)
        teltrace.record_span("leaf", t0w, t0, rows=3, obj=object)
    t0w, t0 = time.time(), time.monotonic()
    teltrace.record_span("root", t0w, t0, error="ValueError: x")
    recs = {r["name"]: r for r in teltrace.recorder.snapshot()}
    leaf, root = recs["leaf"], recs["root"]
    assert leaf["trace_id"] == teltrace.format_id(req.trace_id)
    assert leaf["parent_id"] == teltrace.format_id(req.span_id)
    assert leaf["span_id"] not in (leaf["parent_id"], None)
    assert leaf["dur_us"] >= 2000 and leaf["ts_us"] >= int(t0w * 1e6) - 1e6
    assert leaf["attrs"] == {"rows": 3, "obj": str(object)}
    assert leaf["events"] == [] and leaf["kind"] == "span"
    assert leaf["pid"] == os.getpid()
    assert leaf["tid"] == threading.get_ident()
    assert leaf["thread"] == threading.current_thread().name
    assert set(leaf) == set(recs["request"])
    assert root["parent_id"] is None and root["trace_id"] != leaf["trace_id"]
    assert root["attrs"] == {"error": "ValueError: x"}
    assert teltrace.recorder.snapshot()[0] is leaf     # built once

    seen = []

    class Sampler:
        def on_start(self, trace_id):
            seen.append(("start", trace_id))

        def on_end(self, trace_id, span):
            rec = span.record()
            seen.append(("end", rec["name"], rec["dur_us"]))

    teltrace.set_sampler(Sampler())
    try:
        teltrace.record_span("sampled", time.time(),
                             time.monotonic() - 0.01)
    finally:
        teltrace.set_sampler(None)
    assert seen[0][0] == "start" and seen[1][:2] == ("end", "sampled")
    assert seen[1][2] >= 10_000


def test_retry_emits_span_events():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    pol = retry.RetryPolicy(max_attempts=5, base_delay_s=0.0,
                            retryable=lambda e: isinstance(e, OSError))
    with teltrace.span("op") as s:
        assert pol.call(flaky) == "ok"
        names = [e["name"] for e in s.events]
    assert names.count("retry") == 2


def test_chrome_trace_schema(tmp_path):
    with teltrace.span("parent"):
        with teltrace.span("child"):
            teltrace.add_event("tick", k=1)
    doc = chrome_trace.to_chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"parent", "child"}
    for e in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
    bs = [e for e in events if e["ph"] == "b"]
    es = [e for e in events if e["ph"] == "e"]
    assert len(bs) == len(es) == 2
    assert len({e["id"] for e in bs}) == 1     # one trace, one async id
    assert any(e["ph"] == "i" and e["name"] == "tick" for e in events)
    p = tmp_path / "trace.json"
    assert chrome_trace.write_chrome_trace(str(p)) == str(p)
    assert json.loads(p.read_text())["traceEvents"]


def test_dump_artifacts_writes_metrics_and_trace(tmp_path):
    metrics_mod.metrics.counter("test_torch_trace.dumped").add(2)
    with teltrace.span("dumped"):
        pass
    out = telemetry.dump_artifacts(str(tmp_path / "run"))
    snap = json.loads(open(out["metrics"]).read())["snapshot"]
    assert snap["test_torch_trace.dumped"]["value"] == 2
    names = {e["name"] for e in
             json.loads(open(out["trace"]).read())["traceEvents"]}
    assert "dumped" in names


# -- one script through both packages ------------------------------------------

class _Unjsonable:
    def __str__(self):
        return "unjsonable"


def _script(tr):
    """Every way of recording: nested scoped spans, attributes of every
    kind, a manual span ended later with a status, a context carried to a
    thread, events on a span and standalone ones, an error."""
    with tr.span("root", rows=4, ratio=0.5, flag=True, none=None,
                 listed=[1, 2], odd=_Unjsonable()) as root:
        tr.add_event("tick", k=1)
        with tr.span("child", bucket_rows=16):
            tr.add_event("inner", v=2.5)
        manual = tr.start_span("manual", parent=root.context, req_id=7)
        ctx = tr.current()

        def other():
            with tr.activate(ctx):
                with tr.span("on_thread", n=3):
                    pass
                tr.add_event("bare", where="thread")
        t = threading.Thread(target=other)
        t.start()
        t.join()
        manual.event("ev", x=[1, 2])
        manual.end(status="OK")
        manual.end(status="twice")             # idempotent
    try:
        with tr.span("boom", attempt=1):
            raise ValueError("nope")
    except ValueError:
        pass
    remote = tr.from_wire(1234, 5678)
    with tr.activate(remote):
        with tr.span("from_wire"):
            pass
    tr.add_event("orphan", detail="x")


def _normal(records):
    """Records with ids mapped to their order of first appearance and the
    times, process and thread dropped."""
    ids = {}

    def m(v):
        if v is None:
            return None
        return ids.setdefault(v, len(ids))
    out = []
    for r in records:
        r = dict(r)
        for k in ("ts_us", "dur_us", "pid", "tid", "thread"):
            r.pop(k, None)
        for k in ("trace_id", "span_id", "parent_id"):
            if k in r:
                r[k] = m(r[k])
        r["events"] = [{k: v for k, v in e.items() if k != "ts_us"}
                       for e in r.get("events", ())]
        out.append(r)
    return out


def _both(script, names):
    """``script(package modules)`` through each package; its records of
    those names (a thread another test left running may record too)."""
    out = {}
    for name, mods in PACKAGES.items():
        mods[0].recorder.clear()
        script(*mods)
        out[name] = [r for r in mods[0].recorder.snapshot()
                     if r["name"] in names]
    return out


SCRIPT_NAMES = {"root", "child", "manual", "on_thread", "bare", "boom",
                "from_wire", "orphan"}


def test_one_script_gives_the_jax_records():
    recs = _both(lambda tr, *_: _script(tr), SCRIPT_NAMES)
    assert len(recs["port"]) == len(recs["jax"]) == 8
    assert _normal(recs["port"]) == _normal(recs["jax"])
    port = {r["name"]: r for r in recs["port"]}
    assert port["manual"]["attrs"]["status"] == "OK"
    assert port["root"]["attrs"]["odd"] == "unjsonable"
    assert port["boom"]["attrs"]["error"] == "ValueError: nope"
    assert port["on_thread"]["parent_id"] == port["root"]["span_id"]
    assert port["from_wire"]["trace_id"] == teltrace.format_id(1234)
    assert port["from_wire"]["parent_id"] == teltrace.format_id(5678)
    for r in recs["port"]:
        assert set(r) == set(next(j for j in recs["jax"]
                                  if j["name"] == r["name"]))


def _chrome_normal(doc):
    ids = {}
    out = []
    for e in doc["traceEvents"]:
        e = {k: v for k, v in e.items()
             if k not in ("ts", "dur", "pid", "tid")}
        if "id" in e:
            e["id"] = ids.setdefault(e["id"], len(ids))
        if "args" in e:
            args = dict(e["args"])
            for k in ("trace_id", "span_id", "parent_id"):
                if k in args:
                    args[k] = ids.setdefault(args[k], len(ids))
            e["args"] = args
        out.append(e)
    return out


def test_one_script_gives_the_jax_chrome_trace(tmp_path):
    recs = _both(lambda tr, *_: _script(tr), SCRIPT_NAMES)
    port = chrome_trace.to_chrome_trace(recs["port"])
    jax_ = jchrome.to_chrome_trace(recs["jax"])
    assert _chrome_normal(port) == _chrome_normal(jax_)
    assert port["displayTimeUnit"] == jax_["displayTimeUnit"]
    # the JAX exporter reads the port's records, and the port's the JAX's
    assert (_chrome_normal(jchrome.to_chrome_trace(recs["port"]))
            == _chrome_normal(port))
    path = chrome_trace.write_chrome_trace(str(tmp_path / "t.json"),
                                           recs["jax"])
    assert _chrome_normal(json.loads(open(path).read())) == \
        _chrome_normal(jax_)


def _resilience(tr, _chrome, rt, _metrics):
    """Retries, an exhausted budget and a breaker's whole cycle, inside
    spans and outside any."""
    clock = [0.0]
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] % 3:
            raise OSError(f"transient {calls['n']}")
        return "ok"

    pol = rt.RetryPolicy(max_attempts=5, base_delay_s=0.0, name="t.pol",
                         retryable=lambda e: isinstance(e, OSError))
    with tr.span("retried"):
        assert pol.call(flaky) == "ok"
    short = rt.RetryPolicy(max_attempts=2, base_delay_s=0.0, name="t.short",
                           retryable=lambda e: isinstance(e, OSError))
    with tr.span("exhausted"):
        with pytest.raises(rt.RetriesExhausted):
            short.call(lambda: (_ for _ in ()).throw(OSError("down")))
    br = rt.CircuitBreaker(name="t.br", failure_threshold=2, cooldown_s=1.0,
                           clock=lambda: clock[0])
    with tr.span("breaker"):
        br.record_failure()
        br.record_failure()                 # opens
        with pytest.raises(rt.CircuitOpen):
            br.allow()                      # fast fail
        clock[0] = 2.0
        br.allow()                          # the probe
        br.record_success()                 # closes
    br.record_failure()
    br.record_failure()                     # opens again, untraced


def test_retry_and_breaker_events_equal_the_jax_ones():
    recs = _both(_resilience, {"retried", "exhausted", "breaker",
                               "circuit_open"})
    assert _normal(recs["port"]) == _normal(recs["jax"])
    port = {r["name"]: r for r in recs["port"]}
    assert [e["name"] for e in port["retried"]["events"]] == \
        ["retry", "retry"]
    assert [e["name"] for e in port["exhausted"]["events"]] == \
        ["retry", "retries_exhausted"]
    assert [e["name"] for e in port["breaker"]["events"]] == \
        ["circuit_open", "circuit_fast_fail", "circuit_probe",
         "circuit_close"]
    assert port["circuit_open"]["kind"] == "event"


# -- logs and exemplars -------------------------------------------------------

class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


@pytest.fixture()
def port_log():
    lg = logging.getLogger("dmlc_core_tpu_torch")
    h = _Capture()
    lg.addHandler(h)
    yield h.lines
    lg.removeHandler(h)


def test_log_text_carries_the_trace_id(port_log, monkeypatch):
    monkeypatch.delenv("DMLC_LOG_FORMAT", raising=False)
    with teltrace.span("logged-op") as s:
        log_info("inside %d", 1)
    log_info("outside")
    assert port_log[0] == ("INFO", "inside 1 [trace_id="
                           f"{teltrace.format_id(s.trace_id)}]")
    assert port_log[1] == ("INFO", "outside")


def test_log_json_lines_carry_the_trace_id(port_log, monkeypatch):
    """As the JAX package's JSON log mode (``test_telemetry.py``'s
    ``test_log_json_mode_emits_json_lines``): one JSON object a record,
    its ``trace_id`` the active span's."""
    monkeypatch.setenv("DMLC_LOG_FORMAT", "json")
    with teltrace.span("json-op") as s:
        log_warning("careful: %d", 42)
    log_info("no trace")
    sev, line = port_log[0]
    rec = json.loads(line)
    assert sev == "WARNING" and rec["level"] == "WARNING"
    assert rec["msg"] == "careful: 42"
    assert rec["trace_id"] == teltrace.format_id(s.trace_id)
    assert isinstance(rec["ts"], float)
    rec = json.loads(port_log[1][1])
    assert rec["msg"] == "no trace" and "trace_id" not in rec
    # the handler the port installs prints the JSON line as it is
    fmt = logging.getLogger("dmlc_core_tpu_torch").handlers[0].formatter
    r = logging.LogRecord("x", logging.INFO, "", 0, line, None, None)
    r.dmlc_json = True
    assert fmt.format(r) == line


def test_histogram_exemplars_equal_the_jax_ones():
    """The same observations in and out of a trace give both packages'
    histograms the same exemplars, slot by slot (value and trace id)."""
    def run(tr, _chrome, _rt, mm):
        h = mm.Histogram()
        h.observe(1.0)                       # untraced: no exemplar
        with tr.activate(tr.TraceContext(0xABC, 1)):
            for v in (1.0, 0.2, 1.5):
                h.observe(v)
        with tr.activate(tr.TraceContext(0xDEF, 2)):
            h.observe(20.0)
        return [(e["value"], e["trace_id"])
                for e in h.snapshot()["exemplars"]]
    port = run(*PACKAGES["port"])
    assert port == run(*PACKAGES["jax"])
    assert (0.2, teltrace.format_id(0xABC)) in port
    assert (20.0, teltrace.format_id(0xDEF)) in port   # the tail slot
    h = metrics_mod.Histogram()
    h.observe(3.0)
    assert "exemplars" not in h.snapshot()
    with teltrace.span("slow") as s:
        h.observe(30.0)
    assert h.snapshot()["exemplars"][-1]["trace_id"] == \
        teltrace.format_id(s.trace_id)


# -- torch.profiler -----------------------------------------------------------

def test_profile_trace_names_a_trace_span_range(tmp_path):
    """On the CPU: a ``trace_span`` range on the caller's thread and one
    on another thread (the loader's stages run on their own) are in the
    written trace, and so is the op inside."""
    def other():
        with metrics_mod.trace_span("test.on_thread"):
            torch.ones(4).sum()
    with metrics_mod.profile_trace(str(tmp_path / "prof")) as prof:
        with metrics_mod.trace_span("test.range"):
            torch.ones(8).sum()
        t = threading.Thread(target=other)
        t.start()
        t.join()
    path = prof.trace_path
    assert path is not None and os.path.dirname(path) == str(
        tmp_path / "prof")
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"test.range", "test.on_thread", "aten::sum"} <= names
    rng = next(e for e in events if e.get("name") == "test.range")
    assert rng["ph"] == "X" and rng["dur"] >= 0


def test_trace_span_without_a_profiler_is_a_no_op(monkeypatch, tmp_path):
    """With no profiler running no range is opened (the loader's threads
    pay one attribute read a pack); a capture opens it again."""
    def no_range(name):
        raise AssertionError(f"a range {name!r} opened with no profiler")
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", no_range)
        with metrics_mod.trace_span("nothing.listens"):
            x = torch.ones(2) * 2
    assert x.sum().item() == 4.0
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    with metrics_mod.profile_trace(str(tmp_path)):
        with metrics_mod.trace_span("someone.listens"):
            pass
    assert opened == ["someone.listens"]
