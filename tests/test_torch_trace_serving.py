"""Traced requests through the port's serving path, held against the JAX
package on the CPU (the counterpart of ``tests/test_telemetry.py``'s
``test_serving_trace_propagates_end_to_end``, without its exporter).

* Port client → port server, JAX client → port server, port client → JAX
  server: one trace id crosses the wire, the server's
  ``serving.server.request`` span is the client's
  ``serving.client.predict`` span's child, the engine's
  ``serving.engine.forward`` the server span's, and the server span ends
  ``OK``.
* Every answer the JAX server's status tests give (OK, TOO_LARGE,
  BAD_REQUEST, OVERLOADED, DEADLINE_EXCEEDED, SHUTDOWN), a client gone
  mid-frame (DISCONNECT) and a shed injected at ``serving.server.admit``
  end the port server's span as they end the JAX server's: the same
  records, ids and times aside.
* ``PredictClient``'s dial: a connect that does not complete (a listener
  whose backlog is full) is abandoned and made again, and the bytes on
  the wire stay the JAX client's.
"""

import importlib
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.serving import client as jclient  # noqa: E402
from dmlc_core_tpu.serving import server as jserver  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.utils import faults as jfaults  # noqa: E402
from dmlc_core_tpu_torch.serving import (BucketLadder,  # noqa: E402
                                         PredictClient, PredictionServer)
from dmlc_core_tpu_torch.serving import server as tserver  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.utils import faults as tfaults  # noqa: E402
from test_torch_server import (LADDER, STATUS_CASES, TOL,  # noqa: E402
                               _answers, _fm_params, _jax_fm, _port_fm,
                               _recv, _req, _Stub)

tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")
NAMES = ("serving.client.predict", "serving.server.request",
         "serving.engine.forward")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    teltrace.recorder.clear()
    jtrace.recorder.clear()
    yield
    teltrace.recorder.clear()
    jtrace.recorder.clear()


def _spans(recorder, name):
    return [r for r in recorder.snapshot() if r.get("name") == name]


def _wait_for(recorder, name, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = _spans(recorder, name)
        if len(got) >= n:
            return got
        time.sleep(0.01)
    return _spans(recorder, name)


def _one_chain(client, server, engine):
    """Each client span has exactly one server child and that one engine
    grandchild, all in its trace; every server span ends OK."""
    assert len(client) == len(server) == len(engine) > 0
    by_parent = {r["parent_id"]: r for r in server}
    by_server = {r["parent_id"]: r for r in engine}
    for c in client:
        s = by_parent[c["span_id"]]
        e = by_server[s["span_id"]]
        assert c["trace_id"] == s["trace_id"] == e["trace_id"]
        assert c["parent_id"] is None
        assert s["attrs"]["status"] == "OK"
        assert s["attrs"]["rows"] == c["attrs"]["rows"] == e["attrs"]["rows"]
        assert set(e["attrs"]) == {"rows", "bucket_rows", "bucket_nnz",
                                   "ragged"}
        assert set(s["attrs"]) == {"req_id", "rows", "nnz", "conn",
                                   "status"}


@pytest.mark.parametrize("ragged", [False, True])
def test_port_client_port_server_one_trace(ragged):
    p = _fm_params(4)
    ref = _jax_fm(p, LADDER)
    rng = np.random.default_rng(21)
    reqs = [_req(rng, int(rng.integers(1, 12)), 10) for _ in range(6)]
    with PredictionServer(_port_fm(p, buckets=BucketLadder(LADDER),
                                   ragged=ragged)).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            for r in reqs:
                np.testing.assert_allclose(c.predict(*r), ref.predict(*r),
                                           **TOL)
    rec = teltrace.recorder
    _one_chain(*(_wait_for(rec, n, len(reqs)) for n in NAMES))
    assert all(e["attrs"]["ragged"] == ragged
               for e in _spans(rec, "serving.engine.forward"))


def test_jax_client_port_server_one_trace():
    p = _fm_params(5)
    rng = np.random.default_rng(22)
    reqs = [_req(rng, int(rng.integers(1, 12)), 10) for _ in range(4)]
    with PredictionServer(_port_fm(p, buckets=BucketLadder(LADDER))
                          ).start() as srv:
        with jclient.PredictClient(srv.host, srv.port) as c:
            for r in reqs:
                c.predict(*r)
    _one_chain(_wait_for(jtrace.recorder, NAMES[0], 4),
               _wait_for(teltrace.recorder, NAMES[1], 4),
               _wait_for(teltrace.recorder, NAMES[2], 4))


def test_port_client_jax_server_one_trace():
    p = _fm_params(6)
    rng = np.random.default_rng(23)
    reqs = [_req(rng, int(rng.integers(1, 12)), 10) for _ in range(4)]
    with jserver.PredictionServer(_jax_fm(p, LADDER)).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            for r in reqs:
                c.predict(*r)
    _one_chain(_wait_for(teltrace.recorder, NAMES[0], 4),
               _wait_for(jtrace.recorder, NAMES[1], 4),
               _wait_for(jtrace.recorder, NAMES[2], 4))


def test_a_span_around_predict_parents_the_client_span():
    p = _fm_params(7)
    rng = np.random.default_rng(24)
    with PredictionServer(_port_fm(p, buckets=BucketLadder(LADDER))
                          ).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            with teltrace.span("caller") as caller:
                c.predict(*_req(rng, 3, 5))
                c.submit(*_req(rng, 2, 5)).result(timeout=30)
    client = _spans(teltrace.recorder, "serving.client.predict")
    server = _wait_for(teltrace.recorder, "serving.server.request", 2)
    assert client[0]["parent_id"] == teltrace.format_id(caller.span_id)
    # a raw submit under a span: its server span is the caller's child
    assert {s["parent_id"] for s in server} == {
        client[0]["span_id"], teltrace.format_id(caller.span_id)}
    assert {s["trace_id"] for s in server} == {
        teltrace.format_id(caller.trace_id)}


# -- the statuses the server span ends with ------------------------------------

TRACE_ID, PARENT = 0x1234_5678_9ABC, 0x42


def _traced(frame):
    """The frame with the trace ids set (a hello keeps its zeros)."""
    head = tserver.REQ_HEADER
    req_id, _, _, rows, nnz = head.unpack(frame[:head.size])
    if req_id == tserver.HELLO_REQ_ID:
        return frame
    return head.pack(req_id, TRACE_ID, PARENT, rows, nnz) + frame[head.size:]


def _server_records(recorder):
    """The server spans, ids and times aside, in req_id order."""
    out = []
    for r in _spans(recorder, "serving.server.request"):
        assert r["trace_id"] == teltrace.format_id(TRACE_ID)
        assert r["parent_id"] == teltrace.format_id(PARENT)
        out.append(({k: v for k, v in r["attrs"].items()}, r["events"]))
    return sorted(out, key=lambda a: a[0]["req_id"])


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_server_span_statuses_equal_the_jax_server(case):
    kw, delay, sends, n, req_id, _status = STATUS_CASES[case]
    sends = [(_traced(f), pause) for f, pause in sends]
    got = {}
    for name, cls, rec in (("jax", jserver.PredictionServer,
                            jtrace.recorder),
                           ("port", tserver.PredictionServer,
                            teltrace.recorder)):
        srv = cls(_Stub(delay), warmup=False, **kw).start()
        try:
            if case == "shutdown":
                srv.batcher.close()
            _answers((srv.host, srv.port), sends, n)
        finally:
            srv.stop()
        got[name] = _server_records(rec)
    assert got["port"] == got["jax"]
    want = {"ok": ["OK"], "too_large": ["TOO_LARGE"],
            "bad_header": ["BAD_REQUEST"], "malformed_csr": ["BAD_REQUEST"],
            "hello_mismatch": [],
            "overloaded": ["OK", "OK", "OVERLOADED"],
            "deadline": ["OK", "DEADLINE_EXCEEDED"],
            "shutdown": ["SHUTDOWN"]}[case]
    assert [a["status"] for a, _ in got["port"]] == want


def test_admit_fault_span_equals_the_jax_server():
    got = {}
    for name, cls, mod, rec in (
            ("jax", jserver.PredictionServer, jfaults, jtrace.recorder),
            ("port", tserver.PredictionServer, tfaults, teltrace.recorder)):
        srv = cls(_Stub(), warmup=False).start()
        try:
            with mod.inject_faults("serving.server.admit:error=1:times=2"):
                _answers((srv.host, srv.port),
                         [(_traced(_frame(i)), 0.05) for i in range(3)], 3)
        finally:
            srv.stop()
        got[name] = _server_records(rec)
    assert got["port"] == got["jax"]
    assert [(a["status"], a.get("injected")) for a, _ in got["port"]] == \
        [("OVERLOADED", True), ("OVERLOADED", True), ("OK", None)]


def _frame(req_id):
    return (tserver.REQ_HEADER.pack(req_id, 0, 0, 1, 1)
            + np.array([0, 1], np.int32).tobytes()
            + np.array([1], np.int32).tobytes()
            + np.array([1.0], np.float32).tobytes())


def test_a_client_gone_mid_frame_ends_the_span_disconnect():
    """The JAX server ends it so too (a header, then the socket closes
    before the payload)."""
    for cls, rec in ((jserver.PredictionServer, jtrace.recorder),
                     (tserver.PredictionServer, teltrace.recorder)):
        srv = cls(_Stub(), warmup=False).start()
        try:
            with socket.create_connection((srv.host, srv.port)) as s:
                s.sendall(_traced(_frame(3))[:tserver.REQ_HEADER.size + 2])
            (r,) = _wait_for(rec, "serving.server.request", 1)
        finally:
            srv.stop()
        assert r["attrs"]["status"] == "DISCONNECT"
        assert r["attrs"]["req_id"] == 3


# -- the client's dial ----------------------------------------------------------

def test_dial_retries_a_connect_that_does_not_complete(monkeypatch):
    """A listener with a full backlog drops the client's SYN, so its
    connect hangs; the dial gives it up after ``DMLC_IO_CONNECT_TIMEOUT``
    and connects again once the listener
    accepts.  The request then goes out byte for byte as the JAX
    client's, with the caller's trace ids in its header."""
    monkeypatch.setenv("DMLC_IO_CONNECT_TIMEOUT", "0.3")
    monkeypatch.setenv("DMLC_SERVING_RECONNECT_RETRIES", "30")
    retries = tmetrics.metrics.counter("retry.serving.connect.retries")
    before = retries.value
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(0)
    addr = lst.getsockname()
    fillers = []
    for _ in range(4):                      # fill the accept queue
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(0.2)
        try:
            s.connect(addr)
        except OSError:
            pass
        fillers.append(s)
    ids = np.array([5, 17, 2999], np.int32)
    vals = np.array([1.0, 0.5, -2.25], np.float32)
    rp = np.array([0, 1, 3], np.int64)
    frames = {}

    def serve():
        time.sleep(0.8)                     # the first connect gives up
        for s in fillers:                   # their queued ends read EOF
            s.close()
        lst.settimeout(10)
        while True:
            conn, _ = lst.accept()
            conn.settimeout(10)
            head = conn.recv(tserver.REQ_HEADER.size, socket.MSG_PEEK)
            if not head:
                conn.close()                # a filler
                continue
            conn.settimeout(10)
            want = tserver.REQ_HEADER.size + 4 * 3 + 8 * 3
            frames["got"] = _recv(conn, want)
            req_id = tserver.REQ_HEADER.unpack(frames["got"][:32])[0]
            conn.sendall(tserver.RSP_HEADER.pack(req_id, 0, 2)
                         + np.array([0.25, 0.75], np.float32).tobytes())
            frames["conn"] = conn
            return
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        t0 = time.monotonic()
        with teltrace.span("caller") as caller:
            with PredictClient(*addr, connect_timeout=20,
                               reconnect=False) as c:
                assert time.monotonic() - t0 >= 0.25
                out = c.submit(ids, vals, rp).result(timeout=20)
        np.testing.assert_array_equal(out, [0.25, 0.75])
        assert retries.value > before
    finally:
        t.join(timeout=20)
        if "conn" in frames:
            frames["conn"].close()
        lst.close()
    want = (tserver.REQ_HEADER.pack(0, caller.trace_id, caller.span_id, 2, 3)
            + rp.astype(np.int32).tobytes() + ids.tobytes() + vals.tobytes())
    assert frames["got"] == want
    # the JAX client sends the same bytes under the same context
    with socket.create_server(("127.0.0.1", 0)) as srv:
        with jtrace.activate(jtrace.TraceContext(caller.trace_id,
                                                 caller.span_id)):
            jc = jclient.PredictClient("127.0.0.1", srv.getsockname()[1],
                                       reconnect=False)
            conn, _ = srv.accept()
            with conn:
                jc.submit(ids, vals, rp)
                assert _recv(conn, len(want)) == want
                jc.close()


def test_dial_does_not_retry_a_refused_connect(monkeypatch):
    """A refused connect fails at once, as before: nothing listens."""
    monkeypatch.setenv("DMLC_IO_CONNECT_TIMEOUT", "0.3")
    retries = tmetrics.metrics.counter("retry.serving.connect.retries")
    before = retries.value
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.monotonic()
    with pytest.raises(ConnectionRefusedError):
        PredictClient("127.0.0.1", port, reconnect=False)
    assert time.monotonic() - t0 < 5
    assert retries.value == before
