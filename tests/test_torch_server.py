"""The port's TCP serving (server, client, load generator, ``serve_main``)
and the host modules it copied (metrics, retry), held against the JAX
package on the CPU.

* The wire is the JAX package's, byte for byte: header formats, the
  hello frame, the request frames both clients write for one fixed
  request, and each status's answer from both servers.
* Across packages, a JAX client against the port's server and the port's
  client against a JAX server: scores within ``TOL = rtol 1e-5, atol
  1e-5`` of the JAX engine (float32 sums in different orders).
* The JAX server tests (``tests/test_serving.py``), replayed on the port.
* ``DMLC_ROUTER_REGISTRY`` (A.11.a) joins a registry through a fleet
  agent, in both packages' servers; ``DMLC_FLIGHT_DIR`` and
  ``DMLC_TRACE_SAMPLE`` (A.12.d) arm the flight recorder and install the
  tail sampler at construction, as the JAX server's do.  ``DMLC_FAULT_SPEC`` is honoured: the ``serving.server.admit``
  fault point sheds an injected burst as ``OVERLOADED``, byte for byte
  as the JAX server does, and the client's retries answer every
  request.
* The copied ``Histogram``, ``RetryPolicy`` and ``CircuitBreaker`` give
  the JAX classes' outputs on the same seeds and clocks (exact: the
  arithmetic is the same Python).
"""

import importlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy
# the modules (the JAX package's utils exports the registry as `metrics`)
jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
jretry = importlib.import_module("dmlc_core_tpu.utils.retry")

from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu.serving import client as jclient  # noqa: E402
from dmlc_core_tpu.serving import engine as jengine  # noqa: E402
from dmlc_core_tpu.serving import server as jserver  # noqa: E402
from dmlc_core_tpu_torch.models import (FactorizationMachine,  # noqa: E402
                                        SparseLogReg)
from dmlc_core_tpu_torch.serving import (BucketLadder,  # noqa: E402
                                         InferenceEngine, PredictClient,
                                         PredictionServer, ServerOverloaded,
                                         ServerRejected, run_load)
from dmlc_core_tpu_torch.serving import client as tclient  # noqa: E402
from dmlc_core_tpu_torch.serving import server as tserver  # noqa: E402
from dmlc_core_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from dmlc_core_tpu_torch.utils import retry as tretry  # noqa: E402
from dmlc_core_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager)
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from test_torch_remote_filesys import (S3, hdfs_server,  # noqa: E402,F401
                                       s3_server)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, D = 3000, 8                 # the FM's features and factor width
F_LR = 5000                    # the logreg's, as tests/test_serving.py
TOL = dict(rtol=1e-5, atol=1e-5)
LADDER = [(8, 128), (16, 512), (64, 2048)]


def _fm_params(seed):
    rng = np.random.default_rng(seed)
    return {"w0": np.asarray(0.1 * seed, np.float32),
            "w": (rng.normal(size=F) * 0.3).astype(np.float32),
            "v": (rng.normal(size=(F, D)) * 0.2).astype(np.float32)}


def _req(rng, rows, nnz_per_row, features=F):
    counts = rng.integers(1, nnz_per_row + 1, size=rows)
    ids = rng.integers(0, features, size=int(counts.sum())).astype(np.int32)
    vals = rng.random(len(ids), dtype=np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return ids, vals, row_ptr


def _port_fm(params, **kw):
    return InferenceEngine(FactorizationMachine(F, D, device="cpu"), params,
                           device="cpu", postprocess="sigmoid", **kw)


def _jax_fm(params, ladder=None):
    return jengine.InferenceEngine(
        jsparse.FactorizationMachine(F, D),
        {k: jnp.asarray(v) for k, v in params.items()},
        buckets=None if ladder is None else jengine.BucketLadder(ladder),
        postprocess="sigmoid")


def _logreg_engine(w, b=0.25, ladder=((16, 512), (64, 2048))):
    params = {"w": np.asarray(w, np.float32), "b": np.float32(b)}
    return InferenceEngine(SparseLogReg(F_LR, device="cpu"), params,
                           buckets=BucketLadder(list(ladder)), device="cpu")


def _logreg_ref(w, b, ids, vals, row_ptr):
    return np.array([float(vals[row_ptr[r]:row_ptr[r + 1]]
                           @ w[ids[row_ptr[r]:row_ptr[r + 1]]]) + b
                     for r in range(len(row_ptr) - 1)])


class _Stub:
    """Engine stub both packages' servers take: scores = row index,
    optionally after a delay."""

    def __init__(self, delay=0.0):
        self.ladder = BucketLadder([(64, 4096)])
        self.delay = delay

    def warmup_all(self):
        pass

    def predict(self, ids, vals, row_ptr):
        time.sleep(self.delay)
        return np.arange(len(row_ptr) - 1, dtype=np.float32)


# ---------------------------------------------------------------------------
# the wire, byte for byte
# ---------------------------------------------------------------------------

def test_wire_constants_match_jax():
    assert tserver.REQ_HEADER.format == jserver.REQ_HEADER.format == "<QQQII"
    assert tserver.RSP_HEADER.format == jserver.RSP_HEADER.format == "<QBI"
    assert tserver.HELLO_REQ_ID == jserver.HELLO_REQ_ID == (1 << 64) - 1
    assert tserver.STATUS_NAMES == jserver.STATUS_NAMES
    for name in ("OK", "OVERLOADED", "DEADLINE", "TOO_LARGE", "SHUTDOWN",
                 "BAD_REQUEST"):
        assert getattr(tserver, f"STATUS_{name}") == \
            getattr(jserver, f"STATUS_{name}")
    assert (tserver._MAX_ROWS, tserver._MAX_NNZ, tserver._MAX_MODEL_ID) == \
        (jserver._MAX_ROWS, jserver._MAX_NNZ, jserver._MAX_MODEL_ID)


@pytest.mark.parametrize("model_id", ["default", "fm-v2", "ü" * 3000])
def test_pack_hello_bytes_match_jax(model_id):
    got = tserver.pack_hello(model_id)
    assert got == jserver.pack_hello(model_id)
    assert len(got) <= tserver.REQ_HEADER.size + tserver._MAX_MODEL_ID


def _fixed_request():
    ids = np.array([5, 17, 2999, 0, 42], np.int32)
    vals = np.array([1.0, 0.5, -2.25, 3.0, 1e-3], np.float32)
    return ids, vals, np.array([0, 2, 2, 5], np.int64)


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "peer closed early"
        buf += chunk
    return buf


@pytest.mark.parametrize("model_id", [None, "fm-v2"])
def test_request_frames_of_both_clients_are_byte_identical(model_id):
    ids, vals, rp = _fixed_request()
    want = (tserver.REQ_HEADER.pack(0, 0, 0, 3, 5)
            + rp.astype(np.int32).tobytes() + ids.tobytes() + vals.tobytes())
    if model_id is not None:
        want = tserver.pack_hello(model_id) + want
    got = {}
    for name, cls in (("jax", jclient.PredictClient),
                      ("torch", tclient.PredictClient)):
        with socket.create_server(("127.0.0.1", 0)) as lst:
            c = cls("127.0.0.1", lst.getsockname()[1], model_id=model_id,
                    reconnect=False)
            conn, _ = lst.accept()
            with conn:
                c.submit(ids, vals, rp)
                got[name] = np.frombuffer(_recv(conn, len(want)), np.uint8)
                c.close()
    assert np.array_equal(got["jax"], got["torch"])
    assert got["torch"].tobytes() == want


def _frame(req_id, ids, vals, row_ptr):
    rp = np.asarray(row_ptr, np.int32)
    return (tserver.REQ_HEADER.pack(req_id, 0, 0, len(rp) - 1, len(ids))
            + rp.tobytes() + np.asarray(ids, np.int32).tobytes()
            + np.asarray(vals, np.float32).tobytes())


def _answers(addr, sends, n):
    """Send ``(frame, pause_s)`` pairs on one connection, then read ``n``
    answers: {req_id: raw answer bytes}."""
    out = {}
    with socket.create_connection(addr, timeout=30) as s:
        for frame, pause in sends:
            s.sendall(frame)
            time.sleep(pause)
        for _ in range(n):
            head = _recv(s, tserver.RSP_HEADER.size)
            req_id, status, k = tserver.RSP_HEADER.unpack(head)
            out[req_id] = head + _recv(s, 4 * k if status == 0 else k)
    return out


_ONE = ([1], [1.0], [0, 1])
STATUS_CASES = {
    # name: (server kwargs, stub delay, sends, answers, req_id, status)
    "ok": ({}, 0.0, [(_frame(7, [1, 2, 3], [1, 1, 1], [0, 1, 3]), 0)],
           1, 7, 0),
    "too_large": ({}, 0.0, [(_frame(3, np.arange(65), np.ones(65),
                                    np.arange(66)), 0)], 1, 3, 3),
    "bad_header": ({}, 0.0, [(tserver.REQ_HEADER.pack(4, 0, 0, 0, 5), 0)],
                   1, 4, 5),
    "malformed_csr": ({}, 0.0, [(_frame(5, [1, 2], [1, 1], [0, 5]), 0)],
                      1, 5, 5),
    "hello_mismatch": ({}, 0.0, [(tserver.pack_hello("other"), 0)], 1,
                       tserver.HELLO_REQ_ID, 5),
    # the worker takes request 0; 1 waits in a queue of one; 2 is shed
    "overloaded": (dict(max_queue=1, max_delay_s=0.0), 0.3,
                   [(_frame(0, *_ONE), 0.1), (_frame(1, *_ONE), 0),
                    (_frame(2, *_ONE), 0)], 3, 2, 1),
    # request 1 expires in the queue while the worker serves request 0
    "deadline": (dict(max_delay_s=0.0, default_deadline_s=0.05), 0.3,
                 [(_frame(0, *_ONE), 0.1), (_frame(1, *_ONE), 0)], 2, 1, 2),
    "shutdown": ({}, 0.0, [(_frame(9, *_ONE), 0)], 1, 9, 4),
}


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_answers_of_both_servers_match(case):
    kw, delay, sends, n, req_id, status = STATUS_CASES[case]
    got = {}
    for name, cls in (("jax", jserver.PredictionServer),
                      ("torch", tserver.PredictionServer)):
        srv = cls(_Stub(delay), warmup=False, **kw).start()
        try:
            if case == "shutdown":
                srv.batcher.close()
            got[name] = _answers((srv.host, srv.port), sends, n)[req_id]
        finally:
            srv.stop()
    head = tserver.RSP_HEADER.size
    rid, st, _ = tserver.RSP_HEADER.unpack(got["torch"][:head])
    assert (rid, st) == (req_id, status)
    if case == "deadline":              # the message holds the wait time
        assert got["jax"][:9] == got["torch"][:9]
        assert got["torch"][head:].startswith(b"request expired after")
    else:
        assert got["jax"] == got["torch"]


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def test_jax_client_against_the_port_server():
    p = _fm_params(1)
    ref = _jax_fm(p, LADDER)
    rng = np.random.default_rng(11)
    reqs = [_req(rng, int(rng.integers(1, 20)), 12) for _ in range(12)]
    with PredictionServer(_port_fm(p, buckets=BucketLadder(LADDER)),
                          model_id="fm").start() as srv:
        with jclient.PredictClient(srv.host, srv.port, model_id="fm") as c:
            for r in reqs:
                np.testing.assert_allclose(c.predict(*r), ref.predict(*r),
                                           **TOL)
            futs = [c.submit(*r) for r in reqs]      # pipelined
            for r, f in zip(reqs, futs):
                np.testing.assert_allclose(f.result(timeout=30),
                                           ref.predict(*r), **TOL)


def test_port_client_against_a_jax_server():
    p = _fm_params(2)
    ref = _jax_fm(p, LADDER)
    rng = np.random.default_rng(12)
    reqs = [_req(rng, int(rng.integers(1, 20)), 12) for _ in range(12)]
    with jserver.PredictionServer(_jax_fm(p, LADDER),
                                  model_id="fm").start() as srv:
        with PredictClient(srv.host, srv.port, model_id="fm") as c:
            for r in reqs:
                np.testing.assert_allclose(c.predict(*r), ref.predict(*r),
                                           **TOL)
        rep = run_load(srv.host, srv.port, requests=40, concurrency=2,
                       pipeline_depth=4, rows_per_req=3, nnz_per_row=8,
                       features=F, model_id="fm")
    assert rep["ok"] == 40 and rep["rejected"] == 0, rep["errors"]


def test_port_client_and_server_match_the_jax_engine():
    p = _fm_params(3)
    ref = _jax_fm(p, LADDER)
    rng = np.random.default_rng(13)
    with PredictionServer(_port_fm(p, buckets=BucketLadder(LADDER),
                                   ragged=True)).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            for _ in range(10):
                r = _req(rng, int(rng.integers(1, 40)), 12)
                np.testing.assert_allclose(c.predict(*r), ref.predict(*r),
                                           **TOL)


# ---------------------------------------------------------------------------
# the JAX server tests, on the port
# ---------------------------------------------------------------------------

def test_server_client_roundtrip():
    w = np.arange(F_LR, dtype=np.float32) / F_LR
    with PredictionServer(_logreg_engine(w), warmup=True).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            rng = np.random.default_rng(4)
            for _ in range(20):
                r = _req(rng, int(rng.integers(1, 10)), 16, F_LR)
                np.testing.assert_allclose(c.predict(*r),
                                           _logreg_ref(w, 0.25, *r),
                                           rtol=1e-4, atol=1e-5)


def test_server_pipelined_requests_one_connection():
    w = np.arange(F_LR, dtype=np.float32) / F_LR
    with PredictionServer(_logreg_engine(w, ladder=[(64, 2048)])
                          ).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            rng = np.random.default_rng(5)
            reqs = [_req(rng, 2, 8, F_LR) for _ in range(50)]
            futs = [c.submit(*r) for r in reqs]
            for r, f in zip(reqs, futs):
                np.testing.assert_allclose(f.result(timeout=30),
                                           _logreg_ref(w, 0.25, *r),
                                           rtol=1e-4, atol=1e-5)


def test_server_overload_surfaces_as_typed_error():
    eng = _logreg_engine(np.ones(F_LR), ladder=[(16, 512)])
    orig = eng.predict

    def slow_predict(ids, vals, row_ptr=None):
        time.sleep(0.1)
        return orig(ids, vals, row_ptr)

    eng.predict = slow_predict
    with PredictionServer(eng, max_queue=2, max_delay_s=0.001).start() \
            as srv:
        with PredictClient(srv.host, srv.port) as c:
            futs = [c.submit(np.array([1], np.int32),
                             np.ones(1, np.float32)) for _ in range(30)]
            shed = ok = 0
            for f in futs:
                try:
                    f.result(timeout=30)
                    ok += 1
                except ServerOverloaded:
                    shed += 1
    assert shed > 0, "a burst over a queue of 2 must shed load"
    assert ok > 0, "admitted requests must still complete"


def test_predict_timeout_abandons_pending_entry():
    with PredictionServer(_Stub(delay=0.6), warmup=False,
                          default_deadline_s=10.0).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            with pytest.raises(FutureTimeout):
                c.predict(np.array([1], np.int32), np.ones(1, np.float32),
                          timeout=0.2)
            assert c._pending == {}
            # the late answer to the abandoned request is dropped
            out = c.predict(np.array([1], np.int32), np.ones(1, np.float32),
                            timeout=10.0)
            assert out.shape == (1,) and c._pending == {}


def test_load_generator_reports():
    eng = _logreg_engine(np.ones(F_LR), ladder=[(64, 2048)])
    with PredictionServer(eng).start() as srv:
        rep = run_load(srv.host, srv.port, requests=200, concurrency=2,
                       pipeline_depth=8, rows_per_req=2, nnz_per_row=8,
                       features=F_LR)
    assert rep["ok"] == 200 and rep["rejected"] == 0, rep["errors"]
    assert set(rep) == {"requests", "concurrency", "pipeline_depth",
                        "rows_per_req", "nnz_per_row", "ok", "overload",
                        "rejected", "errors", "wall_s", "qps",
                        "rows_per_s", "latency_ms"}
    assert rep["qps"] > 0 and rep["rows_per_s"] == pytest.approx(
        2 * rep["qps"])
    assert 0 < rep["latency_ms"]["p50"] <= rep["latency_ms"]["p99"]


def test_load_main_prints_the_report(capsys):
    eng = _logreg_engine(np.ones(F_LR), ladder=[(64, 2048)])
    with PredictionServer(eng).start() as srv:
        assert tclient.load_main([f"{srv.host}:{srv.port}", "requests=20",
                                  "concurrency=2", f"features={F_LR}"]) == 0
    assert '"ok": 20' in capsys.readouterr().out
    assert tclient.load_main([]) == 2


def _save_logreg(tmp_path, step, scale):
    CheckpointManager(str(tmp_path)).save(
        step, {"params": {"w": np.full(F_LR, scale, np.float32),
                          "b": np.float32(0.0)},
               "opt_state": {"count": np.int32(0)}},
        meta={"model": "logreg"})


def test_hot_reload_mid_stream_one_switch_point(tmp_path):
    """Requests stream while the weights are swapped under the engine:
    nothing fails, and the answers switch from old to new exactly once."""
    _save_logreg(tmp_path, 1, 1.0)
    eng = _logreg_engine(np.zeros(F_LR), b=0.0, ladder=[(16, 512)])
    assert eng.reload_from_checkpoint(str(tmp_path)) == 1
    ids, vals = np.array([123], np.int32), np.ones(1, np.float32)
    with PredictionServer(eng).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            stop = threading.Event()
            results, failures = [], []

            def stream():
                while not stop.is_set():
                    try:
                        results.append(float(c.predict(ids, vals,
                                                       timeout=30)[0]))
                    except Exception as e:  # noqa: BLE001 — asserted
                        failures.append(repr(e))
                        return

            t = threading.Thread(target=stream, daemon=True)
            t.start()
            while len(results) < 20:
                time.sleep(0.001)
            _save_logreg(tmp_path, 2, 5.0)
            step = srv.reload_from_checkpoint(str(tmp_path))
            n_at_reload = len(results)
            while len(results) < n_at_reload + 20:
                time.sleep(0.001)
            stop.set()
            t.join(timeout=10)
            assert not t.is_alive()
    assert failures == [] and step == 2
    assert results[0] == 1.0 and results[-1] == 5.0
    switch = results.index(5.0)
    assert set(results[:switch]) == {1.0} and set(results[switch:]) == {5.0}


def test_watch_checkpoints_picks_up_new_step(tmp_path):
    _save_logreg(tmp_path, 1, 1.0)
    eng = _logreg_engine(np.zeros(F_LR), b=0.0, ladder=[(16, 512)])
    srv = PredictionServer(eng)
    srv.watch_checkpoints(str(tmp_path), interval_s=0.05)
    v0 = eng.params_version            # the first poll loaded step 1
    assert v0 == 1
    srv.start()
    try:
        _save_logreg(tmp_path, 9, 3.0)
        deadline = time.monotonic() + 20
        while eng.params_version == v0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.params_version > v0, "the watcher never reloaded"
        with PredictClient(srv.host, srv.port) as c:
            assert c.predict(np.array([1], np.int32),
                             np.ones(1, np.float32))[0] == 3.0
    finally:
        srv.stop()


def test_hello_mismatch_is_refused_and_match_serves():
    eng = _logreg_engine(np.ones(F_LR), b=0.0, ladder=[(16, 512)])
    with PredictionServer(eng, model_id="fm-a").start() as srv:
        c = PredictClient(srv.host, srv.port, model_id="fm-b")
        try:
            deadline = time.monotonic() + 20
            while c._dead is None and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(DMLCError, match="hello rejected: model "
                                                "'fm-b' not served here"):
                c.predict(np.array([1], np.int32), np.ones(1, np.float32))
        finally:
            c.close()
        with PredictClient(srv.host, srv.port, model_id="fm-a") as ok:
            assert ok.predict(np.array([1], np.int32),
                              np.ones(1, np.float32))[0] == 1.0


def test_oversized_request_is_too_large():
    eng = _logreg_engine(np.ones(F_LR), ladder=[(16, 512)])
    with PredictionServer(eng).start() as srv:
        with PredictClient(srv.host, srv.port) as c:
            with pytest.raises(ServerRejected, match="TOO_LARGE"):
                c.predict(np.arange(17, dtype=np.int32),
                          np.ones(17, np.float32), np.arange(18))
            assert c.predict(np.array([1], np.int32),
                             np.ones(1, np.float32)).shape == (1,)


def test_health_follows_the_queue():
    srv = PredictionServer(_Stub(delay=0.3), warmup=False, max_queue=4,
                           max_delay_s=0.0).start()
    try:
        assert srv.health == "ok"
        with PredictClient(srv.host, srv.port) as c:
            one = (np.array([1], np.int32), np.ones(1, np.float32))
            futs = [c.submit(*one)]
            time.sleep(0.1)             # the worker is inside predict
            futs += [c.submit(*one) for _ in range(4)]
            deadline = time.monotonic() + 10
            while srv.batcher.queue_depth < 4 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            doc = srv.health_doc()
            assert doc["status"] == "overloaded" and doc["queue_depth"] == 4
            assert doc["queue_fraction"] == 1.0 and doc["inflight"] == 5
            assert doc["model_id"] == "default"
            for f in futs:
                f.result(timeout=30)
        assert srv.health == "ok"
    finally:
        srv.stop()


def test_engine_reload_copies_in_place_and_leaves_the_module_alone():
    model = FactorizationMachine(F, D, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    eng = InferenceEngine(model, buckets=BucketLadder(LADDER), device="cpu")
    ptrs = {k: v.data_ptr() for k, v in eng._params.items()}
    p2 = _fm_params(5)
    eng.reload(p2)
    assert {k: v.data_ptr() for k, v in eng._params.items()} == ptrs
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    rng = np.random.default_rng(14)
    r = _req(rng, 6, 10)
    ref = jengine.InferenceEngine(
        jsparse.FactorizationMachine(F, D),
        {k: jnp.asarray(v) for k, v in p2.items()},
        buckets=jengine.BucketLadder(LADDER))
    np.testing.assert_allclose(eng.predict(*r), ref.predict(*r), **TOL)


@pytest.mark.parametrize("kind", ["deepfm", "dcn"])
def test_engine_serves_a_module_with_subtrees_and_a_jax_tree(kind):
    """A module whose state has dotted names (DeepFM's ``tower.w``,
    DCNv2's ``cross.w``) and a nested JAX param tree reloaded into it."""
    from dmlc_core_tpu.models import dcn as jdcn
    from dmlc_core_tpu.models import deep as jdeep
    from dmlc_core_tpu_torch.models import DCNv2, DeepFM
    jm = (jdeep.DeepFM if kind == "deepfm" else jdcn.DCNv2)(F, D, 2)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp["w"] = (np.random.default_rng(16).normal(size=F) * 0.1
               ).astype(np.float32)
    jp["v"] = jp["v"] * 30.0
    tm = (DeepFM if kind == "deepfm" else DCNv2)(F, D, 2, device="cpu")
    eng = InferenceEngine(tm, buckets=BucketLadder(LADDER), device="cpu",
                          postprocess="sigmoid")
    rng = np.random.default_rng(17)
    r = _req(rng, 9, 12)
    assert eng.predict(*r).shape == (9,)
    eng.reload(jp)
    ref = jengine.InferenceEngine(
        jm, jax.tree_util.tree_map(jnp.asarray, jp),
        buckets=jengine.BucketLadder(LADDER), postprocess="sigmoid")
    for rows in (1, 9, 40):
        r = _req(rng, rows, 12)
        np.testing.assert_allclose(eng.predict(*r), ref.predict(*r), **TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["padded", "ragged"])
def test_engine_metrics_equal_the_jax_engines(ragged):
    """``serving.engine.*`` after the same seeded requests and one reload
    on a fresh registry of each package: the same compiles, batches, rows,
    forward count, occupancy, params version and padding ratios (exact;
    the forward's seconds aside)."""
    rng = np.random.default_rng(17)
    reqs = [_req(rng, int(rng.integers(1, 40)), 12) for _ in range(12)]
    p1, p2 = _fm_params(1), _fm_params(2)
    snaps = {}
    for name, reg in (("port", tmetrics.metrics), ("jax", jmetrics.metrics)):
        reg.reset()
        if name == "port":
            eng = _port_fm(p1, buckets=BucketLadder(LADDER), ragged=ragged)
        else:
            eng = jengine.InferenceEngine(
                jsparse.FactorizationMachine(F, D),
                {k: jnp.asarray(v) for k, v in p1.items()},
                buckets=jengine.BucketLadder(LADDER), postprocess="sigmoid",
                ragged=ragged)
        for r in reqs[:6]:
            eng.predict(*r)
        eng.reload(p2 if name == "port" else
                   {k: jnp.asarray(v) for k, v in p2.items()})
        for r in reqs[6:]:
            eng.predict(*r)
        snap = reg.snapshot()
        snaps[name] = {k: v for k, v in snap.items()
                       if k.startswith("serving.engine.")}
        fwd = snaps[name].pop("serving.engine.forward")
        assert fwd["count"] == len(reqs) and fwd["total_sec"] > 0
        for k in ("rate", "windowed_rate"):
            snaps[name]["serving.engine.rows"].pop(k)
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["serving.engine.batches"]["value"] == len(reqs)
    assert snaps["port"]["serving.engine.params_version"]["value"] == 1


# ---------------------------------------------------------------------------
# what is not ported is refused; the exporter and the SLO monitor are not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,value,item", [
    ("DMLC_ROUTER_REGISTRY", "127.0.0.1:1", "A.11"),
    ("DMLC_FLIGHT_DIR", "/nonexistent", "A.12"),
    ("DMLC_TRACE_SAMPLE", "0.5", "A.12"),
])
def test_unported_server_parts_are_refused(monkeypatch, env, value, item):
    """Each variable, now ported, is taken as the JAX server takes it.
    ``DMLC_ROUTER_REGISTRY`` (A.11.a) arms a fleet agent that registers
    the replica with a registry at ``start()`` and deregisters it at
    ``stop()``: the port's server with a dead endpoint (``value``) before
    its registry, the JAX server with its own.  The A.12.d variables arm
    the flight recorder at that directory (created at the first dump
    only, and none happens here) with its hooks, or install the tail
    sampler at that floor, as the JAX server's construction does to the
    JAX package's."""
    from dmlc_core_tpu.telemetry import flight as jflight
    from dmlc_core_tpu.telemetry import trace as jtrace
    from dmlc_core_tpu_torch.telemetry import flight as tflight
    from dmlc_core_tpu_torch.telemetry import trace as ttrace
    from test_torch_exposition import incident_state
    for key in ("DMLC_FLIGHT_DIR", "DMLC_TRACE_SAMPLE", "DMLC_SLO_SPEC",
                "DMLC_METRICS_PORT", "DMLC_ROUTER_REGISTRY"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv(env, value)
    if item == "A.11":
        _fleet_agents_register(monkeypatch, value)
        return
    with incident_state():
        for mod in (ttrace, jtrace):
            mod._sampler = None
        tflight.flight_recorder.disarm()
        jflight.flight_recorder.disarm()
        srv = PredictionServer(_Stub(), warmup=False)
        jsrv = jserver.PredictionServer(_Stub(), warmup=False)
        try:
            if env == "DMLC_FLIGHT_DIR":
                for rec in (tflight.flight_recorder,
                            jflight.flight_recorder):
                    assert rec.armed and rec._dir == value
                    assert rec._installed
                assert ttrace.get_sampler() is None
                assert not os.path.exists(value)
            else:
                s, js = ttrace.get_sampler(), jtrace.get_sampler()
                assert s is not None and js is not None
                assert s.floor == js.floor == float(value)
                assert not tflight.flight_recorder.armed
        finally:
            srv.stop()
            jsrv.stop()


def _fleet_agents_register(monkeypatch, dead):
    from dmlc_core_tpu.serving.fleet import registry as jregistry
    from dmlc_core_tpu_torch.serving.fleet import registry as tregistry
    monkeypatch.setenv("DMLC_ROUTER_HEARTBEAT", "0.05")
    monkeypatch.setenv("DMLC_ROUTER_BREAKER_COOLDOWN", "0.2")
    for pkg, reg_cls, srv_cls in (
            ("port", tregistry.ReplicaRegistry, PredictionServer),
            ("jax", jregistry.ReplicaRegistry, jserver.PredictionServer)):
        reg = reg_cls(heartbeat_timeout_s=5.0).start()
        srv = None
        try:
            addr = f"{reg.host}:{reg.port}"
            monkeypatch.setenv("DMLC_ROUTER_REGISTRY",
                               f"{dead},{addr}" if pkg == "port" else addr)
            srv = srv_cls(_Stub(), warmup=False)
            assert srv._agent is not None, pkg
            assert reg.replica_records() == {}      # joins at start()
            srv.start()
            jobid = f"replica-{srv.host}:{srv.port}"
            deadline = time.monotonic() + 10
            while (jobid not in reg.replica_records()
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            rec = reg.replica_records()[jobid]
            assert rec["alive"] and rec["model_id"] == "default", pkg
            assert (rec["host"], rec["port"]) == (srv.host, srv.port)
            srv.stop()
            srv = None
            assert reg.replica_records() == {}, pkg     # deregistered
        finally:
            if srv is not None:
                srv.stop()
            reg.stop()


def _healthz(port):
    from test_torch_exposition import scrape
    code, _, body = scrape(port, "/healthz")
    return code, json.loads(body)


@pytest.mark.parametrize("how", ["metrics_port", "DMLC_METRICS_PORT",
                                 "DMLC_SLO_SPEC", "DMLC_SLO_SPEC burn-rate"])
def test_exporter_and_slo_spec_are_accepted(monkeypatch, how):
    """``metrics_port=0`` or ``DMLC_METRICS_PORT=0`` mounts the exporter
    on an ephemeral port of the server's host, started and stopped with
    the server; ``DMLC_SLO_SPEC`` in either grammar builds the monitor,
    which runs while the server does."""
    from test_torch_exposition import stop_samplers
    from dmlc_core_tpu_torch.telemetry import slo as tslo
    for key in ("DMLC_METRICS_PORT", "DMLC_SLO_SPEC"):
        monkeypatch.delenv(key, raising=False)
    kw = {}
    if how == "metrics_port":
        kw["metrics_port"] = 0
    elif how == "DMLC_METRICS_PORT":
        monkeypatch.setenv("DMLC_METRICS_PORT", "0")
    else:
        monkeypatch.setenv("DMLC_SLO_SPEC", "serving.latency_s:max=10s"
                           + (":budget=0.5" if "burn" in how else ""))
    srv = PredictionServer(_Stub(), warmup=False, **kw)
    try:
        if how.startswith("DMLC_SLO_SPEC"):
            assert srv.telemetry is None
            assert isinstance(srv.slo_monitor, tslo.BurnRateMonitor) == \
                ("burn" in how)
            assert srv.slo_monitor._thread is None
            srv.start()
            assert srv.slo_monitor._thread is not None
        else:
            assert srv.slo_monitor is None
            srv.start()
            assert srv.telemetry.port not in (0, srv.port)
            assert _healthz(srv.telemetry.port) == (200, srv.health_doc())
    finally:
        srv.stop()
        stop_samplers()
    if srv.telemetry is not None:
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", srv.telemetry.port),
                                     timeout=2).close()
    if srv.slo_monitor is not None:
        assert srv.slo_monitor._thread is None


def test_a_bad_slo_spec_or_a_taken_port_raises(monkeypatch):
    from test_torch_exposition import stop_samplers
    from dmlc_core_tpu_torch.telemetry.anomaly import SloSpecError
    monkeypatch.setenv("DMLC_SLO_SPEC", "serving.latency_s:p99<0.01")
    with pytest.raises(SloSpecError, match="bad key=value"):
        PredictionServer(_Stub(), warmup=False)
    monkeypatch.delenv("DMLC_SLO_SPEC")
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    srv = PredictionServer(_Stub(), warmup=False,
                           metrics_port=taken.getsockname()[1])
    try:
        with pytest.raises(OSError):
            srv.start()
        assert srv._accept_thread is None       # nothing else started
    finally:
        srv.stop()
        taken.close()
        stop_samplers()     # the exporter's start() started it before binding


def test_admit_fault_sheds_as_the_jax_server_does():
    """``serving.server.admit:error=1:times=2``: the first two requests
    are answered OVERLOADED (the injected fault's message), the third is
    served; both servers answer the same bytes."""
    from dmlc_core_tpu.utils import faults as jfaults
    from dmlc_core_tpu_torch.utils import faults as tfaults
    got = {}
    for name, cls, mod in (("jax", jserver.PredictionServer, jfaults),
                           ("port", PredictionServer, tfaults)):
        shed = (jmetrics if name == "jax" else tmetrics).metrics.counter(
            "serving.server.shed")
        before = shed.value
        srv = cls(_Stub(), warmup=False).start()
        try:
            with mod.inject_faults("serving.server.admit:error=1:times=2"):
                got[name] = _answers(
                    (srv.host, srv.port),
                    [(_frame(i, *_ONE), 0.05) for i in range(3)], 3)
        finally:
            srv.stop()
        assert shed.value == before + 2
    assert got["port"] == got["jax"]
    for i, status in enumerate((1, 1, 0)):
        assert tserver.RSP_HEADER.unpack(
            got["port"][i][:tserver.RSP_HEADER.size])[1] == status
    assert b"injected fault at 'serving.server.admit'" in got["port"][0]


def test_client_retries_answer_every_request_through_a_shed_burst(
        monkeypatch):
    """``DMLC_FAULT_SPEC='serving.server.admit:error=1:times=5'`` sheds
    exactly five admissions; the port's client retries them (its budget
    raised to 8 tries, as a burst of 5 can land on one request) and
    every answer is right."""
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "serving.server.admit:error=1:times=5")
    monkeypatch.setenv("DMLC_SERVING_RETRIES", "8")
    monkeypatch.setenv("DMLC_SERVING_BACKOFF_BASE", "0.001")
    shed = tmetrics.metrics.counter("serving.server.shed")
    retries = tmetrics.metrics.counter("retry.serving.client.retries")
    shed0, retries0 = shed.value, retries.value
    w = np.arange(F_LR, dtype=np.float32) / F_LR
    rng = np.random.default_rng(16)
    reqs = [_req(rng, int(rng.integers(1, 6)), 8, F_LR) for _ in range(40)]
    out = [None] * len(reqs)
    try:
        with PredictionServer(_logreg_engine(w)).start() as srv:
            with PredictClient(srv.host, srv.port) as c:
                def run(k):
                    for i in range(k, len(reqs), 4):
                        out[i] = c.predict(*reqs[i], timeout=30)
                ts = [threading.Thread(target=run, args=(k,))
                      for k in range(4)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in ts)
    finally:
        from dmlc_core_tpu_torch.utils import faults as tfaults
        monkeypatch.delenv("DMLC_FAULT_SPEC")
        tfaults.clear_faults()
    for r, got in zip(reqs, out):
        np.testing.assert_allclose(got, _logreg_ref(w, 0.25, *r),
                                   rtol=1e-4, atol=1e-5)
    assert shed.value == shed0 + 5
    assert retries.value == retries0 + 5


def test_autotuned_serve_forever_is_refused(monkeypatch, tmp_path):
    """No longer refused: with ``DMLC_AUTOTUNE=1`` each window under
    traffic is one autotune epoch over the batcher's knobs, which stay
    within the engine's ladder; ``0`` touches nothing."""
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / "tuned.json"))
    m = tmetrics.metrics
    m.gauge("slo.active_breaches").set(0)
    srv = PredictionServer(_Stub(), warmup=False, max_delay_s=0.001).start()
    stop = threading.Event()

    def traffic():
        with PredictClient(srv.host, srv.port) as c:
            while not stop.is_set():
                c.predict(np.array([1, 2], np.int32),
                          np.ones(2, np.float32),
                          np.array([0, 1, 2], np.int32))
    th = threading.Thread(target=traffic, daemon=True)
    try:
        th.start()
        monkeypatch.setenv("DMLC_AUTOTUNE", "1")
        e0 = m.counter("autotune.epochs").value
        mut0 = m.counter("autotune.mutations").value
        assert srv.serve_forever(window_s=0.15, max_windows=4) == 4
        assert m.counter("autotune.epochs").value - e0 >= 3
        assert m.counter("autotune.mutations").value > mut0
        b = srv.batcher
        ladder = srv.engine.ladder
        assert 0 < b.max_batch_rows <= ladder.max_rows
        assert 0 < b.max_batch_nnz <= ladder.max_nnz
        assert 0.0005 <= b.max_delay_s <= 0.008
        monkeypatch.setenv("DMLC_AUTOTUNE", "0")      # the kill switch
        e1 = m.counter("autotune.epochs").value
        knobs = (b.max_delay_s, b.max_batch_rows, b.max_batch_nnz)
        assert srv.serve_forever(window_s=0.05, max_windows=2) == 2
        assert m.counter("autotune.epochs").value == e1
        assert (b.max_delay_s, b.max_batch_rows, b.max_batch_nnz) == knobs
    finally:
        stop.set()
        th.join(timeout=30)
        srv.stop()


# ---------------------------------------------------------------------------
# serve_main
# ---------------------------------------------------------------------------

def test_serve_main_refusals(monkeypatch, capsys, tmp_path):
    assert tserver.serve_main([]) == 2
    assert "usage" in capsys.readouterr().err
    assert tserver.serve_main(["ckpt_dir=x", "features=10", "model=ffm",
                               "device=cpu"]) == 2
    assert "the serving wire (REQ_HEADER, then ids, vals and row_ptr) " \
        "carries no libfm fields" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tserver.serve_main(["ckpt_dir=x", "features=10"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    # DMLC_AUTOTUNE is no longer refused: serve_main serves, and its
    # serve_forever runs the tuner's windows (no traffic: each aborted)
    monkeypatch.undo()
    monkeypatch.setenv("DMLC_AUTOTUNE", "1")
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / "tuned.json"))
    ran = {}
    real = tserver.PredictionServer.serve_forever

    def two_windows(self, window_s=5.0, max_windows=None):
        ran["windows"] = real(self, window_s=0.02, max_windows=2)
        raise KeyboardInterrupt
    monkeypatch.setattr(tserver.PredictionServer, "serve_forever",
                        two_windows)
    aborted = tmetrics.metrics.counter("autotune.aborted").value
    assert tserver.serve_main([f"ckpt_dir={tmp_path}", "features=10",
                               "device=cpu", "host=127.0.0.1"]) == 0
    assert ran["windows"] == 2
    assert tmetrics.metrics.counter("autotune.aborted").value > aborted


def test_ffm_cannot_be_served_by_either_engine():
    """Why ``serve_main model=ffm`` refuses: a request is ids, vals and
    row_ptr, and the JAX engine's forward of FieldAwareFM on one raises
    the model's KeyError for the missing fields."""
    from dmlc_core_tpu.models.ffm import FieldAwareFM as JFFM
    model = JFFM(64, 4, 2)
    eng = jengine.InferenceEngine(model, model.init(jax.random.PRNGKey(0)),
                                  buckets=jengine.BucketLadder([(4, 16)]))
    with pytest.raises(KeyError, match="needs a 'fields' batch array"):
        eng.predict(np.array([1, 2, 3], np.int32),
                    np.ones(3, np.float32), np.array([0, 2, 3], np.int64))
    assert tserver._FFM_UNSERVABLE.startswith("model=ffm cannot be served")


def test_serve_main_serves_a_checkpoint_in_a_subprocess(tmp_path):
    _serve_main_serves(tmp_path, str(tmp_path / "ck"))


def test_serve_main_serves_a_checkpoint_on_s3(tmp_path, s3_server):
    """``serve_main ckpt_dir=s3://...``: the subprocess reads the
    endpoint and keys from the environment the fake S3 set."""
    _serve_main_serves(tmp_path, "s3://bkt/ck")
    assert "bkt/ck/ckpt-3.bin" in S3.objects


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
def test_watch_checkpoints_on_a_remote_store(s3_server, hdfs_server, kind):
    d = ("s3://bkt/run" if kind == "s3" else
         f"hdfs://127.0.0.1:{hdfs_server[0].server_address[1]}/run")
    mgr = CheckpointManager(d)
    mgr.save(1, {"params": {"w": np.full(F_LR, 1.0, np.float32),
                            "b": np.float32(0.0)}}, meta={"model": "logreg"})
    eng = _logreg_engine(np.zeros(F_LR), b=0.0, ladder=[(16, 512)])
    srv = PredictionServer(eng)
    srv.watch_checkpoints(d, interval_s=0.05)
    assert eng.params_version == 1         # the first poll loaded step 1
    srv.start()
    try:
        mgr.save(4, {"params": {"w": np.full(F_LR, 2.0, np.float32),
                                "b": np.float32(0.0)}})
        deadline = time.monotonic() + 20
        while eng.params_version == 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        with PredictClient(srv.host, srv.port) as c:
            assert c.predict(np.array([1], np.int32),
                             np.ones(1, np.float32))[0] == 2.0
    finally:
        srv.stop()
    assert srv.reload_from_checkpoint(d, step=1) == 1


def test_serve_main_serves_healthz_under_dmlc_metrics_port(tmp_path):
    """``DMLC_METRICS_PORT=0`` and ``DMLC_SLO_SPEC`` through the
    environment, as the JAX CLI takes them: the subprocess prints the
    exporter's port after the serving one, and ``/healthz`` answers."""
    from test_torch_exposition import scrape
    p = _fm_params(7)
    ckpt = str(tmp_path / "ck")
    CheckpointManager(ckpt).save(1, {"params": p}, meta={"model": "fm"})
    env = dict(os.environ, PYTHONPATH=REPO, DMLC_METRICS_PORT="0",
               DMLC_SLO_SPEC="serving.latency_s:max=10s")
    for key in ("DMLC_AUTOTUNE", "DMLC_FAULT_SPEC"):
        env.pop(key, None)
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serving.server",
         f"ckpt_dir={ckpt}", f"features={F}", "model=fm", f"dim={D}",
         "host=127.0.0.1", "port=0", "device=cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving on" not in line:
            left = deadline - time.monotonic()
            assert left > 0 and proc.poll() is None, \
                (tmp_path / "server.log").read_text()
            if select.select([proc.stdout], [], [], left)[0]:
                line = proc.stdout.readline()
        assert line.startswith("serving on 127.0.0.1:")
        # printed right after, and often read into the same buffer
        line = proc.stdout.readline()
        assert line.startswith("telemetry on 127.0.0.1:"), line
        host, port = line.split()[-1].rsplit(":", 1)
        code, ctype, body = scrape(int(port), "/healthz", host=host)
        assert (code, ctype) == (200, "application/json")
        assert json.loads(body) == {"status": "ok", "model_id": "default",
                                    "queue_depth": 0, "queue_fraction": 0.0,
                                    "inflight": 0}
        code, _, body = scrape(int(port), "/metrics", host=host)
        assert code == 200 and "dmlc_serving_server_connections 0" in body
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


def _serve_main_serves(tmp_path, ckpt_dir):
    """``serve_main`` in a subprocess on ``ckpt_dir``: both packages'
    clients get the JAX engine's scores."""
    p = _fm_params(6)
    CheckpointManager(ckpt_dir).save(3, {"params": p}, meta={"model": "fm"})
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in ("DMLC_AUTOTUNE", "DMLC_METRICS_PORT", "DMLC_FAULT_SPEC"):
        env.pop(key, None)
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serving.server",
         f"ckpt_dir={ckpt_dir}", f"features={F}", "model=fm",
         f"dim={D}", "host=127.0.0.1", "port=0", "device=cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving on" not in line:
            left = deadline - time.monotonic()
            assert left > 0 and proc.poll() is None, \
                (tmp_path / "server.log").read_text()
            if select.select([proc.stdout], [], [], left)[0]:
                line = proc.stdout.readline()
        host, port = line.split()[-1].rsplit(":", 1)
        ref = _jax_fm(p)
        rng = np.random.default_rng(15)
        reqs = [_req(rng, int(rng.integers(1, 30)), 12) for _ in range(6)]
        for cls in (PredictClient, jclient.PredictClient):
            with cls(host, int(port)) as c:
                for r in reqs:
                    np.testing.assert_allclose(c.predict(*r),
                                               ref.predict(*r), **TOL)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    assert "hot-reloaded step 3" in (tmp_path / "server.log").read_text()


# ---------------------------------------------------------------------------
# metrics, against the JAX classes (tests/test_metrics.py)
# ---------------------------------------------------------------------------

MODS = pytest.mark.parametrize("m", [jmetrics, tmetrics], ids=["jax", "torch"])


def _histogram_trace(m, values, cap, seed):
    h = m.Histogram(max_samples=cap, seed=seed)
    for v in values:
        h.observe(v)
    snap = {k: v for k, v in h.snapshot().items() if k != "exemplars"}
    return (snap, h.quantiles([0.0, 0.1, 0.5, 0.9, 1.0]), h.state())


@pytest.mark.parametrize("cap,seed", [(1000, 0), (64, 3), (7, 11)])
def test_histogram_matches_jax(cap, seed):
    values = [float(v) for v in
              np.random.default_rng(seed).permutation(10_000)]
    want = _histogram_trace(jmetrics, values, cap, seed)
    assert _histogram_trace(tmetrics, values, cap, seed) == want


def test_histogram_exact_quantiles_under_cap():
    h = tmetrics.Histogram(max_samples=1000)
    for v in range(1, 101):
        h.observe(float(v))
    assert (h.count, h.min, h.max) == (100, 1.0, 100.0)
    assert h.mean == pytest.approx(50.5)
    assert h.quantile(0.0) == 1.0 and h.quantile(1.0) == 100.0
    p50, p95, p99 = h.quantiles([0.5, 0.95, 0.99])
    assert (p50, p95, p99) == pytest.approx((50.5, 95.05, 99.01))


def test_histogram_reservoir_beyond_cap_stays_bounded():
    h = tmetrics.Histogram(max_samples=64, seed=3)
    for v in range(10_000):
        h.observe(float(v))
    assert h.count == 10_000 and len(h.state()["samples"]) == 64
    assert h.mean == pytest.approx(4999.5)
    assert 2000.0 < h.quantile(0.5) < 8000.0


def test_histogram_empty_errors_and_time():
    h = tmetrics.Histogram()
    assert (h.count, h.quantile(0.5), h.mean) == (0, 0.0, 0.0)
    for q in (1.5, -0.1):
        with pytest.raises(ValueError):
            h.quantile(q)
    with pytest.raises(ValueError):
        tmetrics.Histogram(max_samples=0)
    with h.time():
        pass
    assert h.count == 1 and h.min >= 0.0


def test_histogram_merge_matches_jax():
    states = {}
    for m in (jmetrics, tmetrics):
        out = []
        for i, n in enumerate((50, 500, 3000)):
            h = m.Histogram(max_samples=256, seed=i)
            for v in np.random.default_rng(i).random(n):
                h.observe(float(v))
            out.append(h.state())
        states[m] = out
    assert tmetrics.Histogram.merge(states[tmetrics]) == \
        jmetrics.Histogram.merge(states[jmetrics])
    assert tmetrics.Histogram.merge([])["count"] == 0


@MODS
def test_counter_thread_safe(m):
    c = m.Counter()

    def bump():
        for _ in range(1000):
            c.add()

    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert c.value == 4000
    assert m.Counter.merge([c.state(), c.state()])["value"] == 8000


def _meters_trace(m):
    now = [0.0]
    tm = m.ThroughputMeter(window_sec=1.0, clock=lambda: now[0])
    st = m.StageTimer(clock=lambda: now[0])
    out = []
    for dt, n in ((1.0, 100), (0.5, 50), (0.2, 7), (3.0, 0), (0.1, 5)):
        now[0] += dt
        with st.time():
            now[0] += 0.25
        tm.add(n)
        out.append((tm.snapshot(), tm.rate(), tm.windowed_rate(),
                    st.snapshot()))
    g = m.Gauge()
    g.set(3.5)
    out.append((g.snapshot(), m.Gauge.merge([g.state(), {"value": 9.0}])))
    return out


def test_throughput_stage_and_gauge_match_jax():
    assert _meters_trace(tmetrics) == _meters_trace(jmetrics)
    trace = _meters_trace(tmetrics)
    assert trace[0][1] == pytest.approx(100 / 1.25)
    assert trace[-1][0] == {"type": "gauge", "value": 3.5}


def test_stage_timer_decorator():
    now = [0.0]
    st = tmetrics.StageTimer(clock=lambda: now[0])

    @st
    def work():
        now[0] += 1.0
        return 7

    assert work() == 7 and work.__name__ == "work"
    assert st.count == 1 and st.mean_sec == pytest.approx(1.0)


def test_registry_snapshot_reuse_and_generation():
    r = tmetrics.MetricsRegistry()
    r.counter("a.b").add(3)
    r.counter("a.b").add(2)              # the same instance by name
    r.gauge("g").set(1.0)
    r.histogram("lat").observe(2.0)
    with r.stage("s").time():
        pass
    r.throughput("t").add(4)
    snap = r.snapshot()
    assert snap["a.b"]["value"] == 5 and snap["g"]["value"] == 1.0
    assert snap["s"]["count"] == 1 and snap["lat"]["p50"] == 2.0
    assert snap["t"]["total"] == 4
    import json
    json.dumps(snap)
    assert r.state()["lat"]["samples"] == [2.0]
    r.report()
    gen = r.generation
    r.reset()
    assert r.snapshot() == {} and r.generation == gen + 1


def test_batcher_metrics_rebind_after_reset():
    """A batcher built before ``metrics.reset()`` still reports into the
    registry afterwards (generation-based rebinding)."""
    from dmlc_core_tpu_torch.serving import MicroBatcher
    with MicroBatcher(_Stub(), max_delay_s=0.0) as b:
        tmetrics.metrics.reset()
        b.submit(np.zeros(1), np.ones(1)).result(timeout=10)
        deadline = time.monotonic() + 10
        while "serving.batcher.batches" not in tmetrics.metrics.snapshot() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    snap = tmetrics.metrics.snapshot()
    assert snap["serving.batcher.batches"]["value"] >= 1
    assert snap["serving.latency_s"]["count"] >= 1


def test_batcher_apply_knobs_bounds_and_applies():
    from dmlc_core_tpu_torch.serving import MicroBatcher
    with MicroBatcher(_Stub(), max_delay_s=5.0) as b:
        b.apply_knobs(max_delay_s=0.0, max_batch_rows=8, max_batch_nnz=100)
        assert (b.max_delay_s, b.max_batch_rows, b.max_batch_nnz) == \
            (0.0, 8, 100)
        t0 = time.monotonic()
        b.submit(np.zeros(1), np.ones(1)).result(timeout=10)
        assert time.monotonic() - t0 < 4.0     # the new delay trigger
        for kw in (dict(max_delay_s=-1), dict(max_batch_rows=65),
                   dict(max_batch_nnz=0)):
            with pytest.raises(DMLCError):
                b.apply_knobs(**kw)


# ---------------------------------------------------------------------------
# retry, against the JAX classes (tests/test_retry.py)
# ---------------------------------------------------------------------------

RMODS = pytest.mark.parametrize("r", [jretry, tretry], ids=["jax", "torch"])


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@RMODS
def test_deadline_remaining_and_clamp(r):
    clk = FakeClock()
    dl = r.Deadline(10.0, clock=clk)
    assert dl.remaining() == pytest.approx(10.0)
    assert dl.clamp(3.0) == pytest.approx(3.0)
    assert dl.clamp(30.0) == pytest.approx(10.0)
    clk.advance(9.5)
    assert dl.clamp(3.0) == pytest.approx(0.5) and not dl.expired()
    clk.advance(1.0)
    assert dl.expired() and dl.clamp(3.0) == 0.0
    with pytest.raises(r.DeadlineExpired):
        dl.check("unit test")
    un = r.Deadline.unbounded()
    assert un.remaining() == float("inf") and un.clamp(7.0) == 7.0
    un.check()


def _retry_trace(r, seed):
    """One schedule of failures through a seeded policy on a fake clock:
    the sleeps, the calls and how it ended."""
    clk = FakeClock()
    sleeps, seen = [], []

    def fake_sleep(s):
        sleeps.append(s)
        clk.advance(max(s, 0.3))

    policy = r.RetryPolicy(max_attempts=100, base_delay_s=0.05,
                           max_delay_s=1.0, seed=seed,
                           name=f"ut.trace{seed}", sleep=fake_sleep)
    calls = {"n": 0}

    def always_fails():
        calls["n"] += 1
        raise OSError("down")

    try:
        policy.call(always_fails, deadline=r.Deadline(2.0, clock=clk),
                    on_retry=lambda a, e: seen.append((a, str(e))))
    except r.DeadlineExpired as e:
        ended = ("deadline", type(e.__cause__).__name__)
    backoffs = [policy.backoff_s(a) for a in range(1, 12)]
    return sleeps, seen, calls["n"], ended, backoffs


@pytest.mark.parametrize("seed", [0, 42])
def test_retry_schedule_matches_jax(seed):
    got = _retry_trace(tretry, seed)
    assert got == _retry_trace(jretry, seed)
    sleeps, seen, n, ended, backoffs = got
    assert ended == ("deadline", "OSError") and n == len(seen) < 100
    assert all(s <= 2.0 for s in sleeps)
    for a, d in enumerate(backoffs, 1):
        assert 0.0 <= d <= min(1.0, 0.05 * 2.0 ** (a - 1))


@RMODS
def test_retry_attempts_predicate_and_counters(r):
    sleeps = []
    policy = r.RetryPolicy(max_attempts=5, base_delay_s=0.01, seed=0,
                           name="ut.port.transient", sleep=sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return "ok"

    m = r.metrics
    before = m.counter("retry.ut.port.transient.retries").value
    assert policy.call(flaky) == "ok" and calls["n"] == 3
    assert len(sleeps) == 2
    assert m.counter("retry.ut.port.transient.retries").value == before + 2

    capped = r.RetryPolicy(max_attempts=3, name="ut.port.exhaust",
                           sleep=lambda s: None)
    ex_before = m.counter("retry.ut.port.exhaust.exhausted").value
    with pytest.raises(r.RetriesExhausted) as ei:
        capped.call(lambda: (_ for _ in ()).throw(OSError("down")))
    assert isinstance(ei.value.__cause__, OSError)
    assert m.counter("retry.ut.port.exhaust.exhausted").value == \
        ex_before + 1
    with pytest.raises(ValueError):            # not retryable
        capped.call(lambda: (_ for _ in ()).throw(ValueError("bug")))

    class Shed(Exception):
        pass

    shed = r.RetryPolicy(max_attempts=4, base_delay_s=0.0,
                         retryable=lambda e: isinstance(e, Shed),
                         sleep=lambda s: None)
    calls["n"] = 0

    def shed_twice():
        calls["n"] += 1
        if calls["n"] < 3:
            raise Shed()
        return calls["n"]

    assert shed.call(shed_twice) == 3


@RMODS
def test_retry_after_hint_clamped_by_deadline(r):
    class Busy(OSError):
        def __init__(self, retry_after_s):
            super().__init__("429")
            self.retry_after_s = retry_after_s

    sleeps = []
    policy = r.RetryPolicy(max_attempts=3, base_delay_s=0.001,
                           sleep=sleeps.append)
    calls = {"n": 0}

    def server_says_wait():
        calls["n"] += 1
        if calls["n"] == 1:
            raise Busy(5.0)
        return "ok"

    assert policy.call(server_says_wait) == "ok" and sleeps == [5.0]
    sleeps.clear()
    calls["n"] = 0
    assert policy.call(server_says_wait,
                       deadline=r.Deadline(0.5, clock=FakeClock())) == "ok"
    assert sleeps == [0.5]


@RMODS
def test_retry_and_breaker_from_env(r, monkeypatch):
    monkeypatch.setenv("UT_RETRIES", "7")
    monkeypatch.setenv("UT_BACKOFF_BASE", "0.25")
    monkeypatch.setenv("UT_BACKOFF_MAX", "3.5")
    monkeypatch.setenv("UT_DEADLINE", "9")
    monkeypatch.setenv("UT_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("UT_BREAKER_COOLDOWN", "1.5")
    p = r.RetryPolicy.from_env("UT")
    assert (p.max_attempts, p.base_delay_s, p.max_delay_s, p.deadline_s,
            p.name) == (7, 0.25, 3.5, 9, "ut")
    p2 = r.RetryPolicy.from_env("UT", max_attempts=2, name="mine")
    assert (p2.max_attempts, p2.name) == (2, "mine")
    monkeypatch.setenv("UT_DEADLINE", "0")
    assert r.RetryPolicy.from_env("UT").deadline_s is None
    br = r.CircuitBreaker.from_env("UT")
    assert (br.failure_threshold, br.cooldown_s, br.name) == (2, 1.5, "ut")


def _breaker_trace(r):
    """A scripted run of the breaker's state machine on a fake clock:
    (state, allowed) after each event."""
    clk = FakeClock()
    br = r.CircuitBreaker(f"ut.script.{r.__name__}", failure_threshold=3,
                          cooldown_s=5.0, clock=clk)
    out = []

    def allow():
        try:
            br.allow()
            return True
        except r.CircuitOpen:
            return False

    script = ["fail", "fail", "ok", "fail", "fail", "fail", "allow",
              ("tick", 4.9), "allow", ("tick", 0.2), "allow", "allow",
              "fail", ("tick", 4.9), "allow", ("tick", 0.2), "allow", "ok",
              "allow", "fail"]
    for ev in script:
        res = None
        if ev == "fail":
            br.record_failure()
        elif ev == "ok":
            br.record_success()
        elif ev == "allow":
            res = allow()
        else:
            clk.advance(ev[1])
        out.append((br.state, res))
    calls = []
    for fn in (lambda: (_ for _ in ()).throw(OSError("x")),
               lambda: "ok"):
        try:
            calls.append(br.call(fn))
        except (OSError, r.CircuitOpen) as e:
            calls.append(type(e).__name__)
    return out, calls


def test_breaker_state_machine_matches_jax():
    got = _breaker_trace(tretry)
    assert got == _breaker_trace(jretry)
    states, _ = got
    assert states[5] == ("open", None)        # the third failure in a row
    assert states[6] == ("open", False)       # fast fail
    assert states[10] == ("half_open", True)  # the one probe
    assert states[11] == ("half_open", False)  # everyone else waits
    assert states[17] == ("closed", None)     # the probe came back


@RMODS
def test_breaker_counters(r):
    clk = FakeClock()
    name = f"ut.count.{r.__name__.replace('.', '_')}"
    br = r.CircuitBreaker(name, failure_threshold=1, cooldown_s=5.0,
                          clock=clk)
    opens = r.metrics.counter(f"circuit.{name}.opens").value
    fast = r.metrics.counter(f"circuit.{name}.fast_fails").value
    br.record_failure()
    with pytest.raises(r.CircuitOpen):
        br.allow()
    assert r.metrics.counter(f"circuit.{name}.opens").value == opens + 1
    assert r.metrics.counter(f"circuit.{name}.fast_fails").value == fast + 1
