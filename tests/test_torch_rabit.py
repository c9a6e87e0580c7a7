"""The port's rabit client (``parallel/rabit.py``) held against the JAX
package's, and the slice as a whole: a data-parallel cohort whose ranks
come from the port's tracker.

* Collectives: ``allreduce`` (sum, max, min, prod), ``broadcast`` from
  every root and ``allgather``, over worlds 1, 2, 4 and 7 of threads:
  ``array_equal`` (``==`` for broadcast objects) to a JAX cohort's on the
  same inputs.
* A mixed cohort: two JAX and two port contexts on one tracker, once
  with each package's tracker, give the same results as a cohort of one
  package: the wire is the same.
* Recovery: ``recover`` keeps the rank; the topology a registration
  reply brings never rolls back a newer pushed one and is applied under
  the peer lock (JAX ``tests/test_lockcheck.py``'s cases); the
  ``DMLC_PEER_RECV_TIMEOUT`` cases.
* ``checkpoint`` / ``load_checkpoint`` / ``resume_seq``, and a port
  checkpoint restored by a JAX context.
* ``push_telemetry`` on its cadence; the log context stamps ``rank=`` on
  text and JSON records as the JAX package's does (JAX
  ``tests/test_telemetry.py``'s two cases), and registration sets it.
* The connect retry (a difference by design): a tracker connect to a
  listener that never accepts times out and the next try succeeds; a
  refused connect raises at once.
* The slice: ``tests/torch_dp_worker.py`` with ``launcher="tracker"``,
  two gloo ranks training FM flat on their own batches.  Tolerances are
  ``tests/test_torch_dp_train.py``'s against JAX ``make_train_step(mesh=)``
  on the union batches (losses ``rtol 1e-4``, parameters ``rtol 1e-4,
  atol 1e-5``); the rabit-reduced ``[sum of w * bce, sum of w, steps]``
  equals the mesh's all-reduce of the same (``rtol 1e-12``: float64 sums
  of two terms) and the JAX reference's (the loss ``rtol 1e-4``, as the
  parameters it is taken at; weights and steps exact); the ranks'
  digests are equal (bit-equal replicas), and the mesh's axes are JAX
  ``data_parallel_mesh``'s.

Every tracker binds port 0 on 127.0.0.1 and is stopped; both packages'
log contexts are put back after each test.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.parallel import mesh as jmesh  # noqa: E402
from dmlc_core_tpu.parallel import rabit as jrabit  # noqa: E402
from dmlc_core_tpu.parallel import tracker as jtracker  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.utils import logging as jlogging  # noqa: E402
from dmlc_core_tpu_torch.parallel import data_parallel_mesh  # noqa: E402
from dmlc_core_tpu_torch.parallel import rabit, tracker  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.utils import logging as tlogging  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402
from test_torch_exposition import history, scrape  # noqa: E402,F401

TRACKERS = {"port": tracker, "jax": jtracker}
CONTEXTS = {"port": rabit.RabitContext, "jax": jrabit.RabitContext}
WORLDS = (1, 2, 4, 7)
OPS = ("sum", "max", "min", "prod")


@pytest.fixture(autouse=True)
def _log_context():
    """Registration stamps ``rank`` on the process's log context: put both
    packages' back."""
    yield
    tlogging.set_log_context(rank=None)
    jlogging.set_log_context(rank=None)


def _cohort(tracker_mod, kinds, fn, timeout=60.0):
    """One tracker of ``tracker_mod`` and a context a thread, of the
    package ``kinds[i]`` for job ``w{i}``: ``fn(ctx)`` of each, by rank."""
    t = tracker_mod.RabitTracker(num_workers=len(kinds),
                                 host_ip="127.0.0.1")
    t.start()
    results, errors = {}, []

    def worker(i):
        try:
            ctx = CONTEXTS[kinds[i]]("127.0.0.1", t.port, jobid=f"w{i}",
                                     heartbeat_interval=0)
            results[ctx.rank] = fn(ctx)
            ctx.shutdown()
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(kinds))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    t.join(timeout=30)
    assert not errors, errors
    return [results[r] for r in range(len(kinds))]


def _inputs(world):
    rng = np.random.default_rng(100 + world)
    return {"f": rng.standard_normal((world, 5)),
            "i": rng.integers(-4, 9, size=(world, 3)).astype(np.int32),
            "g": rng.standard_normal((world, 2, 3)).astype(np.float32)}


def _all_collectives(world):
    inp = _inputs(world)

    def fn(ctx):
        r = ctx.rank
        out = {}
        for op in OPS:
            out[op] = ctx.allreduce(inp["f"][r], op)
            out[op + "_int"] = ctx.allreduce(inp["i"][r], op)
        for root in sorted({0, world - 1, world // 2}):
            obj = ({"root": root, "a": inp["f"][root], "s": "x" * root}
                   if r == root else None)
            out[f"bcast{root}"] = ctx.broadcast(obj, root=root)
        out["allgather"] = ctx.allgather(inp["g"][r])
        out["seq"] = ctx.seq
        return out
    return fn


@pytest.fixture(scope="module")
def cohorts():
    return {(world, pkg): _cohort(TRACKERS[pkg], [pkg] * world,
                                  _all_collectives(world))
            for world in WORLDS for pkg in ("port", "jax")}


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_equals_the_jax_cohorts(cohorts, world, op):
    got, want = cohorts[world, "port"], cohorts[world, "jax"]
    inp = _inputs(world)
    fold = {"sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}[op]
    for g, w in zip(got, want):
        for key in (op, op + "_int"):
            _same(g[key], w[key])
        np.testing.assert_allclose(g[op], fold(inp["f"], axis=0),
                                   rtol=1e-12)
        assert g[op].flags.writeable


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_from_every_root_equals_the_jax_cohorts(cohorts, world):
    got, want = cohorts[world, "port"], cohorts[world, "jax"]
    inp = _inputs(world)
    for g, w in zip(got, want):
        for key in [k for k in g if k.startswith("bcast")]:
            root = int(key[5:])
            _same(g[key], w[key])
            if world > 1:
                assert g[key]["root"] == root
                np.testing.assert_array_equal(g[key]["a"], inp["f"][root])


@pytest.mark.parametrize("world", WORLDS)
def test_allgather_equals_the_jax_cohorts(cohorts, world):
    got, want = cohorts[world, "port"], cohorts[world, "jax"]
    for g, w in zip(got, want):
        _same(g["allgather"], w["allgather"])
        np.testing.assert_array_equal(g["allgather"], _inputs(world)["g"])
        assert g["seq"] == w["seq"]


@pytest.mark.parametrize("host", sorted(TRACKERS))
def test_a_mixed_cohort_gives_the_same_results(cohorts, host):
    """Jobs w0..w3 alternate JAX and port contexts on one tracker of
    ``host``'s package: every result is the one-package cohort's."""
    got = _cohort(TRACKERS[host], ["jax", "port", "jax", "port"],
                  _all_collectives(4))
    for g, w in zip(got, cohorts[4, "port"]):
        _same(g, w)


# ---------------------------------------------------------------------------
# recovery and links
# ---------------------------------------------------------------------------

def test_recover_keeps_the_rank():
    world = 3
    t = tracker.RabitTracker(num_workers=world, host_ip="127.0.0.1")
    t.start()
    ranks, errors = {}, []
    ready = threading.Barrier(world)

    def worker(i):
        try:
            ctx = rabit.RabitContext("127.0.0.1", t.port, jobid=f"w{i}",
                                     heartbeat_interval=0)
            ranks[i] = ctx.rank
            ready.wait()
            ctx.shutdown()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors, errors
    ctx = rabit.RabitContext("127.0.0.1", t.port, jobid="w1", recover=True,
                             connect_links=False, heartbeat_interval=0)
    assert ctx.rank == ranks[1]
    ctx.shutdown()
    t.stop()


def _bare(cls):
    ctx = cls.__new__(cls)
    ctx._peer_lock = threading.Lock()
    ctx._target_gen = 0
    ctx._addresses = {}
    return ctx


@pytest.mark.parametrize("pkg", sorted(CONTEXTS))
def test_topology_never_rolls_back(pkg):
    ctx = _bare(CONTEXTS[pkg])
    ctx._target_gen = 5                         # pushed by reset_links
    ctx._addresses = {0: ("pushed-host", 9000)}
    ctx._apply_topology(3, {0: ("stale-host", 1), 1: ("filler", 2)})
    assert ctx._target_gen == 5
    assert ctx._addresses == {0: ("pushed-host", 9000), 1: ("filler", 2)}
    ctx._apply_topology(7, {0: ("new-host", 3)})
    assert ctx._target_gen == 7
    assert ctx._addresses == {0: ("new-host", 3)}


def test_topology_is_applied_under_the_peer_lock():
    ctx = _bare(rabit.RabitContext)

    class Probe:
        entered = 0

        def __enter__(self):
            Probe.entered += 1

        def __exit__(self, *exc):
            pass

    ctx._peer_lock = Probe()
    ctx._apply_topology(1, {0: ("h", 1)})
    assert Probe.entered == 1 and ctx._addresses == {0: ("h", 1)}


@pytest.mark.parametrize("raw,kw,want", [
    (None, {"recover_timeout": 45.0}, 90.0),     # twice recover_timeout
    ("0", {}, None), ("-3", {}, None),           # unbounded
    ("garbage", {"recover_timeout": 30.0}, 60.0),  # a typo: the default
    ("7.5", {}, 7.5)])
def test_peer_recv_timeout_as_the_jax_context(monkeypatch, raw, kw, want):
    if raw is None:
        monkeypatch.delenv("DMLC_PEER_RECV_TIMEOUT", raising=False)
    else:
        monkeypatch.setenv("DMLC_PEER_RECV_TIMEOUT", raw)
    for kind, cls in CONTEXTS.items():
        t = tracker.RabitTracker(num_workers=1, host_ip="127.0.0.1")
        t.start()
        ctx = cls("127.0.0.1", t.port, jobid="w0", heartbeat_interval=0,
                  **kw)
        try:
            assert ctx.peer_recv_timeout == want, kind
        finally:
            ctx.shutdown()
            t.stop()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_load_and_resume_seq(tmp_path, monkeypatch):
    """``checkpoint`` keeps the state and the sequence number; a reborn
    context (``recover``) of either package reads it back and resumes in
    step; ``resume_seq`` only before a collective; ``shutdown`` removes
    the file."""
    monkeypatch.setenv("DMLC_CHECKPOINT_DIR", str(tmp_path))

    def fn(ctx):
        ctx.allreduce(np.ones(2))
        ctx.allreduce(np.ones(2))
        ctx.checkpoint({"phase": ctx.rank})
        with pytest.raises(DMLCError, match="resume_seq after 2"):
            ctx.resume_seq(9)
        return ctx.seq, ctx.version_number, ctx._ckpt_path()

    t = tracker.RabitTracker(num_workers=2, host_ip="127.0.0.1")
    t.start()
    results, errors = {}, []

    def worker(i):
        try:
            ctx = rabit.RabitContext("127.0.0.1", t.port, jobid=f"w{i}",
                                     heartbeat_interval=0)
            results[i] = fn(ctx)
            # no shutdown: the checkpoint stays for the reborn worker
            ctx._hb_stop.set()
            ctx._accepting = False
            ctx._listener.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors, errors
    try:
        for i in range(2):
            seq, version, path = results[i]
            assert (seq, version) == (2, 1) and os.path.exists(path)
        for kind in ("jax", "port"):
            ctx = CONTEXTS[kind]("127.0.0.1", t.port, jobid="w1",
                                 recover=True, connect_links=False,
                                 heartbeat_interval=0)
            assert ctx.load_checkpoint() == {"phase": ctx.rank}
            assert (ctx.seq, ctx.version_number) == (2, 1)
            if kind == "jax":
                ctx._accepting = False
                ctx._listener.close()
        assert ctx._ckpt_path() == results[1][2]
        ctx.shutdown()
        assert not os.path.exists(results[1][2])
        fresh = rabit.RabitContext("127.0.0.1", t.port, jobid="w0",
                                   recover=True, connect_links=False,
                                   heartbeat_interval=0)
        fresh.resume_seq(5)
        assert fresh.seq == 5
        os.unlink(fresh._ckpt_path())
        assert fresh.load_checkpoint() is None
        fresh.shutdown()
    finally:
        t.stop()


# ---------------------------------------------------------------------------
# telemetry and the log context
# ---------------------------------------------------------------------------

def test_push_telemetry_cadence_and_the_rank_on_the_log():
    """The JAX cadence test on the port: pushes without an explicit call
    (and one at shutdown) reach the tracker's ``/metrics``; registration
    stamps ``rank=`` on the process's log records."""
    t = tracker.RabitTracker(num_workers=1, host_ip="127.0.0.1",
                             telemetry_port=0)
    t.start()
    try:
        before = metrics.counter("worker.work_done").value
        rc = rabit.RabitContext(t.host_ip, t.port, jobid="w0",
                                heartbeat_interval=0,
                                telemetry_interval=0.05)
        try:
            tlogging.log_info("after registration")
            assert tlogging.get_log_tail()[-1].endswith(
                "after registration [rank=0]")
            metrics.counter("worker.work_done").add(3)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                states = t.telemetry_states()
                if states.get("0", {}).get("worker.work_done", {}).get(
                        "value") == before + 3:
                    break
                time.sleep(0.02)
            assert states["0"]["worker.work_done"]["value"] == before + 3
        finally:
            rc.shutdown()
        code, _, body = scrape(t.telemetry.port, "/metrics")
        assert code == 200 and "dmlc_worker_work_done_total" in body
    finally:
        t.stop()


class _Capture:
    """The port logger's records, as its handler would format them."""

    def __init__(self):
        import logging
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(
            (rec.levelname, rec.getMessage()))

    def __enter__(self):
        tlogging._logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        tlogging._logger.removeHandler(self.handler)


def test_log_text_records_carry_the_rank_and_trace_id_as_jax():
    jgot, tids = [], {}
    jlogging.set_log_sink(lambda sev, msg: jgot.append((sev, msg)))
    try:
        with _Capture() as got:
            for mod, trace in ((tlogging, teltrace), (jlogging, jtrace)):
                mod.set_log_context(rank=3, host="h1")
                with trace.span("logged-op") as s:
                    mod.log_info("inside")
                mod.set_log_context(host=None)
                mod.log_info("outside")
                mod.set_log_context(rank=None)
                mod.log_info("bare")
                tids[mod] = trace.format_id(s.trace_id)
    finally:
        jlogging.set_log_sink(None)
    mine, theirs = tids[tlogging], tids[jlogging]
    assert [m.replace(mine, "T") for _, m in got] == \
        [m.replace(theirs, "T") for _, m in jgot] == [
            "inside [rank=3 host=h1 trace_id=T]", "outside [rank=3]",
            "bare"]
    assert tlogging.get_log_tail()[-3].endswith(
        f"INFO inside [rank=3 host=h1 trace_id={mine}]")


def test_log_json_records_carry_the_rank_and_trace_id_as_jax(monkeypatch):
    monkeypatch.setenv("DMLC_LOG_FORMAT", "json")
    jgot, tids = [], {}
    jlogging.set_log_sink(lambda sev, line: jgot.append((sev, line)))
    try:
        with _Capture() as got:
            for mod, trace in ((tlogging, teltrace), (jlogging, jtrace)):
                mod.set_log_context(rank=1)
                with trace.span("json-op") as s:
                    mod.log_warning("careful: %d", 42)
                tids[mod] = trace.format_id(s.trace_id)
    finally:
        jlogging.set_log_sink(None)
    (sev, line), = got
    (jsev, jline), = jgot
    rec, jrec = json.loads(line), json.loads(jline)
    assert sev == jsev == "WARNING"
    assert list(rec) == list(jrec) == ["ts", "level", "msg", "rank",
                                       "trace_id"]
    assert (rec["trace_id"], jrec["trace_id"]) == (tids[tlogging],
                                                   tids[jlogging])
    for r in (rec, jrec):
        r.pop("ts"), r.pop("trace_id")
    assert rec == jrec == {"level": "WARNING", "msg": "careful: 42",
                           "rank": 1}
    assert tlogging.get_log_tail()[-1] == line


def test_dmlc_rank_seeds_the_context_at_import():
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c",
         "from dmlc_core_tpu_torch.utils import logging as l; "
         "l.log_info('hi'); print(l.get_log_tail()[-1])"],
        env={**os.environ, "DMLC_RANK": "4", "PYTHONPATH": repo},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("INFO hi [rank=4]")


# ---------------------------------------------------------------------------
# the connect retry
# ---------------------------------------------------------------------------

def test_a_tracker_connect_that_timed_out_is_made_again(monkeypatch):
    """The first connect goes to a listener whose queue is full (it never
    accepts): it times out after ``DMLC_IO_CONNECT_TIMEOUT``, and the next
    try reaches the tracker.  A refused connect raises at once."""
    monkeypatch.setenv("DMLC_IO_CONNECT_TIMEOUT", "0.3")
    hole = socket.socket()
    hole.bind(("127.0.0.1", 0))
    hole.listen(0)
    filler = socket.create_connection(hole.getsockname(), timeout=2)
    real = socket.create_connection
    tries = []

    def dial(addr, timeout=None, *a, **kw):
        tries.append(timeout)
        if len(tries) == 1:
            return real(hole.getsockname(), timeout, *a, **kw)
        return real(addr, timeout, *a, **kw)

    t = tracker.RabitTracker(num_workers=1, host_ip="127.0.0.1")
    t.start()
    retries = metrics.counter("retry.rabit.connect.retries").value
    try:
        monkeypatch.setattr(rabit.socket, "create_connection", dial)
        t0 = time.monotonic()
        ctx = rabit.RabitContext("127.0.0.1", t.port, jobid="w0",
                                 heartbeat_interval=0, connect_links=False)
        assert ctx.rank == 0 and ctx.world_size == 1
        assert time.monotonic() - t0 >= 0.3
        assert tries[:2] == [0.3, 0.3]
        assert metrics.counter("retry.rabit.connect.retries").value \
            == retries + 1
        monkeypatch.setattr(rabit.socket, "create_connection", real)
        ctx.shutdown()
        gone = socket.socket()
        gone.bind(("127.0.0.1", 0))
        port = gone.getsockname()[1]
        gone.close()
        t0 = time.monotonic()
        with pytest.raises(ConnectionRefusedError):
            rabit._connect(("127.0.0.1", port), 10.0)
        assert time.monotonic() - t0 < 0.3
        assert metrics.counter("retry.rabit.connect.retries").value \
            == retries + 1
    finally:
        filler.close()
        hole.close()
        t.stop()


# ---------------------------------------------------------------------------
# the slice: a tracker-bootstrapped dp cohort
# ---------------------------------------------------------------------------

def test_data_parallel_mesh_takes_make_mesh_arguments():
    with pytest.raises(DMLCError, match="NCCL runs on CUDA"):
        data_parallel_mesh(device="cpu", backend="nccl")


@pytest.fixture(scope="module")
def tracker_cohort(tmp_path_factory):
    from test_torch_dp_train import CASES, D, F, L, LR, STEPS, _batch, _flat
    from test_torch_dp_train import _init
    from torch_dp_worker import run_cohort
    world = 2
    case = dict(CASES["fm_flat"], kbatch=False, eval=False, name="fm_flat",
                F=F, D=D, L=L, lr=LR, steps=STEPS)
    arrays = {f"fm_flat/init/{k}": v for k, v in _flat(_init(case))}
    for r in range(world):
        for s in range(STEPS):
            for k, v in _batch("flat", 10 * s + r).items():
                arrays[f"fm_flat/r{r}/s{s}/{k}"] = v
    d = tmp_path_factory.mktemp("tracker_cohort")
    np.savez(d / "in.npz", **arrays)
    ranks = run_cohort(d, world, "train,rabit", launcher="tracker",
                       inputs=str(d / "in.npz"), cases=[case])
    return case, arrays, ranks


def test_tracker_cohort_matches_jax_on_the_union_batch(tracker_cohort):
    from test_torch_dp_train import PARAMS, TRAJ, _steps_batches, jax_train
    case, arrays, ranks = tracker_cohort
    from test_torch_dp_train import _init
    want, jlosses = jax_train(case, _init(case),
                              _steps_batches(arrays, "fm_flat", 2), 2)
    for out in ranks:
        np.testing.assert_allclose(out["fm_flat/losses"], jlosses, **TRAJ)
        for k, v in want.items():
            np.testing.assert_allclose(out[f"fm_flat/params/{k}"], v,
                                       err_msg=k, **PARAMS)
    assert [int(o["rabit_rank"]) for o in ranks] == [0, 1]
    assert [int(o["rank"]) for o in ranks] == [0, 1]
    assert all(int(o["rabit_world"]) == 2 for o in ranks)
    for out in ranks:
        assert json.loads(str(out["shape"])) == dict(
            jmesh.data_parallel_mesh(jax.devices()[:2]).shape)


def test_tracker_cohort_sums_agree_over_rabit_the_mesh_and_jax(
        tracker_cohort):
    from test_torch_dp_train import _init, _steps_batches, jax_train
    from dmlc_core_tpu.models import sparse as jsparse
    case, arrays, ranks = tracker_cohort
    params, _ = jax_train(case, _init(case),
                          _steps_batches(arrays, "fm_flat", 2), 2)
    model = jsparse.FactorizationMachine(case["F"], case["D"],
                                         l2=case["l2"])
    forward = jax.jit(model.forward)
    params = {k: jax.numpy.asarray(v) for k, v in params.items()}
    loss = wsum = 0.0
    for b in _steps_batches(arrays, "fm_flat", 2):
        z = np.asarray(forward(params, {k: jax.numpy.asarray(v)
                                        for k, v in b.items()}),
                       np.float64)
        y = (b["labels"] > 0).astype(np.float64)
        w = b["weights"].astype(np.float64)
        per = np.logaddexp(0.0, -z) * y + np.logaddexp(0.0, z) * (1 - y)
        loss += float((per * w).sum())
        wsum += float(w.sum())
    for out in ranks:
        got = out["fm_flat/rabit_sums"]
        np.testing.assert_allclose(got, out["fm_flat/mesh_sums"],
                                   rtol=1e-12)
        np.testing.assert_array_equal(got, ranks[0]["fm_flat/rabit_sums"])
        np.testing.assert_allclose(got[0], loss, rtol=1e-4)
        assert got[1:].tolist() == [wsum, 2.0 * case["steps"]]


def test_tracker_cohort_digests_agree(tracker_cohort):
    _, _, ranks = tracker_cohort
    for out in ranks:
        digests = out["fm_flat/digests"]
        assert digests.shape == (2, 3)
        np.testing.assert_array_equal(digests[0], digests[1])
        np.testing.assert_array_equal(out["fm_flat/root_digest"],
                                      digests[0])
