"""The port's rendezvous tracker (``parallel/tracker.py``) held against the
JAX package's.

* Topology: ``compute_tree``, ``compute_ring`` and ``tree_parent`` are
  equal for every world from 1 to 64.
* Replies: for the same scripted registrations (each with an explicit
  host and port) both trackers give equal assignment dicts, equal
  replies to a ``recover`` and equal error replies.
* Replay: ``replay_tracker_state`` is equal to the JAX function on every
  prefix of generated logs (hypothesis), with and without a snapshot.
* Journals: a tracker of either package restores the journal the other
  wrote (compacted or not), with the same workers, ranks and generation,
  and re-admits a worker from its unchanged address at that generation.
* Liveness: ``LivenessBoard`` and ``jittered`` behave as the JAX ones; a
  silent worker is declared dead once and the survivor gets the
  ``reset_links`` push (from either package's tracker).
* Telemetry: the merged ``/metrics`` sample lines (the merged totals and
  the ``rank=`` series, leaving out the trackers' own registries, which
  differ by package) and the ``/stragglers`` documents are equal to the
  JAX tracker's for the same pushes (three ranks listed, the slow one
  flagged; two ranks judge no stage, as the board's ``min_ranks`` is 3);
  ``/timeline`` has points and ``/diagnose`` answers over the merged
  stores.
* The SIGKILL drill against ``python -m
  dmlc_core_tpu_torch.parallel.tracker`` (JAX
  ``tests/test_control_ha.py``'s), restarted by either package's CLI, and
  SIGTERM's clean stop with a compacted journal.
* ``PSTracker``'s environment and scheduler spawn.

Every comparison is exact.  Metric counters are compared as deltas (the
registries are process-wide), every tracker and listener binds port 0
on 127.0.0.1, and every tracker started is stopped.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.parallel import tracker as jtracker  # noqa: E402
from dmlc_core_tpu.utils.metrics import MetricsRegistry  # noqa: E402
from dmlc_core_tpu.utils.metrics import metrics as jmetrics  # noqa: E402
from dmlc_core_tpu_torch.parallel import tracker  # noqa: E402
from dmlc_core_tpu_torch.parallel.rabit import RabitContext  # noqa: E402
from dmlc_core_tpu_torch.utils import logging as tlogging  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402
from test_torch_exposition import history, scrape  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": tracker, "jax": jtracker}


@pytest.fixture(autouse=True)
def _log_context():
    """A context's registration stamps ``rank`` on the process's log
    context, which later tests in this process would see: put it back."""
    yield
    tlogging.set_log_context(rank=None)


def _cmd(addr, msg, timeout=30.0):
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        tracker.send_json(s, msg)
        return tracker.recv_json(s.makefile("r"))


def _listeners(n):
    """Real listening sockets, so that a reset notify connects."""
    out = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(8)
        out.append(s)
    return out


def _register_all(addr, workers, cmd="start"):
    """Register ``[(jobid, host, port)]`` at once (a start blocks until
    the cohort is whole): ``{jobid: reply}``."""
    replies = {}

    def one(jobid, host, port):
        replies[jobid] = _cmd(addr, {"cmd": cmd, "jobid": jobid,
                                     "host": host, "port": port})

    ts = [threading.Thread(target=one, args=w) for w in workers]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
        assert not t.is_alive(), "rendezvous wedged"
    return replies


# ---------------------------------------------------------------------------
# topology and replies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", range(1, 65))
def test_topology_equals_the_jax_trackers(world):
    assert tracker.compute_tree(world) == jtracker.compute_tree(world)
    assert tracker.compute_ring(world) == jtracker.compute_ring(world)
    assert [tracker.tree_parent(r) for r in range(world)] == \
        [jtracker.tree_parent(r) for r in range(world)]


#: cohorts of (jobid, host): task "10" sorts before task "2" (strings),
#: and hosts order ranks before job ids
COHORTS = {
    "one": [("0", "127.0.0.1")],
    "two": [("1", "127.0.0.1"), ("0", "127.0.0.1")],
    "string_order": [("2", "127.0.0.1"), ("10", "127.0.0.1"),
                     ("1", "127.0.0.1")],
    "hosts": [("a", "10.0.0.2"), ("b", "10.0.0.1"), ("c", "10.0.0.2"),
              ("d", "10.0.0.1"), ("e", "10.0.0.3")],
    "eight": [(f"w{i}", "127.0.0.1") for i in range(8)],
}


def _replies(mod, cohort, extra):
    """Every reply of one tracker: the cohort's starts, a recover from an
    unchanged address, a start beyond the cohort, an unknown command."""
    t = mod.RabitTracker(num_workers=len(cohort), host_ip="127.0.0.1")
    t.start()
    try:
        addr = ("127.0.0.1", t.port)
        workers = [(j, h, 40000 + i) for i, (j, h) in enumerate(cohort)]
        out = _register_all(addr, workers)
        j, h, p = workers[-1]
        out["recover"] = _cmd(addr, {"cmd": "recover", "jobid": j,
                                     "host": h, "port": p})
        out["extra"] = _cmd(addr, {"cmd": "start", "jobid": extra,
                                   "host": "127.0.0.1", "port": 1})
        out["unknown"] = _cmd(addr, {"cmd": "bogus"})
        out["envs"] = {k: (v if k != "DMLC_TRACKER_PORT" else "")
                       for k, v in t.worker_envs().items()}
        return out
    finally:
        t.stop()


@pytest.mark.parametrize("name", sorted(COHORTS))
def test_assignment_replies_equal_the_jax_trackers(name):
    cohort = COHORTS[name]
    got = _replies(tracker, cohort, "zz")
    want = _replies(jtracker, cohort, "zz")
    assert got == want
    ranks = [got[j]["rank"] for j, _ in sorted(cohort,
                                                key=lambda w: (w[1], w[0]))]
    assert ranks == list(range(len(cohort)))
    assert got["recover"]["generation"] == 0
    assert "error" in got["extra"] and "error" in got["unknown"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_moved_worker_bumps_the_generation_and_resets_the_others(pkg):
    """A recover from a new address keeps the rank, bumps the generation
    and pushes ``reset_links`` (``-2``, then one JSON line) to every
    other worker's listener, the same from both trackers."""
    t = PACKAGES[pkg].RabitTracker(num_workers=2, host_ip="127.0.0.1")
    t.start()
    peers = _listeners(3)
    try:
        addr = ("127.0.0.1", t.port)
        p1, p2, p3 = (s.getsockname()[1] for s in peers)
        first = _register_all(addr, [("w1", "127.0.0.1", p1),
                                     ("w2", "127.0.0.1", p2)])
        r = _cmd(addr, {"cmd": "recover", "jobid": "w2",
                        "host": "127.0.0.1", "port": p3})
        assert r["rank"] == first["w2"]["rank"] and r["generation"] == 1
        assert r["addresses"] == {str(first["w1"]["rank"]):
                                  ["127.0.0.1", p1]}
        peers[0].settimeout(10.0)
        conn, _ = peers[0].accept()
        with conn:
            conn.settimeout(10.0)
            f = conn.makefile("rb")
            assert f.read(8) == (-2).to_bytes(8, "little", signed=True)
            reset = json.loads(f.readline())
        assert reset == {"cmd": "reset_links", "generation": 1,
                         "addresses": {str(first["w1"]["rank"]):
                                       ["127.0.0.1", p1],
                                       str(r["rank"]): ["127.0.0.1", p3]}}
    finally:
        for s in peers:
            s.close()
        t.stop()


def test_join_times_out_and_the_envs_name_the_tracker():
    t = tracker.RabitTracker(num_workers=2, host_ip="127.0.0.1")
    t.start()
    try:
        assert t.worker_envs() == {"DMLC_TRACKER_URI": "127.0.0.1",
                                   "DMLC_TRACKER_PORT": str(t.port),
                                   "DMLC_NUM_WORKER": "2"}
        with pytest.raises(DMLCError, match="timed out"):
            t.join(timeout=0.2)
    finally:
        t.stop()


# ---------------------------------------------------------------------------
# replay and journals
# ---------------------------------------------------------------------------

JOBS = st.sampled_from(["a", "b", "c", "10", "2"])
RECORDS = st.lists(st.one_of(
    st.fixed_dictionaries({
        "op": st.just("worker"), "jobid": JOBS,
        "host": st.sampled_from(["127.0.0.1", "10.0.0.1", None]),
        "port": st.one_of(st.integers(0, 65535), st.none()),
        "rank": st.integers(-1, 5)}),
    st.fixed_dictionaries({
        "op": st.just("assign"),
        "ranks": st.dictionaries(JOBS, st.integers(0, 5), max_size=4)}),
    st.fixed_dictionaries({"op": st.just("generation"),
                           "generation": st.integers(0, 9)}),
    st.fixed_dictionaries({"op": st.sampled_from(["other", "x"])})),
    max_size=14)
SNAPSHOTS = st.one_of(st.none(), st.fixed_dictionaries({
    "schema": st.just(tracker.TRACKER_SNAP_SCHEMA),
    "workers": st.dictionaries(JOBS, st.fixed_dictionaries({
        "host": st.just("127.0.0.1"), "port": st.integers(1, 9),
        "rank": st.integers(-1, 4)}), max_size=3),
    "generation": st.integers(0, 4)}))


@settings(max_examples=120, deadline=None, database=None)
@given(snap=SNAPSHOTS, records=RECORDS)
def test_replay_equals_the_jax_replay_on_every_prefix(snap, records):
    assert tracker.TRACKER_SNAP_SCHEMA == jtracker.TRACKER_SNAP_SCHEMA
    for n in range(len(records) + 1):
        assert tracker.replay_tracker_state(snap, records[:n]) == \
            jtracker.replay_tracker_state(snap, records[:n])


def _durable(t):
    return ({j: (r.host, r.port, r.rank) for j, r in t._workers.items()},
            dict(t._rank_of), t._generation, t._assigned)


@pytest.mark.parametrize("compacted", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_tracker_restores_the_others_journal(tmp_path, writer,
                                                  compacted):
    """The writer assigns a cohort of three and re-admits a moved worker
    (generation 1); the reader restores its journal, killed (the log as
    written) or stopped (one snapshot, an empty log), to the same state,
    and re-admits a worker from its unchanged address at generation 1
    with no reset."""
    wmod = PACKAGES[writer]
    rmod = PACKAGES["port" if writer == "jax" else "jax"]
    rreg = metrics if rmod is tracker else jmetrics
    journal = str(tmp_path / "trk" / "tracker")
    peers = _listeners(4)
    ports = [s.getsockname()[1] for s in peers]
    w = wmod.RabitTracker(num_workers=3, host_ip="127.0.0.1",
                          journal=journal)
    w.start()
    try:
        first = _register_all(("127.0.0.1", w.port),
                              [(f"w{i}", "127.0.0.1", ports[i])
                               for i in range(3)])
        r = _cmd(("127.0.0.1", w.port), {"cmd": "recover", "jobid": "w2",
                                          "host": "127.0.0.1",
                                          "port": ports[3]})
        assert r["generation"] == 1
        want = _durable(w)
        if compacted:
            w.stop()
        else:                      # as a SIGKILL leaves it: no compaction
            w._stop = True
            w._sock.shutdown(socket.SHUT_RDWR)
            w._sock.close()
            w._journal.close()
        replayed = rreg.counter("tracker.journal.replayed").value
        back = rmod.RabitTracker(num_workers=3, host_ip="127.0.0.1",
                                 journal=journal)
        try:
            assert _durable(back) == want
            assert rreg.counter("tracker.journal.replayed").value \
                - replayed == (0 if compacted else 6)
            back.start()
            again = _cmd(("127.0.0.1", back.port), {
                "cmd": "recover", "jobid": "w0", "host": "127.0.0.1",
                "port": ports[0]})
            assert again["rank"] == first["w0"]["rank"]
            assert again["generation"] == 1
        finally:
            back.stop()
    finally:
        for s in peers:
            s.close()


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def test_liveness_board_follows_the_jax_rules():
    got, want = tracker.LivenessBoard(0.05), jtracker.LivenessBoard(0.05)
    log = {"port": [], "jax": []}
    for name, b in (("port", got), ("jax", want)):
        out = log[name]
        out.append([b.beat("a"), b.beat("b"), b.beat("c")])
        b.forget("c")
        time.sleep(0.12)
        out.append(sorted(m for m, _ in b.sweep(eligible=lambda m: m != "b")))
        out.append(sorted(m for m, _ in b.sweep()))
        out.append(sorted(m for m, _ in b.sweep()))      # once each
        out.append([b.is_dead("a"), b.is_dead("c"), sorted(b.dead_members())])
        out.append([b.beat("a"), b.is_dead("a"), sorted(b.dead_members())])
        b.forget("b")
        out.append(sorted(b.dead_members()))
    assert log["port"] == log["jax"]
    assert log["port"][1:4] == [["a"], ["b"], []]


@pytest.mark.parametrize("jitter", ["0", "0.2", "5"])
def test_jittered_draws_as_the_jax_function(monkeypatch, jitter):
    import random
    monkeypatch.setenv("DMLC_HEARTBEAT_JITTER", jitter)
    for interval in (0.0, 0.25, 5.0):
        random.seed(11)
        got = [tracker.jittered(interval) for _ in range(20)]
        random.seed(11)
        want = [jtracker.jittered(interval) for _ in range(20)]
        assert got == want
        frac = min(float(jitter), 0.9)
        assert all(interval * (1 - frac) - 1e-12 <= x
                   <= interval * (1 + frac) + 1e-12 or x == 0.001
                   for x in got)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_silent_worker_is_declared_dead_and_the_survivor_reset(pkg):
    """The JAX liveness test on the port's contexts, under either
    package's tracker: the counter (of that tracker's package) moves by
    one and the survivor's target generation reaches 1."""
    reg = metrics if pkg == "port" else jmetrics
    dead0 = reg.counter("tracker.dead_workers").value
    t = PACKAGES[pkg].RabitTracker(num_workers=2, host_ip="127.0.0.1",
                                   heartbeat_timeout_s=0.6)
    t.start()
    ctxs, errors = {}, []

    def worker(i):
        try:
            ctxs[i] = RabitContext("127.0.0.1", t.port, jobid=f"w{i}",
                                   heartbeat_interval=0.1)
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors, errors
    survivor = ctxs[0] if ctxs[1].rank != 0 else ctxs[1]
    silent = ctxs[1] if survivor is ctxs[0] else ctxs[0]
    try:
        silent._hb_stop.set()
        give_up = time.monotonic() + 10
        while time.monotonic() < give_up:
            if (reg.counter("tracker.dead_workers").value > dead0
                    and survivor._target_gen >= 1):
                break
            time.sleep(0.05)
        assert reg.counter("tracker.dead_workers").value == dead0 + 1
        assert survivor._target_gen >= 1
    finally:
        for c in ctxs.values():
            c.shutdown()
        t.stop()


# ---------------------------------------------------------------------------
# fleet telemetry
# ---------------------------------------------------------------------------

def _state(rank: int, lat_base: float) -> dict:
    reg = MetricsRegistry()
    reg.counter("reqs").add(5 + rank * 2)
    reg.counter("device_loader.batches").add(8 * (rank + 1))
    reg.gauge("queue").set(3 + rank)
    h = reg.histogram("lat_s")
    for i in range(100):
        h.observe(lat_base + i * 0.001)
    state = reg.state()
    # a stage timer, rank 2 ten times slower than the others
    mean = 0.001 * (10 if rank == 2 else 1)
    state["device_loader.pack"] = {"type": "stage", "count": 10,
                                   "total_sec": 10 * mean, "mean_sec": mean}
    return state


def _push(t, rank, state):
    with socket.create_connection(("127.0.0.1", t.port), timeout=5) as s:
        tracker.send_json(s, {"cmd": "telemetry", "jobid": f"j{rank}",
                              "rank": rank, "state": state})


def _fleet_lines(t) -> list:
    code, _, body = scrape(t.telemetry.port, "/metrics")
    assert code == 200
    return sorted(ln for ln in body.splitlines()
                  if ln and not ln.startswith("#")
                  and 'rank="tracker"' not in ln)


def _pushed(t, n: int) -> None:
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and len(t.telemetry_states()) < n:
        time.sleep(0.02)
    assert len(t.telemetry_states()) == n


@pytest.mark.parametrize("ranks", [2, 3])
def test_merged_metrics_and_stragglers_equal_the_jax_trackers(ranks):
    """The same pushes give the same merged sample lines and the same
    ``/stragglers`` document.  The board judges a stage reported by at
    least ``min_ranks`` (3) ranks: two ranks give no stage, three list
    every rank, the slow one flagged."""
    pages, boards = {}, {}
    for name, mod in PACKAGES.items():
        t = mod.RabitTracker(num_workers=ranks, host_ip="127.0.0.1",
                             telemetry_port=0)
        t.start()
        try:
            for rank in range(ranks):
                _push(t, rank, _state(rank, 0.1 + 0.4 * rank))
            _pushed(t, ranks)
            pages[name] = _fleet_lines(t)
            code, _, body = scrape(t.telemetry.port, "/stragglers")
            assert code == 200
            boards[name] = json.loads(body)
        finally:
            t.stop()
    assert pages["port"] == pages["jax"]
    assert boards["port"] == boards["jax"]
    lines = pages["port"]
    assert f"dmlc_reqs_total {sum(5 + 2 * r for r in range(ranks))}" \
        in lines
    for r in range(ranks):
        assert f'dmlc_reqs_total{{rank="{r}"}} {5 + 2 * r}' in lines
    p99 = next(float(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith('dmlc_lat_s{quantile="0.99"}'))
    assert 0.1 + 0.4 * (ranks - 1) < p99 < 0.2 + 0.4 * (ranks - 1)
    board = boards["port"]
    assert board["min_ranks"] == 3
    if ranks < 3:
        assert board["stages"] == {} and board["stragglers"] == []
    else:
        assert set(board["stages"]["device_loader.pack"]) == {"0", "1", "2"}
        assert board["stragglers"] == ["2"]
        assert 'dmlc_straggler_suspect{rank="2"} 1' in lines


def test_timeline_and_diagnose_on_the_tracker(monkeypatch):
    """The tracker's history samples the merged view (``/timeline`` gets
    points of a pushed counter) and ``/diagnose`` answers over the
    merged stores with the JAX document's schema."""
    monkeypatch.setenv("DMLC_TIMELINE_INTERVAL", "0.05")
    t = tracker.RabitTracker(num_workers=2, host_ip="127.0.0.1",
                             telemetry_port=0)
    t.start()
    try:
        for rank in range(2):
            _push(t, rank, _state(rank, 0.1))
        _pushed(t, 2)
        deadline = time.monotonic() + 10.0
        points = 0
        while time.monotonic() < deadline and not points:
            code, _, body = scrape(t.telemetry.port,
                                   "/timeline?metric=reqs")
            assert code == 200
            points = sum(len(tier["points"])
                         for s in json.loads(body)["series"].values()
                         for tier in s["tiers"])
            time.sleep(0.05)
        assert points > 0
        code, _, body = scrape(t.telemetry.port, "/diagnose?since=60")
        assert code == 200
        assert json.loads(body)["schema"] == "dmlc.diagnosis/1"
    finally:
        t.stop()


# ---------------------------------------------------------------------------
# the SIGKILL drill and the CLI
# ---------------------------------------------------------------------------

def _spawn(module, **kw):
    """``python -m module k=v ...``: the process and its bound address."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module] + [f"{k}={v}" for k, v in kw.items()],
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    line = proc.stdout.readline()
    assert line, f"{module} died before binding"
    doc = json.loads(line)
    return proc, (str(doc["host"]), int(doc["port"]))


PORT_CLI = "dmlc_core_tpu_torch.parallel.tracker"
CLIS = {"port": PORT_CLI, "jax": "dmlc_core_tpu.parallel.tracker"}


@pytest.mark.parametrize("restart", sorted(CLIS))
def test_tracker_sigkilled_mid_epoch_readmits_the_cohort(tmp_path, restart):
    """JAX ``tests/test_control_ha.py``'s drill against the port's CLI,
    restarted by either package's: both workers back at their ranks and
    generation 0, a moved worker bumping it to 1; then SIGTERM stops the
    restarted tracker with exit 0 and a compacted journal."""
    journal = str(tmp_path / "trk" / "tracker")
    proc, addr = _spawn(PORT_CLI, port=0, workers=2, journal=journal)
    peers = _listeners(3)
    p1, p2, p3 = (s.getsockname()[1] for s in peers)
    try:
        first = _register_all(addr, [("w1", "127.0.0.1", p1),
                                     ("w2", "127.0.0.1", p2)])
        ranks = {j: first[j]["rank"] for j in ("w1", "w2")}
        assert sorted(ranks.values()) == [0, 1]
        assert all(first[j]["generation"] == 0 for j in ranks)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        proc, addr2 = _spawn(CLIS[restart], port=addr[1], workers=2,
                             journal=journal)
        assert addr2 == addr
        for jobid, wport in (("w1", p1), ("w2", p2)):
            r = _cmd(addr, {"cmd": "recover", "jobid": jobid,
                            "host": "127.0.0.1", "port": wport})
            assert r["rank"] == ranks[jobid] and r["generation"] == 0
        r = _cmd(addr, {"cmd": "recover", "jobid": "w2",
                        "host": "127.0.0.1", "port": p3})
        assert r["rank"] == ranks["w2"] and r["generation"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        with open(journal + ".snap") as f:
            snap = json.load(f)
        assert snap["schema"] == tracker.TRACKER_SNAP_SCHEMA
        assert snap["generation"] == 1
        assert {j: w["rank"] for j, w in snap["workers"].items()} == ranks
        assert os.path.getsize(journal + ".log") == 0
    finally:
        for s in peers:
            s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_pstracker_env_and_scheduler_spawn():
    """The JAX test on the port's class: the scheduler gets
    ``DMLC_ROLE=scheduler`` and the root's address; without a command
    nothing is spawned."""
    t = tracker.PSTracker(
        host_ip="127.0.0.1", port=0,
        pscmd=[sys.executable, "-c",
               "import os; "
               "assert os.environ['DMLC_ROLE']=='scheduler'; "
               "assert os.environ['DMLC_PS_ROOT_URI']=='127.0.0.1'; "
               "assert int(os.environ['DMLC_PS_ROOT_PORT'])>0; "
               "assert os.environ['EXTRA']=='1'"],
        extra_env={"EXTRA": "1"})
    env = t.worker_envs()
    assert env == {"DMLC_PS_ROOT_URI": "127.0.0.1",
                   "DMLC_PS_ROOT_PORT": str(t.port)}
    t.start()
    assert t.join() == 0
    t.stop()
    idle = tracker.PSTracker(host_ip="127.0.0.1", port=0)
    jidle = jtracker.PSTracker(host_ip="127.0.0.1", port=0)
    assert sorted(idle.worker_envs()) == sorted(jidle.worker_envs())
    jidle.stop()
    idle.start()
    assert idle.join() == 0
    idle.stop()
