"""Rendezvous tracker: rank assignment, the allreduce topology, restart
recovery, liveness and fleet telemetry: the control plane of
``dmlc-submit``'s rabit tracker.

Counterpart of ``dmlc_core_tpu/parallel/tracker.py``, with the same
JSON-line protocol and the same replies, so that either package's
:class:`~dmlc_core_tpu_torch.parallel.rabit.RabitContext` registers with
either package's tracker:

* every worker registers ``{"cmd": "start", "jobid", "port"}`` (and
  optionally ``"host"``); once the cohort is whole, ranks are assigned
  by ``(host, jobid)`` sorted as strings, and each worker gets its rank,
  its binary-tree parent and children, its neighbours on the DFS ring
  over the tree and their addresses, and the link generation;
* ``recover`` re-registers a restarted worker: it keeps its rank, and
  only a worker whose address moved bumps the generation and pushes
  ``reset_links`` to every survivor's peer listener (a ``-2`` handshake,
  then one JSON line);
* ``heartbeat`` feeds the liveness board; a worker silent past
  ``heartbeat_timeout_s`` is declared dead once (``tracker.dead_workers``)
  and the survivors get the same ``reset_links`` push;
* ``telemetry`` carries a rank-tagged registry state; the merged view is
  served on ``DMLC_TRACKER_METRICS_PORT`` (``/metrics`` with ``rank=``
  drill-down series, ``/stragglers``, ``/timeline`` and ``/diagnose``
  over the merged stores);
* ``print`` relays a worker's line to the tracker's log; ``shutdown``
  counts a worker out (:meth:`RabitTracker.join`).

With ``journal=`` (or ``DMLC_TRACKER_JOURNAL``) the tracker write-ahead
journals worker addresses, rank assignments and the link generation
through :class:`~dmlc_core_tpu_torch.utils.durable.StateJournal`
(``tracker.journal.appends``, ``.snapshots``, ``.replayed``).  A tracker
killed and restarted on the same port and journal re-admits the live
cohort: a ``recover`` from an unchanged address gets the old rank at the
current generation, with no reset, since the workers' links were never
broken.  The files are the JAX package's, so each package replays the
other's journal.  ``python -m dmlc_core_tpu_torch.parallel.tracker``
runs one (:func:`tracker_main`).
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.aggregate import ResetGuard, merge_states, render_fleet
from ..telemetry.anomaly import StragglerBoard
from ..telemetry.diagnose import DiagnosisEngine
from ..telemetry.exposition import TelemetryServer
from ..telemetry.timeseries import HistoryStore
from ..transport.frames import send_all
from ..utils.durable import StateJournal
from ..utils.logging import DMLCError, log_info, log_warning
from ..utils.metrics import metrics
from ..utils.parameter import get_env

__all__ = ["RabitTracker", "PSTracker", "LivenessBoard", "compute_tree",
           "compute_ring", "tree_parent", "recv_json", "send_json",
           "jittered", "replay_tracker_state", "tracker_main",
           "TRACKER_SNAP_SCHEMA"]

TRACKER_SNAP_SCHEMA = "dmlc.tracker.snapshot/1"


def replay_tracker_state(snapshot: Optional[Dict[str, Any]],
                         records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure replay of tracker journal ``records`` over ``snapshot`` (or
    a blank state); any prefix of a valid log replays without error.

    State shape: ``{"workers": {jobid: {"host", "port", "rank"}},
    "generation": int}``.
    """
    state: Dict[str, Any] = {"workers": {}, "generation": 0}
    if snapshot:
        w = snapshot.get("workers")
        if isinstance(w, dict):
            state["workers"] = json.loads(json.dumps(w))
        state["generation"] = int(snapshot.get("generation", 0))
    for rec in records:
        op = rec.get("op")
        if op == "worker":
            state["workers"][str(rec["jobid"])] = {
                "host": rec.get("host"), "port": rec.get("port"),
                "rank": int(rec.get("rank", -1))}
        elif op == "assign":
            for jobid, rank in (rec.get("ranks") or {}).items():
                w = state["workers"].get(str(jobid))
                if w is not None:
                    w["rank"] = int(rank)
        elif op == "generation":
            state["generation"] = max(state["generation"],
                                      int(rec.get("generation", 0)))
    return state


def jittered(interval_s: float) -> float:
    """``interval_s`` ± ``DMLC_HEARTBEAT_JITTER`` (default 0.2 = ±20%),
    uniformly drawn per call.  Every periodic re-registration loop
    (data-service workers, serving replica agents) sleeps through this:
    a restarted control plane then sees beats *spread over* the interval
    instead of a thundering herd synchronized by the restart itself."""
    frac = float(get_env("DMLC_HEARTBEAT_JITTER", 0.2))
    if frac <= 0.0 or interval_s <= 0.0:
        return interval_s
    frac = min(frac, 0.9)
    spread = random.uniform(-frac, frac)
    return max(0.001, interval_s * (1.0 + spread))


# ---------------- topology math ----------------

def compute_tree(world: int) -> Dict[int, List[int]]:
    """Binary-tree neighbor map {rank: [neighbors]} (reference ``get_tree``
    `tracker.py:185`: parent (r-1)//2, children 2r+1 / 2r+2)."""
    nbrs: Dict[int, List[int]] = {r: [] for r in range(world)}
    for r in range(1, world):
        parent = (r - 1) // 2
        nbrs[parent].append(r)
        nbrs[r].append(parent)
    return nbrs


def tree_parent(rank: int) -> int:
    return (rank - 1) // 2 if rank > 0 else -1


def compute_ring(world: int) -> List[int]:
    """DFS pre-order ring over the binary tree (reference ``find_share_ring``
    `tracker.py:193-210`): consecutive ring hops share a tree edge, so
    recovery traffic rides existing links."""
    order: List[int] = []

    def dfs(r: int) -> None:
        if r >= world:
            return
        order.append(r)
        dfs(2 * r + 1)
        dfs(2 * r + 2)

    dfs(0)
    return order


# ---------------- wire helpers (JSON-line protocol) ----------------

def send_json(sock: socket.socket, obj: dict) -> None:
    data = (json.dumps(obj) + "\n").encode()
    send_all(sock, data)


def recv_json(sock_file) -> Optional[dict]:
    line = sock_file.readline()
    if not line:
        return None
    return json.loads(line)


# ---------------- liveness ----------------

class LivenessBoard:
    """Heartbeat table + death sweep — the liveness half of the tracker,
    factored out so every control-plane server speaking the JSON-line
    protocol (this tracker; in the JAX package also the data-service
    dispatcher) runs the same rules: a member is registered by its first beat, declared dead
    exactly once when silent past the timeout, and revived by any later
    beat.  Metric emission stays at the caller (each server counts its
    own dead under its own literal name).

    Owns its own lock; callers holding a coarser server lock may nest
    board calls inside it (server lock → board lock, one direction only).
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}
        self._dead: set = set()

    def beat(self, member: str) -> bool:
        """Record a heartbeat (first beat registers the member); True when
        this beat revived a member previously declared dead — the caller
        decides what a misdiagnosed slow-but-alive member means."""
        with self._lock:
            self._last[member] = time.monotonic()
            if member in self._dead:
                self._dead.discard(member)
                return True
            return False

    def forget(self, member: str) -> None:
        """Stop tracking a cleanly-departing member: it stops beating by
        design and must never be declared dead afterwards."""
        with self._lock:
            self._last.pop(member, None)
            self._dead.discard(member)

    def is_dead(self, member: str) -> bool:
        with self._lock:
            return member in self._dead

    def dead_members(self) -> set:
        with self._lock:
            return set(self._dead)

    def sweep(self, eligible=None) -> List[Tuple[str, float]]:
        """Declare members silent past the timeout dead, once each, and
        return them as ``[(member, silence_seconds)]``.  ``eligible``
        optionally filters who may be declared (the tracker excludes
        pre-assignment registrants and completed cohorts)."""
        now = time.monotonic()
        newly: List[Tuple[str, float]] = []
        with self._lock:
            for member, t in self._last.items():
                if member in self._dead or now - t <= self.timeout_s:
                    continue
                if eligible is not None and not eligible(member):
                    continue
                self._dead.add(member)
                newly.append((member, now - t))
        return newly


# ---------------- tracker ----------------

class _WorkerRecord:
    def __init__(self, jobid: str, host: str, port: int):
        self.jobid = jobid
        self.host = host
        self.port = port
        self.rank = -1


class RabitTracker:
    """TCP rendezvous service (the reference's ``RabitTracker``).

    >>> t = RabitTracker(num_workers=4); t.start()
    >>> env = t.worker_envs()   # DMLC_TRACKER_URI/PORT for workers
    >>> t.join()                 # until all workers shut down
    """

    #: journal-before-mutate contract (dmlclint ``durable-state``)
    _DURABLE_STATE = ("_workers", "_rank_of", "_generation")
    _DURABLE_FIELDS = ("rank", "host", "port")

    def __init__(self, num_workers: int, host_ip: Optional[str] = None,
                 port: int = 0, max_port: int = 9999,
                 heartbeat_timeout_s: Optional[float] = None,
                 telemetry_port: Optional[int] = None,
                 journal: Optional[str] = None):
        self.num_workers = num_workers
        self.host_ip = host_ip or _default_host_ip()
        # dead-worker detection: workers beat (cmd=heartbeat) and a monitor
        # declares silence beyond the timeout a death — survivors get the
        # same reset_links push a recover registration triggers, so they
        # stop blocking on the corpse NOW instead of when (if) a launcher
        # restarts it.  0 (the default) disables the monitor.
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = get_env("DMLC_HEARTBEAT_TIMEOUT", 0.0)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.liveness = LivenessBoard(self.heartbeat_timeout_s)
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        bound = False
        # port=0 (default) = OS-assigned ephemeral port: concurrent trackers
        # can never collide (the DMLC_TRACKER_PORT env carries the real port
        # to workers).  An explicit port keeps the reference's scan behavior
        # (`tracker.py:141-153`) for fixed-port deployments; a port above
        # max_port (a restart pinned to a prior ephemeral bind) is a
        # single exact candidate, not an empty scan range.
        candidates = [0] if port == 0 else range(port, max(port, max_port) + 1)
        for p in candidates:
            try:
                self._sock.bind((self.host_ip, p))
                self.port = self._sock.getsockname()[1]
                bound = True
                break
            except OSError:
                continue
        if not bound:
            raise DMLCError(f"tracker: no free port in [{port}, {max_port}]")
        self._sock.listen(128)
        self._lock = threading.Condition()
        self._workers: Dict[str, _WorkerRecord] = {}  # jobid → record
        self._rank_of: Dict[str, int] = {}
        self._assigned = False
        self._generation = 0  # bumped on every post-assignment recover
        self._shutdown_count = 0
        self._start_time: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # fleet telemetry: workers push rank-tagged registry snapshots
        # (cmd=telemetry) and the tracker exposes the merged view on its
        # own /metrics endpoint.  Unset/negative port = disabled.
        if telemetry_port is None:
            p = get_env("DMLC_TRACKER_METRICS_PORT", -1)
            telemetry_port = p if p >= 0 else None
        # durable rendezvous: journal rank assignments + link
        # generation so a restarted tracker re-admits the live cohort
        if journal is None:
            journal = get_env("DMLC_TRACKER_JOURNAL", "") or None
        self._journal: Optional[StateJournal] = None
        self._journal_snap_every = max(16, int(get_env(
            "DMLC_TRACKER_JOURNAL_SNAP_EVERY", 512)))
        if journal:
            self._journal = StateJournal(
                str(journal), snap_schema=TRACKER_SNAP_SCHEMA,
                on_append=metrics.counter("tracker.journal.appends").add,
                on_snapshot=metrics.counter(
                    "tracker.journal.snapshots").add)
            with self._lock:
                self._restore_locked()
        self._telemetry_states: Dict[str, dict] = {}
        # cross-rank straggler detection over the same pushes: every
        # rank-tagged state feeds the board, /metrics carries per-rank
        # straggler_z / straggler_suspect gauges, /stragglers the JSON
        self.straggler_board = StragglerBoard()
        # restarted workers must not drive merged fleet counters
        # backwards: re-base at the ingestion point
        self._reset_guard = ResetGuard()
        # fleet timeline: sample the merged view (rank-tagged pushed
        # histories fold into one queryable /timeline)
        self.history = HistoryStore(
            snapshot_fn=lambda: merge_states(self.telemetry_states()))
        self.telemetry: Optional[TelemetryServer] = None
        if telemetry_port is not None:
            # /diagnose over the MERGED stores: the fleet timeline and
            # the cross-rank straggler board, so one query on the
            # tracker attributes an incident across every rank
            self.telemetry = TelemetryServer(
                port=int(telemetry_port), metrics_fn=self._render_fleet,
                stragglers_fn=self.straggler_board.snapshot,
                timeline_fn=self.history.timeline,
                diagnose_fn=DiagnosisEngine(
                    history=self.history,
                    stragglers_fn=self.straggler_board.snapshot,
                ).endpoint_doc)

    # -- public control --
    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        if self.heartbeat_timeout_s > 0:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             name="tracker-heartbeat",
                                             daemon=True)
            self._monitor.start()
        if self.telemetry is not None:
            self.telemetry.start()
            self.history.start()
            log_info("tracker fleet metrics at http://%s:%d/metrics",
                     self.host_ip, self.telemetry.port)
        log_info("tracker started at %s:%d for %d workers",
                 self.host_ip, self.port, self.num_workers)

    def worker_envs(self) -> Dict[str, str]:
        """Env contract for workers (reference ``slave_envs`` `tracker.py:182`)."""
        return {
            "DMLC_TRACKER_URI": self.host_ip,
            "DMLC_TRACKER_PORT": str(self.port),
            "DMLC_NUM_WORKER": str(self.num_workers),
        }

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until all workers sent shutdown (reference ``join`` :329-331)."""
        deadline = time.monotonic() + timeout if timeout else None
        with self._lock:
            while self._shutdown_count < self.num_workers:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise DMLCError("tracker join timed out")
                self._lock.wait(remaining)
        if self._start_time is not None:
            log_info("@tracker All of %d nodes got shutdown; %.2f secs between "
                     "start and shutdown", self.num_workers,
                     time.monotonic() - self._start_time)
        self.stop()

    def stop(self) -> None:
        self._stop = True
        self._monitor_stop.set()
        self.history.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
        # shutdown() before close(): close() alone does not wake a
        # thread blocked inside accept(), and the blocked syscall keeps
        # the listen port held — an in-process restart on the same port
        # (the HA drills) would then fail to rebind
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._journal is not None:
            with self._lock:
                self._journal.compact(self._durable_state_locked())
            self._journal.close()

    def _render_fleet(self) -> str:
        with self._lock:
            per_rank = dict(self._telemetry_states)
        page = render_fleet(per_rank, own_snapshot=metrics.snapshot())
        rows = self.straggler_board.series()
        if rows:
            from ..telemetry.exposition import render_series
            page += render_series(rows)
        return page

    def telemetry_states(self) -> Dict[str, dict]:
        """Latest per-rank registry states pushed via ``cmd=telemetry``."""
        with self._lock:
            return dict(self._telemetry_states)

    # -- durable rendezvous --
    def _jlog(self, op: str, **fields: Any) -> None:
        """One write-ahead record; no-op without a journal.  Callers
        hold ``self._lock`` (the tracker's one big lock — the
        dispatcher's inline-compaction pattern applies)."""
        if self._journal is None:
            return
        self._journal.append({"op": op, "ts": time.time(), **fields})
        if self._journal.appends_since_snapshot >= self._journal_snap_every:
            self._journal.compact(self._durable_state_locked())

    def _durable_state_locked(self) -> Dict[str, Any]:
        return {"workers": {j: {"host": r.host, "port": r.port,
                                "rank": r.rank}
                            for j, r in self._workers.items()},
                "generation": self._generation}

    def _restore_locked(self) -> None:
        snap, records = self._journal.load()
        if snap is None and not records:
            return
        state = replay_tracker_state(snap, records)
        self._workers = {}
        self._rank_of = {}
        for jobid, w in state.get("workers", {}).items():
            rec = _WorkerRecord(jobid, str(w.get("host")),
                                int(w.get("port") or 0))
            rec.rank = int(w.get("rank", -1))
            self._workers[jobid] = rec
            if rec.rank >= 0:
                self._rank_of[jobid] = rec.rank
        self._generation = int(state.get("generation", 0))
        self._assigned = any(r.rank >= 0 for r in self._workers.values())
        for jobid in self._workers:
            # liveness grace: restored workers get a full window to
            # re-attach before the monitor declares them dead
            self.liveness.beat(jobid)
        metrics.counter("tracker.journal.replayed").add(len(records))
        log_info("tracker: replayed %d journal record(s) → %d worker(s)"
                 ", generation %d%s", len(records), len(self._workers),
                 self._generation,
                 " (ranks assigned)" if self._assigned else "")
        self._journal.compact(self._durable_state_locked())

    # -- accept/assign logic --
    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        f = conn.makefile("r")
        try:
            msg = recv_json(f)
            if msg is None:
                return
            cmd = msg.get("cmd")
            if cmd == "print":
                log_info("@worker: %s", msg.get("msg", ""))
            elif cmd == "shutdown":
                with self._lock:
                    self._shutdown_count += 1
                    self.liveness.forget(str(msg.get("jobid", "")))
                    self._lock.notify_all()
            elif cmd == "telemetry":
                # rank-tagged registry state push; last write per rank wins
                # (each push is a full snapshot, not a delta)
                state = msg.get("state")
                if isinstance(state, dict):
                    rank = str(msg.get("rank"))
                    state = self._reset_guard.fold(rank, state)
                    with self._lock:
                        self._telemetry_states[rank] = state
                    # outside the tracker lock: the board has its own
                    self.straggler_board.update(msg.get("rank"), state)
            elif cmd == "heartbeat":
                jobid = str(msg.get("jobid", ""))
                if self.liveness.beat(jobid):
                    # slow-but-alive: the monitor misdiagnosed it; the
                    # next reset/recover round re-links it
                    log_warning("tracker: worker %r revived by "
                                   "heartbeat", jobid)
            elif cmd in ("start", "recover"):
                self._register_and_reply(conn, msg, recovering=(cmd == "recover"))
            else:
                send_json(conn, {"error": f"unknown cmd {cmd!r}"})
        except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
            log_warning("tracker connection error: %s", e)
            try:
                send_json(conn, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _register_and_reply(self, conn: socket.socket, msg: dict,
                            recovering: bool) -> None:
        jobid = str(msg.get("jobid", ""))
        host = msg.get("host") or conn.getpeername()[0]
        port = int(msg["port"])
        notify: List[Tuple[str, int]] = []
        with self._lock:
            if self._start_time is None:
                self._start_time = time.monotonic()
            self.liveness.beat(jobid)
            rec = self._workers.get(jobid)
            if rec is None:
                rec = _WorkerRecord(jobid, host, port)
                self._jlog("worker", jobid=jobid, host=host, port=port,
                           rank=-1)
                self._workers[jobid] = rec
            else:
                # restarted worker: keep rank, refresh address.  An
                # UNCHANGED address is re-admission after a *tracker*
                # restart (the worker never died, its peers' links are
                # intact) — same rank, current generation, no reset.
                moved = (rec.host, rec.port) != (host, port)
                if moved:
                    self._jlog("worker", jobid=jobid, host=host,
                               port=port, rank=rec.rank)
                rec.host, rec.port = host, port
                if moved and self._assigned and rec.rank >= 0:
                    # MID-JOB restart: surviving peers hold sockets to the
                    # dead incarnation — bump the link generation and push a
                    # reset to every survivor so they drop stale links and
                    # re-rendezvous (reference wait_conn re-linking,
                    # `tracker.py:80-135,279-291`)
                    self._jlog("generation",
                               generation=self._generation + 1)
                    self._generation += 1
                    notify = [(w.host, w.port) for w in self._workers.values()
                              if w.jobid != jobid and w.rank >= 0]
            if not self._assigned:
                # a `recover` can also be the registration that COMPLETES
                # the cohort (a worker that crashed before first rendezvous
                # and was restarted by the launcher retry loop) — assignment
                # must trigger regardless of the command
                if len(self._workers) >= self.num_workers:
                    self._assign_ranks_locked()
                    self._lock.notify_all()
                else:
                    # wait until full cohort present
                    while not self._assigned and not self._stop:
                        self._lock.wait(timeout=1.0)
            rec = self._workers[jobid]
            if rec.rank < 0:
                # a registration beyond the cohort (extra worker, or a server
                # process misusing the worker rendezvous) gets a clean error
                reply = {"error": f"cohort of {self.num_workers} already "
                                  f"assigned; job {jobid!r} is not a member"}
            else:
                reply = self._build_assignment(rec)
            if notify:
                reset = {"cmd": "reset_links",
                         "generation": self._generation,
                         "addresses": {str(w.rank): [w.host, w.port]
                                       for w in self._workers.values()
                                       if w.rank >= 0}}
        for host_port in notify:
            self._notify_reset(host_port, reset)
        send_json(conn, reply)

    def _monitor_loop(self) -> None:
        """Sweep heartbeats; a worker silent past the timeout is declared
        dead ONCE (until it beats or re-registers): bump the link
        generation and push reset_links to the survivors — the same repair
        a recover registration drives, just initiated by the tracker."""
        interval = max(0.1, self.heartbeat_timeout_s / 4.0)
        while not self._monitor_stop.wait(interval):
            notify: List[Tuple[str, int]] = []
            reset: Optional[dict] = None
            with self._lock:
                if not self._assigned:
                    continue
                newly_dead = self.liveness.sweep(
                    eligible=lambda j: (
                        j in self._workers and self._workers[j].rank >= 0
                        and self._shutdown_count < self.num_workers))
                if not newly_dead:
                    continue
                for j, silence in newly_dead:
                    metrics.counter("tracker.dead_workers").add(1)
                    log_warning(
                        "tracker: worker %r (rank %d) missed heartbeats "
                        "for %.1fs — declaring dead", j,
                        self._workers[j].rank, silence)
                self._jlog("generation", generation=self._generation + 1)
                self._generation += 1
                dead = self.liveness.dead_members()
                notify = [(w.host, w.port) for w in self._workers.values()
                          if w.jobid not in dead and w.rank >= 0]
                reset = {"cmd": "reset_links",
                         "generation": self._generation,
                         "addresses": {str(w.rank): [w.host, w.port]
                                       for w in self._workers.values()
                                       if w.rank >= 0}}
            for host_port in notify:
                self._notify_reset(host_port, reset)

    def _notify_reset(self, addr: Tuple[str, int], reset: dict) -> None:
        """Push a link-reset control message to a survivor's peer listener
        (sentinel rank -2 handshake, then one JSON line).  Retried — a
        dropped notify would strand that survivor waiting for a reset that
        never comes."""
        last: Optional[Exception] = None
        for attempt in range(3):
            try:
                with socket.create_connection(addr, timeout=10.0) as s:
                    send_all(s, struct.pack("<q", -2))
                    send_json(s, reset)
                return
            except OSError as e:
                last = e
                time.sleep(0.5 * (attempt + 1))
        log_warning("tracker: reset notify to %s failed after retries: %s",
                       addr, last)

    def _assign_ranks_locked(self) -> None:
        # sort by host then jobid for locality (reference :294-311)
        ordered = sorted(self._workers.values(),
                         key=lambda r: (r.host, r.jobid))
        self._jlog("assign", ranks={rec.jobid: rank
                                    for rank, rec in enumerate(ordered)})
        for rank, rec in enumerate(ordered):
            rec.rank = rank
            self._rank_of[rec.jobid] = rank
        self._assigned = True
        log_info("@tracker all %d workers registered; ranks assigned",
                 self.num_workers)

    def _addr_of(self, rank: int) -> Tuple[str, int]:
        for rec in self._workers.values():
            if rec.rank == rank:
                return rec.host, rec.port
        raise DMLCError(f"no worker with rank {rank}")

    def _build_assignment(self, rec: _WorkerRecord) -> dict:
        world = self.num_workers
        tree = compute_tree(world)
        ring = compute_ring(world)
        pos = ring.index(rec.rank)
        ring_prev = ring[(pos - 1) % world]
        ring_next = ring[(pos + 1) % world]
        parent = tree_parent(rec.rank)
        children = [c for c in tree[rec.rank] if c != parent]
        return {
            "rank": rec.rank,
            "world": world,
            "parent": parent,
            "children": children,
            "tree_neighbors": tree[rec.rank],
            "ring_prev": ring_prev,
            "ring_next": ring_next,
            "generation": self._generation,
            "addresses": {str(r): list(self._addr_of(r))
                          for r in set(tree[rec.rank] + [ring_prev, ring_next])
                          if r != rec.rank},
        }


class PSTracker:
    """Parameter-server bootstrap (the reference's ``PSTracker``): start
    the **scheduler** process locally with ``DMLC_ROLE=scheduler`` and
    hand every worker and server the same ``DMLC_PS_ROOT_URI`` /
    ``DMLC_PS_ROOT_PORT`` rendezvous environment.

    The scheduler is any command (ps-lite's in the reference).
    ``pscmd=None`` spawns nothing and only makes the environment, as the
    reference does when no scheduler command is given.
    """

    def __init__(self, host_ip: Optional[str] = None, port: int = 9100,
                 max_port: int = 9999, pscmd: Optional[List[str]] = None,
                 extra_env: Optional[Dict[str, str]] = None):
        self.host_ip = host_ip or _default_host_ip()
        # reserve a free port and HOLD the socket (a bind-then-close probe
        # races: two trackers scanning concurrently would both pick the
        # same port); released right before the scheduler spawns.
        # port=0 asks the OS for an ephemeral port (no scan, no collisions).
        self.port = None
        self._reserve: Optional[socket.socket] = None
        candidates = [0] if port == 0 else range(port, max_port + 1)
        for p in candidates:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((self.host_ip, p))
                self.port = s.getsockname()[1]
                self._reserve = s
                break
            except OSError:
                s.close()
        if self.port is None:
            raise DMLCError(f"pstracker: no free port in [{port}, {max_port}]")
        self.pscmd = pscmd
        self.extra_env = dict(extra_env or {})
        self._proc = None

    def worker_envs(self) -> Dict[str, str]:
        return {
            "DMLC_PS_ROOT_URI": self.host_ip,
            "DMLC_PS_ROOT_PORT": str(self.port),
        }

    def start(self) -> None:
        if not self.pscmd:
            return
        env = dict(os.environ)
        env.update(self.worker_envs())
        env.update(self.extra_env)
        env["DMLC_ROLE"] = "scheduler"
        if self._reserve is not None:
            # hand the port to the scheduler (it binds it itself, as
            # ps-lite does); SO_REUSEADDR makes the TIME_WAIT-free rebind
            # immediate — the race window is just this spawn
            self._reserve.close()
            self._reserve = None
        self._proc = subprocess.Popen(self.pscmd, env=env)
        log_info("pstracker: scheduler started at %s:%d (pid %d)",
                 self.host_ip, self.port, self._proc.pid)

    def join(self) -> int:
        return self._proc.wait() if self._proc else 0

    def stop(self) -> None:
        if self._reserve is not None:
            self._reserve.close()
            self._reserve = None
        if self._proc and self._proc.poll() is None:
            self._proc.terminate()
            self._proc.wait()


def _default_host_ip() -> str:
    # prefer a routable address; fall back to loopback on a host with no
    # route.  A UDP connect sends no packet: it only asks the kernel which
    # source address the route would use
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 53))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


def tracker_main(argv=None) -> int:
    """CLI: ``python -m dmlc_core_tpu_torch.parallel.tracker [host=H]
    [port=N] [workers=N] [journal=PREFIX] [heartbeat_timeout=S]``: serve
    until killed.

    The chaos drill's surface: a drill runs the tracker as a process,
    SIGKILLs it mid-epoch and restarts it with the same ``port=`` and
    ``journal=``, and the replay re-admits the cohort at the current
    generation.  The bound address is printed as one JSON line on stdout
    (``{"host": ..., "port": ...}``); SIGTERM is a clean stop (the
    journal compacted); ``DMLC_TRACKER_METRICS_PORT`` mounts the fleet
    pages."""
    args = list(sys.argv[1:] if argv is None else argv)
    kw = dict(a.split("=", 1) for a in args)
    t = RabitTracker(
        num_workers=int(kw.get("workers", 1)),
        host_ip=kw.get("host", "127.0.0.1"),
        port=int(kw.get("port", 0)),
        journal=kw.get("journal") or None,
        heartbeat_timeout_s=(float(kw["heartbeat_timeout"])
                             if "heartbeat_timeout" in kw else None))
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())
    t.start()
    print(json.dumps({"host": t.host_ip, "port": t.port}), flush=True)
    try:
        while not done.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    t.stop()
    return 0


if __name__ == "__main__":
    sys.exit(tracker_main())
