"""Replica registry: membership, heartbeat liveness, the multi-model map.

Counterpart of ``dmlc_core_tpu/serving/fleet/registry.py``: the same
JSON-line commands and replies, the same journal records and snapshot
schema (either package replays a journal the other wrote, and either
package's :class:`ReplicaAgent` joins either package's
:class:`ReplicaRegistry`), the same metric names and the same CLI.

One registry process owns the serving fleet's metadata.  A replica
registers (or only starts heartbeating: an unknown jobid's heartbeat
carrying an address IS a registration, so a replica that outlives a
registry restart re-appears on its next beat), sends its health report
and a push of its whole metrics registry on every beat, and is declared
dead by the tracker's
:class:`~dmlc_core_tpu_torch.parallel.tracker.LivenessBoard` rules when
it falls silent.  The pushes feed a
:class:`~dmlc_core_tpu_torch.telemetry.anomaly.StragglerBoard`, which
flags a replica that is alive but slower than its peers.

The **multi-model map** (``model_id`` → checkpoint dir → replica set)
lets one fleet serve many checkpoints: each replica names its model when
it registers, ``list_replicas`` filters by model, and the canary rollouts
(:mod:`.rollout`) move one model's stable checkpoint pointer
independently of every other's.

Control flows back to the replicas **by pull**: the registry never dials
a replica.  Directives (the reloads of a canary, a promote or a
rollback) queue per jobid and ride the heartbeat *replies*; the replica
applies them and acks on its next beat, so a replica needs no reachable
control port.

Wire: the tracker's JSON lines (``send_json`` / ``recv_json``), one
request a connection; a request with ``trace_id`` / ``parent_span`` keys
is handled under a ``serving.fleet.rpc`` span parented to the caller.

**Durability.**  With ``journal=`` (or ``DMLC_REGISTRY_JOURNAL``) every
durable mutation (membership, the stable pointers, the directive queues,
the rollouts' active canaries and ledger) is journaled before it is made
through :class:`~dmlc_core_tpu_torch.utils.durable.StateJournal`.  A
SIGKILLed registry restarted on the same port and journal resumes
mid-rollout: the canary set, pending acks and ledger replay from disk,
and the replicas re-attach by the heartbeat-is-registration rule.
Heartbeat *reports* (qps, queue pressure, p99) are not journaled: the
next beat refreshes them.

**Fencing and a warm standby.**  A journaled registry stamps a monotonic
``control_epoch`` on every reply and refreshes a
:class:`~dmlc_core_tpu_torch.utils.durable.FencedLease` beside the
journal.  A second registry started with ``standby=True`` on the same
journal serves stale reads while it polls the lease; when the lease
expires it replays the journal, bumps the epoch and takes over, after
which the old primary's writes are refused (``fenced``) and clients'
:class:`~dmlc_core_tpu_torch.transport.endpoints.EndpointSet` drop any
reply of a lower epoch.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ...parallel.tracker import (LivenessBoard, jittered, recv_json,
                                 send_json)
from ...telemetry import flight as flight_mod
from ...telemetry import trace as teltrace
from ...telemetry.anomaly import StragglerBoard
from ...telemetry.diagnose import DiagnosisEngine
from ...telemetry.exposition import TelemetryServer
from ...telemetry.timeseries import HistoryStore
from ...transport.endpoints import EndpointSet, EndpointsLike
from ...transport.listener import Listener, serve_connection
from ...utils.durable import FencedLease, StateJournal
from ...utils.logging import DMLCError, log_info, log_warning
from ...utils.metrics import metrics
from ...utils.parameter import get_env

__all__ = ["ReplicaRegistry", "ReplicaAgent", "fleet_rpc",
           "replay_registry_state", "registry_main", "REGISTRY_SNAP_SCHEMA"]

REGISTRY_SNAP_SCHEMA = "dmlc.fleet.registry.snapshot/1"

#: membership facts journaled per replica (the durable half of a
#: record; heartbeat report fields are volatile and live in ``_reports``)
_MEMBER_KEYS = ("host", "port", "health_port", "model_id")

#: replica report keys copied verbatim from a heartbeat into the record
_REPORT_KEYS = ("health", "queue_fraction", "queue_depth", "inflight",
                "p99_ms", "qps", "step", "params_version", "slo_breaches",
                "reload_error")


def fleet_rpc(addr: Tuple[str, int], obj: dict,
              timeout: float = 30.0) -> dict:
    """One JSON-line request/response round trip to the replica registry
    (the dispatcher_rpc idiom: trace ids ride as optional JSON keys)."""
    tid, sid = teltrace.wire_ids()
    if tid and "trace_id" not in obj:
        obj = {**obj, "trace_id": tid, "parent_span": sid}
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        send_json(s, obj)
        reply = recv_json(s.makefile("r"))
    if reply is None:
        raise DMLCError(f"registry {addr} closed without replying "
                        f"to {obj.get('cmd')!r}")
    if "error" in reply:
        raise DMLCError(f"registry: {reply['error']}")
    return reply


def _blank_registry_state() -> Dict[str, Any]:
    return {"control_epoch": 0, "replicas": {}, "models": {},
            "directives": {},
            "rollouts": {"active": {}, "ledger": [], "seq": 0}}


def replay_registry_state(snapshot: Optional[Dict[str, Any]],
                          records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure replay of registry journal ``records`` over ``snapshot`` (or
    a blank state).  Unknown ops are skipped (forward compatibility) and
    records naming absent replicas or rollouts are skipped too, so *any*
    prefix of a valid log replays without error.

    State shape (all JSON)::

        {"control_epoch": int,
         "replicas":   {jobid: {"host", "port", "health_port",
                                "model_id"}},
         "models":     {model_id: {"ckpt_dir", "step"}},
         "directives": {jobid: [directive, ...]},
         "rollouts":   {"active": {model_id: rollout-record},
                        "ledger": [events], "seq": int}}
    """
    state = _blank_registry_state()
    if snapshot:
        for k in ("replicas", "models", "directives", "rollouts"):
            v = snapshot.get(k)
            if isinstance(v, dict):
                state[k] = json.loads(json.dumps(v))    # deep copy
        state["control_epoch"] = int(snapshot.get("control_epoch", 0))
        state["rollouts"].setdefault("active", {})
        state["rollouts"].setdefault("ledger", [])
        state["rollouts"].setdefault("seq", 0)
    ro_tab = state["rollouts"]
    for rec in records:
        op = rec.get("op")
        if op == "epoch":
            state["control_epoch"] = max(state["control_epoch"],
                                         int(rec.get("control_epoch", 0)))
        elif op == "replica":
            state["replicas"][str(rec["jobid"])] = {
                k: rec.get(k) for k in _MEMBER_KEYS}
        elif op == "replica_gone":
            jobid = str(rec.get("jobid"))
            state["replicas"].pop(jobid, None)
            state["directives"].pop(jobid, None)
        elif op == "model":
            state["models"][str(rec["model_id"])] = {
                "ckpt_dir": rec.get("ckpt_dir"), "step": rec.get("step")}
        elif op == "directive":
            state["directives"].setdefault(str(rec["jobid"]), []) \
                .append(dict(rec.get("directive") or {}))
        elif op == "directives_drained":
            jobid = str(rec.get("jobid"))
            q = state["directives"].get(jobid) or []
            q = q[int(rec.get("count", len(q))):]
            if q:
                state["directives"][jobid] = q
            else:
                state["directives"].pop(jobid, None)
        elif op == "rollout_staged":
            ro = dict(rec.get("rollout") or {})
            if ro.get("model_id") is not None:
                ro.setdefault("acked", [])
                ro.setdefault("failed", [])
                ro_tab["active"][str(ro["model_id"])] = ro
                ro_tab["seq"] = max(int(ro_tab.get("seq", 0)),
                                    int(rec.get("seq", 0)))
        elif op == "rollout_ack":
            rid = rec.get("rollout_id")
            for ro in ro_tab["active"].values():
                if ro.get("id") != rid:
                    continue
                side = "acked" if rec.get("ok", True) else "failed"
                if rec["jobid"] not in ro[side]:
                    ro[side].append(rec["jobid"])
        elif op == "rollout_gone":
            jobid = rec.get("jobid")
            for ro in ro_tab["active"].values():
                if jobid in (ro.get("canaries") or []):
                    ro["canaries"].remove(jobid)
        elif op == "rollout_finished":
            # one fsync'd record = the atomic promote/rollback
            # transition: close the rollout AND (on promote) move the
            # stable pointer, so replay can never re-promote a closed
            # rollout or close one whose pointer move was lost
            model_id = str(rec.get("model_id"))
            ro = ro_tab["active"].get(model_id)
            if ro is not None and ro.get("id") == rec.get("rollout_id"):
                del ro_tab["active"][model_id]
                if rec.get("promoted"):
                    state["models"][model_id] = {
                        "ckpt_dir": rec.get("ckpt_dir"),
                        "step": rec.get("step")}
        elif op == "rollout_event":
            ev = rec.get("event")
            if isinstance(ev, dict):
                ro_tab["ledger"].append(ev)
    cap = 4096
    if len(ro_tab["ledger"]) > cap:
        ro_tab["ledger"] = ro_tab["ledger"][-cap:]
    return state


class ReplicaRegistry:
    """TCP control-plane server for the serving fleet.

    >>> reg = ReplicaRegistry(); reg.start()
    >>> # replicas: ReplicaAgent(server, reg.address).start(), or
    >>> # DMLC_ROUTER_REGISTRY=host:port before PredictionServer(...)
    >>> reg.stop()

    ``heartbeat_timeout_s`` (default ``DMLC_ROUTER_HEARTBEAT_TIMEOUT``,
    5 s) declares a silent replica dead.  ``telemetry_port`` mounts a
    :class:`TelemetryServer` on the registry's host with the fleet
    console (``/fleet``), the rollout ledger (``/rollouts``), the fleet
    timeline (``/timeline``) and ``/diagnose``.

    ``journal`` (default ``DMLC_REGISTRY_JOURNAL``) enables the durable
    control plane: a ``<prefix>.log``/``.snap`` journal pair plus a
    ``<prefix>.lease`` fencing lease (TTL ``DMLC_CONTROL_LEASE_S``,
    compaction threshold ``DMLC_REGISTRY_JOURNAL_SNAP_EVERY``).
    ``standby=True`` makes this instance a warm standby on the shared
    journal: reads are served from the replayed (possibly stale) state,
    writes are refused, and the instance promotes itself once the
    primary's lease expires.
    """

    #: journal-before-mutate: every method that mutates these journals
    #: first
    _DURABLE_STATE = ("_replicas", "_models", "_directives",
                      "_control_epoch")

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 heartbeat_timeout_s: Optional[float] = None,
                 telemetry_port: Optional[int] = None,
                 journal: Optional[str] = None,
                 standby: bool = False):
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = get_env("DMLC_ROUTER_HEARTBEAT_TIMEOUT",
                                          5.0)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.liveness = LivenessBoard(self.heartbeat_timeout_s)
        self.straggler_board = StragglerBoard()
        self._lock = threading.Lock()
        #: jobid → membership record (address, model) — durable
        self._replicas: Dict[str, Dict[str, Any]] = {}
        #: jobid → latest heartbeat report fields — volatile by design
        self._reports: Dict[str, Dict[str, Any]] = {}
        #: model_id → {"ckpt_dir", "step"} — the stable pointer the
        #: rollout machinery moves on promote
        self._models: Dict[str, Dict[str, Any]] = {}
        #: jobid → queued directives, drained into heartbeat replies
        self._directives: Dict[str, List[dict]] = {}
        self._last_beat: Dict[str, float] = {}
        self._stop_ev = threading.Event()
        self._threads: List[threading.Thread] = []
        self._m_replicas = metrics.gauge("fleet.registry.replicas")
        self._listener = Listener(host, port, backlog=64)
        self._srv = self._listener.sock
        self.host, self.port = self._listener.host, self._listener.port
        # -- durable control plane ----------------------------------------
        if journal is None:
            journal = get_env("DMLC_REGISTRY_JOURNAL", "") or None
        self.standby = bool(standby)
        self._fenced = False
        self._control_epoch = 0
        self._owner = f"{self.host}:{self.port}"
        self._journal: Optional[StateJournal] = None
        self._lease: Optional[FencedLease] = None
        #: serializes journal appends against compaction; never held
        #: while taking ``_lock`` inside an append path (``_jlog`` is
        #: always called with no registry/rollout lock held)
        self._jmutex = threading.Lock()
        self._journal_snap_every = max(16, int(get_env(
            "DMLC_REGISTRY_JOURNAL_SNAP_EVERY", 512)))
        restored: Optional[Dict[str, Any]] = None
        if journal:
            self._journal = StateJournal(
                str(journal), snap_schema=REGISTRY_SNAP_SCHEMA,
                on_append=metrics.counter(
                    "fleet.registry.journal.appends").add,
                on_snapshot=metrics.counter(
                    "fleet.registry.journal.snapshots").add)
            self._lease = FencedLease(
                str(journal) + ".lease",
                ttl_s=float(get_env("DMLC_CONTROL_LEASE_S", 2.0)))
            with self._lock:
                restored = self._restore_locked()
        from .rollout import RolloutManager
        self.rollouts = RolloutManager(self)
        if restored is not None:
            self.rollouts._restore_state(restored.get("rollouts") or {})
        if self._journal is not None and not self.standby:
            self._become_primary()
        # fleet timeline: the registry's own counters plus synthetic
        # fleet-level gauges derived from heartbeat reports, so
        # /timeline answers "how did alive-count / aggregate inflight /
        # worst queue pressure move" without scraping every replica
        self.history = HistoryStore(snapshot_fn=self._history_snapshot)
        self.telemetry: Optional[TelemetryServer] = None
        if telemetry_port is not None:
            # /diagnose over the MERGED fleet view: the registry's
            # synthetic fleet gauges, the per-model straggler board,
            # and the replica console rows
            self.telemetry = TelemetryServer(
                port=int(telemetry_port), host=self.host,
                fleet_fn=self.fleet_snapshot,
                rollouts_fn=self.rollouts.snapshot,
                timeline_fn=self.history.timeline,
                diagnose_fn=DiagnosisEngine(
                    history=self.history,
                    stragglers_fn=self.straggler_board.snapshot,
                    fleet_fn=self.fleet_snapshot,
                ).endpoint_doc)

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    # -- durable control plane ------------------------------------------
    def _jlog(self, op: str, **fields: Any) -> None:
        """One write-ahead journal record; no-op without a journal.
        Callers must not hold ``_lock`` or the rollout lock (compaction
        takes ``_jmutex`` first, then those — same order everywhere)."""
        if self._journal is None:
            return
        with self._jmutex:
            self._journal.append({"op": op, "ts": time.time(), **fields})

    def _durable_state_locked(self) -> Dict[str, Any]:
        return {
            "control_epoch": self._control_epoch,
            "replicas": {j: {k: r.get(k) for k in _MEMBER_KEYS}
                         for j, r in self._replicas.items()},
            "models": {m: dict(ptr) for m, ptr in self._models.items()},
            "directives": {j: [dict(d) for d in q]
                           for j, q in self._directives.items() if q},
        }

    def _restore_locked(self) -> Optional[Dict[str, Any]]:
        """Replay the journal into the membership / model / directive
        tables; returns the full replayed state (the rollout slice is
        applied by the caller once the RolloutManager exists)."""
        self._replicas.clear()
        self._models.clear()
        self._directives.clear()
        snap, records = self._journal.load()
        if snap is None and not records:
            return None
        state = replay_registry_state(snap, records)
        self._control_epoch = int(state.get("control_epoch", 0))
        self._replicas = {j: {k: r.get(k) for k in _MEMBER_KEYS}
                          for j, r in state.get("replicas", {}).items()}
        self._models = {m: dict(p)
                        for m, p in state.get("models", {}).items()}
        self._directives = {j: [dict(d) for d in q]
                            for j, q in state.get("directives", {}).items()
                            if q}
        now = time.monotonic()
        for jobid in self._replicas:
            # liveness grace: a restored replica gets a full heartbeat
            # window to re-attach before the sweep declares it dead
            self.liveness.beat(jobid)
            self._last_beat[jobid] = now
        self._m_replicas.set(len(self._replicas))
        metrics.counter("fleet.registry.journal.replayed") \
            .add(len(records))
        log_info("fleet registry: replayed %d journal record(s) over "
                 "%s snapshot → %d replica(s), %d model(s), epoch %d",
                 len(records), "a" if snap else "no",
                 len(self._replicas), len(self._models),
                 self._control_epoch)
        return state

    def _become_primary(self) -> None:
        """Claim (or re-claim) the fencing lease: bump the monotonic
        ``control_epoch`` past anything the journal or lease has seen,
        journal it, stamp the lease, and compact."""
        lease_epoch = self._lease.current_epoch() if self._lease else 0
        epoch = max(self._control_epoch, lease_epoch) + 1
        self._jlog("epoch", control_epoch=epoch)
        with self._lock:
            self._control_epoch = epoch
        self._fenced = False
        if self._lease is not None:
            self._lease.refresh(self._owner, epoch)
        metrics.gauge("fleet.registry.control_epoch").set(epoch)
        self._compact()
        log_info("fleet registry %s: primary at control_epoch %d",
                 self._owner, epoch)

    def _compact(self) -> None:
        if self._journal is None:
            return
        with self._jmutex:
            with self._lock:
                state = self._durable_state_locked()
            state["rollouts"] = self.rollouts.durable_snapshot()
            self._journal.compact(state)

    def _fence_error(self) -> Optional[dict]:
        """Reject writes once a standby has taken over: the on-disk
        lease carrying a higher epoch than ours means we are the stale
        primary.  Standbys refuse writes outright until promotion."""
        if self._journal is None:
            return None
        if self.standby:
            return {"error": "standby: not primary (reads only)",
                    "control_epoch": self._control_epoch}
        if not self._fenced and self._lease is not None:
            if self._lease.current_epoch() > self._control_epoch:
                self._fenced = True
        if self._fenced:
            metrics.counter("fleet.registry.fenced").add(1)
            return {"error": f"fenced: control_epoch "
                             f"{self._control_epoch} superseded",
                    "control_epoch": self._control_epoch}
        return None

    def _standby_loop(self) -> None:
        """Warm standby: poll the primary's lease; replay + take over
        once it expires."""
        poll = max(0.05, (self._lease.ttl_s if self._lease else 2.0) / 4.0)
        while not self._stop_ev.wait(jittered(poll)):
            if self._lease is None or not self._lease.expired():
                continue
            metrics.counter("fleet.registry.takeovers").add(1)
            log_info("fleet registry %s: primary lease expired — "
                     "taking over", self._owner)
            with self._lock:
                restored = self._restore_locked()
            self.rollouts._restore_state(
                (restored or {}).get("rollouts") or {})
            self.standby = False
            self._become_primary()
            self._sweep_loop()
            return

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ReplicaRegistry":
        sweep = self._standby_loop if self.standby else self._sweep_loop
        self._threads.append(self._listener.spawn(
            self._on_conn, name="fleet-registry-accept",
            stopping=self._stop_ev.is_set))
        t = threading.Thread(target=sweep, name="fleet-registry-sweep",
                             daemon=True)
        t.start()
        self._threads.append(t)
        self.rollouts.start()
        if self.telemetry is not None:
            self.telemetry.start()
            self.history.start()
        # incident bundles dumped in this process carry the rollout
        # ledger — a bad-canary postmortem reads transitions directly
        flight_mod.register_contributor("rollout_ledger",
                                        self.rollouts.snapshot)
        log_info("serving fleet registry on %s:%d (heartbeat timeout "
                 "%.1fs)", self.host, self.port, self.heartbeat_timeout_s)
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        flight_mod.unregister_contributor("rollout_ledger")
        self.history.stop()
        self.rollouts.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
        # Listener.close() is shutdown()-before-close(): close() alone
        # does not wake a thread blocked inside accept()
        self._listener.close()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._journal is not None:
            if not self.standby and not self._fenced:
                self._compact()         # clean stop: snapshot + empty log
            self._journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- introspection ---------------------------------------------------
    def replica_records(self, model_id: Optional[str] = None
                        ) -> Dict[str, Dict[str, Any]]:
        """jobid → record copy (with ``alive``/``straggler`` flags) —
        the rollout manager's and ``list_replicas``'s shared view."""
        try:
            suspects = set(self.straggler_board.suspects())
        except Exception:   # <3 replicas / no pushes yet — board is moot
            suspects = set()
        dead = self.liveness.dead_members()
        with self._lock:
            out = {}
            for jobid, rec in self._replicas.items():
                if model_id is not None and rec.get("model_id") != model_id:
                    continue
                out[jobid] = {**rec, **self._reports.get(jobid, {}),
                              "alive": jobid not in dead,
                              "straggler": jobid in suspects}
            return out

    def models_snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            by_model: Dict[str, List[str]] = {}
            for jobid, rec in self._replicas.items():
                by_model.setdefault(str(rec.get("model_id")), []) \
                    .append(jobid)
            return {m: {**ptr, "replicas": sorted(by_model.get(m, []))}
                    for m, ptr in self._models.items()} | {
                m: {"ckpt_dir": None, "step": None, "replicas": sorted(js)}
                for m, js in by_model.items() if m not in self._models}

    def fleet_snapshot(self) -> Dict[str, Any]:
        """The ``/fleet`` body: per-replica health / load / heartbeat age
        / straggler flags plus the multi-model map."""
        now = time.monotonic()
        records = self.replica_records()
        with self._lock:
            beats = dict(self._last_beat)
        replicas = {}
        for jobid, rec in records.items():
            beat = beats.get(jobid)
            replicas[jobid] = {
                "addr": f"{rec.get('host')}:{rec.get('port')}",
                "model_id": rec.get("model_id"),
                "health": rec.get("health", "?"),
                "alive": rec.get("alive", True),
                "straggler": rec.get("straggler", False),
                "heartbeat_age_s": (round(now - beat, 3)
                                    if beat is not None else None),
                "queue_fraction": rec.get("queue_fraction", 0.0),
                "inflight": rec.get("inflight", 0),
                "qps": rec.get("qps", 0.0),
                "p99_ms": rec.get("p99_ms"),
                "step": rec.get("step"),
            }
        return {"schema": "dmlc.serving.fleet/1", "ts": time.time(),
                "heartbeat_timeout_s": self.heartbeat_timeout_s,
                "replicas": replicas, "models": self.models_snapshot()}

    def _history_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """What the fleet timeline samples: the registry's own registry
        plus snapshot-form gauges rolled up from replica heartbeats."""
        records = self.replica_records()
        alive = [r for r in records.values() if r.get("alive")]
        rollup = {
            "fleet.replicas.alive": float(len(alive)),
            "fleet.replicas.total": float(len(records)),
            "fleet.inflight.total": float(sum(
                r.get("inflight") or 0 for r in alive)),
            "fleet.qps.total": float(sum(r.get("qps") or 0.0
                                         for r in alive)),
            "fleet.queue_fraction.max": float(max(
                (r.get("queue_fraction") or 0.0 for r in alive),
                default=0.0)),
        }
        snap = dict(metrics.snapshot())
        for name, v in rollup.items():
            snap[name] = {"type": "gauge", "value": v}
        return snap

    # -- rollout plumbing ------------------------------------------------
    def push_directive(self, jobid: str, directive: dict) -> None:
        """Queue a directive for a replica's next heartbeat reply."""
        self._jlog("directive", jobid=jobid, directive=directive)
        with self._lock:
            self._directives.setdefault(jobid, []).append(directive)

    def stable_pointer(self, model_id: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._models.get(model_id) or {})

    def set_stable_pointer(self, model_id: str, ckpt_dir: Optional[str],
                           step: Optional[int]) -> None:
        self._jlog("model", model_id=model_id, ckpt_dir=ckpt_dir,
                   step=step)
        with self._lock:
            self._models[model_id] = {"ckpt_dir": ckpt_dir, "step": step}

    # -- liveness --------------------------------------------------------
    def _beat(self, jobid: str) -> None:
        self.liveness.beat(jobid)
        with self._lock:
            self._last_beat[jobid] = time.monotonic()

    def _sweep_loop(self) -> None:
        interval = max(0.05, self.heartbeat_timeout_s / 4.0)
        if self._lease is not None:
            interval = min(interval, max(0.05, self._lease.ttl_s / 3.0))
        while not self._stop_ev.wait(interval):
            for jobid, silence in self.liveness.sweep():
                metrics.counter("fleet.registry.dead_replicas").add(1)
                log_warning("fleet registry: replica %r silent for "
                            "%.1fs — declaring dead", jobid, silence)
            if self._lease is not None and not self._fenced:
                if not self._lease.refresh(self._owner,
                                           self._control_epoch):
                    self._fenced = True
                    log_warning("fleet registry %s: fenced by a "
                                "standby takeover (epoch %d "
                                "superseded) — refusing writes",
                                self._owner, self._control_epoch)
            if (self._journal is not None
                    and self._journal.appends_since_snapshot
                    >= self._journal_snap_every):
                self._compact()

    # -- request handling ------------------------------------------------
    def _on_conn(self, conn: socket.socket, _addr) -> None:
        serve_connection(self._handle, conn, name="fleet-registry-rpc")

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(30.0)
            msg = recv_json(conn.makefile("r"))
            if msg is None:
                return
            ctx = teltrace.from_wire(msg.get("trace_id"),
                                     msg.get("parent_span"))
            if ctx is not None:
                with teltrace.activate(ctx), \
                        teltrace.span("serving.fleet.rpc",
                                      cmd=msg.get("cmd")):
                    reply = self._dispatch(msg)
            else:
                reply = self._dispatch(msg)
            send_json(conn, reply)
        except (OSError, ValueError, KeyError, TypeError) as e:
            log_warning("fleet registry connection error: %s", e)
            try:
                send_json(conn, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    #: commands that mutate durable state — fenced once a standby takes
    #: over (reads keep flowing from a stale primary; writes must not)
    _WRITE_CMDS = frozenset({"register_replica", "deregister_replica",
                             "heartbeat", "set_model", "stage_rollout"})

    def _dispatch(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd in self._WRITE_CMDS:
            fenced = self._fence_error()
            if fenced is not None:
                return fenced
        reply = self._dispatch_cmd(msg)
        if isinstance(reply, dict):
            # every reply carries the fencing epoch: EndpointSet drops
            # replies stamped lower than the highest it has seen
            reply.setdefault("control_epoch", self._control_epoch)
        return reply

    def _dispatch_cmd(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd == "register_replica":
            return self._cmd_register(msg)
        if cmd == "deregister_replica":
            return self._cmd_deregister(msg)
        if cmd == "heartbeat":
            return self._cmd_heartbeat(msg)
        if cmd == "list_replicas":
            model = msg.get("model_id")
            recs = self.replica_records(model)
            return {"replicas": [
                {"jobid": j, "host": r.get("host"), "port": r.get("port"),
                 "health_port": r.get("health_port"),
                 "model_id": r.get("model_id"),
                 "health": r.get("health", "ok"),
                 "queue_fraction": r.get("queue_fraction", 0.0),
                 "inflight": r.get("inflight", 0),
                 "alive": r.get("alive", True),
                 "straggler": r.get("straggler", False),
                 "step": r.get("step")}
                for j, r in sorted(recs.items())]}
        if cmd == "set_model":
            self.set_stable_pointer(str(msg["model_id"]),
                                    msg.get("ckpt_dir"), msg.get("step"))
            return {"ok": True}
        if cmd == "models":
            return {"models": self.models_snapshot()}
        if cmd == "fleet":
            return self.fleet_snapshot()
        if cmd == "stage_rollout":
            return self.rollouts.stage(
                str(msg["model_id"]), str(msg["ckpt_dir"]),
                step=msg.get("step"), fraction=msg.get("fraction"),
                bake_s=msg.get("bake_s"))
        if cmd == "rollouts":
            return self.rollouts.snapshot()
        return {"error": f"unknown cmd {cmd!r}"}

    def _register(self, msg: dict) -> None:
        jobid = str(msg["jobid"])
        rec = {"host": str(msg["host"]), "port": int(msg["port"]),
               "health_port": msg.get("health_port"),
               "model_id": str(msg.get("model_id") or "default")}
        self._jlog("replica", jobid=jobid, **rec)
        with self._lock:
            self._replicas.setdefault(jobid, {}).update(rec)
            self._m_replicas.set(len(self._replicas))
        self._beat(jobid)

    def _cmd_register(self, msg: dict) -> dict:
        self._register(msg)
        log_info("fleet registry: replica %r registered at %s:%s "
                 "(model=%s)", msg["jobid"], msg["host"], msg["port"],
                 msg.get("model_id") or "default")
        return {"ok": True}

    def _cmd_deregister(self, msg: dict) -> dict:
        jobid = str(msg["jobid"])
        self._jlog("replica_gone", jobid=jobid)
        with self._lock:
            self._replicas.pop(jobid, None)
            self._reports.pop(jobid, None)
            self._directives.pop(jobid, None)
            self._last_beat.pop(jobid, None)
            self._m_replicas.set(len(self._replicas))
        self.liveness.forget(jobid)
        self.rollouts.on_replica_gone(jobid)
        return {"ok": True}

    def _cmd_heartbeat(self, msg: dict) -> dict:
        jobid = str(msg["jobid"])
        with self._lock:
            known = jobid in self._replicas
        if not known and "host" in msg and "port" in msg:
            # auto-registration: the first beat after a registry restart
            # (or a replica that skipped explicit registration) carries
            # its address — a heartbeat IS a registration
            self._register(msg)
            log_info("fleet registry: replica %r auto-registered via "
                     "heartbeat", jobid)
        self._beat(jobid)
        report = {k: msg[k] for k in _REPORT_KEYS if k in msg}
        with self._lock:
            if jobid in self._replicas:
                self._reports.setdefault(jobid, {}).update(report)
            directives = self._directives.pop(jobid, [])
        if directives:
            # journaled *after* the pop: a crash in between replays the
            # directives (at-least-once — reloads are idempotent and
            # acks dedup), never loses them.  count-based so a push
            # racing this drain keeps its queue position on replay.
            self._jlog("directives_drained", jobid=jobid,
                       count=len(directives))
        state = msg.get("state")
        if isinstance(state, dict):
            # metric push riding the heartbeat: feeds cross-replica
            # straggler detection, same as the data-service fleet
            self.straggler_board.update(jobid, state)
        for ack in msg.get("applied") or []:
            self.rollouts.on_ack(jobid, ack)
        return {"ok": True, "directives": directives}


class ReplicaAgent:
    """The replica-side half of the control plane, run inside a
    :class:`~dmlc_core_tpu_torch.serving.server.PredictionServer`
    process (its constructor builds one when ``DMLC_ROUTER_REGISTRY`` is
    set).

    Registers the replica, then heartbeats at ``DMLC_ROUTER_HEARTBEAT``
    cadence carrying the live ``/healthz`` body (health word,
    queue-depth fraction, inflight), serving p99, checkpoint step and a
    full metrics-state push; applies hot-reload directives carried in
    heartbeat replies and acks them on the next beat.  A dead registry
    never takes the replica down: failed beats log at most once per
    outage and the loop keeps probing (the next successful beat
    re-registers via the heartbeat auto-registration path).

    ``report_overrides`` lets tests and operators force report fields
    (e.g. ``{"slo_breaches": 1}`` to drill the canary auto-rollback).

    ``registry_addr`` accepts a single ``(host, port)`` tuple, a
    ``"host:port,host:port"`` string, or a list of either: beats walk
    the :class:`~dmlc_core_tpu_torch.transport.endpoints.EndpointSet` in
    sticky order, so a standby registry picks up the fleet's heartbeats
    the moment it takes over.
    """

    def __init__(self, server: Any, registry_addr: EndpointsLike, *,
                 jobid: Optional[str] = None,
                 model_id: Optional[str] = None,
                 interval_s: Optional[float] = None):
        self.server = server
        self.registry = EndpointSet(registry_addr,
                                    env_prefix="DMLC_ROUTER",
                                    name="fleet.agent")
        self.registry_addr = self.registry.primary
        self.jobid = jobid or f"replica-{server.host}:{server.port}"
        self.model_id = (model_id or getattr(server, "model_id", None)
                         or "default")
        if interval_s is None:
            interval_s = get_env("DMLC_ROUTER_HEARTBEAT", 1.0)
        self.interval_s = max(0.05, float(interval_s))
        self.report_overrides: Dict[str, Any] = {}
        self._acks: List[dict] = []
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registry_down = False

    # -- report assembly -------------------------------------------------
    def _report(self) -> Dict[str, Any]:
        doc = self.server.health_doc() if hasattr(self.server,
                                                  "health_doc") else {}
        snap = metrics.snapshot()
        lat = snap.get("serving.latency_s") or {}
        reqs = snap.get("serving.batcher.requests") or {}
        engine = getattr(self.server, "engine", None)
        report: Dict[str, Any] = {
            "jobid": self.jobid, "host": self.server.host,
            "port": self.server.port, "model_id": self.model_id,
            "health": doc.get("status", "ok"),
            "queue_fraction": doc.get("queue_fraction", 0.0),
            "queue_depth": doc.get("queue_depth", 0),
            "inflight": doc.get("inflight", 0),
            "p99_ms": float(lat.get("p99", 0.0) or 0.0) * 1e3,
            "qps": float(reqs.get("windowed_rate",
                                  reqs.get("rate", 0.0)) or 0.0),
            "step": getattr(self, "_step", None),
            "params_version": getattr(engine, "params_version", None),
            "slo_breaches": int(
                metrics.gauge("slo.active_breaches").value),
            "state": snap,
        }
        telemetry = getattr(self.server, "telemetry", None)
        if telemetry is not None:
            report["health_port"] = telemetry.port
        report.update(self.report_overrides)
        return report

    def _apply(self, directive: dict) -> None:
        kind = directive.get("kind")
        ack = {"rollout_id": directive.get("rollout_id"), "kind": kind}
        if kind == "reload":
            try:
                step = self.server.reload_from_checkpoint(
                    str(directive["ckpt_dir"]), directive.get("step"))
                self._step = step
                ack.update(ok=True, step=step)
            except Exception as e:  # noqa: BLE001 — a bad checkpoint must
                # not kill the replica; the registry learns via the ack
                ack.update(ok=False, error=str(e))
                log_warning("fleet agent %s: reload directive failed: "
                            "%s", self.jobid, e)
        else:
            ack.update(ok=False, error=f"unknown directive {kind!r}")
        with self._lock:
            self._acks.append(ack)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ReplicaAgent":
        try:
            self.registry.call(lambda addr: fleet_rpc(
                addr, {"cmd": "register_replica", **self._report()},
                timeout=5.0))
        except (OSError, DMLCError) as e:
            # heartbeat auto-registration picks this up once the
            # registry is reachable
            log_warning("fleet agent %s: registration deferred (%s)",
                        self.jobid, e)
        self._thread = threading.Thread(target=self._run,
                                        name=f"fleet-agent-{self.jobid}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self.registry.call(lambda addr: fleet_rpc(
                addr, {"cmd": "deregister_replica", "jobid": self.jobid},
                timeout=2.0))
        except (OSError, DMLCError):
            pass               # registry gone — its sweep will notice

    def _run(self) -> None:
        # jittered beats (±DMLC_HEARTBEAT_JITTER): a restarted registry
        # must not absorb every agent's re-registration in one instant
        while not self._stop_ev.wait(jittered(self.interval_s)):
            msg = {"cmd": "heartbeat", **self._report()}
            with self._lock:
                if self._acks:
                    msg["applied"], self._acks = self._acks, []
            try:
                reply = self.registry.call(
                    lambda addr: fleet_rpc(addr, msg, timeout=5.0))
            except (OSError, DMLCError) as e:
                if not self._registry_down:
                    self._registry_down = True
                    log_warning("fleet agent %s: heartbeat failed "
                                "(%s) — will keep probing", self.jobid, e)
                with self._lock:
                    # re-queue unacked directives' acks for the next beat
                    self._acks = msg.get("applied", []) + self._acks
                continue
            self._registry_down = False
            for directive in reply.get("directives") or []:
                self._apply(directive)


def registry_main(argv=None) -> int:
    """CLI: ``python -m dmlc_core_tpu_torch.serving.fleet.registry
    [host=H] [port=N] [journal=PREFIX] [standby=1]
    [heartbeat_timeout=S]``: serve until killed.

    The bound address is printed as one JSON line on stdout
    (``{"host": ..., "port": ...}``); SIGTERM is a clean stop (the
    journal compacted), SIGKILL the crash the journal exists for: a
    registry restarted on the same port and ``journal=`` resumes a
    rollout in flight."""
    import signal
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    kw = dict(a.split("=", 1) for a in args)
    reg = ReplicaRegistry(
        host=kw.get("host", "127.0.0.1"),
        port=int(kw.get("port", 0)),
        journal=kw.get("journal") or None,
        standby=kw.get("standby", "") not in ("", "0", "false"),
        heartbeat_timeout_s=(float(kw["heartbeat_timeout"])
                             if "heartbeat_timeout" in kw else None))
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())
    reg.start()
    print(json.dumps({"host": reg.host, "port": reg.port}), flush=True)
    try:
        while not done.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    reg.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(registry_main())
