"""The port's fleet registry as a durable control plane, held against the
JAX package's on the CPU: its journal, fencing and warm standby, and the
registry CLI SIGKILLed mid-canary.

* Any prefix of a registry journal replays to a consistent state, and
  both packages' ``replay_registry_state`` give the same state on every
  prefix of a journal either package wrote (``tests/test_control_ha.py``
  run on both).
* A registry restarted on a journal the other package wrote (after a
  crash: no clean stop) restores the same membership, stable pointers,
  directive queues and rollouts, one ``control_epoch`` higher.
* Fencing: a primary whose lease a higher epoch took (written by either
  package's ``FencedLease``) refuses writes and keeps serving reads; a
  warm standby takes over an expired lease, across packages too.
* The drill: ``python -m dmlc_core_tpu_torch.serving.fleet.registry``
  SIGKILLed between a canary's ack and its promote, while two of the
  port's servers (joined through ``DMLC_ROUTER_REGISTRY``) answer a
  steady load; restarted on the same port and journal (by either
  package's CLI), it replays the rollout, the bake resumes, the promote
  lands exactly once, the fleet converges and no request fails.  Then
  SIGTERM: exit 0 and a compacted journal.  The JAX drill's router half
  waits for ROADMAP A.11.b.

Every wait is bounded; each subprocess is killed at the end.
"""

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.serving.fleet import registry as jregistry  # noqa: E402
from dmlc_core_tpu.utils import durable as jdurable  # noqa: E402
from dmlc_core_tpu_torch.parallel.launcher.gpu import \
    _free_port_run  # noqa: E402
from dmlc_core_tpu_torch.serving import PredictClient  # noqa: E402
from dmlc_core_tpu_torch.serving import PredictionServer  # noqa: E402
from dmlc_core_tpu_torch.serving.fleet import registry  # noqa: E402
from dmlc_core_tpu_torch.transport import endpoints  # noqa: E402
from dmlc_core_tpu_torch.utils import durable  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401
from test_torch_fleet import (_fm_engine, _fm_params, _req,  # noqa: E402
                              _save_ckpt, _Versions, _wait_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each package's registry module and durable module
PKGS = {"port": (registry, durable), "jax": (jregistry, jdurable)}
CLI = {"port": "dmlc_core_tpu_torch.serving.fleet.registry",
       "jax": "dmlc_core_tpu.serving.fleet.registry"}


def _assert_registry_consistent(state):
    assert int(state["control_epoch"]) >= 0
    for jobid, rec in state["replicas"].items():
        assert isinstance(jobid, str) and "host" in rec and "port" in rec
    for jobid, q in state["directives"].items():
        assert q, (jobid, "empty directive queue survived replay")
    ro = state["rollouts"]
    for model_id, r in ro["active"].items():
        assert r.get("id") and r.get("model_id") == model_id
        assert set(r.get("acked", [])) <= set(r.get("canaries", [])) | \
            set(r.get("acked", []))
    assert len(ro["ledger"]) <= 4096


def _journal_story(reg_mod, prefix):
    """The JAX prefix test's commands on a journaled registry of
    ``reg_mod``, left running; returns it, the rollout's canary and the
    rollout's id."""
    reg = reg_mod.ReplicaRegistry(heartbeat_timeout_s=60.0, journal=prefix)
    reg.start()
    addr = reg.address
    for i in (1, 2):
        registry.fleet_rpc(addr, {"cmd": "register_replica",
                                  "jobid": f"r{i}", "host": "127.0.0.1",
                                  "port": 9000 + i, "model_id": "default"})
    registry.fleet_rpc(addr, {"cmd": "set_model", "model_id": "default",
                              "ckpt_dir": "/ck/v1", "step": 1})
    staged = registry.fleet_rpc(addr, {"cmd": "stage_rollout",
                                       "model_id": "default",
                                       "ckpt_dir": "/ck/v2", "step": 2,
                                       "fraction": 0.5, "bake_s": 600.0})
    canary = staged["canaries"][0]
    # a heartbeat drains the reload directive, the next acks it
    hb = registry.fleet_rpc(addr, {"cmd": "heartbeat", "jobid": canary})
    assert [d["kind"] for d in hb["directives"]] == ["reload"]
    registry.fleet_rpc(addr, {"cmd": "heartbeat", "jobid": canary,
                              "applied": [{"rollout_id": staged["rollout_id"],
                                           "kind": "reload", "ok": True}]})
    registry.fleet_rpc(addr, {"cmd": "deregister_replica", "jobid": "r2"})
    # a directive still queued for r1 when the journal is read
    reg.push_directive("r1", {"kind": "reload", "rollout_id": "manual",
                              "ckpt_dir": "/ck/x", "step": 5})
    return reg, canary, staged["rollout_id"]


def _crash(reg):
    """Stop a registry as a crash would: no compaction, its lease left
    to expire."""
    reg._stop_ev.set()
    reg._listener.close()
    reg.rollouts.stop()
    for t in reg._threads:
        t.join(timeout=5.0)
    if reg._journal is not None:
        reg._journal.close()


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_any_registry_journal_prefix_replays_consistent(tmp_path, writer):
    """A crash can cut the registry log after ANY record: every prefix
    replays to a consistent state with a monotone ``control_epoch``, and
    the two packages' replays agree on each."""
    prefix = str(tmp_path / "reg" / "registry")
    reg, canary, _ = _journal_story(PKGS[writer][0], prefix)
    try:
        # read the journal BEFORE the clean stop compacts it away
        snap, records = durable.StateJournal(
            prefix, snap_schema=registry.REGISTRY_SNAP_SCHEMA).load()
        jsnap, jrecords = jdurable.StateJournal(
            prefix, snap_schema=jregistry.REGISTRY_SNAP_SCHEMA).load()
    finally:
        reg.stop()
    assert (snap, records) == (jsnap, jrecords)
    assert len(records) >= 8          # epoch / replica / model / rollout
    last_epoch = 0
    for k in range(len(records) + 1):
        state = registry.replay_registry_state(snap, records[:k])
        assert state == jregistry.replay_registry_state(snap, records[:k])
        _assert_registry_consistent(state)
        assert state["control_epoch"] >= last_epoch
        last_epoch = state["control_epoch"]
    full = registry.replay_registry_state(snap, records)
    assert set(full["replicas"]) == {"r1"}        # r2 deregistered
    assert full["models"]["default"]["ckpt_dir"] == "/ck/v1"
    ro = full["rollouts"]["active"]["default"]
    assert ro["canaries"] == [canary] and ro["acked"] == [canary]
    assert [d["rollout_id"] for d in full["directives"]["r1"]] == ["manual"]
    # the whole state as a snapshot replays alike in both packages
    snapshot = {"schema": registry.REGISTRY_SNAP_SCHEMA, **full}
    assert registry.replay_registry_state(snapshot, []) == full
    assert jregistry.replay_registry_state(snapshot, []) == full


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_registry_restores_a_crashed_registrys_journal(tmp_path, writer,
                                                       reader):
    prefix = str(tmp_path / "reg" / "registry")
    reg, canary, rid = _journal_story(PKGS[writer][0], prefix)
    epoch = reg._control_epoch
    want = (sorted(reg.replica_records()), reg.models_snapshot(),
            {j: list(q) for j, q in reg._directives.items()},
            reg.rollouts.durable_snapshot())
    _crash(reg)
    again = PKGS[reader][0].ReplicaRegistry(heartbeat_timeout_s=60.0,
                                            journal=prefix)
    again.start()
    try:
        got = (sorted(again.replica_records()), again.models_snapshot(),
               {j: list(q) for j, q in again._directives.items()},
               again.rollouts.durable_snapshot())
        assert got == want
        assert again._control_epoch == epoch + 1
        listing = registry.fleet_rpc(again.address, {"cmd": "rollouts"})
        ro = listing["active"]["default"]
        assert (ro["id"], ro["canaries"], ro["acked"]) == \
            (rid, [canary], [canary])
        assert listing["control_epoch"] == epoch + 1
    finally:
        again.stop()


@pytest.mark.parametrize("usurper", sorted(PKGS))
def test_stale_primary_writes_rejected_by_control_epoch(tmp_path, usurper):
    prefix = str(tmp_path / "fence" / "registry")
    lease_mod = PKGS[usurper][1]
    with registry.ReplicaRegistry(heartbeat_timeout_s=60.0,
                                  journal=prefix) as reg:
        reg.start()
        epoch = reg._control_epoch
        assert epoch >= 1
        registry.fleet_rpc(reg.address, {"cmd": "register_replica",
                                         "jobid": "r1", "host": "127.0.0.1",
                                         "port": 9001})
        # a standby took over: the shared lease now carries a higher
        # epoch than this (paused, partitioned, ...) primary's
        lease_mod.FencedLease(prefix + ".lease", ttl_s=60.0) \
            .refresh("usurper", epoch + 1)
        with pytest.raises(DMLCError, match="fenced"):
            registry.fleet_rpc(reg.address, {"cmd": "set_model",
                                             "model_id": "default",
                                             "ckpt_dir": "/ck", "step": 1})
        # reads keep flowing from the fenced primary, stamped with its
        # epoch, so an EndpointSet client refuses them
        listing = registry.fleet_rpc(reg.address, {"cmd": "list_replicas"})
        assert listing["control_epoch"] == epoch
        assert [r["jobid"] for r in listing["replicas"]] == ["r1"]


@pytest.mark.parametrize("primary_pkg,standby_pkg",
                         [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_warm_standby_takes_over_expired_lease(tmp_path, monkeypatch,
                                               primary_pkg, standby_pkg):
    # a lease of 1 s (the JAX test: 0.4 s): a primary stalled under load
    # for 0.4 s must not lose it before the crash
    monkeypatch.setenv("DMLC_CONTROL_LEASE_S", "1.0")
    prefix = str(tmp_path / "ha" / "registry")
    primary = PKGS[primary_pkg][0].ReplicaRegistry(heartbeat_timeout_s=60.0,
                                                   journal=prefix)
    primary.start()
    registry.fleet_rpc(primary.address, {"cmd": "register_replica",
                                         "jobid": "r1", "host": "127.0.0.1",
                                         "port": 9001, "model_id": "default"})
    epoch1 = primary._control_epoch
    standby = PKGS[standby_pkg][0].ReplicaRegistry(
        heartbeat_timeout_s=60.0, journal=prefix, standby=True)
    standby.start()
    try:
        # a standby refuses writes outright before it takes over
        with pytest.raises(DMLCError, match="standby"):
            registry.fleet_rpc(standby.address, {"cmd": "set_model",
                                                 "model_id": "default",
                                                 "ckpt_dir": "/ck",
                                                 "step": 1})
        _crash(primary)           # its lease simply stops being refreshed
        assert _wait_for(lambda: not standby.standby, timeout=10.0), \
            "standby never took over the expired lease"
        # the takeover replayed the shared journal and bumped the epoch
        es = endpoints.EndpointSet([primary.address, standby.address],
                                   name="ha.client")
        listing = es.call(lambda addr: registry.fleet_rpc(
            addr, {"cmd": "list_replicas"}, timeout=2.0))
        assert [r["jobid"] for r in listing["replicas"]] == ["r1"]
        assert listing["control_epoch"] > epoch1
        assert es.current() == standby.address
        ok = es.call(lambda addr: registry.fleet_rpc(
            addr, {"cmd": "set_model", "model_id": "default",
                   "ckpt_dir": "/ck/v2", "step": 2}, timeout=2.0))
        assert ok["ok"] and standby.stable_pointer(
            "default")["ckpt_dir"] == "/ck/v2"
    finally:
        standby.stop()


# ---------------------------------------------------------------------------
# the drill: the registry CLI SIGKILLed mid-canary
# ---------------------------------------------------------------------------

def _spawn_registry(pkg, tmp_path, **kw):
    """``python -m <registry CLI> k=v ...``; returns the process and the
    address of its JSON bind line (read within 60 s)."""
    log = open(tmp_path / f"registry_{pkg}_{time.monotonic_ns()}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", CLI[pkg]] + [f"{k}={v}" for k, v in kw.items()],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu",
                       "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=log, text=True)
    log.close()
    ready, _, _ = select.select([proc.stdout], [], [], 60.0)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"{CLI[pkg]} did not bind within 60 s")
    doc = json.loads(line)
    return proc, (str(doc["host"]), int(doc["port"]))


class _Load:
    """Two client threads sending fixed requests to every replica in
    turn until stopped; every answer and every failure is kept."""

    def __init__(self, servers, reqs):
        self.servers, self.reqs = servers, reqs
        self.answers, self.failures = [], []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(2)]
        for t in self._threads:
            t.start()

    def _run(self):
        clients = [PredictClient(s.host, s.port) for s in self.servers]
        try:
            k = 0
            while not self._stop.is_set():
                for i, c in enumerate(clients):
                    j = k % len(self.reqs)
                    try:
                        got = c.predict(*self.reqs[j], timeout=30)
                    except Exception as e:  # noqa: BLE001 — counted
                        self.failures.append(repr(e))
                        continue
                    self.answers.append((i, j, got))
                k += 1
        finally:
            for c in clients:
                c.close()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)
        return not any(t.is_alive() for t in self._threads)


@pytest.mark.parametrize("restart_pkg", sorted(CLI))
def test_registry_sigkilled_mid_canary_exactly_once_promote(
        tmp_path, monkeypatch, restart_pkg):
    """The port's registry CLI dies between the canary's ack and the
    promote, under load; restarted on the same port and journal (by
    ``restart_pkg``'s CLI) it replays the canary set and the pending ack,
    the bake runs again and the promote lands exactly once."""
    monkeypatch.setenv("DMLC_ROUTER_HEARTBEAT", "0.1")
    # short breaker cooldowns: the agents re-attach soon after the restart
    monkeypatch.setenv("DMLC_ROUTER_BREAKER_COOLDOWN", "0.3")
    monkeypatch.setenv("DMLC_ROUTER_BREAKER_THRESHOLD", "3")
    params = {v: _fm_params(v) for v in (1, 2)}
    ck = {v: tmp_path / f"v{v}" for v in params}
    for v, p in params.items():
        _save_ckpt(ck[v], v, p)
    versions = _Versions(params)
    journal = str(tmp_path / "reg" / "registry")
    port = _free_port_run(0)
    proc, addr = _spawn_registry("port", tmp_path, host="127.0.0.1",
                                 port=port, journal=journal,
                                 heartbeat_timeout=5.0)
    assert addr == ("127.0.0.1", port)
    monkeypatch.setenv("DMLC_ROUTER_REGISTRY", f"127.0.0.1:{port}")
    servers, load = [], None
    try:
        registry.fleet_rpc(addr, {"cmd": "set_model", "model_id": "default",
                                  "ckpt_dir": str(ck[1]), "step": 1})
        for _ in range(2):
            servers.append(PredictionServer(_fm_engine(params[1]),
                                            warmup=False).start())
        assert _wait_for(lambda: len(registry.fleet_rpc(
            addr, {"cmd": "list_replicas"})["replicas"]) == 2)
        rng = np.random.default_rng(11)
        reqs = [_req(rng, rows=3) for _ in range(4)]
        engines = {v: _fm_engine(p) for v, p in params.items()}
        refs = [{v: e.predict(*r) for v, e in engines.items()} for r in reqs]
        load = _Load(servers, reqs)
        assert _wait_for(lambda: len(load.answers) >= 20)
        staged = registry.fleet_rpc(addr, {
            "cmd": "stage_rollout", "model_id": "default",
            "ckpt_dir": str(ck[2]), "step": 2, "fraction": 0.5,
            "bake_s": 3.0})
        canary = staged["canaries"][0]

        def canary_acked():
            ro = registry.fleet_rpc(addr, {"cmd": "rollouts"},
                                    timeout=2.0)["active"].get("default")
            return ro is not None and canary in ro["acked"]

        assert _wait_for(canary_acked, timeout=15.0), \
            "the canary never acked its reload"
        # -- the kill: acked, not yet promoted (a 3 s bake) --------------
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        proc, addr2 = _spawn_registry(restart_pkg, tmp_path,
                                      host="127.0.0.1", port=port,
                                      journal=journal, heartbeat_timeout=5.0)
        assert addr2 == addr
        # the replayed rollout holds the canary set and its ack
        ro = registry.fleet_rpc(addr, {"cmd": "rollouts"})["active"][
            "default"]
        assert ro["id"] == staged["rollout_id"]
        assert ro["canaries"] == [canary] and canary in ro["acked"]

        def promoted():
            doc = registry.fleet_rpc(addr, {"cmd": "rollouts"}, timeout=2.0)
            return not doc["active"] and any(
                e["event"] == "promoted" for e in doc["events"])

        assert _wait_for(promoted, timeout=30.0), \
            registry.fleet_rpc(addr, {"cmd": "rollouts"})
        doc = registry.fleet_rpc(addr, {"cmd": "rollouts"})
        events = Counter((e["event"], e["rollout_id"]) for e in doc["events"])
        rid = staged["rollout_id"]
        assert events[("promoted", rid)] == 1     # exactly once
        assert events[("staged", rid)] == 1
        assert sum(events.values()) == 2
        assert registry.fleet_rpc(addr, {"cmd": "models"})["models"][
            "default"]["ckpt_dir"] == str(ck[2])
        # the agents re-attached: each beat the new registry
        assert _wait_for(lambda: all(
            r["health"] != "?" for r in registry.fleet_rpc(
                addr, {"cmd": "fleet"})["replicas"].values()), timeout=15.0)
        # the fleet converges on v2 (the promote reloaded the rest)
        assert _wait_for(lambda: [versions.of(s) for s in servers] ==
                         [2, 2], timeout=20.0)
        n_before = len(load.answers)
        assert _wait_for(lambda: len(load.answers) >= n_before + 8)
        assert load.stop(), "a client thread wedged"
        # -- no request failed through the whole drill ---------------------
        assert load.failures == []
        seen = {1: set(), 2: set()}
        for i, j, got in load.answers:
            for v, ref in refs[j].items():
                if np.allclose(got, ref, rtol=1e-6, atol=1e-6):
                    seen[v].add(i)
                    break
            else:
                raise AssertionError(f"replica {i}: an answer of neither "
                                     f"version")
        assert seen == {1: {0, 1}, 2: {0, 1}}
        # -- SIGTERM: a clean stop, the journal compacted ------------------
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        snap, records = durable.StateJournal(
            journal, snap_schema=registry.REGISTRY_SNAP_SCHEMA).load()
        assert records == [] and snap["models"]["default"]["step"] == 2
    finally:
        if load is not None:
            load.stop()
        for s in servers:
            s.stop()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
