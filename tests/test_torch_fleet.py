"""The port's serving fleet control plane (``dmlc_core_tpu_torch/serving/
fleet/``: ``ReplicaRegistry``, ``ReplicaAgent``, ``fleet_rpc``,
``RolloutManager``) held against the JAX package's on the CPU, with real
TCP on loopback.

* The JAX registry tests (``tests/test_serving_fleet.py``: membership,
  the multi-model map and liveness; directives and acks; one rollout a
  model) on every pairing of the two packages' registries and agents.
* The JAX canary test (promote on a clean bake, roll back on an SLO
  breach, the ledger at ``/rollouts`` and in a flight bundle) over the
  port's ``PredictionServer`` and a small FM, under either package's
  registry, and then a checkpoint of the wrong shape: the canary's engine
  refuses the reload, its ack says so and the rollout rolls back, while
  the canary goes on answering with the stable checkpoint.
* One command sequence sent to both packages' registries: the same
  replies, fleet snapshots, rollout ledgers and ``/fleet`` and
  ``/rollouts`` bodies, apart from the wall clock and the ages.

Scores are the FM's within ``TOL`` of the version's own engine (float32
sums in the same order: the same engine on the same weights).
"""

import http.client
import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.serving.fleet import registry as jregistry  # noqa: E402
from dmlc_core_tpu.telemetry import flight as jflight  # noqa: E402
from dmlc_core_tpu_torch.models import FactorizationMachine  # noqa: E402
from dmlc_core_tpu_torch.serving import (BucketLadder,  # noqa: E402
                                         InferenceEngine, PredictionServer)
from dmlc_core_tpu_torch.serving.fleet import registry  # noqa: E402
from dmlc_core_tpu_torch.telemetry import flight as tflight  # noqa: E402
from dmlc_core_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager)
from test_torch_exposition import history  # noqa: E402,F401

F, D = 3000, 8
TOL = dict(rtol=1e-6, atol=1e-6)
REGISTRIES = {"port": registry, "jax": jregistry}
FLIGHT = {"port": tflight, "jax": jflight}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _wait_for(cond, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


class _StubReplica:
    """Just enough of a PredictionServer for the agent and registry."""

    def __init__(self, host="127.0.0.1", port=1, model_id="default"):
        self.host, self.port, self.model_id = host, port, model_id
        self.engine = type("E", (), {"params_version": 1})()
        self.telemetry = None
        self.reloads = []

    def health_doc(self):
        return {"status": "ok", "queue_depth": 0,
                "queue_fraction": 0.0, "inflight": 0}

    def reload_from_checkpoint(self, directory, step=None):
        self.reloads.append((directory, step))
        return step or 0


# ---------------------------------------------------------------------------
# the registry's control plane, across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reg_pkg,agent_pkg", PAIRS)
def test_registry_membership_multi_model_and_liveness(reg_pkg, agent_pkg):
    reg_mod, agent_mod = REGISTRIES[reg_pkg], REGISTRIES[agent_pkg]
    with reg_mod.ReplicaRegistry(heartbeat_timeout_s=0.4) as reg:
        reg.start()
        a1 = agent_mod.ReplicaAgent(_StubReplica(port=1001, model_id="m1"),
                                    reg.address, interval_s=0.1).start()
        a2 = agent_mod.ReplicaAgent(_StubReplica(port=1002, model_id="m2"),
                                    reg.address, interval_s=0.1).start()
        assert _wait_for(lambda: len(reg.replica_records()) == 2)
        # the multi-model map: list_replicas filters by model
        only_m1 = registry.fleet_rpc(reg.address, {
            "cmd": "list_replicas", "model_id": "m1"})["replicas"]
        assert [r["jobid"] for r in only_m1] == ["replica-127.0.0.1:1001"]
        models = registry.fleet_rpc(reg.address, {"cmd": "models"})["models"]
        assert set(models) == {"m1", "m2"}
        # a heartbeat from an UNKNOWN jobid carrying an address registers
        reply = registry.fleet_rpc(reg.address, {
            "cmd": "heartbeat", "jobid": "ghost", "host": "127.0.0.1",
            "port": 1003, "model_id": "m1", "health": "ok"})
        assert reply["ok"] and "ghost" in reg.replica_records()
        # silence: the ghost never beats again and is declared dead
        assert _wait_for(
            lambda: not reg.replica_records()["ghost"]["alive"],
            timeout=5.0)
        # the agents keep beating and stay alive through the sweep
        assert reg.replica_records()["replica-127.0.0.1:1001"]["alive"]
        # deregistering removes the record
        a2.stop()
        assert _wait_for(
            lambda: "replica-127.0.0.1:1002" not in reg.replica_records())
        a1.stop()


@pytest.mark.parametrize("reg_pkg,agent_pkg", PAIRS)
def test_registry_queues_directives_and_collects_acks(reg_pkg, agent_pkg):
    reg_mod, agent_mod = REGISTRIES[reg_pkg], REGISTRIES[agent_pkg]
    with reg_mod.ReplicaRegistry(heartbeat_timeout_s=2.0) as reg:
        reg.start()
        acks = []
        on_ack = reg.rollouts.on_ack
        reg.rollouts.on_ack = lambda j, ack: (acks.append((j, ack)),
                                              on_ack(j, ack))
        stub = _StubReplica(port=1005)
        ag = agent_mod.ReplicaAgent(stub, reg.address,
                                    interval_s=0.05).start()
        assert _wait_for(lambda: len(reg.replica_records()) == 1)
        reg.push_directive(ag.jobid, {"kind": "reload", "rollout_id": "x",
                                      "ckpt_dir": "/tmp/ck", "step": 9})
        # the directive rides a heartbeat reply and lands on the stub; its
        # ack rides the next beat
        assert _wait_for(lambda: stub.reloads == [("/tmp/ck", 9)])
        assert _wait_for(lambda: len(acks) == 1)
        # an unknown directive is acked as a failure, and the agent lives
        reg.push_directive(ag.jobid, {"kind": "explode", "rollout_id": "y"})
        assert _wait_for(lambda: len(acks) == 2)
        assert acks == [
            (ag.jobid, {"rollout_id": "x", "kind": "reload", "ok": True,
                        "step": 9}),
            (ag.jobid, {"rollout_id": "y", "kind": "explode", "ok": False,
                        "error": "unknown directive 'explode'"})]
        assert stub.reloads == [("/tmp/ck", 9)]
        assert reg.replica_records()[ag.jobid]["alive"]
        ag.stop()


@pytest.mark.parametrize("reg_pkg", sorted(REGISTRIES))
def test_rollout_rejects_double_stage_and_no_replicas(reg_pkg):
    with REGISTRIES[reg_pkg].ReplicaRegistry(heartbeat_timeout_s=2.0) as reg:
        reg.start()
        out = reg.rollouts.stage("default", "/tmp/ck")
        assert "error" in out            # no live replica
        stub = _StubReplica(port=1009)
        ag = registry.ReplicaAgent(stub, reg.address, interval_s=0.05).start()
        assert _wait_for(lambda: len(reg.replica_records()) == 1)
        first = reg.rollouts.stage("default", "/tmp/ck", bake_s=30.0)
        assert "rollout_id" in first
        second = reg.rollouts.stage("default", "/tmp/ck2")
        assert "error" in second         # one in flight a model
        ag.stop()


# ---------------------------------------------------------------------------
# the bake's judgement, against the JAX manager's
# ---------------------------------------------------------------------------

class _StubFleet:
    """What a RolloutManager asks of its registry, over fixed records."""

    def __init__(self, records):
        self.records = records
        self.pushed, self.pointer = [], {"ckpt_dir": "/ck/v1", "step": 1}

    def replica_records(self, model_id=None):
        return {j: dict(r) for j, r in self.records.items()}

    def push_directive(self, jobid, directive):
        self.pushed.append((jobid, directive))

    def stable_pointer(self, model_id):
        return dict(self.pointer)

    def set_stable_pointer(self, model_id, ckpt_dir, step):
        self.pointer = {"ckpt_dir": ckpt_dir, "step": step}


def _rec(alive=True, p99=1.0, breaches=0):
    return {"alive": alive, "p99_ms": p99, "slo_breaches": breaches}


#: (records of r1..r3 once staged, the canary's ack, the bake, seconds to
#: age the rollout by); r1 is the canary.  Before its ack a canary's p99
#: describes the old checkpoint and is not judged.
BAKES = {
    "clean": ({}, True, 0.0, 0.0),
    "baking": ({}, True, 600.0, 0.0),
    "p99 breach": ({"r1": _rec(p99=10.0), "r2": _rec(p99=2.0),
                    "r3": _rec(p99=4.0)}, True, 600.0, 0.0),
    "p99 under the noise floor": ({"r1": _rec(p99=0.9),
                                   "r2": _rec(p99=0.1)}, True, 0.0, 0.0),
    "p99 before the ack": ({"r1": _rec(p99=50.0)}, None, 600.0, 0.0),
    "slo breach": ({"r1": _rec(breaches=2)}, None, 600.0, 0.0),
    "dead canary": ({"r1": _rec(alive=False)}, None, 600.0, 0.0),
    "failed reload": ({}, False, 600.0, 0.0),
    "never acked": ({}, None, 1.0, 20.0),
    "dead control group": ({"r2": _rec(alive=False, p99=0.0),
                            "r3": _rec(alive=False, p99=0.0),
                            "r1": _rec(p99=30.0)}, True, 0.0, 0.0),
}


def _bake(mod, case):
    overrides, ack, bake, age = BAKES[case]
    fleet = _StubFleet({j: _rec() for j in ("r1", "r2", "r3")})
    mgr = mod.RolloutManager(fleet, p99_ratio=1.5)
    st = mgr.stage("default", "/ck/v2", step=2, fraction=0.3, bake_s=bake)
    assert st["canaries"] == ["r1"]
    fleet.records.update(overrides)
    if ack is not None:
        mgr.on_ack("r1", {"rollout_id": st["rollout_id"], "ok": ack,
                          "error": None if ack else "bad shape"})
    mgr._active["default"]["staged_at"] -= age
    mgr.evaluate_once()
    return (_stable(mgr.snapshot()), fleet.pushed, fleet.pointer,
            _stable(mgr.durable_snapshot()))


@pytest.mark.parametrize("case", sorted(BAKES))
def test_bake_judges_as_jax_does(case):
    """Each breach rule (a failed reload, an SLO breach, a dead canary,
    the canary's p99 over 1.5 times the control group's above the 1 ms
    noise floor, canaries that never ack) and a clean bake: the port's
    manager reaches the JAX manager's outcome, ledger and directives."""
    from dmlc_core_tpu.serving.fleet import rollout as jrollout
    from dmlc_core_tpu_torch.serving.fleet import rollout
    got = _bake(rollout, case)
    assert got == _bake(jrollout, case)
    snap, pushed, pointer, _ = got
    last = snap["events"][-1]
    if case in ("clean", "p99 under the noise floor", "dead control group"):
        assert last["event"] == "promoted" and pointer["step"] == 2
        assert [j for j, _ in pushed] == ["r1", "r2", "r3"][:1 + len(
            last["reloaded"])]
    elif case in ("baking", "p99 before the ack"):
        assert last["event"] == "staged" and snap["active"]
    else:
        assert last["event"] == "rolled_back" and pointer["step"] == 1
        assert not snap["active"]
        assert pushed[-1] == ("r1", {"kind": "reload",
                                     "rollout_id": "ro-1-rollback",
                                     "ckpt_dir": "/ck/v1", "step": 1})


# ---------------------------------------------------------------------------
# canary rollouts over the port's server
# ---------------------------------------------------------------------------

def _fm_params(seed, dim=D):
    rng = np.random.default_rng(seed)
    return {"w0": np.asarray(0.1 * seed, np.float32),
            "w": (rng.normal(size=F) * 0.3).astype(np.float32),
            "v": (rng.normal(size=(F, dim)) * 0.2).astype(np.float32)}


def _fm_engine(params, dim=D):
    return InferenceEngine(FactorizationMachine(F, dim, device="cpu"),
                           params, device="cpu", postprocess="sigmoid",
                           buckets=BucketLadder([(16, 512)]))


def _save_ckpt(directory, step, params):
    CheckpointManager(str(directory)).save(step, {"params": params},
                                           meta={"model": "fm"})


def _req(rng, rows=4, nnz_per_row=16):
    counts = rng.integers(1, nnz_per_row + 1, size=rows)
    ids = rng.integers(0, F, size=int(counts.sum())).astype(np.int32)
    vals = rng.random(len(ids), dtype=np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return ids, vals, row_ptr


def _http_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    try:
        conn.request("GET", path)
        rsp = conn.getresponse()
        return rsp.status, json.loads(rsp.read())
    finally:
        conn.close()


class _Versions:
    """Which checkpoint a replica serves: its scores on a fixed request
    held against each version's own engine."""

    def __init__(self, versions):
        self.req = _req(np.random.default_rng(5), rows=3)
        self.refs = {v: _fm_engine(p).predict(*self.req)
                     for v, p in versions.items()}

    def of(self, srv):
        got = srv.engine.predict(*self.req)
        hits = [v for v, ref in self.refs.items()
                if np.allclose(got, ref, **TOL)]
        assert len(hits) == 1, (got, self.refs)
        return hits[0]


@pytest.mark.parametrize("reg_pkg", sorted(REGISTRIES))
def test_canary_promote_on_pass_and_rollback_on_breach(tmp_path, reg_pkg,
                                                       monkeypatch):
    """The replicas join through ``DMLC_ROUTER_REGISTRY``: each server
    arms its own agent, started and deregistered with it."""
    params = {v: _fm_params(v) for v in (1, 2, 3)}
    ck = {v: tmp_path / f"v{v}" for v in params}
    for v, p in params.items():
        _save_ckpt(ck[v], v, p)
    ck_bad = tmp_path / "bad"            # an FM of another width
    _save_ckpt(ck_bad, 4, _fm_params(4, dim=D // 2))
    versions = _Versions(params)
    reg = REGISTRIES[reg_pkg].ReplicaRegistry(
        heartbeat_timeout_s=2.0, telemetry_port=0).start()
    monkeypatch.setenv("DMLC_ROUTER_REGISTRY", f"{reg.host}:{reg.port}")
    monkeypatch.setenv("DMLC_ROUTER_HEARTBEAT", "0.1")
    pairs = []
    try:
        for _ in range(2):
            srv = PredictionServer(_fm_engine(params[1]), metrics_port=0,
                                   warmup=False).start()
            pairs.append((srv, srv._agent))
        registry.fleet_rpc(reg.address, {
            "cmd": "set_model", "model_id": "default",
            "ckpt_dir": str(ck[1]), "step": 1})
        assert _wait_for(lambda: len(reg.replica_records()) == 2)
        listing = registry.fleet_rpc(reg.address, {"cmd": "list_replicas"})
        assert sorted(r["health_port"] for r in listing["replicas"]) == \
            sorted(srv.telemetry.port for srv, _ in pairs)

        def fleet_versions():
            return sorted(versions.of(srv) for srv, _ in pairs)

        assert fleet_versions() == [1, 1]
        # -- promote on a clean bake -------------------------------------
        staged = registry.fleet_rpc(reg.address, {
            "cmd": "stage_rollout", "model_id": "default",
            "ckpt_dir": str(ck[2]), "step": 2, "fraction": 0.5,
            "bake_s": 0.4})
        assert len(staged["canaries"]) == 1
        assert _wait_for(lambda: fleet_versions() == [2, 2], timeout=15.0), \
            fleet_versions()
        assert reg.stable_pointer("default")["ckpt_dir"] == str(ck[2])
        status, doc = _http_json(reg.telemetry.port, "/rollouts")
        assert status == 200
        assert [e["event"] for e in doc["events"]] == ["staged",
                                                       "promoted"]
        # -- roll back on an SLO breach the canary reports ---------------
        canary = staged["canaries"][0]
        canary_agent = next(ag for _, ag in pairs if ag.jobid == canary)
        canary_agent.report_overrides = {"slo_breaches": 1}
        staged2 = registry.fleet_rpc(reg.address, {
            "cmd": "stage_rollout", "model_id": "default",
            "ckpt_dir": str(ck[3]), "step": 3, "fraction": 0.5,
            "bake_s": 5.0})
        assert staged2["canaries"] == [canary]
        assert _wait_for(
            lambda: any(e["event"] == "rolled_back"
                        for e in reg.rollouts.snapshot()["events"]),
            timeout=15.0)
        canary_agent.report_overrides = {}
        # the canary reloads the STABLE pointer (v2), not v3
        assert _wait_for(lambda: fleet_versions() == [2, 2], timeout=15.0), \
            fleet_versions()
        assert reg.stable_pointer("default")["ckpt_dir"] == str(ck[2])
        # -- roll back on a checkpoint the canary's engine refuses --------
        staged3 = registry.fleet_rpc(reg.address, {
            "cmd": "stage_rollout", "model_id": "default",
            "ckpt_dir": str(ck_bad), "step": 4, "fraction": 0.5,
            "bake_s": 5.0})
        assert staged3["canaries"] == [canary]
        seen = set()

        def rolled_back():
            seen.add(versions.of(pairs[0][0]))
            seen.add(versions.of(pairs[1][0]))
            return [e for e in reg.rollouts.snapshot()["events"]
                    if e["event"] == "rolled_back"
                    and e["rollout_id"] == staged3["rollout_id"]]

        assert _wait_for(rolled_back, timeout=15.0)
        reason = rolled_back()[0]["reason"]
        assert reason.startswith(f"reload failed on ['{canary}']"), reason
        assert seen == {2} and fleet_versions() == [2, 2]
        assert reg.stable_pointer("default")["ckpt_dir"] == str(ck[2])
        # every transition in the ledger AND in a flight bundle
        _, doc = _http_json(reg.telemetry.port, "/rollouts")
        events = [e["event"] for e in doc["events"]]
        assert events == ["staged", "promoted", "staged", "rolled_back",
                          "staged", "rolled_back"]
        bundle = FLIGHT[reg_pkg].flight_recorder.bundle("test")
        assert [e["event"] for e in bundle["rollout_ledger"]["events"]] == \
            events
    finally:
        for srv, _ in pairs:
            srv.stop()
        left = reg.replica_records()
        reg.stop()
    for _, ag in pairs:
        assert not ag._thread.is_alive()
    assert left == {}                     # each server deregistered


# ---------------------------------------------------------------------------
# one command sequence, both registries
# ---------------------------------------------------------------------------

#: fields that hold the wall clock or an age: they differ between runs
_VOLATILE = ("ts", "heartbeat_age_s", "elapsed_s")


def _stable(doc):
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, (list, tuple)):
        return [_stable(v) for v in doc]
    return doc


def _command_story(mod):
    """Registration by command and by heartbeat, reports, two models, a
    rollout promoted, one rolled back on a failed ack, a deregistration,
    the read commands and an unknown one, on one registry of ``mod``
    (its watch loop stopped: the passes run here, in order)."""
    out = []
    reg = mod.ReplicaRegistry(heartbeat_timeout_s=60.0, telemetry_port=0)
    reg.start()
    reg.rollouts.stop()
    try:
        def rpc(msg):
            try:
                reply = registry.fleet_rpc(reg.address, msg)
            except Exception as e:  # noqa: BLE001 — the error is compared
                reply = {"raised": type(e).__name__, "msg": str(e)}
            out.append(_stable(reply))
            return reply

        for i, model in ((1, "m1"), (2, "m1"), (3, "m2")):
            rpc({"cmd": "register_replica", "jobid": f"r{i}",
                 "host": "127.0.0.1", "port": 9000 + i, "model_id": model,
                 "health_port": 9100 + i})
        rpc({"cmd": "heartbeat", "jobid": "r4", "host": "127.0.0.1",
             "port": 9004, "model_id": "m2"})
        for i in (1, 2, 3, 4):
            rpc({"cmd": "heartbeat", "jobid": f"r{i}", "health": "ok",
                 "qps": 10.0 * i, "p99_ms": 2.0 + i, "inflight": i,
                 "queue_fraction": 0.25, "step": 1, "ignored": True})
        rpc({"cmd": "set_model", "model_id": "m1", "ckpt_dir": "/ck/v1",
             "step": 1})
        rpc({"cmd": "list_replicas"})
        rpc({"cmd": "list_replicas", "model_id": "m2"})
        rpc({"cmd": "models"})
        staged = rpc({"cmd": "stage_rollout", "model_id": "m1",
                      "ckpt_dir": "/ck/v2", "step": 2, "fraction": 0.5,
                      "bake_s": 0.0})
        rpc({"cmd": "stage_rollout", "model_id": "m1", "ckpt_dir": "/x"})
        rpc({"cmd": "stage_rollout", "model_id": "none", "ckpt_dir": "/x"})
        canary = staged["canaries"][0]
        rpc({"cmd": "heartbeat", "jobid": canary})          # the directive
        rpc({"cmd": "rollouts"})
        rpc({"cmd": "heartbeat", "jobid": canary, "applied": [
            {"rollout_id": staged["rollout_id"], "kind": "reload",
             "ok": True, "step": 2}]})
        reg.rollouts.evaluate_once()                         # promote
        rpc({"cmd": "heartbeat", "jobid": "r2"})             # its reload
        staged = rpc({"cmd": "stage_rollout", "model_id": "m2",
                      "ckpt_dir": "/ck/m2", "step": 7, "fraction": 1.0,
                      "bake_s": 0.0})
        for jobid in staged["canaries"]:
            rpc({"cmd": "heartbeat", "jobid": jobid, "applied": [
                {"rollout_id": staged["rollout_id"], "kind": "reload",
                 "ok": False, "error": "bad shape"}]})
        reg.rollouts.evaluate_once()                         # roll back
        rpc({"cmd": "deregister_replica", "jobid": "r3"})
        rpc({"cmd": "models"})
        rpc({"cmd": "rollouts"})
        rpc({"cmd": "fleet"})
        rpc({"cmd": "nope"})
        rpc({"no": "cmd"})
        out.append(_stable(reg.fleet_snapshot()))
        out.append(_stable(reg.rollouts.snapshot()))
        out.append(_stable(reg.rollouts.durable_snapshot()))
        for path in ("/fleet", "/rollouts"):
            out.append(_stable(_http_json(reg.telemetry.port, path)))
    finally:
        reg.stop()
    return out


def test_registries_answer_a_command_sequence_alike():
    port, ref = _command_story(registry), _command_story(jregistry)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, a, b)
    # the story reached what it meant to: a promote and a rollback
    events = [e["event"] for e in port[-1][1]["events"]]
    assert events == ["staged", "promoted", "staged", "rolled_back"]
