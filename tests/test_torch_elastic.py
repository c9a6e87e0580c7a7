"""The port's elastic mesh (``parallel/elastic.py``, ``ElasticTorchMesh``)
against the JAX package's ``ElasticJaxMesh``.

* The rejoin (JAX ``tests/test_tracker_rabit.py``'s
  ``test_elastic_jax_mesh_rejoin_after_kill`` on the port): three gloo
  processes on the CPU and the port's tracker; rank 2 exits 7 after the
  first generation's collectives and is respawned with
  ``DMLC_NUM_ATTEMPT=1``; every rank reaches generation 1, where an
  all-reduce and an all-gather over the rebuilt group are exact (small
  integers in float32), the reborn rank receives the survivors' state
  from peers (``array_equal``, no checkpoint), and the torn-down
  generation 0's ``Mesh`` raises, naming its generation.  Run three
  ways: by default (the redistribute overlaps each rebuild:
  ``elastic.reshard_overlaps`` one a join), ``DMLC_RESHARD_OVERLAP=0``
  (sequential: 0) and ``DMLC_RESHARD=0`` (rebuild only: no state, no
  stats), as the JAX package behaves.
* A mixed cohort, control plane only (``DMLC_ELASTIC_DATA_PLANE=0``):
  ``ElasticJaxMesh`` and ``ElasticTorchMesh`` threads on one tracker
  agree the same generations at every sync point, and a state held by
  one package's ranks reaches a reborn rank of the other.
* A call on a closed generation's ``Mesh`` raises a ``DMLCError`` that
  names the generation: collectives (at any axis size),
  ``make_train_step(mesh=)`` and ``make_train_step_kbatch(mesh=)``.

Ranks are processes (the rejoin) or threads; the worker processes import
no JAX.  Every tracker binds 127.0.0.1 and is stopped."""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.parallel import elastic as jelastic  # noqa: E402
from dmlc_core_tpu.parallel import rabit as jrabit  # noqa: E402
from dmlc_core_tpu.parallel import reshard as jreshard  # noqa: E402
from dmlc_core_tpu.utils import logging as jlogging  # noqa: E402
from dmlc_core_tpu_torch.parallel import (ElasticTorchMesh,  # noqa: E402
                                          StateHandle, allgather,
                                          allreduce, make_mesh, rabit,
                                          tracker)
from dmlc_core_tpu_torch.parallel import elastic  # noqa: E402
from dmlc_core_tpu_torch.utils import logging as tlogging  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _log_context():
    yield
    tlogging.set_log_context(rank=None)
    jlogging.set_log_context(rank=None)


WORKER = r'''
import faulthandler, json, os, sys
faulthandler.dump_traceback_later(100, exit=True)   # a hang shows its stacks
import numpy as np
import torch
from dmlc_core_tpu_torch.parallel import (ElasticTorchMesh, RabitContext,
                                          StateHandle, allgather, allreduce)
from dmlc_core_tpu_torch.utils.logging import DMLCError
from dmlc_core_tpu_torch.utils.metrics import metrics

STATE = {"w": np.arange(12, dtype=np.float32).reshape(4, 3),
         "step": np.int32(7)}
attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
ctx = RabitContext.from_env(heartbeat_interval=0)
if attempt > 0:
    # LoadCheckPoint: the reborn rank's seq lines up with the survivors'
    assert ctx.load_checkpoint() == {"phase": 1}
box = {"state": None if attempt else STATE}
mesh = ElasticTorchMesh(ctx, device="cpu")
mesh.register_state(StateHandle(lambda: box["state"], template=STATE))
out = {"rank": ctx.rank, "attempt": attempt}
if attempt == 0:
    mesh.initialize()
    assert mesh.generation == 0 and mesh.mesh.generation == 0
    g0 = mesh.mesh
    s = allreduce(torch.tensor([float(ctx.rank + 1)]), g0)
    assert float(s) == 6.0, s
    rows = ctx.allreduce(np.array([100.0], np.float32))
    assert float(rows[0]) == 300.0
    ctx.checkpoint({"phase": 1})
    if ctx.rank == 2:
        print("DYING", flush=True)
        os._exit(7)                      # crash: no shutdown, no goodbye
    res = mesh.resync()                  # sync point: survivors rebuild
    assert res, "survivors must observe the bumped generation"
    try:
        allreduce(torch.ones(1), g0)
        out["old_generation"] = "ran"
    except DMLCError as e:
        out["old_generation"] = str(e)
else:
    res = mesh.resync()                  # the reborn rank's join
assert mesh.generation == 1 and mesh.mesh.generation == 1
x = torch.full((3,), 10.0 * (ctx.rank + 1))
out["allreduce"] = allreduce(x, mesh.mesh).tolist()
out["allgather"] = allgather(x[:1], mesh.mesh).tolist()
out["rebuilt"] = bool(res)
out["state_equal"] = (None if res.state is None else all(
    np.array_equal(res.state[k], STATE[k]) for k in STATE))
out["stats"] = None if res.stats is None else res.stats.as_dict()
out["overlaps"] = metrics.counter("elastic.reshard_overlaps").value
out["timings"] = mesh.timings
mesh.close()
assert mesh.mesh is None and mesh.generation == -1
ctx.shutdown()
print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port_pair():
    for _ in range(20):
        s0, s1 = socket.socket(), socket.socket()
        try:
            s0.bind(("127.0.0.1", 0))
            p = s0.getsockname()[1]
            s1.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
        finally:
            s0.close()
            s1.close()
    raise OSError("no two consecutive free ports")


@pytest.mark.parametrize("variant", ["overlap", "sequential", "no_reshard"])
def test_rejoin_after_kill_rebuilds_the_gloo_group(tmp_path, variant):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    t = tracker.RabitTracker(num_workers=3, host_ip="127.0.0.1")
    t.start()
    env = {**os.environ, **t.worker_envs(), "PYTHONPATH": REPO,
           "DMLC_ELASTIC_BASE_PORT": str(_free_port_pair()),
           "DMLC_CHECKPOINT_DIR": str(tmp_path),
           "DMLC_CONNECT_TIMEOUT": "120", "DMLC_RECOVER_TIMEOUT": "120",
           "OMP_NUM_THREADS": "1"}
    for k in ("DMLC_RESHARD", "DMLC_RESHARD_OVERLAP",
              "DMLC_ELASTIC_DATA_PLANE", "DMLC_FAULT_SPEC"):
        env.pop(k, None)
    if variant == "sequential":
        env["DMLC_RESHARD_OVERLAP"] = "0"
    if variant == "no_reshard":
        env["DMLC_RESHARD"] = "0"

    def spawn(rank, attempt):
        log = open(tmp_path / f"r{rank}_a{attempt}.log", "w+")
        return subprocess.Popen(
            [sys.executable, str(script)],
            env=dict(env, DMLC_TASK_ID=str(rank),
                     DMLC_NUM_ATTEMPT=str(attempt)),
            stdout=log, stderr=subprocess.STDOUT, text=True), log

    procs = {i: spawn(i, 0) for i in range(3)}
    try:
        assert procs[2][0].wait(timeout=120) == 7   # crashed as scripted
        procs[2] = spawn(2, 1)                      # launcher-style retry
        for p, _ in procs.values():
            p.wait(timeout=120)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        t.stop()
    texts = {}
    for i, (p, log) in procs.items():
        log.seek(0)
        texts[i] = log.read()
        log.close()
    bad = {i: p.returncode for i, (p, _) in procs.items() if p.returncode}
    assert not bad, (bad, {i: texts[i][-6000:] for i in texts})
    outs = {i: json.loads(next(ln for ln in texts[i].splitlines()
                               if ln.startswith("RESULT "))[7:])
            for i in texts}
    for i, o in outs.items():
        assert o["rank"] == i and o["rebuilt"]
        assert o["allreduce"] == [60.0] * 3
        assert o["allgather"] == [10.0, 20.0, 30.0]
        # a survivor joined generations 0 and 1, the reborn rank 1 only
        assert o["overlaps"] == ((2 if i < 2 else 1) if variant == "overlap"
                                 else 0)
        if i < 2:
            assert "mesh generation 0 is closed" in o["old_generation"]
        if variant == "no_reshard":
            assert o["state_equal"] is None and o["stats"] is None
            continue
        assert o["state_equal"] is True
        st = o["stats"]
        assert st["leaves_from_checkpoint"] == 0 and st["world"] == 3
        if i == 2:
            assert st["leaves_from_peers"] == 2
            assert st["bytes_moved"] == 12 * 4 + 4
        else:
            assert st["leaves_local"] == 2 and st["bytes_moved"] == 0
    assert outs[2]["attempt"] == 1


# ---------------------------------------------------------------------------
# a mixed cohort on the control plane
# ---------------------------------------------------------------------------

MESHES = {"port": (ElasticTorchMesh, rabit.RabitContext, StateHandle),
          "jax": (jelastic.ElasticJaxMesh, jrabit.RabitContext,
                  jreshard.StateHandle)}


@pytest.mark.parametrize("kinds", [["jax", "port", "port"],
                                   ["port", "jax", "jax"]])
def test_a_mixed_cohort_agrees_the_same_generations(monkeypatch, kinds):
    """Rank 2 holds no state (a reborn rank's position) and proposes a
    bump: every rank, of either package, moves to generation 1 at the
    same sync point, and rank 2 gets the others' state; then a quiet
    sync point keeps generation 1 everywhere."""
    monkeypatch.setenv("DMLC_ELASTIC_DATA_PLANE", "0")
    monkeypatch.delenv("DMLC_NUM_ATTEMPT", raising=False)
    state = {"v": np.arange(20, dtype=np.float32).reshape(5, 4),
             "n": np.int32(3)}
    t = tracker.RabitTracker(num_workers=3, host_ip="127.0.0.1")
    t.start()
    got, errors = {}, []

    def worker(i):
        cls, ctx_cls, handle_cls = MESHES[kinds[i]]
        ctx = ctx_cls("127.0.0.1", t.port, jobid=f"w{i}",
                      heartbeat_interval=0)
        try:
            mesh = cls(ctx, base_port=1)
            box = {"state": state if ctx.rank != 2 else None}
            mesh.register_state(handle_cls(lambda: box["state"],
                                           template=state))
            mesh.initialize()
            gens = [mesh.generation]
            if ctx.rank == 2:
                mesh.mark_failed()
            res = mesh.resync()
            gens.append(mesh.generation)
            quiet = mesh.resync()
            gens.append(mesh.generation)
            got[ctx.rank] = (gens, bool(res), bool(quiet), res.state,
                             kinds[i])
            mesh.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            ctx.shutdown()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    t.stop()
    assert not errors, errors
    assert sorted({k for *_, k in got.values()}) == ["jax", "port"]
    for rank, (gens, rebuilt, quiet, restored, _) in got.items():
        assert gens == [0, 1, 1] and rebuilt and not quiet
        for k in state:
            np.testing.assert_array_equal(restored[k], state[k])


# ---------------------------------------------------------------------------
# a closed generation raises
# ---------------------------------------------------------------------------

def test_calls_on_a_closed_generation_raise():
    from dmlc_core_tpu_torch import FactorizationMachine, adam
    from dmlc_core_tpu_torch.models import (make_train_step,
                                            make_train_step_kbatch)
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("this process already has a process group")
    mesh = make_mesh("dp=-1", device="cpu")
    mesh.generation = 4
    model = FactorizationMachine(16, 2, device="cpu")
    opt = adam(model, 1e-2)
    step = make_train_step(model, opt, mesh)
    kstep = make_train_step_kbatch(model, opt, mesh)
    batch = {"ids": torch.tensor([1, 3], dtype=torch.int32),
             "vals": torch.ones(2), "segments": torch.tensor(
                 [0, 1], dtype=torch.int32),
             "row_ptr": torch.tensor([0, 1, 2], dtype=torch.int32),
             "labels": torch.tensor([0.0, 1.0]), "weights": torch.ones(2)}
    step(batch)                                   # open: runs
    assert float(allreduce(torch.ones(1), mesh)) == 1.0
    mesh.close()
    assert mesh.closed and "closed" in repr(mesh)
    for call in (lambda: allreduce(torch.ones(1), mesh),
                 lambda: allgather(torch.ones(1), mesh),
                 lambda: mesh.group("dp"), lambda: mesh.world_group,
                 lambda: step(batch),
                 lambda: kstep({k: v[None] for k, v in batch.items()})):
        with pytest.raises(DMLCError, match="mesh generation 4 is closed"):
            call()


def test_a_closed_mesh_outside_a_generation_says_so():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("this process already has a process group")
    mesh = make_mesh("dp=-1", device="cpu")
    mesh.close()
    with pytest.raises(DMLCError, match="this mesh is closed"):
        allreduce(torch.ones(1), mesh)


def test_the_environment_defaults_match_the_jax_package(monkeypatch):
    for k in ("DMLC_RESHARD", "DMLC_ELASTIC_DATA_PLANE"):
        monkeypatch.delenv(k, raising=False)
    assert elastic._reshard_enabled() is jelastic._reshard_enabled() is True
    assert elastic._data_plane_enabled() is \
        jelastic._data_plane_enabled() is True
    monkeypatch.setenv("DMLC_RESHARD", "0")
    monkeypatch.setenv("DMLC_ELASTIC_DATA_PLANE", "false")
    assert elastic._reshard_enabled() is jelastic._reshard_enabled() is False
    assert elastic._data_plane_enabled() is \
        jelastic._data_plane_enabled() is False
    with pytest.raises(DMLCError, match="base_port"):
        monkeypatch.delenv("DMLC_ELASTIC_BASE_PORT", raising=False)
        ElasticTorchMesh(type("Ctx", (), {"world_size": 1, "rank": 0})())
