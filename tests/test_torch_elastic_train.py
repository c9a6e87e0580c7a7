"""The port's elastic example (``python -m
dmlc_core_tpu_torch.examples.elastic_train``) against the JAX package's
``examples/elastic_train.py`` on one libsvm file, three ranks a cohort,
control plane only (``DMLC_ELASTIC_DATA_PLANE=0``), at
``tests/test_chaos.py``'s size: 512 features, dim 4, 64-row batches,
three epochs, both from the JAX ``init(PRNGKey(0))`` parameters.

* Without a crash, every rank's ``EPOCH`` loss agrees with the JAX
  cohort's within ``tests/test_torch_kstep.py``'s ``SWING_TOL[0.05]``
  (rtol 1e-2, atol 2e-4: Adam at lr 0.05 amplifies the packages'
  rounding differences), epoch by epoch.
* The chaos drill (``elastic.epoch:error=1.0:times=1:after=1`` on rank
  2, respawned with attempt 1): JAX ``test_chaos.py``'s assertions hold
  on the port (every epoch once on every rank, zero checkpoint reads,
  one loss and one digest an epoch, the reborn rank's join epoch
  rebuilt at generation 1 with its whole state from peers), and its
  losses match the JAX drill's within the same tolerance.
* The launcher drives the same example: ``--cluster gpu -n 3
  --elastic --max-attempts 2`` with ``--crash-rank 2 --crash-epoch 1``
  respawns the victim and exits 0.

The ranks are processes; the port's import no JAX."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu_torch.parallel import tracker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWING = dict(rtol=1e-2, atol=2e-4)    # test_torch_kstep.SWING_TOL[0.05]
FAULT = "elastic.epoch:error=1.0:times=1:after=1"
ARGS = ["--epochs", "3", "--features", "512", "--batch-rows", "64"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A libsvm file (ids below 3000, hashed to 512; balanced labels) and
    the JAX example's initial parameters as an ``.npz``."""
    from dmlc_core_tpu.models import FactorizationMachine
    tmp = tmp_path_factory.mktemp("elastic_train")
    rng = np.random.default_rng(0)
    w = rng.standard_normal(3000)
    path = tmp / "train.libsvm"
    with open(path, "w") as f:
        for _ in range(600):
            idx = np.sort(rng.choice(3000, size=int(rng.integers(2, 9)),
                                     replace=False))
            x = rng.random(len(idx))
            f.write(f"{int(w[idx] @ x > 0)} " + " ".join(
                f"{j}:{v:.4f}" for j, v in zip(idx, x)) + "\n")
    init = FactorizationMachine(num_features=512, dim=4).init(
        jax.random.PRNGKey(0))
    np.savez(tmp / "init.npz", **{k: np.asarray(v) for k, v in init.items()})
    return tmp, f"file://{path}", str(tmp / "init.npz")


def _cohort(tmp, name, cmd, fault=None):
    """Three ranks of ``cmd`` on a tracker of the port's; rank 2 armed
    with ``fault`` and respawned with attempt 1 once it exits 7.
    Returns ``(EPOCH records, [(stdout, stderr)] of every process)``."""
    run = tmp / name
    (run / "ckpt").mkdir(parents=True)
    t = tracker.RabitTracker(num_workers=3, host_ip="127.0.0.1")
    t.start()
    base = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
            **t.worker_envs(), "DMLC_ELASTIC_BASE_PORT": "1",
            "DMLC_ELASTIC_DATA_PLANE": "0",
            "DMLC_CHECKPOINT_DIR": str(run / "ckpt"),
            "DMLC_CONNECT_TIMEOUT": "120", "DMLC_RECOVER_TIMEOUT": "120",
            "OMP_NUM_THREADS": "1"}
    base.pop("DMLC_FAULT_SPEC", None)

    def spawn(i, attempt, spec=None):
        env = dict(base, DMLC_TASK_ID=f"c{i}", DMLC_NUM_ATTEMPT=str(attempt))
        if spec:
            env["DMLC_FAULT_SPEC"] = spec
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    procs = [spawn(i, 0, fault if i == 2 else None) for i in range(3)]
    outs = []
    try:
        if fault:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and procs[2].poll() is None:
                time.sleep(0.1)
            out, err = procs[2].communicate(timeout=10)
            assert procs[2].returncode == 7, err[-2000:]
            assert "CRASHING at epoch 1" in out
            outs.append((out, err))
            procs[2] = spawn(2, 1)
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        t.stop()
    recs = [json.loads(ln[6:]) for out, _ in outs
            for ln in out.splitlines() if ln.startswith("EPOCH ")]
    return recs, outs


def _jax_cmd():
    return [sys.executable, os.path.join(REPO, "examples", "elastic_train.py")]


def _port_cmd(init):
    return [sys.executable, "-m", "dmlc_core_tpu_torch.examples.elastic_train",
            "--device", "cpu", "--init", init]


@pytest.fixture(scope="module")
def runs(data):
    """Each cohort once a module, as it is first asked for."""
    tmp, uri, init = data
    cache = {}

    def get(pkg, fault):
        key = (pkg, fault)
        if key not in cache:
            cmd = (_jax_cmd() if pkg == "jax" else _port_cmd(init)) + \
                [uri] + ARGS
            cache[key] = _cohort(tmp, f"{pkg}_{int(bool(fault))}", cmd,
                                 fault)
        return cache[key]
    return get


def _losses(recs):
    return {(r["rank"], r["epoch"]): r["loss"] for r in recs}


def test_losses_match_the_jax_example_without_a_crash(runs):
    got, _ = runs("port", None)
    want, _ = runs("jax", None)
    assert len(got) == len(want) == 9
    g, w = _losses(got), _losses(want)
    assert sorted(g) == sorted(w)
    keys = sorted(w)
    np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys],
                               **SWING)
    for recs in (got, want):
        assert all(r["gen"] == 0 and not r["rebuilt"] and r["contributed"]
                   for r in recs)
    for e in range(3):
        assert len({r["digest"] for r in got if r["epoch"] == e}) == 1


def test_the_chaos_drill_holds_on_the_port(runs):
    """JAX ``test_chaos.py``'s assertions, on the port's example."""
    recs, outs = runs("port", FAULT)
    assert "reborn (attempt 1), resuming at epoch 1" in outs[-1][0]
    by_rank = {}
    for r in recs:
        by_rank.setdefault(r["rank"], []).append(r)
    assert sorted(by_rank) == [0, 1, 2]
    for rank, rs in by_rank.items():
        assert [r["epoch"] for r in rs] == [0, 1, 2], (rank, rs)
        assert all(r["from_ckpt"] == 0 for r in rs)
    for e in range(3):
        assert len({r["loss"] for r in recs if r["epoch"] == e}) == 1
        assert len({r["digest"] for r in recs if r["epoch"] == e}) == 1
    joins = [r for r in recs if not r["contributed"]]
    assert len(joins) == 1
    join = joins[0]
    assert join["epoch"] == 1 and join["rebuilt"] and join["gen"] == 1
    # params w0, w, v and adam's count, mu and nu of each: all from peers
    assert join["from_peers"] == 10
    assert join["bytes_moved"] == 3 * (4 + 512 * 4 + 512 * 4 * 4) + 4
    for rank, rs in by_rank.items():
        assert rs[1]["gen"] == 1 and rs[1]["rebuilt"]


def test_the_chaos_drill_matches_the_jax_drill(runs):
    got, _ = runs("port", FAULT)
    want, _ = runs("jax", FAULT)
    g, w = _losses(got), _losses(want)
    assert sorted(g) == sorted(w)
    keys = sorted(w)
    np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys],
                               **SWING)
    assert ({(r["rank"], r["epoch"], r["contributed"], r["gen"],
              r["from_peers"], r["from_ckpt"]) for r in got}
            == {(r["rank"], r["epoch"], r["contributed"], r["gen"],
                 r["from_peers"], r["from_ckpt"]) for r in want})


def test_the_gpu_launcher_respawns_the_crashed_rank(data, tmp_path):
    _, uri, init = data
    env = {**os.environ, "PYTHONPATH": REPO,
           "DMLC_ELASTIC_DATA_PLANE": "0",
           "DMLC_CHECKPOINT_DIR": str(tmp_path),
           "DMLC_CONNECT_TIMEOUT": "120", "DMLC_RECOVER_TIMEOUT": "120",
           "OMP_NUM_THREADS": "1"}
    env.pop("DMLC_FAULT_SPEC", None)
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.parallel.launcher.submit",
         "--cluster", "gpu", "-n", "3", "--elastic", "--max-attempts", "2",
         "--host-ip", "127.0.0.1", "--"] + _port_cmd(init) +
        [uri] + ARGS + ["--crash-rank", "2", "--crash-epoch", "1"],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-2500:])
    assert "gpu worker 2 exited rc=7 (attempt 1/2)" in out.stderr
    recs = [json.loads(ln[6:]) for ln in out.stdout.splitlines()
            if ln.startswith("EPOCH ")]
    assert sorted((r["rank"], r["epoch"]) for r in recs) == \
        [(r, e) for r in range(3) for e in range(3)]
    assert all(r["gen"] == (0 if r["epoch"] == 0 else 1) for r in recs)
