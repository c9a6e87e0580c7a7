"""The port's launcher (``parallel/launcher/``: ``opts``, ``filecache``,
``local``, ``gpu``, ``submit``) against the JAX package's.

* The parser: the same ``Namespace`` as the JAX parser for the same
  command lines (every option the JAX tests use), and the same errors.
* ``filecache.resolve``: the same ``(files, archives, command)`` as the
  JAX function, auto-cache on and off.
* ``local``: end to end with a port rabit worker (JAX
  ``tests/test_tracker_rabit.py``'s ``test_local_launcher_end_to_end``),
  max-attempts exhaustion (JAX ``tests/test_launchers.py``'s), the PS
  mode's environment (its ``test_ps_mode_exports_scheduler_env``).
* ``gpu``: each worker's environment (``MASTER_ADDR`` /
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` = rank mod
  the cards, ``DMLC_ELASTIC_BASE_PORT`` from a run of free ports under
  ``--elastic``); elastic respawn with a bumped ``DMLC_NUM_ATTEMPT``,
  and a crash without ``--elastic`` failing fast (JAX
  ``test_tracker_rabit.py``'s tpu cases); ``initialize_torch_from_env``.
* Dry runs launch nothing; ``--cluster ssh|slurm|sge|mpi|yarn|mesos``
  and ``tpu`` are refused with a ``DMLCError`` before any tracker
  starts, on a dry run too.

Every tracker binds 127.0.0.1."""

import json
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.parallel.launcher import filecache as jfilecache  # noqa
from dmlc_core_tpu.parallel.launcher import opts as jopts  # noqa: E402
from dmlc_core_tpu_torch.parallel.launcher import (filecache, gpu,  # noqa
                                                   opts)
from dmlc_core_tpu_torch.parallel.launcher.submit import \
    submit as submit_job  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYPATH = f"PYTHONPATH={REPO}"

COMMAND_LINES = [
    ["--cluster", "local", "-n", "3", "--", "python", "w.py"],
    ["--cluster", "tpu", "-n", "3", "--elastic", "--max-attempts", "2",
     "--host-ip", "127.0.0.1", "--env", "A=1", "--env", "B=x=y", "--",
     "python", "examples/elastic_train.py", "data.libsvm"],
    ["-n", "2", "-s", "1", "--host-ip", "127.0.0.1", "python", "p.py"],
    ["--cluster", "slurm", "-n", "4", "--queue", "prod",
     "--slurm-worker-nodes", "3", "--slurm-server-nodes", "1",
     "--yarn-app-dir", "/stage/app", "--", "run"],
    ["--cluster", "sge", "-n", "2", "--queue", "prod", "--sge-queue",
     "special", "--sge-log-dir", "/tmp/logs", "--dry-run", "--", "run"],
    ["--cluster", "local", "-n", "1", "--worker-memory", "2g",
     "--server-memory", "512m", "--server-cores", "3", "--worker-cores",
     "2", "--jobname", "j", "--log-level", "DEBUG", "--", "run", "--x"],
    ["--cluster", "yarn", "-n", "2", "--yarn-queue", "q",
     "--yarn-app-classpath", "/cp", "--hdfs-tempdir", "/h",
     "--auto-file-cache", "false", "--", "run"],
    ["--cluster", "mesos", "-n", "2", "--mesos-master", "m:5050",
     "--host-file", "hosts", "--sync-dst-dir", "/d", "--log-file",
     "/tmp/l.log", "--", "run"],
]


@pytest.mark.parametrize("argv", COMMAND_LINES,
                         ids=[str(i) for i in range(len(COMMAND_LINES))])
def test_the_parser_gives_the_jax_namespace(argv, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert vars(opts.get_opts(argv)) == vars(jopts.get_opts(argv))
    assert vars(opts.build_parser().parse_args(argv)) == \
        vars(jopts.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["-n", "2"],                                  # no command
    ["-n", "2", "--env", "NOEQUALS", "--", "run"],
    ["-n", "2", "--worker-memory", "2t", "--", "run"],
    ["-n", "2", "--files", "/no/such/file", "--", "run"],
    ["--cluster", "nope", "-n", "2", "--", "run"],
])
def test_the_parser_refuses_what_the_jax_parser_refuses(argv):
    for mod in (opts, jopts):
        with pytest.raises(SystemExit):
            mod.get_opts(argv)


def test_the_env_defaults_match(monkeypatch):
    monkeypatch.setenv("DMLC_SUBMIT_CLUSTER", "local")
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "5")
    monkeypatch.setenv("DMLC_ELASTIC", "1")
    argv = ["-n", "1", "run"]
    got, want = opts.get_opts(argv), jopts.get_opts(argv)
    assert vars(got) == vars(want)
    assert got.max_attempts == 5 and got.elastic is True
    assert "gpu" in opts.CLUSTERS and set(jopts.CLUSTERS) < set(opts.CLUSTERS)


@pytest.mark.parametrize("auto", [True, False])
def test_filecache_resolve_equals_the_jax_one(tmp_path, monkeypatch, auto):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "train.py").write_text("print('hi')")
    (tmp_path / "conf.txt").write_text("x")
    (tmp_path / "lib.zip").write_bytes(b"PK")
    argv = ([sys.executable, "train.py", "conf.txt", "--lr", "0.1"],
            [str(tmp_path / "conf.txt"), "train.py"],
            ["lib.zip", "missing.tar"])
    got = filecache.resolve(*argv, auto_file_cache=auto)
    assert got == jfilecache.resolve(*argv, auto_file_cache=auto)
    if auto:
        assert got[2] == [sys.executable, "./train.py", "./conf.txt",
                          "--lr", "0.1"]


def test_filecache_staging_equals_the_jax_one(tmp_path):
    (tmp_path / "f.sh").write_text("echo")
    files, archives = [str(tmp_path / "f.sh")], [str(tmp_path / "a.tgz")]
    for mode in ("copy", "cwd"):
        assert filecache.stage_snippet(files, archives, mode) == \
            jfilecache.stage_snippet(files, archives, mode)
    filecache.stage_into(str(tmp_path / "stage"), files, [])
    assert (tmp_path / "stage" / "f.sh").read_text() == "echo"


# ---------------------------------------------------------------------------
# local
# ---------------------------------------------------------------------------

RABIT_WORKER = r"""
import numpy as np
from dmlc_core_tpu_torch.parallel import RabitContext
with RabitContext.from_env(heartbeat_interval=0) as rc:
    out = rc.allreduce(np.array([float(rc.rank + 1)]))
    assert out[0] == sum(range(1, rc.world_size + 1)), out
    rc.tracker_print(f"rank {rc.rank} ok")
"""


def _submit_cli(args, timeout=120, **kw):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.parallel.launcher.submit"]
        + args, cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=env, **kw)


def test_local_launcher_end_to_end_with_a_port_rabit_worker(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(RABIT_WORKER)
    out = _submit_cli(["--cluster", "local", "-n", "3", "--host-ip",
                       "127.0.0.1", sys.executable, str(script)])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "local job finished: all 3 processes exited cleanly" in out.stderr


def test_max_attempts_exhaustion_aborts_the_job(tmp_path):
    prog = tmp_path / "always_fail.py"
    counter = tmp_path / "attempts.txt"
    prog.write_text(
        "import os, sys\n"
        f"with open({str(counter)!r}, 'a') as f:\n"
        "    f.write(os.environ.get('DMLC_NUM_ATTEMPT', '?') + '\\n')\n"
        "sys.exit(9)\n")
    rc = submit_job(["--cluster", "local", "-n", "1", "--host-ip",
                     "127.0.0.1", "--max-attempts", "3", "--env", PYPATH,
                     "--", sys.executable, str(prog)])
    assert rc == 9
    assert counter.read_text().split() == ["0", "1", "2"]


def test_ps_mode_exports_scheduler_env(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\n"
        "assert os.environ['DMLC_PS_ROOT_URI'] == '127.0.0.1'\n"
        "assert int(os.environ['DMLC_PS_ROOT_PORT']) > 0\n"
        "assert os.environ['DMLC_NUM_SERVER'] == '1'\n")
    rc = submit_job(["--cluster", "local", "-n", "2", "-s", "1",
                     "--host-ip", "127.0.0.1", "--env", PYPATH, "--",
                     sys.executable, str(probe)])
    assert rc == 0


# ---------------------------------------------------------------------------
# gpu
# ---------------------------------------------------------------------------

ENV_DUMP = (
    "import json, os, sys\n"
    "keys = ['MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',\n"
    "        'LOCAL_RANK', 'DMLC_TASK_ID', 'DMLC_NUM_WORKER', 'DMLC_ROLE',\n"
    "        'DMLC_JOB_CLUSTER', 'DMLC_NUM_ATTEMPT', 'DMLC_TRACKER_URI',\n"
    "        'DMLC_ELASTIC_BASE_PORT', 'EXTRA']\n"
    "out = {k: os.environ.get(k) for k in keys}\n"
    "open(os.path.join(sys.argv[1], os.environ['RANK'] + '.json'), 'w')"
    ".write(json.dumps(out))\n")


@pytest.mark.parametrize("elastic", [False, True])
def test_gpu_workers_get_torchruns_environment(tmp_path, elastic):
    script = tmp_path / "dump.py"
    script.write_text(ENV_DUMP)
    out = _submit_cli(["--cluster", "gpu", "-n", "3", "--host-ip",
                       "127.0.0.1", "--env", "EXTRA=1"]
                      + (["--elastic"] if elastic else [])
                      + ["--", sys.executable, str(script), str(tmp_path)])
    assert out.returncode == 0, out.stderr[-2000:]
    envs = [json.loads((tmp_path / f"{r}.json").read_text())
            for r in range(3)]
    cards = gpu.card_count()
    for r, e in enumerate(envs):
        assert e["RANK"] == e["DMLC_TASK_ID"] == str(r)
        assert e["WORLD_SIZE"] == e["DMLC_NUM_WORKER"] == "3"
        assert e["LOCAL_RANK"] == str(r % cards if cards else r)
        assert e["MASTER_ADDR"] == "127.0.0.1" == e["DMLC_TRACKER_URI"]
        assert e["DMLC_ROLE"] == "worker" and e["DMLC_JOB_CLUSTER"] == "gpu"
        assert e["DMLC_NUM_ATTEMPT"] == "0" and e["EXTRA"] == "1"
    assert len({e["MASTER_PORT"] for e in envs}) == 1
    bases = {e["DMLC_ELASTIC_BASE_PORT"] for e in envs}
    assert bases == ({None} if not elastic else bases)
    if elastic:
        assert len(bases) == 1 and int(bases.pop()) > 0


def test_gpu_local_rank_is_the_rank_modulo_the_cards():
    args = opts.get_opts(["--cluster", "gpu", "-n", "6", "--env", "K=V",
                          "--", "run"])
    rdv = gpu.torch_rendezvous_env(6, "10.0.0.1", 1234)
    assert rdv == {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234",
                   "WORLD_SIZE": "6"}
    got = [gpu.worker_env(args, {"DMLC_TRACKER_URI": "t"}, r, rdv, 4, "777")
           for r in range(6)]
    assert [e["LOCAL_RANK"] for e in got] == ["0", "1", "2", "3", "0", "1"]
    assert all(e["DMLC_ELASTIC_BASE_PORT"] == "777" and e["K"] == "V"
               for e in got)
    assert "DMLC_ELASTIC_BASE_PORT" not in gpu.worker_env(
        args, {}, 0, rdv, 0, "")


def test_free_port_run_is_consecutive():
    import socket
    base = gpu._free_port_run(8)
    socks = []
    try:
        for i in range(9):
            s = socket.socket()
            s.bind(("", base + i))
            socks.append(s)
    finally:
        for s in socks:
            s.close()


CRASH_ONCE = (
    "import os, sys\n"
    "attempt = os.environ['DMLC_NUM_ATTEMPT']\n"
    "open(os.path.join(sys.argv[1], os.environ['RANK'] + '.' + attempt),"
    " 'w').close()\n"
    "sys.exit(3 if os.environ['RANK'] == '1' and attempt == '0' else 0)\n")


def test_gpu_elastic_respawns_a_crashed_worker(tmp_path):
    script = tmp_path / "crash.py"
    script.write_text(CRASH_ONCE)
    out = _submit_cli(["--cluster", "gpu", "-n", "2", "--elastic",
                       "--max-attempts", "2", "--host-ip", "127.0.0.1",
                       "--", sys.executable, str(script), str(tmp_path)])
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(p.name for p in tmp_path.iterdir() if p.name[0] in "01") \
        == ["0.0", "1.0", "1.1"]
    assert "gpu worker 1 exited rc=3 (attempt 1/2)" in out.stderr


def test_gpu_without_elastic_fails_fast(tmp_path):
    script = tmp_path / "crash.py"
    script.write_text(
        "import os, sys\n"
        "assert os.environ.get('DMLC_NUM_ATTEMPT', '0') == '0', "
        "'non-elastic job must never see a retry attempt'\n"
        "sys.exit(3 if os.environ['DMLC_TASK_ID'] == '1' else 0)\n")
    t0 = time.monotonic()
    out = _submit_cli(["--cluster", "gpu", "-n", "2", "--max-attempts", "3",
                       "--host-ip", "127.0.0.1", "--", sys.executable,
                       str(script)])
    assert out.returncode == 3, out.stderr[-1500:]
    assert time.monotonic() - t0 < 120


def test_initialize_torch_from_env(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert gpu.initialize_torch_from_env() is None
    if dist.is_initialized():
        pytest.skip("this process already has a process group")
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    mesh = gpu.initialize_torch_from_env(device="cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# dry runs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cluster", ["local", "gpu"])
def test_a_dry_run_launches_nothing(cluster, tmp_path):
    marker = tmp_path / "ran"
    rc = submit_job(["--cluster", cluster, "-n", "2", "-s", "1",
                     "--dry-run", "--host-ip", "127.0.0.1", "--",
                     sys.executable, "-c",
                     f"open({str(marker)!r}, 'w').close()"])
    assert rc == 0 and not marker.exists()


@pytest.mark.parametrize("cluster", ["ssh", "slurm", "sge", "mpi", "yarn",
                                     "mesos", "tpu"])
@pytest.mark.parametrize("dry", [False, True])
def test_unported_clusters_are_refused_before_the_tracker(cluster, dry,
                                                          monkeypatch):
    import importlib
    mod = importlib.import_module(
        "dmlc_core_tpu_torch.parallel.launcher.submit")

    def no_tracker(*a, **k):
        raise AssertionError("a tracker started")
    monkeypatch.setattr(mod, "RabitTracker", no_tracker)
    want = "--cluster gpu" if cluster == "tpu" else "A.7.c2"
    with pytest.raises(DMLCError, match=want):
        submit_job(["--cluster", cluster, "-n", "2", "--host-ip",
                    "127.0.0.1"] + (["--dry-run"] if dry else [])
                   + ["--", "definitely-not-a-real-binary"])


def test_the_cli_exits_2_on_a_refusal():
    out = _submit_cli(["--cluster", "yarn", "-n", "2", "--", "run"])
    assert out.returncode == 2
    assert "A.7.c2" in out.stderr and "Traceback" not in out.stderr
