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
* The cluster backends without a card (``wrapper``, ``bootstrap``,
  ``batch``, ``ssh``, ``mesos``, ``yarn``, ``yarn_am``): the JAX
  ``tests/test_launchers.py`` cases on the port's modules with its fakes
  (ssh and rsync run locally, a dead host exits 255, a fake ``hadoop``,
  a fake ResourceManager), the wrappers' and commands' bytes equal to
  the JAX package's, ``fixup_env``'s ``DMLC_*`` keys equal to the JAX
  one's beside the torch keys.
* A dry run of every cluster launches nothing; ``tpu`` is refused with
  a ``DMLCError`` naming ``gpu`` before any tracker starts, on a dry run
  too.

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


def _ephemeral_low():
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


@pytest.mark.parametrize("length", [0, 1, 8])
def test_free_port_run_lies_below_the_ephemeral_range(length):
    """A run a store binds later must lie wholly below the range the
    kernel draws outgoing connections' ports from: a port-0 bind's port
    (the old draw) lies inside it, and any connection made before the
    store binds may hold it (EADDRINUSE at a rejoin).  ``_free_port``
    (``MASTER_PORT``) is the run of one."""
    low = _ephemeral_low()
    draws = [gpu._free_port_run(length) for _ in range(20)]
    if length == 0:
        draws.append(gpu._free_port())
    for base in draws:
        assert 1024 <= base and base + length < low, (base, length, low)
    assert len(set(draws)) > 1          # drawn at random, not one fixed run


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

@pytest.mark.parametrize("cluster", ["local", "gpu", "ssh", "slurm", "sge",
                                     "mpi", "yarn", "mesos"])
def test_a_dry_run_launches_nothing(cluster, tmp_path, monkeypatch):
    # no scheduler binary may run: an empty PATH beside the interpreter
    monkeypatch.setenv("PATH", str(tmp_path))
    marker = tmp_path / "ran"
    rc = submit_job(["--cluster", cluster, "-n", "2", "-s", "1",
                     "--dry-run", "--host-ip", "127.0.0.1", "--",
                     sys.executable, "-c",
                     f"open({str(marker)!r}, 'w').close()"])
    assert rc == 0 and not marker.exists()


@pytest.mark.parametrize("cluster", ["tpu"])
@pytest.mark.parametrize("dry", [False, True])
def test_unported_clusters_are_refused_before_the_tracker(cluster, dry,
                                                          monkeypatch):
    import importlib
    mod = importlib.import_module(
        "dmlc_core_tpu_torch.parallel.launcher.submit")

    def no_tracker(*a, **k):
        raise AssertionError("a tracker started")
    monkeypatch.setattr(mod, "RabitTracker", no_tracker)
    with pytest.raises(DMLCError, match="--cluster gpu"):
        submit_job(["--cluster", cluster, "-n", "2", "--host-ip",
                    "127.0.0.1"] + (["--dry-run"] if dry else [])
                   + ["--", "definitely-not-a-real-binary"])


def test_the_cli_exits_2_on_a_refusal():
    out = _submit_cli(["--cluster", "tpu", "-n", "2", "--", "run"])
    assert out.returncode == 2
    assert "--cluster gpu" in out.stderr and "Traceback" not in out.stderr


# ---------------------------------------------------------------------------
# the cluster backends without a card (ssh, slurm, sge, mpi, yarn, mesos),
# held against the JAX package: JAX tests/test_launchers.py's cases
# ---------------------------------------------------------------------------

from dmlc_core_tpu.parallel.launcher import bootstrap as jbootstrap  # noqa
from dmlc_core_tpu.parallel.launcher import mesos as jmesos  # noqa: E402
from dmlc_core_tpu.parallel.launcher import wrapper as jwrapper  # noqa
from dmlc_core_tpu.parallel.launcher import yarn as jyarn  # noqa: E402
from dmlc_core_tpu_torch.parallel.launcher import (batch,  # noqa: E402
                                                   bootstrap, mesos, ssh,
                                                   wrapper, yarn, yarn_am)
from test_torch_embed_train import fake_ssh_bin  # noqa: E402

ENVS = {"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": "9091"}


def _args(cluster, extra=(), mod=opts):
    return mod.get_opts([
        "--cluster", cluster, "-n", "3", "-s", "1", "--jobname", "jobx",
        *extra, "--", "python", "train.py", "--lr", "0.1"])


def _yarn_script(args, envs=ENVS, mod=yarn):
    cmd = mod.build_yarn_command(args, envs)
    path = cmd[cmd.index("-shell_script") + 1]
    with open(path) as f:
        body = f.read()
    return cmd, path, body


def _run_script(path, container, **kw):
    return subprocess.run(
        ["bash", path], env={**os.environ, "CONTAINER_ID":
                             f"container_1700000000001_0001_01_{container}"},
        capture_output=True, text=True, timeout=60, **kw)


@pytest.mark.parametrize("cluster, snippet, stage_mode", [
    ("slurm", 'export DMLC_TASK_ID="${SLURM_PROCID}"', "copy"),
    ("sge", 'export DMLC_TASK_ID="$((SGE_TASK_ID - 1))"', "copy"),
    ("yarn", yarn._RANK_SNIPPET, "cwd"),
])
def test_the_wrapper_is_the_jax_wrapper(cluster, snippet, stage_mode,
                                        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "w.bin").write_text("x")
    extra = ["--files", "w.bin", "--max-attempts", "3", "--env", "K=V x",
             "--worker-memory", "2g", "--server-cores", "3"]
    args, jargs = _args(cluster, extra), _args(cluster, extra, jopts)
    assert wrapper.wrapper_body(args, ENVS, cluster, snippet, stage_mode) \
        == jwrapper.wrapper_body(jargs, ENVS, cluster, snippet, stage_mode)
    assert wrapper.job_env(args, ENVS, cluster) == \
        jwrapper.job_env(jargs, ENVS, cluster)
    assert wrapper.retry_loop("run x", oneline=True) == \
        jwrapper.retry_loop("run x", oneline=True)
    path = wrapper.write_wrapper_script(args, ENVS, cluster, snippet)
    try:
        assert os.access(path, os.X_OK)
        assert open(path).read() == wrapper.wrapper_body(args, ENVS, cluster,
                                                         snippet)
    finally:
        os.unlink(path)


def test_yarn_command_shape_equals_the_jax_one():
    args = _args("yarn", ["--yarn-queue", "prod", "--worker-memory-mb",
                          "2048", "--worker-cores", "4"])
    cmd, path, body = _yarn_script(args)
    jcmd, jpath, jbody = _yarn_script(
        _args("yarn", ["--yarn-queue", "prod", "--worker-memory-mb", "2048",
                       "--worker-cores", "4"], jopts), mod=jyarn)
    os.unlink(path)
    os.unlink(jpath)
    assert body == jbody
    i = cmd.index("-shell_script") + 1
    assert cmd[:i] + cmd[i + 1:] == jcmd[:i] + jcmd[i + 1:]
    joined = " ".join(cmd)
    assert "distributedshell.Client" in joined
    assert "-num_containers 4" in joined          # 3 workers + 1 server
    assert "-container_memory 2048" in joined
    assert "-container_vcores 4" in joined
    assert "-queue prod" in joined and "-appname jobx" in joined
    assert "export DMLC_TRACKER_URI=10.0.0.1" in body
    assert "export DMLC_NUM_WORKER=3" in body
    assert "export DMLC_NUM_SERVER=1" in body
    assert 'DMLC_NUM_ATTEMPT="$attempt" python train.py --lr 0.1' in body


@pytest.mark.parametrize("container, want", [
    ("000002", ["0", "server"]), ("000005", ["3", "worker"])])
def test_yarn_wrapper_rank_and_role(container, want):
    _, path, body = _yarn_script(_args("yarn"))
    with open(path, "w") as f:
        f.write(body.replace("python train.py --lr 0.1",
                             'echo "$DMLC_TASK_ID $DMLC_ROLE"; true'))
    try:
        assert _run_script(path, container).stdout.split() == want
    finally:
        os.unlink(path)


def test_yarn_out_of_range_container_fails_fast():
    _, path, _ = _yarn_script(_args("yarn"))
    try:
        out = _run_script(path, "000099")
        assert out.returncode == 1 and "outside cohort" in out.stderr
    finally:
        os.unlink(path)


def test_wrapper_retry_loop_drives_recover_protocol():
    args = opts.get_opts(["--cluster", "yarn", "-n", "2", "--max-attempts",
                          "3", "--", "bash", "-c",
                          'echo "att=$DMLC_NUM_ATTEMPT id=$DMLC_TASK_ID"; '
                          '[ "$DMLC_NUM_ATTEMPT" -ge 2 ]'])
    _, path, _ = _yarn_script(args)
    try:
        out = _run_script(path, "000002")
        assert out.returncode == 0
        assert out.stdout.splitlines() == ["att=0 id=0", "att=1 id=0",
                                           "att=2 id=0"]
    finally:
        os.unlink(path)


def test_wrapper_retry_exhaustion_propagates_rc():
    args = opts.get_opts(["--cluster", "yarn", "-n", "1", "--max-attempts",
                          "2", "--", "bash", "-c", "exit 7"])
    _, path, _ = _yarn_script(args)
    try:
        out = _run_script(path, "000002")
        assert out.returncode == 7
        assert out.stderr.count("exited rc=7") == 2
    finally:
        os.unlink(path)


def test_the_wrapper_skips_a_blacklisted_node():
    _, path, body = _yarn_script(_args("yarn"))
    host = subprocess.run(["hostname", "-s"], capture_output=True,
                          text=True).stdout.strip()
    try:
        out = subprocess.run(
            ["bash", path], capture_output=True, text=True, timeout=60,
            env={**os.environ, "DMLC_BLACKLISTED_NODES": f"other,{host}",
                 "CONTAINER_ID": "container_1700000000001_0001_01_000002"})
        assert out.returncode == 1 and "is blacklisted" in out.stderr
    finally:
        os.unlink(path)


def test_mesos_commands_equal_the_jax_ones():
    args = _args("mesos", ["--mesos-master", "master:5050"])
    cmds = mesos.build_mesos_commands(args, ENVS)
    assert cmds == jmesos.build_mesos_commands(
        _args("mesos", ["--mesos-master", "master:5050"], jopts), ENVS)
    assert len(cmds) == 4
    for tid, c in enumerate(cmds):
        assert c[0] == "mesos-execute" and "--master=master:5050" in c
        assert f"--name=jobx-task-{tid}" in c
        inline = next(a for a in c
                      if a.startswith("--command=")).split("=", 1)[1]
        assert "/tmp/" not in inline          # self-contained
        role = "server" if tid < 1 else "worker"
        assert f"export DMLC_TASK_ID={tid}" in inline
        assert f"export DMLC_ROLE={role}" in inline
        out = subprocess.run(
            ["bash", "-c", inline.replace(
                "python train.py --lr 0.1",
                "sh -c 'echo \"$DMLC_TASK_ID $DMLC_ROLE $DMLC_NUM_ATTEMPT\"'")],
            capture_output=True, text=True, timeout=60)
        assert out.stdout.split() == [str(tid), role, "0"]


def test_mesos_submit_runs_one_task_a_command(tmp_path, monkeypatch):
    log = tmp_path / "calls"
    fake = tmp_path / "mesos-execute"
    fake.write_text(f"#!/bin/bash\necho \"$2\" >> {log}\nexit 0\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    assert mesos.submit_mesos(_args("mesos"), ENVS) == 0
    assert sorted(log.read_text().split()) == [
        f"--name=jobx-task-{t}" for t in range(4)]


@pytest.mark.parametrize("cluster, binary, flags", [
    ("slurm", "srun", ["-n", "4"]),
    ("sge", "qsub", ["-t", "1-4", "-sync", "y"]),
    ("mpi", "mpirun", ["-n", "4"]),
])
def test_batch_submit_runs_the_scheduler_on_the_wrapper(cluster, binary,
                                                        flags, tmp_path,
                                                        monkeypatch):
    """A fake scheduler binary records its arguments and runs the wrapper
    as the scheduler's first task would."""
    log = tmp_path / "args"
    env_var = {"slurm": "SLURM_PROCID=0", "sge": "SGE_TASK_ID=1",
               "mpi": "OMPI_COMM_WORLD_RANK=0"}[cluster]
    fake = tmp_path / binary
    fake.write_text("#!/bin/bash\n"
                    f'printf "%s\\n" "$@" > {log}\n'
                    f'env {env_var} bash "${{@: -1}}"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    args = opts.get_opts(["--cluster", cluster, "-n", "3", "-s", "1", "--",
                          "bash", "-c",
                          f'echo "$DMLC_TASK_ID $DMLC_ROLE" > {tmp_path}/ran'])
    submit = {"slurm": batch.submit_slurm, "sge": batch.submit_sge,
              "mpi": batch.submit_mpi}[cluster]
    assert submit(args, ENVS) == 0
    called = log.read_text().split()
    assert all(f in called for f in flags), called
    assert not os.path.exists(called[-1])     # the wrapper is removed
    assert (tmp_path / "ran").read_text().split() == ["0", "server"]


def test_opts_memory_forms_and_server_resources():
    args = _args("local", ["--worker-memory", "2g", "--server-memory",
                           "512m", "--server-cores", "3"])
    env = wrapper.job_env(args, ENVS, "slurm")
    assert env["DMLC_SERVER_CORES"] == "3"
    assert env["DMLC_SERVER_MEMORY_MB"] == "512"
    assert env["DMLC_WORKER_MEMORY_MB"] == "2048"


def test_opts_generic_queue_and_slurm_nodes(monkeypatch):
    args = _args("slurm", ["--queue", "prod", "--slurm-worker-nodes", "3",
                           "--slurm-server-nodes", "1"])
    seen = {}
    monkeypatch.setattr(batch, "_launch",
                        lambda a, cmd, label, script: seen.update(cmd=cmd)
                        or os.unlink(script) or 0)
    batch.submit_slurm(args, dict(ENVS))
    cmd = seen["cmd"]
    assert cmd[cmd.index("-N") + 1] == "4"
    assert cmd[cmd.index("-p") + 1] == "prod"


def test_opts_sge_log_dir_forwarded(tmp_path, monkeypatch):
    args = _args("sge", ["--sge-log-dir", str(tmp_path), "--dry-run"])
    seen = {}
    orig = batch._launch

    def grab(args_, cmd, label, script):
        seen["cmd"] = cmd
        return orig(args_, cmd, label, script)

    monkeypatch.setattr(batch, "_launch", grab)
    assert batch.submit_sge(args, ENVS) == 0
    joined = " ".join(seen["cmd"])
    assert f"-o {tmp_path}" in joined and f"-e {tmp_path}" in joined


def test_yarn_ships_cache_via_shell_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data.txt").write_text("x")
    (tmp_path / "libs.zip").write_bytes(b"PK\x05\x06" + b"\x00" * 18)
    args = opts.get_opts(["--cluster", "yarn", "-n", "1", "--files",
                          "data.txt", "--archives", "libs.zip", "--",
                          "python", "-c", "pass"])
    cmd, path, body = _yarn_script(args)
    os.unlink(path)
    joined = " ".join(cmd)
    assert "-shell_files" in joined and str(tmp_path / "data.txt") in joined
    assert "unzip -oq ./libs.zip -d ." in body and "mktemp" not in body


def test_batch_wrapper_stages_and_cds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "w.bin").write_text("x")
    args = opts.get_opts(["--cluster", "slurm", "-n", "1", "--files",
                          "w.bin", "--", "python", "-c", "pass"])
    body = wrapper.wrapper_body(args, ENVS, "slurm", "export DMLC_TASK_ID=0")
    assert "mktemp -d" in body
    assert f"cp -f {tmp_path}/w.bin" in body
    assert 'cd "$DMLC_STAGE_DIR"' in body


# -- bootstrap ---------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {"SLURM_PROCID": "3", "DMLC_NUM_SERVER": "2", "DMLC_NUM_WORKER": "6"},
    {"SLURM_PROCID": "2", "DMLC_NUM_SERVER": "2", "DMLC_NUM_WORKER": "6"},
    {"SGE_TASK_ID": "1", "DMLC_NUM_SERVER": "2"},
    {"SGE_TASK_ID": "undefined"},
    {"OMPI_COMM_WORLD_RANK": "4", "DMLC_NUM_WORKER": "5"},
    {"PMI_RANK": "0"},
    {"DMLC_TASK_ID": "7", "SLURM_PROCID": "1", "DMLC_ROLE": "worker"},
    {"DMLC_TASK_ID": "1", "DMLC_NUM_SERVER": "1", "RANK": "9",
     "WORLD_SIZE": "12", "DMLC_NUM_WORKER": "3"},
], ids=lambda e: ",".join(sorted(e)))
def test_fixup_env_keeps_the_jax_dmlc_keys(env):
    """The DMLC_* keys equal the JAX bootstrap's; the worker's rank and
    the world follow it (RANK = task id - servers, workers only;
    WORLD_SIZE = DMLC_NUM_WORKER), where the JAX one fills
    JAX_PROCESS_ID / JAX_NUM_PROCESSES; an explicit value is kept."""
    got, want = bootstrap.fixup_env(env), jbootstrap.fixup_env(env)
    dmlc = {k: v for k, v in got.items() if k.startswith("DMLC_")}
    assert dmlc == {k: v for k, v in want.items() if k.startswith("DMLC_")}
    assert not any(k.startswith("JAX_") for k in got)
    if "RANK" in env:
        assert got["RANK"] == env["RANK"]
    elif "JAX_PROCESS_ID" in want:
        assert got["RANK"] == want["JAX_PROCESS_ID"]
    else:
        assert "RANK" not in got
    if "WORLD_SIZE" in env:
        assert got["WORLD_SIZE"] == env["WORLD_SIZE"]
    else:
        assert got.get("WORLD_SIZE") == want.get("JAX_NUM_PROCESSES")


def test_fixup_env_maps_workers_onto_ranks():
    e = bootstrap.fixup_env({"SLURM_PROCID": "3", "DMLC_NUM_SERVER": "2",
                             "DMLC_NUM_WORKER": "6"})
    assert (e["DMLC_TASK_ID"], e["DMLC_ROLE"], e["RANK"],
            e["WORLD_SIZE"]) == ("3", "worker", "1", "6")
    e = bootstrap.fixup_env({"SGE_TASK_ID": "1", "DMLC_NUM_SERVER": "2"})
    assert (e["DMLC_TASK_ID"], e["DMLC_ROLE"]) == ("0", "server")
    assert "RANK" not in e


def test_bootstrap_unpacks_and_execs(tmp_path):
    import zipfile
    with zipfile.ZipFile(tmp_path / "bundle.zip", "w") as z:
        z.writestr("inner.txt", "shipped")
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.parallel.launcher."
         "bootstrap", "--", sys.executable, "-c",
         "import os; print(os.environ['DMLC_ROLE'], os.environ['RANK'], "
         "os.environ['WORLD_SIZE'], open('bundle/inner.txt').read())"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "SLURM_PROCID": "0", "DMLC_NUM_SERVER": "0",
             "DMLC_NUM_WORKER": "1", "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["worker", "0", "1", "shipped"]
    assert bootstrap.main([]) == 2


# -- ssh ---------------------------------------------------------------------

def test_host_pool_blacklist_and_exhaustion():
    a, b = ("h1", 22), ("h2", 22)
    pool = ssh.HostPool([a, b], fail_limit=2)
    assert pool.assign() in (a, b)
    assert not pool.record_failure(a)          # 1st failure: kept
    assert pool.record_failure(a)              # 2nd: blacklisted
    assert pool.blacklisted == {a}
    assert pool.assign() == b and pool.assign() == b
    assert pool.record_failure(b, unreachable=True)   # 255 → immediate
    with pytest.raises(DMLCError):
        pool.assign()


def test_parse_host_file(tmp_path):
    from dmlc_core_tpu.parallel.launcher.ssh import \
        parse_host_file as jparse
    hosts = tmp_path / "hosts"
    hosts.write_text("# cluster\nh1\nh2:2222  # a comment\n\n10.0.0.3\n")
    assert ssh.parse_host_file(str(hosts)) == jparse(str(hosts)) == [
        ("h1", 22), ("h2", 2222), ("10.0.0.3", 22)]
    hosts.write_text("# nobody\n")
    with pytest.raises(DMLCError, match="lists no hosts"):
        ssh.parse_host_file(str(hosts))


def test_shipped_file_readable_in_worker_cwd_ssh(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH",
                       f"{fake_ssh_bin(tmp_path)}:{os.environ['PATH']}")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data.txt").write_text("hello-ssh")
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("127.0.0.1\n")
    rc = submit_job([
        "--cluster", "ssh", "-n", "1", "--host-file", str(hosts),
        "--host-ip", "127.0.0.1", "--jobname", f"t{os.getpid()}",
        "--files", "data.txt", "--", sys.executable, "-c",
        "import sys; sys.exit(0 if open('data.txt').read()=='hello-ssh'"
        " else 3)"])
    assert rc == 0


def test_dead_host_replaced_and_job_finishes(tmp_path, monkeypatch):
    """One of two hosts is dead: the task placed there is blacklisted
    off it and rescheduled onto the live host, a two-rank port rabit
    cohort forms, an allreduce completes, the job exits 0."""
    monkeypatch.setenv("PATH",
                       f"{fake_ssh_bin(tmp_path)}:{os.environ['PATH']}")
    monkeypatch.chdir(tmp_path)
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("deadhost\n127.0.0.1\n")
    script = tmp_path / "worker.py"
    script.write_text(RABIT_WORKER)
    rc = submit_job(["--cluster", "ssh", "-n", "2", "--host-file",
                     str(hosts), "--host-ip", "127.0.0.1", "--max-attempts",
                     "3", "--env", PYPATH, "--", sys.executable,
                     str(script)])
    assert rc == 0


def test_ssh_respawns_a_crashed_task_with_a_bumped_attempt(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("PATH",
                       f"{fake_ssh_bin(tmp_path)}:{os.environ['PATH']}")
    monkeypatch.setenv("DMLC_HOST_FAIL_LIMIT", "5")
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("127.0.0.1\n")
    script = tmp_path / "crash.py"
    script.write_text(CRASH_ONCE.replace("os.environ['RANK']",
                                         "os.environ['DMLC_TASK_ID']"))
    rc = submit_job(["--cluster", "ssh", "-n", "2", "--host-file",
                     str(hosts), "--host-ip", "127.0.0.1", "--max-attempts",
                     "2", "--", sys.executable, str(script), str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir() if p.name[0] in "01") \
        == ["0.0", "1.0", "1.1"]


def test_ssh_without_a_host_file_is_refused():
    with pytest.raises(DMLCError, match="--host-file"):
        submit_job(["--cluster", "ssh", "-n", "1", "--host-ip",
                    "127.0.0.1", "--", "true"])


# -- yarn --------------------------------------------------------------------

def test_yarn_app_level_reacquire(tmp_path, monkeypatch):
    """A FAILED app is resubmitted with fresh containers, bounded by
    DMLC_YARN_APP_ATTEMPTS, with RM REST diagnostics logged when the
    endpoint answers; a 0-rc app submits once."""
    import http.server
    import threading

    count = tmp_path / "count"
    count.write_text("0")
    fake = tmp_path / "hadoop"
    fake.write_text(
        "#!/bin/bash\n"
        f"n=$(cat {count}); n=$((n+1)); echo $n >{count}\n"
        "echo 'Submitted application application_1700000000001_0042'\n"
        "if [ \"$n\" -lt 3 ]; then exit 1; fi\n"
        "exit 0\n")
    fake.chmod(0o755)
    monkeypatch.setenv("HADOOP_HOME", "")
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")

    class RM(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            assert self.path.endswith(
                "/ws/v1/cluster/apps/application_1700000000001_0042")
            body = (b'{"app": {"state": "FINISHED", "finalStatus": "FAILED",'
                    b' "diagnostics": "Container released on a *lost* node"}}')
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), RM)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv("DMLC_YARN_RM_HTTP",
                           f"http://127.0.0.1:{srv.server_address[1]}")
        rep = yarn.rm_app_report("application_1700000000001_0042")
        assert rep["finalStatus"] == "FAILED" and "lost" in rep["diagnostics"]
        monkeypatch.setenv("DMLC_YARN_APP_ATTEMPTS", "3")
        args = _args("yarn")
        assert yarn.submit_yarn(args, ENVS) == 0
        assert count.read_text().strip() == "3"   # 2 failures + 1 success
        count.write_text("-10")                   # needs 13 runs
        monkeypatch.setenv("DMLC_YARN_APP_ATTEMPTS", "2")
        assert yarn.submit_yarn(args, ENVS) != 0
        assert count.read_text().strip() == "-8"  # exactly 2 submissions
        count.write_text("99")
        monkeypatch.setenv("DMLC_YARN_APP_ATTEMPTS", "3")
        assert yarn.submit_yarn(args, ENVS) == 0
        assert count.read_text().strip() == "100"
    finally:
        srv.shutdown()
    monkeypatch.setenv("DMLC_YARN_RM_HTTP", "http://127.0.0.1:1")
    assert yarn.rm_app_report("application_1_1") == {}


def test_yarn_without_hadoop_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("HADOOP_HOME", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(DMLCError, match="hadoop CLI"):
        yarn.submit_yarn(_args("yarn"), ENVS)


def _fake_rm():
    """In-process RM REST stub for the per-task app supervisor (JAX
    ``tests/test_launchers.py``'s): outcomes scripted per (task_id,
    attempt), assigned when an app is submitted."""
    import http.server
    import re
    import threading

    class RM(http.server.BaseHTTPRequestHandler):
        apps, payloads, kills, next_id, outcomes = {}, [], [], [0], {}
        default = ("FINISHED", "SUCCEEDED", "goodnode")

        def log_message(self, *a):
            pass

        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            if self.path.endswith("/new-application"):
                self.next_id[0] += 1
                self._send({"application-id":
                            f"application_1_{self.next_id[0]:04d}"})
                return
            payload = json.loads(body)
            type(self).payloads.append(payload)
            env = {e["key"]: e["value"] for e in
                   payload["am-container-spec"]["environment"]["entry"]}
            key = (env["DMLC_TASK_ID"], env["DMLC_NUM_ATTEMPT"])
            state, final, node = self.outcomes.get(key, self.default)
            self.apps[payload["application-id"]] = {
                "state": state, "finalStatus": final,
                "amHostHttpAddress": f"{node}:8042",
                "diagnostics": f"scripted outcome for task/attempt {key}"}
            self._send({}, 202)

        def do_GET(self):
            rep = self.apps.get(self.path.rsplit("/", 1)[-1])
            self._send({"app": rep} if rep else {}, 200 if rep else 404)

        def do_PUT(self):
            m = re.search(r"/apps/([^/]+)/state", self.path)
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            type(self).kills.append(m.group(1))
            self.apps[m.group(1)] = {"state": "KILLED",
                                     "finalStatus": "KILLED",
                                     "amHostHttpAddress": "x:1"}
            self._send({})

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), RM)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, RM


def _env_of(payload):
    return {e["key"]: e["value"] for e in
            payload["am-container-spec"]["environment"]["entry"]}


def test_yarn_rest_container_death_retries_only_that_task():
    srv, RM = _fake_rm()
    try:
        RM.outcomes[("1", "0")] = ("FINISHED", "FAILED", "badnode")
        client = yarn_am.YarnRestClient(
            f"http://127.0.0.1:{srv.server_address[1]}")
        tasks = [yarn_am.TaskSpec(i, "run-task") for i in range(3)]
        sup = yarn_am.TaskSupervisor(client, tasks, max_attempts=3,
                                     node_fail_limit=1, poll_s=0,
                                     sleep=lambda s: None)
        assert sup.run() == 0
        by_task = {}
        for p in RM.payloads:
            env = _env_of(p)
            by_task.setdefault(env["DMLC_TASK_ID"], []).append(env)
        assert len(by_task["0"]) == 1 and len(by_task["2"]) == 1
        assert [e["DMLC_NUM_ATTEMPT"] for e in by_task["1"]] == ["0", "1"]
        assert by_task["1"][1]["DMLC_BLACKLISTED_NODES"] == "badnode"
        assert RM.kills == [] and sup.blacklist == {"badnode"}
    finally:
        srv.shutdown()


def test_yarn_rest_abort_after_max_attempts_kills_cohort():
    srv, RM = _fake_rm()
    try:
        for a in range(5):
            RM.outcomes[("0", str(a))] = ("FINISHED", "FAILED", f"n{a}")
        RM.outcomes[("1", "0")] = ("RUNNING", "UNDEFINED", "n9")
        client = yarn_am.YarnRestClient(
            f"http://127.0.0.1:{srv.server_address[1]}")
        sup = yarn_am.TaskSupervisor(
            client, [yarn_am.TaskSpec(0, "x"), yarn_am.TaskSpec(1, "x")],
            max_attempts=2, node_fail_limit=3, poll_s=0,
            sleep=lambda s: None)
        assert sup.run() == 1
        task0 = [p for p in RM.payloads if _env_of(p)["DMLC_TASK_ID"] == "0"]
        assert len(task0) == 2 and len(RM.kills) == 1
    finally:
        srv.shutdown()


def test_yarn_rest_mode_end_to_end_via_submit(monkeypatch):
    srv, RM = _fake_rm()
    try:
        monkeypatch.setenv("DMLC_YARN_MODE", "rest")
        monkeypatch.setenv("DMLC_YARN_RM_HTTP",
                           f"http://127.0.0.1:{srv.server_address[1]}")
        assert yarn.submit_yarn(_args("yarn"), ENVS) == 0
        assert len(RM.payloads) == 4
        for p in RM.payloads:
            assert "base64 -d" in p["am-container-spec"]["commands"]["command"]
        assert sorted(int(_env_of(p)["DMLC_TASK_ID"])
                      for p in RM.payloads) == [0, 1, 2, 3]
    finally:
        srv.shutdown()


def test_yarn_rest_client_needs_an_endpoint():
    with pytest.raises(DMLCError, match="DMLC_YARN_RM_HTTP"):
        yarn_am.YarnRestClient("")
