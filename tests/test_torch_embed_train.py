"""The port's ``examples/train_embed_shard.py`` (ROADMAP A.8) on the CPU:
a three-rank cohort of processes over the port's tracker, the plain
path (``--device cpu``).

* Kill one rank entering epoch 1 and the run stays bit-equal to the
  no-kill run: every ``(rank, epoch)`` loss and state digest (the JAX
  package's own chaos proof, ``tests/test_embed_shard.py``), with zero
  checkpoint reads and the reborn rank's shard moved from peers.
* After every flush each interval's holders, primary and replicas, hold
  the same bits.
* The port's example starts from the JAX example's tower and keeps its
  records: the same keys, losses within 1e-5 of the JAX cohort's on the
  same data (float32 sums in another order).
* The launcher's ssh backend (fake ssh, a dead host in the host file)
  launches the same kill cohort end to end.

Every wait is bounded; a failed rank's stderr tail is in the message."""

import json
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from dmlc_core_tpu_torch.parallel import RabitTracker  # noqa: E402
from dmlc_core_tpu_torch.parallel.launcher.gpu import \
    _free_port_run  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
TIMEOUT = 240
RECORD_KEYS = {"rank", "epoch", "loss", "gen", "rebuilt", "digest",
               "from_peers", "from_ckpt", "bytes_moved", "resident"}
FEATURES, DIM = 512, 8


def _libsvm(tmp_path, rows=300):
    """The JAX chaos test's data: 300 rows, ids below 3000, hashed into
    512 rows by ``id_mod``."""
    rng = np.random.default_rng(0)
    path = tmp_path / "embed.libsvm"
    with open(path, "w") as f:
        for r in range(rows):
            k = int(rng.integers(1, 5))
            idx = np.sort(rng.choice(3000, size=k, replace=False))
            f.write(f"{r % 2} " + " ".join(
                f"{j}:{rng.random():.4f}" for j in idx) + "\n")
    return str(path)


PORT_EXAMPLE = [sys.executable, "-m",
                "dmlc_core_tpu_torch.examples.train_embed_shard"]
JAX_EXAMPLE = [sys.executable,
               os.path.join(REPO, "examples", "train_embed_shard.py")]


def _cmd(uri, report, prog=PORT_EXAMPLE, extra=()):
    return prog + [f"file://{uri}", "--epochs", "3", "--features",
                   str(FEATURES), "--dim", str(DIM), "--batch-rows", "64",
                   *extra] + (["--report", report] if report else [])


def _env(tmp_path, tag, **kw):
    ckpt = tmp_path / f"ckpt_{tag}"
    ckpt.mkdir()
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1",
           "DMLC_ELASTIC_BASE_PORT": str(_free_port_run(8)),
           "DMLC_CHECKPOINT_DIR": str(ckpt),
           "DMLC_CONNECT_TIMEOUT": "120", "DMLC_RECOVER_TIMEOUT": "300"}
    env.pop("DMLC_FAULT_SPEC", None)
    env.update(kw)
    return env


def _records(outs):
    return [json.loads(ln[6:]) for out in outs
            for ln in out.splitlines() if ln.startswith("EPOCH ")]


def run_cohort(uri, tmp_path, tag, kill, *, prog=PORT_EXAMPLE,
               extra=("--device", "cpu"), report=True, env_extra=None):
    """A ``WORLD``-rank cohort of the example over a tracker in this
    process; with ``kill``, rank 2 dies entering epoch 1 (after epoch 0
    is synced and checkpointed) and is respawned with a bumped attempt.
    Returns the EPOCH records and the report directory."""
    tracker = RabitTracker(num_workers=WORLD, host_ip="127.0.0.1")
    tracker.start()
    tenv = tracker.worker_envs()
    base = _env(tmp_path, tag, DMLC_TRACKER_URI=tenv["DMLC_TRACKER_URI"],
                DMLC_TRACKER_PORT=str(tenv["DMLC_TRACKER_PORT"]),
                **(env_extra or {}))
    rdir = str(tmp_path / f"report_{tag}") if report else ""
    cmd = _cmd(uri, rdir, prog=prog, extra=extra)

    def spawn(i, attempt, fault=None):
        env = dict(base, DMLC_TASK_ID=str(i), DMLC_NUM_ATTEMPT=str(attempt))
        if fault:
            env["DMLC_FAULT_SPEC"] = fault
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=REPO)

    procs = [spawn(i, 0, "embed.epoch:error=1.0:times=1:after=1"
                   if (kill and i == 2) else None) for i in range(WORLD)]
    outs = []
    try:
        if kill:
            try:
                crash_out, crash_err = procs[2].communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail("the victim never crashed")
            assert procs[2].returncode == 7, \
                f"victim rc={procs[2].returncode}: {crash_err[-2000:]}"
            assert "CRASHING at epoch 1" in crash_out
            outs.append(crash_out)
            procs = [procs[0], procs[1], spawn(2, 1)]
        deadline = time.monotonic() + TIMEOUT
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank process {i} did not finish in {TIMEOUT} s")
            assert p.returncode == 0, f"rank {i}: {err[-2000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        tracker.join(timeout=30)
    return _records(outs), rdir


def _report_lines(rdir):
    lines = []
    for r in range(WORLD):
        with open(os.path.join(rdir, f"embed_r{r}.jsonl")) as f:
            lines += [json.loads(ln) for ln in f if ln.strip()]
    return lines


def _holders_agree(lines):
    """Per epoch: every interval's digest is one across its holders."""
    by_epoch = {}
    for ln in lines:
        for iv, d in ln["blocks"].items():
            by_epoch.setdefault(ln["epoch"], {}).setdefault(iv, set()).add(d)
    return {e: {iv: len(ds) for iv, ds in ivs.items()}
            for e, ivs in by_epoch.items()}


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("embed_train")
    uri = _libsvm(tmp)
    nk = run_cohort(uri, tmp, "nk", kill=False)
    kk = run_cohort(uri, tmp, "k", kill=True)
    return uri, tmp, nk, kk


def test_kill_and_no_kill_are_bit_equal_on_the_plain_path(cohorts):
    """The port's run of the JAX chaos proof: killing a rank between
    epochs changes nothing observable."""
    _, _, (nk_recs, _), (kk_recs, _) = cohorts
    nk = {(r["rank"], r["epoch"]): r for r in nk_recs}
    kk = {(r["rank"], r["epoch"]): r for r in kk_recs}
    keys = [(r, e) for r in range(WORLD) for e in range(3)]
    assert sorted(nk) == sorted(kk) == keys   # every epoch exactly once
    assert len(nk_recs) == len(kk_recs) == len(keys)
    for key in keys:
        assert nk[key]["loss"] == kk[key]["loss"], key
        assert nk[key]["digest"] == kk[key]["digest"], key
    for r in kk.values():
        assert set(r) == RECORD_KEYS
        assert r["from_ckpt"] == 0            # zero checkpoint reads, ever
        # no rank ever resides the whole 512x8xf32 table
        assert 0 < r["resident"] < FEATURES * DIM * 4
    reborn = kk[(2, 1)]
    assert reborn["rebuilt"] and reborn["gen"] == 1
    assert reborn["from_peers"] >= 1 and reborn["bytes_moved"] > 0
    assert not nk[(2, 1)]["rebuilt"]
    # the loss falls
    losses = [nk[(0, e)]["loss"] for e in range(3)]
    assert losses[2] < losses[0], losses


@pytest.mark.parametrize("tag", ["nk", "k"])
def test_every_holder_of_a_shard_holds_the_same_bits(cohorts, tag):
    _, _, nk, kk = cohorts
    _, rdir = nk if tag == "nk" else kk
    lines = _report_lines(rdir)
    agree = _holders_agree(lines)
    assert sorted(agree) == [0, 1, 2]
    for epoch, ivs in agree.items():
        # three shards, each held by its primary and one replica
        assert len(ivs) == WORLD, (epoch, ivs)
        assert all(n == 1 for n in ivs.values()), (epoch, ivs)
    for ln in lines:
        assert ln["launches"] == {}           # the plain path: no kernel
        assert ln["counters"]["lookup_ids"] > 0
        assert ln["counters"]["flushes"] == 1


def test_the_reborn_rank_reports_its_join(cohorts):
    _, _, _, (_, rdir) = cohorts
    lines = _report_lines(rdir)
    with open(os.path.join(rdir, "crash_r2.json")) as f:
        crash = json.load(f)
    assert crash["epoch"] == 1
    join = [ln for ln in lines if ln["rank"] == 2 and ln["attempt"] == 1
            and ln["epoch"] == 1]
    assert len(join) == 1
    j = join[0]
    # its join epoch: every row remote (it held nothing), then rebuilt
    assert j["counters"]["cache_misses"] > 0
    assert j["counters"]["exchange_bytes"] > 0
    assert j["stats"]["leaves_from_peers"] >= 1
    assert j["joined_at"] > crash["time"]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(rdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    assert [o["attempt"] for o in ranks] == [0, 0, 1]


def test_the_port_example_follows_the_jax_example(cohorts):
    """The JAX example's no-kill cohort on the same data: the same record
    keys, the same per-rank resident bytes and losses within 1e-5 (the
    pooled sums and the tower add in other orders)."""
    pytest.importorskip("jax")
    uri, tmp, (nk_recs, _), _ = cohorts
    jax_recs, _ = run_cohort(
        uri, tmp, "jax", kill=False, report=False, prog=JAX_EXAMPLE,
        extra=(), env_extra={"DMLC_ELASTIC_DATA_PLANE": "0"})
    port = {(r["rank"], r["epoch"]): r for r in nk_recs}
    ref = {(r["rank"], r["epoch"]): r for r in jax_recs}
    assert sorted(port) == sorted(ref)
    for key, want in ref.items():
        got = port[key]
        assert set(got) == set(want)
        assert got["resident"] == want["resident"], key
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   atol=1e-5, err_msg=str(key))


def test_dispatcher_is_refused_naming_a9(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m",
         "dmlc_core_tpu_torch.examples.train_embed_shard", "x.libsvm",
         "--dispatcher", "127.0.0.1:1", "--device", "cpu"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "A.9" in out.stderr


# ---------------------------------------------------------------------------
# the launcher's ssh backend launches the cohort
# ---------------------------------------------------------------------------

def fake_ssh_bin(tmp_path, dead_host="deadhost"):
    """ssh/rsync fakes (JAX ``tests/test_launchers.py``'s): remote
    commands run locally; ssh to ``dead_host`` exits 255 (connection
    refused), as a dead node."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "ssh").write_text(
        "#!/bin/bash\n"
        'while [[ "$1" == -* ]]; do [[ "$1" == -o || "$1" == -p ]] && '
        "shift; shift; done\n"
        'host="$1"; shift\n'
        f'[[ "$host" == {dead_host} ]] && exit 255\n'
        'exec bash -c "$*"\n')
    (bin_dir / "rsync").write_text(
        "#!/bin/bash\nargs=()\n"
        'for a in "$@"; do case "$a" in -*) ;; *) args+=("$a");; esac; '
        "done\n"
        'unset "args[0]" 2>/dev/null\n'
        'args=("${args[@]}")\n'
        'dest="${args[-1]}"\n'
        f'[[ "$dest" == {dead_host}:* ]] && exit 255\n'
        'dest="${dest#*:}"\nunset "args[-1]"\n'
        'exec cp -f "${args[@]}" "$dest"\n')
    for f in bin_dir.iterdir():
        f.chmod(f.stat().st_mode | stat.S_IXUSR)
    return bin_dir


def test_ssh_launches_a_kill_cohort_with_a_dead_host(tmp_path):
    uri = _libsvm(tmp_path)
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("deadhost\n127.0.0.1\nlocalhost\n")
    rdir = str(tmp_path / "report")
    env = _env(tmp_path, "ssh")
    env["PATH"] = f"{fake_ssh_bin(tmp_path)}:{env['PATH']}"
    base_port = env.pop("DMLC_ELASTIC_BASE_PORT")
    cmd = [sys.executable, "-m",
           "dmlc_core_tpu_torch.parallel.launcher.submit", "--cluster",
           "ssh", "-n", str(WORLD), "--host-file", str(hosts),
           "--host-ip", "127.0.0.1", "--max-attempts", "2",
           "--env", f"DMLC_ELASTIC_BASE_PORT={base_port}",
           "--env", f"PYTHONPATH={REPO}",
           "--env", f"DMLC_CHECKPOINT_DIR={env['DMLC_CHECKPOINT_DIR']}",
           "--env", "OMP_NUM_THREADS=1", "--"] + _cmd(
        uri, rdir, extra=("--device", "cpu", "--crash-rank", "2",
                          "--crash-epoch", "1"))
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "host deadhost:22 blacklisted after 1 failure(s) (unreachable)" \
        in out.stderr
    assert "ssh task 2 on" in out.stderr and "exited rc=7" in out.stderr
    recs = _records([out.stdout])
    keys = sorted((r["rank"], r["epoch"]) for r in recs)
    assert keys == [(r, e) for r in range(WORLD) for e in range(3)]
    reborn = next(r for r in recs if (r["rank"], r["epoch"]) == (2, 1))
    assert reborn["rebuilt"] and reborn["gen"] == 1
    assert reborn["from_peers"] >= 1 and reborn["bytes_moved"] > 0
    assert all(r["from_ckpt"] == 0 for r in recs)
    for ivs in _holders_agree(_report_lines(rdir)).values():
        assert all(n == 1 for n in ivs.values()), ivs
