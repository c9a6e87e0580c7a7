"""The port's closed-loop autotuner (``pipeline/autotune.py``), the cases
of ``tests/test_autotune.py`` run on the port's modules, and the port's
and the JAX package's ``Autotuner`` held to the same decisions.

Hill climb and persistence, warm start, rollback, abort, the freeze on
an injected stall (the port's ``StallDetector`` and fault points) and on
an active SLO breach gauge, ``DMLC_AUTOTUNE`` gating, ``autotune_key``,
the knob spaces, ``MicroBatcher.apply_knobs`` bounds, and ``serve_ingest``
across connections with the tuner on and off.
"""

import json
import random
import time
import types

import pytest

pytest.importorskip("jax")

from dmlc_core_tpu.pipeline import autotune as jat  # noqa: E402
from dmlc_core_tpu.pipeline import fingerprint as jfp  # noqa: E402
from dmlc_core_tpu.utils.metrics import metrics as jmetrics  # noqa: E402
from dmlc_core_tpu_torch.pipeline import autotune as at  # noqa: E402
from dmlc_core_tpu_torch.pipeline import fingerprint as fp  # noqa: E402
from dmlc_core_tpu_torch.pipeline import tuned  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402


@pytest.fixture()
def tuned_file(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(path))
    metrics.gauge("slo.active_breaches").set(0)
    jmetrics.gauge("slo.active_breaches").set(0)
    return path


def _counter(name):
    return metrics.counter(name).value


def _run_to_convergence(tuner, objective, max_epochs=60):
    for _ in range(max_epochs):
        cfg = tuner.begin_epoch()
        tuner.end_epoch(objective(cfg))
        if tuner.converged:
            return
    raise AssertionError("did not converge")


# -- the controller ----------------------------------------------------------

def test_hill_climb_finds_optimum_and_persists(tuned_file):
    knobs = [at.Knob("threads", (1, 2, 4, 8), baseline=1),
             at.Knob("prefetch", (1, 2, 4), baseline=1)]
    t = at.Autotuner(knobs, key="deadbeef|c1|host", min_gain=0.01)
    e0 = _counter("autotune.epochs")

    def objective(cfg):      # one peak, at threads 4 and prefetch 4
        return 100.0 - 10 * abs(cfg["threads"] - 4) \
            - 10 * abs(cfg["prefetch"] - 4)

    _run_to_convergence(t, objective)
    assert t.best_config() == {"threads": 4, "prefetch": 4}
    assert metrics.gauge("autotune.converged").value == 1.0
    assert _counter("autotune.epochs") - e0 == t.epoch
    assert metrics.gauge("autotune.knob.threads").value == 4.0
    doc = json.loads(tuned_file.read_text())
    saved = doc["autotune"]["deadbeef|c1|host"]
    assert saved["knobs"] == {"threads": 4, "prefetch": 4}
    assert saved["objective"] == pytest.approx(100.0)
    assert saved["host"] == fp.host_shape()
    m0 = _counter("autotune.mutations")
    cfg = t.begin_epoch()
    assert cfg == {"threads": 4, "prefetch": 4}
    assert t.end_epoch(objective(cfg))["action"] == "steady"
    assert _counter("autotune.mutations") == m0


def test_warm_start_skips_search(tuned_file):
    tuned.save_autotuned("k|c1|host", {"knobs": {"threads": 8},
                                       "objective": 50.0})
    t = at.Autotuner([at.Knob("threads", (1, 2, 4, 8), baseline=1)],
                     key="k|c1|host")
    assert t.converged and t.config() == {"threads": 8}
    m0 = _counter("autotune.mutations")
    t.begin_epoch()
    assert t.end_epoch(49.0)["action"] == "steady"
    assert _counter("autotune.mutations") == m0


def test_warm_start_from_a_jax_winner(tuned_file):
    """A converged entry the JAX tuner persisted warm-starts the port's
    tuner at the same key (one file, one section)."""
    jt = jat.Autotuner([jat.Knob("k", (1, 2, 4, 8), baseline=1)],
                       key="x|c1|host", min_gain=0.01)
    _run_to_convergence(jt, lambda cfg: -abs(cfg["k"] - 4))
    t = at.Autotuner([at.Knob("k", (1, 2, 4, 8), baseline=1)],
                     key="x|c1|host")
    assert t.converged and t.config() == {"k": 4}


def test_rejected_mutation_rolls_back(tuned_file):
    t = at.Autotuner([at.Knob("k", (1, 2, 4), baseline=2)], key=None)
    t.begin_epoch()
    out = t.end_epoch(10.0)
    assert out["action"] == "baseline" and "next_knob" in out
    mutated = t.config()["k"]
    assert mutated != 2
    t.begin_epoch()
    out = t.end_epoch(5.0)
    assert out["action"] == "reject"
    assert t.best_config() == {"k": 2}


def test_abort_epoch_reverts_unjudged(tuned_file):
    t = at.Autotuner([at.Knob("k", (1, 2, 4), baseline=1)], key=None)
    t.begin_epoch()
    t.end_epoch(10.0)
    assert t.config() != t.best_config()
    a0 = _counter("autotune.aborted")
    t.begin_epoch()
    t.abort_epoch()
    assert _counter("autotune.aborted") == a0 + 1
    assert t.config() == t.best_config() == {"k": 1}
    t.begin_epoch()
    t.end_epoch(10.0)


def test_freeze_on_injected_stall_halts_and_rolls_back(tuned_file,
                                                       monkeypatch):
    """A stall injected through ``DMLC_FAULT_SPEC`` and flagged by the
    port's StallDetector halts mutations and rolls back."""
    from dmlc_core_tpu_torch.telemetry import StallDetector
    from dmlc_core_tpu_torch.utils.faults import clear_faults, fault_point

    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    clear_faults()
    det = StallDetector("autotune_test", z_threshold=8.0, min_samples=4)

    def tick():
        t0 = time.perf_counter()
        fault_point("autotune.test.stage")
        det.observe(time.perf_counter() - t0)

    t = at.Autotuner([at.Knob("k", (1, 2, 4), baseline=1)], key=None,
                     backoff_epochs=2)
    t.begin_epoch()
    for _ in range(10):
        tick()
    t.end_epoch(10.0)
    assert t.config() == {"k": 2}
    stalls0 = _counter("anomaly.stalls.autotune_test")
    t.begin_epoch()
    monkeypatch.setenv("DMLC_FAULT_SPEC",
                       "autotune.test.stage:latency=150ms")
    tick()
    monkeypatch.delenv("DMLC_FAULT_SPEC")
    clear_faults()
    assert _counter("anomaly.stalls.autotune_test") > stalls0
    assert metrics.gauge("anomaly.stall_z.autotune_test").value > 8.0
    out = t.end_epoch(99.0)
    assert out["action"] == "freeze"
    assert t.config() == t.best_config() == {"k": 1}
    m0 = _counter("autotune.mutations")
    t.begin_epoch()
    assert t.end_epoch(10.0)["action"] == "backoff"
    t.begin_epoch()
    assert t.end_epoch(10.0)["action"] == "backoff"
    assert _counter("autotune.mutations") == m0
    t.begin_epoch()
    assert t.end_epoch(10.0)["action"] == "resume"
    assert _counter("autotune.mutations") == m0 + 1


def test_freeze_on_active_slo_breach(tuned_file):
    t = at.Autotuner([at.Knob("k", (1, 2), baseline=1)], key=None)
    metrics.gauge("slo.active_breaches").set(1)
    try:
        t.begin_epoch()
        assert t.end_epoch(10.0)["action"] == "freeze"
    finally:
        metrics.gauge("slo.active_breaches").set(0)


def test_stall_detector_matches_jax():
    """The same durations give the same z-scores and flags."""
    from dmlc_core_tpu.telemetry.anomaly import StallDetector as JStall
    from dmlc_core_tpu_torch.telemetry import StallDetector
    rng = random.Random(3)
    ours = StallDetector("same_z", min_samples=4)
    theirs = JStall("same_z", min_samples=4)
    for i in range(200):
        d = rng.expovariate(100.0) + (0.5 if i % 50 == 49 else 0.0)
        assert ours.observe(d) == theirs.observe(d)
    assert metrics.counter("anomaly.stalls.same_z").value == \
        jmetrics.counter("anomaly.stalls.same_z").value > 0


def _decisions(mod, objective_seq, knobs):
    t = mod.Autotuner(knobs, key=None, min_gain=0.02, backoff_epochs=1)
    out = []
    for obj in objective_seq:
        cfg = t.begin_epoch()
        act = t.end_epoch(obj)
        out.append((cfg, act))
        if t.converged:
            break
    return out


@pytest.mark.parametrize("seed", range(4))
def test_same_decisions_as_jax(tuned_file, seed):
    """A deterministic objective sequence drives both controllers: every
    proposed config and every action agree."""
    rng = random.Random(seed)
    seq = [rng.uniform(10, 20) for _ in range(60)]

    def knobs(mod):
        return [mod.Knob("a", (1, 2, 4, 8, 16), baseline=2),
                mod.Knob("b", (0.5, 1.0, 2.0), baseline=1.0),
                mod.Knob("c", (3,), baseline=3)]
    ours = _decisions(at, seq, knobs(at))
    theirs = _decisions(jat, seq, knobs(jat))
    assert ours == theirs and len(ours) > 3


# -- gating ----------------------------------------------------------------------

def test_maybe_autotuner_gating(tuned_file, monkeypatch):
    factory = lambda: [at.Knob("k", (1, 2))]      # noqa: E731
    monkeypatch.delenv("DMLC_AUTOTUNE", raising=False)
    assert at.maybe_autotuner(factory) is None
    assert at.maybe_autotuner(factory, gate=False) is None
    assert at.maybe_autotuner(factory, gate=True) is not None
    assert not at.enabled()
    monkeypatch.setenv("DMLC_AUTOTUNE", "0")
    assert at.maybe_autotuner(factory) is None
    assert at.maybe_autotuner(factory, gate=True) is None
    monkeypatch.setenv("DMLC_AUTOTUNE", "1")
    assert at.maybe_autotuner(factory) is not None
    assert at.enabled()


# -- keys and knob spaces ----------------------------------------------------------

def test_autotune_key_relaxed_projection():
    base = {"page_format": 1,
            "files": [["/d/a.svm", 100, 111], ["/d/b.svm", 200, 222]],
            "batch_rows": 64, "nnz_cap": 1024}
    touched = dict(base, files=[["/d/a.svm", 100, 999],
                                ["/d/b.svm", 200, 222]])
    resized = dict(base, files=[["/d/a.svm", 101, 111],
                                ["/d/b.svm", 200, 222]])
    format_bump = dict(base, page_format=2)
    k = fp.autotune_key(base, "host", shape="c1")
    assert fp.autotune_key(touched, "host", shape="c1") == k
    assert fp.autotune_key(format_bump, "host", shape="c1") == k
    assert fp.autotune_key(resized, "host", shape="c1") != k
    assert fp.autotune_key(base, "cuda", shape="c1") != k
    assert fp.autotune_key(base, "host", shape="c8") != k
    assert k.endswith("|c1|host")
    assert fp.autotune_key(None, "host", shape="c1").endswith("|c1|host")
    # the JAX package's keys, so persisted entries are shared
    for f in (base, touched, resized, None):
        assert fp.autotune_key(f, "host") == jfp.autotune_key(f, "host")
    assert fp.host_shape() == jfp.host_shape()


def test_loader_fingerprint_keys_the_tuner(tmp_path):
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.pipeline import DeviceLoader
    data = tmp_path / "t.libsvm"
    data.write_text("".join(f"{r % 2} {r}:1 {r + 1}:0.5\n"
                            for r in range(50)))
    with DeviceLoader(create_parser(str(data), nthreads=1, threaded=False),
                      batch_rows=16, nnz_cap=128, emit="host", device="cpu",
                      cache=str(tmp_path / "t.pages")) as loader:
        got = loader._cache_fingerprint()
        split = fp.find_file_split(loader.source)
        assert got["files"] == fp.split_files(split)
        assert got["wire_compact"] is False
        key = fp.autotune_key(got, "host")
        assert key == fp.autotune_key(got, "host")


@pytest.mark.parametrize("kw", [dict(), dict(cores=1), dict(cores=32),
                                dict(cache=True, device=True),
                                dict(degraded=True, cache=True)])
def test_ingest_knob_space_matches_jax(kw):
    ours = at.ingest_knob_space(**kw)
    theirs = jat.ingest_knob_space(**kw)
    assert [(k.name, k.values, k.value) for k in ours] == \
        [(k.name, k.values, k.value) for k in theirs]


def test_serving_knob_space_applies_live():
    applied = []
    fake = types.SimpleNamespace(
        engine=types.SimpleNamespace(
            ladder=types.SimpleNamespace(max_rows=64, max_nnz=4096)),
        max_delay_s=0.002, max_batch_rows=64, max_batch_nnz=4096,
        apply_knobs=lambda **kw: applied.append(kw))
    knobs = at.serving_knob_space(fake)
    by = {k.name: k for k in knobs}
    assert by["max_batch_rows"].values[-1] == 64
    assert by["max_batch_nnz"].values[-1] == 4096
    assert by["max_delay_s"].value == pytest.approx(0.002)
    t = at.Autotuner(knobs, key=None)
    t.begin_epoch()
    assert {"max_delay_s": 0.002} in applied
    assert {"max_batch_rows": 64} in applied


def test_micro_batcher_apply_knobs_bounds():
    from dmlc_core_tpu_torch.serving.batcher import MicroBatcher
    from dmlc_core_tpu_torch.utils.logging import DMLCError

    engine = types.SimpleNamespace(
        ladder=types.SimpleNamespace(max_rows=32, max_nnz=1024))
    b = MicroBatcher(engine, max_queue=4)
    try:
        b.apply_knobs(max_delay_s=0.004, max_batch_rows=16,
                      max_batch_nnz=512)
        assert (b.max_delay_s, b.max_batch_rows, b.max_batch_nnz) \
            == (0.004, 16, 512)
        with pytest.raises(DMLCError):
            b.apply_knobs(max_batch_rows=64)
        with pytest.raises(DMLCError):
            b.apply_knobs(max_delay_s=-1.0)
        assert b.max_batch_rows == 16
    finally:
        b.close(drain=False)


# -- serve_ingest ------------------------------------------------------------------

def _write(path, rows, seed, width):
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(rows):
            idx = np.sort(rng.choice(5000, size=width, replace=False))
            f.write(f"{r % 2} " + " ".join(
                f"{j}:{rng.random():.3f}" for j in idx) + "\n")


def _drain_host(port):
    from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader
    rl = RemoteIngestLoader([("127.0.0.1", port)], batch_rows=64,
                            emit="host", device="cpu")
    frames = 0
    try:
        for kind, buf, meta, rows in rl:
            assert kind == "fused"
            rl.recycle(buf)
            frames += 1
    finally:
        rl.close()
    return frames


def test_serve_ingest_autotunes_across_connections(tmp_path, monkeypatch):
    """Three connections are three evaluation epochs: the tuner counts
    them and exports its knob gauges while frames flow."""
    from test_torch_ingest import start_port_worker
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / "tuned.json"))
    monkeypatch.delenv("DMLC_AUTOTUNE", raising=False)
    metrics.gauge("slo.active_breaches").set(0)
    data = tmp_path / "w.libsvm"
    _write(data, 300, 1, 8)
    e0 = _counter("autotune.epochs")
    port = start_port_worker(str(data), 0, 1, max_epochs=3, autotune=True)
    for _ in range(3):
        assert _drain_host(port) > 0
    deadline = time.monotonic() + 10
    while (_counter("autotune.epochs") - e0 < 3
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert _counter("autotune.epochs") - e0 == 3
    assert metrics.gauge("autotune.knob.parser_threads").value >= 1


def test_serve_ingest_autotune_off_is_noop(tmp_path, monkeypatch):
    """``DMLC_AUTOTUNE=0``: serve_ingest builds no controller, even when
    forced."""
    from test_torch_ingest import start_port_worker
    monkeypatch.setenv("DMLC_AUTOTUNE", "0")
    data = tmp_path / "n.libsvm"
    _write(data, 100, 2, 5)
    e0 = _counter("autotune.epochs")
    m0 = _counter("autotune.mutations")
    port = start_port_worker(str(data), 0, 1, max_epochs=1, autotune=True)
    assert _drain_host(port) > 0
    time.sleep(0.2)
    assert _counter("autotune.epochs") == e0
    assert _counter("autotune.mutations") == m0
