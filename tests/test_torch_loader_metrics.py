"""The port's loaders publish the JAX loaders' metrics.

* After an epoch, the port's ``metrics.snapshot()`` holds every key the
  JAX ``DeviceLoader``'s does for the same file and configuration (the
  native, python, streampack, row-major, ragged and pooled-transfer
  paths, and a cached epoch), with the same batch and row counts;
* over two epochs of a ``#cachefile`` source the ``page_cache.*``
  counters are equal across the packages, and equal to the port loader's
  own ``cache_stats``;
* a pack delay injected into the python pack moves
  ``anomaly.stalls.device_loader.pack`` in both packages, and each
  package's ``Autotuner`` then refuses to judge that epoch (``freeze``);
* ``RemoteIngestLoader`` publishes ``remote_ingest.h2d``,
  ``.batches``, ``.rows`` and ``transport.buffer_reuse`` with the JAX
  loader's counts for the same worker.

No timeline sampler writes into either registry while a test runs:
every ``TelemetryServer`` of either package starts its package's
process-wide one, nothing stops it, and each of its ticks counts on
``telemetry.timeline.samples``, a key no loader makes.  A sampler left
running by another test file in the same process would otherwise add
that key to one side of the comparison at random.  For the same reason both packages' span rings
start empty: the loaders record spans, and a ring that other tests
filled counts each eviction on ``telemetry.spans_dropped``.

Everything runs on the CPU (``device="cpu"``).
"""

import shutil
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from conftest import start_ingest_worker as start_jax_worker  # noqa: E402
from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.pipeline import DeviceLoader as JDeviceLoader  # noqa: E402
from dmlc_core_tpu.pipeline import \
    RemoteIngestLoader as JRemoteIngestLoader  # noqa: E402
from dmlc_core_tpu.pipeline import autotune as jat  # noqa: E402
from dmlc_core_tpu.pipeline import device_loader as jdl  # noqa: E402
from dmlc_core_tpu.telemetry import timeseries as jtimeseries  # noqa: E402
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu.utils.metrics import metrics as jmetrics  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import autotune as at  # noqa: E402
from dmlc_core_tpu_torch.pipeline import loader as loader_mod  # noqa: E402
from dmlc_core_tpu_torch.telemetry import timeseries  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402
from test_torch_ingest import start_port_worker  # noqa: E402
from test_torch_page_cache import \
    _write_libsvm as write_libsvm  # noqa: E402

ROWS, CAP = 64, 1024
CACHE_KEYS = ("hits", "misses", "drops", "bytes_read", "bytes_written")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()
    return native


@pytest.fixture()
def clean(monkeypatch, tmp_path):
    """Both registries and span rings empty, no fault spec, no SLO
    breach, a scratch tuned file, and every timeline sampler's tick, JAX
    and port, a no-op (see the module's docstring)."""
    monkeypatch.setattr(jtimeseries.HistoryStore, "sample_once",
                        lambda self, now=None: 0)
    monkeypatch.setattr(timeseries.HistoryStore, "sample_once",
                        lambda self, now=None: 0)
    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    monkeypatch.delenv("DMLC_AUTOTUNE", raising=False)
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / "tuned.json"))
    metrics.reset()
    jmetrics.reset()
    teltrace.recorder.clear()
    jtrace.recorder.clear()
    yield
    metrics.reset()
    jmetrics.reset()


def _write_libsvm(path, rows, seed):
    write_libsvm(path, rows, seed)
    return str(path)


def _drain(loader):
    return sum(1 for _ in loader)


def _value(snap, name):
    m = snap[name]
    return m["total"] if m["type"] == "throughput" else (
        m["count"] if m["type"] == "stage" else m["value"])


# per configuration: (port loader keywords, port parser keywords, JAX loader
# keywords, JAX parser keywords, the JAX native packer on)
CONFIGS = {
    "native": ({}, {}, {}, {}, True),
    "python": (dict(engine="python"), dict(engine="python"), {}, {}, False),
    "streampack": ({}, dict(threaded=False, nthreads=1), {},
                   dict(threaded=False, nthreads=1), True),
    "rowmajor": (dict(layout="rowmajor"), {}, dict(layout="rowmajor"), {},
                 True),
    "ragged": (dict(ragged=True), {}, dict(ragged=True), {}, True),
    "pooled": (dict(put_threads=2, engine="python"), dict(engine="python"),
               dict(put_threads=2), {}, False),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_metric_keys_equal_the_jax_loaders(lib, clean, tmp_path,
                                           monkeypatch, config):
    _keys_and_counts_equal(tmp_path, monkeypatch, config)


def test_a_running_jax_timeline_sampler_adds_no_key(lib, clean, tmp_path,
                                                    monkeypatch):
    """The python loaders' comparison with a JAX timeline sampler
    ticking every millisecond into the JAX registry all along, as one
    left running by another test ticks."""
    store = jtimeseries.HistoryStore(snapshot_fn=jmetrics.snapshot)
    store.start(interval_s=0.001)
    try:
        _keys_and_counts_equal(tmp_path, monkeypatch, "python")
    finally:
        store.stop()


def test_a_running_port_timeline_sampler_adds_no_key(lib, clean, tmp_path,
                                                     monkeypatch):
    """The same with the port's sampler ticking into the port's
    registry, as a port exporter started by another test leaves it."""
    store = timeseries.HistoryStore(snapshot_fn=metrics.snapshot)
    store.start(interval_s=0.001)
    try:
        _keys_and_counts_equal(tmp_path, monkeypatch, "python")
    finally:
        store.stop()


def _keys_and_counts_equal(tmp_path, monkeypatch, config):
    path = _write_libsvm(tmp_path / "d.libsvm", 700, 1)
    pkw, ppk, jkw, jpk, jax_native = CONFIGS[config]
    if not jax_native:
        monkeypatch.setattr(jnative, "has_packer", lambda: False)
    with JDeviceLoader(jcreate_parser(path, **jpk), ROWS, CAP,
                       id_mod=2048, wire_compact=False, **jkw) as ld:
        jn = _drain(ld)
    with DeviceLoader(create_parser(path, **ppk), ROWS, CAP, id_mod=2048,
                      device="cpu", **pkw) as ld:
        n = _drain(ld)
    assert n == jn > 5
    want, got = jmetrics.snapshot(), metrics.snapshot()
    assert set(got) == set(want)
    for name in ("device_loader.batches", "device_loader.rows",
                 "parser.bytes"):
        assert _value(got, name) == _value(want, name), name
    assert _value(got, "device_loader.batches") == n
    assert _value(got, "device_loader.rows") == 700
    timed = ("device_loader.h2d_pool" if config == "pooled"
             else "device_loader.h2d")
    assert _value(got, timed) == _value(want, timed) == n


def _cached(root, name):
    """A ``#cachefile`` URI over its own copy of the data: each package
    writes its own page file."""
    d = root / name
    d.mkdir()
    _write_libsvm(d / "d.libsvm", 700, 2)
    return f"{d / 'd.libsvm'}#{d / 'cache'}"


def test_cache_counts_equal_the_jax_loaders(lib, clean, tmp_path):
    ju, pu = _cached(tmp_path, "jax"), _cached(tmp_path, "port")
    with JDeviceLoader(jcreate_parser(ju), ROWS, CAP, id_mod=2048,
                       wire_compact=False, put_threads=1,
                       cache_queue_pages=32) as ld:
        jn = [_drain(ld)]
        ld.before_first()
        jn.append(_drain(ld))
    with DeviceLoader(create_parser(pu), ROWS, CAP, id_mod=2048,
                      device="cpu", cache_queue_pages=32) as ld:
        n = [_drain(ld)]
        ld.before_first()
        n.append(_drain(ld))
        stats = dict(ld.cache_stats)
    assert n == jn and n[0] > 5
    want, got = jmetrics.snapshot(), metrics.snapshot()
    assert set(got) == set(want)
    for k in CACHE_KEYS:
        name = f"page_cache.{k}"
        assert _value(got, name) == _value(want, name) == stats[k], name
    assert stats["hits"] == stats["misses"] == 1 and stats["drops"] == 0
    assert stats["bytes_read"] == stats["bytes_written"] > 0
    for name in ("device_loader.cache_read", "device_loader.cache_write",
                 "device_loader.batches"):
        assert _value(got, name) == _value(want, name), name


def _slow_nth(pack, n, delay):
    """``pack`` (a pack function of either package), with a sleep of
    ``delay`` seconds before its ``n``-th call."""
    calls = [0]

    def slow(*a, **kw):
        calls[0] += 1
        if calls[0] == n:
            time.sleep(delay)
        return pack(*a, **kw)
    return slow


def _tuned_epoch(tuner, run_epoch):
    tuner.begin_epoch()
    run_epoch()
    return tuner.end_epoch(10.0)["action"]


def test_pack_stall_freezes_the_autotuner(lib, clean, tmp_path,
                                          monkeypatch):
    """The 24th python pack of an epoch sleeps 0.25 s (a pack takes
    about a millisecond here): both loaders' pack stall detectors flag
    it, and both tuners freeze instead of judging the epoch.  The epoch
    before it runs with flagging off (``DMLC_STALL_Z=0``, so that no
    scheduling hiccup of this host can flag it) and is judged: the
    tuner's baseline."""
    path = _write_libsvm(tmp_path / "d.libsvm", 40 * ROWS, 3)
    monkeypatch.setattr(jnative, "has_packer", lambda: False)

    def port_epoch():
        with DeviceLoader(create_parser(path, engine="python"), ROWS, CAP,
                          id_mod=2048, device="cpu",
                          engine="python") as ld:
            assert _drain(ld) == 40

    def jax_epoch():
        with JDeviceLoader(jcreate_parser(path), ROWS, CAP, id_mod=2048,
                           wire_compact=False, put_threads=1) as ld:
            assert _drain(ld) == 40

    cases = (("port", metrics, at, loader_mod, port_epoch),
             ("jax", jmetrics, jat, jdl, jax_epoch))
    for name, reg, mod, lmod, epoch in cases:
        reg.gauge("slo.active_breaches").set(0)
        tuner = mod.Autotuner([mod.Knob("k", (1, 2, 4), baseline=1)],
                              key=None)
        monkeypatch.setenv("DMLC_STALL_Z", "0")
        assert _tuned_epoch(tuner, epoch) == "baseline", name
        monkeypatch.delenv("DMLC_STALL_Z")
        stalls = reg.counter("anomaly.stalls.device_loader.pack").value
        with monkeypatch.context() as m:
            m.setattr(lmod, "pack_flat", _slow_nth(lmod.pack_flat, 24, 0.25))
            assert _tuned_epoch(tuner, epoch) == "freeze", name
        assert reg.counter(
            "anomaly.stalls.device_loader.pack").value > stalls, name
        assert reg.counter("autotune.freezes").value == 1, name


def test_remote_ingest_loader_metrics_equal_the_jax_loaders(clean,
                                                            tmp_path):
    path = _write_libsvm(tmp_path / "w.libsvm", 600, 4)
    tport = start_port_worker(f"file://{path}", 0, 1, max_epochs=1)
    jport = start_jax_worker(f"file://{path}", 0, 1, max_epochs=1,
                             wire_compact=False)
    with RemoteIngestLoader([("127.0.0.1", tport)], batch_rows=ROWS,
                            device="cpu") as ld:
        n = _drain(ld)
    ld = JRemoteIngestLoader([("127.0.0.1", jport)], batch_rows=ROWS)
    try:
        jn = _drain(ld)
    finally:
        ld.close()
    assert n == jn > 5
    want, got = jmetrics.snapshot(), metrics.snapshot()
    for name in ("remote_ingest.h2d", "remote_ingest.batches",
                 "remote_ingest.rows", "transport.buffer_reuse"):
        assert _value(got, name) == _value(want, name), name
    assert _value(got, "remote_ingest.h2d") == n
    # every frame's header after the first, the end-of-stream one included
    assert _value(got, "transport.buffer_reuse") == n
