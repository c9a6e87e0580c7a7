"""The spans of the port's loaders, tuner and ingest, held against the
JAX package on the CPU.

* The port's and the JAX ``DeviceLoader`` read the same file (native,
  python, ragged and pooled-transfer packs, and a cached epoch): per span
  name the counts are equal, and so are the attributes, record by
  record.  The pack and transfer spans are children of the span that was
  active where the loader was constructed (they run on the loader's
  threads).
* On one scripted run of epochs (a warm start, an abort, a freeze, the
  climb to convergence), the port's ``Autotuner`` records the JAX tuner's
  ``autotune.decide`` spans and ``autotune.*`` events.
* A port ingest worker records ``ingest.serve_epoch`` and the port's
  ``RemoteIngestLoader`` one ``remote_ingest.h2d`` a frame, under its
  consumer's span, as the JAX worker and loader do.
"""

import collections
import gc
import importlib
import json
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
from dmlc_core_tpu.telemetry import trace as jtrace  # noqa: E402
from dmlc_core_tpu_torch import native  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import autotune as at  # noqa: E402
from dmlc_core_tpu_torch.telemetry import trace as teltrace  # noqa: E402
from test_torch_ingest import start_port_worker  # noqa: E402
from test_torch_loader_metrics import CONFIGS, _cached  # noqa: E402
from test_torch_loader_metrics import _write_libsvm  # noqa: E402
from test_torch_trace import _normal  # noqa: E402

ROWS, CAP = 64, 1024
jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics").metrics
metrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics").metrics


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    assert native.available() and jnative.available()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    monkeypatch.delenv("DMLC_AUTOTUNE", raising=False)
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / "tuned.json"))
    # an earlier test's abandoned page-replay generator, closed when the
    # collector next runs, would end its span (GeneratorExit) in this
    # test's rings: close them all before the rings are cleared
    gc.collect()
    teltrace.recorder.clear()
    jtrace.recorder.clear()
    yield
    teltrace.recorder.clear()
    jtrace.recorder.clear()


def _by_name(records):
    """{span name: sorted attribute dicts (as JSON)} of span records."""
    out = collections.defaultdict(list)
    for r in records:
        if r.get("kind") == "span":
            out[r["name"]].append(json.dumps(r["attrs"], sort_keys=True))
    return {k: sorted(v) for k, v in out.items()}


def _drain(loader):
    return sum(1 for _ in loader)


def _under_root(tr, make, epochs=1):
    """Construct and drain a loader inside a root span; the root's
    context and the batches an epoch."""
    with tr.span("consumer") as root:
        ctx = root.context
        with make() as ld:
            n = [_drain(ld)]
            for _ in range(epochs - 1):
                ld.before_first()
                n.append(_drain(ld))
    return ctx, n


def _in_trace(records, ctx):
    """The records of the root's trace, and the page replay's span (the
    JAX loader roots it on its own): another test's threads left running
    in this process (an xdist worker runs many files) may add spans of
    their own to the ring."""
    tid = teltrace.format_id(ctx.trace_id)
    return [r for r in records if r.get("trace_id") == tid
            or r.get("name") == "page_cache.serve_epoch"]


def _check_parents(records, ctx):
    tid = teltrace.format_id(ctx.trace_id)
    sid = teltrace.format_id(ctx.span_id)
    for r in records:
        if r.get("name") in ("device_loader.pack", "device_loader.h2d"):
            assert (r["trace_id"], r["parent_id"]) == (tid, sid), r


@pytest.mark.parametrize("config", ["native", "python", "ragged", "pooled"])
def test_loader_spans_equal_the_jax_loaders(lib, tmp_path, monkeypatch,
                                            config):
    path = _write_libsvm(tmp_path / "d.libsvm", 700, 1)
    pkw, ppk, jkw, jpk, jax_native = CONFIGS[config]
    if not jax_native:
        monkeypatch.setattr(jnative, "has_packer", lambda: False)
    jctx, jn = _under_root(jtrace, lambda: JDeviceLoader(
        jcreate_parser(path, **jpk), ROWS, CAP, id_mod=2048,
        wire_compact=False, **jkw))
    ctx, n = _under_root(teltrace, lambda: DeviceLoader(
        create_parser(path, **ppk), ROWS, CAP, id_mod=2048, device="cpu",
        **pkw))
    assert n == jn and n[0] > 5
    recs = _in_trace(teltrace.recorder.snapshot(), ctx)
    jrecs = _in_trace(jtrace.recorder.snapshot(), jctx)
    got = _by_name(recs)
    assert got == _by_name(jrecs)
    assert len(got["device_loader.h2d"]) == n[0]
    packs = len(got.get("device_loader.pack", ()))
    assert packs == (0 if config == "native" else n[0])
    if config == "pooled":
        assert set(got["device_loader.h2d"]) == {'{"sync": true}'}
    _check_parents(recs, ctx)
    _check_parents(jrecs, jctx)


def test_cached_epoch_spans_equal_the_jax_loaders(lib, tmp_path):
    ju, pu = _cached(tmp_path, "jax"), _cached(tmp_path, "port")
    jctx, jn = _under_root(jtrace, lambda: JDeviceLoader(
        jcreate_parser(ju), ROWS, CAP, id_mod=2048, wire_compact=False,
        put_threads=1, cache_queue_pages=32), epochs=2)
    ctx, n = _under_root(teltrace, lambda: DeviceLoader(
        create_parser(pu), ROWS, CAP, id_mod=2048, device="cpu",
        cache_queue_pages=32), epochs=2)
    assert n == jn and n[0] > 5
    recs = _in_trace(teltrace.recorder.snapshot(), ctx)
    got = _by_name(recs)
    assert got == _by_name(_in_trace(jtrace.recorder.snapshot(), jctx))
    assert got["page_cache.serve_epoch"] == [json.dumps({"pages": n[1]})]
    assert len(got["device_loader.h2d"]) == sum(n)
    _check_parents(recs, ctx)
    (serve,) = [r for r in recs if r["name"] == "page_cache.serve_epoch"]
    assert serve["parent_id"] == teltrace.format_id(ctx.span_id)


def test_a_loader_built_untraced_roots_no_shared_trace(lib, tmp_path):
    """Without a context at construction each span roots its own trace,
    as in the JAX loader."""
    path = _write_libsvm(tmp_path / "d.libsvm", 300, 2)
    with DeviceLoader(create_parser(path, engine="python"), ROWS, CAP,
                      id_mod=2048, device="cpu", engine="python") as ld:
        n = _drain(ld)
    recs = [r for r in teltrace.recorder.snapshot()
            if r["name"].startswith("device_loader.")]
    assert len(recs) == 2 * n
    assert all(r["parent_id"] is None for r in recs)
    assert len({r["trace_id"] for r in recs}) == 2 * n


# -- the tuner ------------------------------------------------------------------

def _tuner_script(mod, reg, monkeypatch, tmp_path, name):
    """Epochs: an abort, a baseline, the climb with one freeze (a stall
    counted mid-epoch), to convergence; then a tuner at the same key
    warm-starts."""
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(tmp_path / f"{name}.json"))
    reg.reset()
    reg.gauge("slo.active_breaches").set(0)

    def knobs():
        return [mod.Knob("a", (1, 2, 4, 8), baseline=2),
                mod.Knob("b", ("x", "y"), baseline="x")]
    t = mod.Autotuner(knobs(), key="trace-key", backoff_epochs=1)
    t.begin_epoch()
    t.abort_epoch()
    objectives = iter([10.0, 12.0, 11.0, 13.0, 20.0, 9.0, 9.0, 9.0, 9.0,
                       9.0, 9.0, 9.0, 9.0, 9.0])
    epoch = 0
    while not t.converged:
        t.begin_epoch()
        epoch += 1
        if epoch == 4:
            reg.counter("anomaly.stalls.test").add(1)
        t.end_epoch(next(objectives))
    mod.Autotuner(knobs(), key="trace-key")
    return epoch


def test_tuner_spans_and_events_equal_the_jax_tuner(monkeypatch, tmp_path):
    epochs = {}
    recs = {}
    for name, mod, reg, rec in (("jax", jat, jmetrics, jtrace.recorder),
                                ("port", at, metrics, teltrace.recorder)):
        rec.clear()
        epochs[name] = _tuner_script(mod, reg, monkeypatch, tmp_path, name)
        recs[name] = [r for r in rec.snapshot()
                      if r["name"].startswith("autotune.")]
    assert epochs["port"] == epochs["jax"] > 4
    assert _normal(recs["port"]) == _normal(recs["jax"])
    port = recs["port"]
    decide = [r for r in port if r["name"] == "autotune.decide"]
    assert len(decide) == epochs["port"]
    actions = [r["attrs"]["action"] for r in decide]
    assert actions[0] == "baseline" and "freeze" in actions
    assert actions[-1] == "converge"
    events = [r["name"] for r in port if r["kind"] == "event"]
    assert events == ["autotune.abort", "autotune.warm_start"]
    inner = [e["name"] for r in decide for e in r["events"]]
    assert "autotune.mutate" in inner and inner[-1] == "autotune.converged"


# -- ingest -----------------------------------------------------------------------

def _remote(tr, loader_cls, port, **kw):
    with tr.span("consumer") as root:
        ctx = root.context
        ld = loader_cls([("127.0.0.1", port)], batch_rows=ROWS, **kw)
        try:
            n = _drain(ld)
        finally:
            ld.close()
    return ctx, n


def _serve_epoch(recorder):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        got = [r for r in recorder.snapshot()
               if r["name"] == "ingest.serve_epoch"]
        if got:
            return got
        time.sleep(0.01)
    return []


def test_ingest_spans_equal_the_jax_workers(lib, tmp_path):
    path = _write_libsvm(tmp_path / "w.libsvm", 600, 4)
    tport = start_port_worker(f"file://{path}", 0, 1, max_epochs=1)
    ctx, n = _remote(teltrace, RemoteIngestLoader, tport, device="cpu")
    jport = start_jax_worker(f"file://{path}", 0, 1, max_epochs=1,
                             wire_compact=False)
    jctx, jn = _remote(jtrace, JRemoteIngestLoader, jport)
    assert n == jn > 5
    (serve,) = _serve_epoch(teltrace.recorder)
    (jserve,) = _serve_epoch(jtrace.recorder)
    assert serve["attrs"].pop("peer").startswith("('127.0.0.1'")
    jserve["attrs"].pop("peer")
    assert serve["attrs"] == jserve["attrs"] == {"part": 0, "nparts": 1,
                                                  "frames": n}
    h2d = [r for r in teltrace.recorder.snapshot()
           if r["name"] == "remote_ingest.h2d"]
    jh2d = [r for r in jtrace.recorder.snapshot()
            if r["name"] == "remote_ingest.h2d"]
    assert sorted(json.dumps(r["attrs"]) for r in h2d) == \
        sorted(json.dumps(r["attrs"]) for r in jh2d)
    assert len(h2d) == n
    for r in h2d:
        assert r["trace_id"] == teltrace.format_id(ctx.trace_id)
        assert r["parent_id"] == teltrace.format_id(ctx.span_id)
    for r in jh2d:
        assert r["parent_id"] == jtrace.format_id(jctx.span_id)
