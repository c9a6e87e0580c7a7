"""The port's capture watchdog and device-memory gauges
(``telemetry/graph_introspect.py``), held against the JAX package's
compile watchdog (``telemetry/xla_introspect.py``) on the CPU.

* The same seeded sequences of feed calls (captures, hits, warm-up
  windows, ladder misses) give both watchdogs equal snapshots, equal
  ``xla.*`` metrics and equal flight notes (exact).
* The port's engine on the CPU feeds the watchdog as the JAX engine
  feeds its own, on the same ladder and calls: one capture per bucket
  in ``warmup_all`` under the JAX bucket keys (flat and ragged), one hit
  per call after it, no alert; a request past the ladder counts a ladder
  miss, latches the alert and notes it.
* A second engine that captures lazily after the first went steady
  raises the recapture alert (counter, latched gauge, a flight note and
  a ``retrace_alert`` bundle), as a second JAX engine's compile does;
  one that warms up first does not.
* A hit on a steady bucket takes no lock and looks up no metric, and
  follows a registry reset.
* ``sample_memory`` returns False and sets nothing without CUDA, and
  initialises nothing; on a (faked) initialised allocator its gauges are
  the allocator's numbers, and a device with no memory reserved is not
  read.

The ``history`` fixture (``tests/test_torch_exposition.py``) clears both
watchdogs and puts back both flight recorders around each test.
"""

import importlib
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.serving import engine as jengine  # noqa: E402
from dmlc_core_tpu.telemetry import flight as jflight  # noqa: E402
from dmlc_core_tpu.telemetry import xla_introspect as jxla  # noqa: E402
from dmlc_core_tpu_torch.serving import BucketLadder  # noqa: E402
from dmlc_core_tpu_torch.serving import RequestTooLarge  # noqa: E402
from dmlc_core_tpu_torch.telemetry import flight  # noqa: E402
from dmlc_core_tpu_torch.telemetry import graph_introspect as gi  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401
from test_torch_server import _fm_params, _jax_fm, _port_fm, _req  # noqa: E402

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics")
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics")

LADDER = [(8, 128), (16, 512)]
PACKAGES = {"port": (gi, tmetrics, flight), "jax": (jxla, jmetrics, jflight)}


def _xla(snapshot):
    """The ``xla.*`` metrics of a snapshot, the compile-time histogram by
    its count only (its values are wall times)."""
    out = {}
    for k, v in snapshot.items():
        if k.startswith("xla."):
            out[k] = ({"type": v["type"], "count": v["count"]}
                      if k == "xla.compile_seconds" else v)
    return out


def _notes(fl):
    return [{k: v for k, v in n.items() if k not in ("ts", "wall_s")}
            for n in fl.flight_recorder.notes()]


@pytest.fixture()
def fresh(monkeypatch):
    """A fresh watchdog over a fresh registry in each package, installed
    where its engine looks it up; empty flight note rings."""
    regs = {}
    for name, (mod, mmod, fl) in PACKAGES.items():
        regs[name] = mmod.MetricsRegistry()
        monkeypatch.setattr(mod, "watchdog",
                            mod.RetraceWatchdog(registry=regs[name]))
        fl.flight_recorder._notes.clear()
    return regs


# ---------------------------------------------------------------------------
# the watchdog, call for call
# ---------------------------------------------------------------------------

def _calls(seed, n=60):
    rng = np.random.default_rng(seed)
    keys = ["r8x128", "r16x512", "ragged-r128x8192"]
    out = []
    for _ in range(n):
        op = rng.choice(["compile", "hit", "hit", "hit", "steady",
                         "steady_one", "warmup", "miss"])
        key = str(rng.choice(keys))
        out.append((str(op), key, round(float(rng.random()), 6)))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_watchdogs_agree_call_for_call(fresh, seed):
    got = {}
    for name, (mod, _, fl) in PACKAGES.items():
        wd = mod.watchdog
        retraces = []
        for op, key, wall in _calls(seed):
            if op == "compile":
                retraces.append(wd.note_compile(key, wall))
            elif op == "hit":
                wd.note_hit(key)
            elif op == "steady":
                wd.mark_steady()
            elif op == "steady_one":
                wd.mark_steady(key)
            elif op == "warmup":
                wd.begin_warmup()
            else:
                wd.note_ladder_miss(f"too big {key}")
        snap = wd.snapshot()
        got[name] = (retraces, snap, wd.alerted,
                     fresh[name].snapshot(), _notes(fl))
        wd.reset_alert()
        assert not wd.alerted
        assert fresh[name].gauge("xla.retrace_alert").value == 0
    assert got["port"] == got["jax"]
    assert any(got["port"][0]) and got["port"][2]


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [_req(rng, int(rng.integers(1, 16)), 8) for _ in range(n)]


def test_engine_feeds_the_watchdog_as_the_jax_engine_does(fresh):
    params = _fm_params(2)
    engines = {"port": _port_fm(params, buckets=BucketLadder(LADDER)),
               "jax": _jax_fm(params, LADDER)}
    reqs = _requests(4, 9)
    got = {}
    for name, eng in engines.items():
        mod, _, fl = PACKAGES[name]
        eng.warmup_all()
        after_warmup = _xla(fresh[name].snapshot())
        for r in reqs:
            eng.predict(*r)
        with pytest.raises(Exception) as e:
            eng.predict(*_req(np.random.default_rng(1), 80, 2))
        got[name] = (after_warmup, _xla(fresh[name].snapshot()),
                     {k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                      for k, v in mod.watchdog.snapshot()["buckets"].items()},
                     _notes(fl), type(e.value).__name__)
    assert got["port"] == got["jax"]
    after_warmup, final, buckets, notes, exc = got["port"]
    assert exc == "RequestTooLarge"
    assert after_warmup == {
        "xla.compiles": {"type": "counter", "value": 2},
        "xla.compile.r8x128": {"type": "counter", "value": 1},
        "xla.compile.r16x512": {"type": "counter", "value": 1},
        "xla.compile_seconds": {"type": "histogram", "count": 2}}
    assert final["xla.cache_hits"]["value"] == len(reqs)
    assert final["xla.ladder_misses"]["value"] == 1
    assert final["xla.retrace_alert"]["value"] == 1
    assert "xla.retrace_alerts" not in final
    assert buckets == {"r8x128": {"compiles": 1, "steady": True},
                       "r16x512": {"compiles": 1, "steady": True}}
    assert [n["kind"] for n in notes] == ["ladder_miss"]


def test_ragged_buckets_take_the_jax_keys(fresh):
    params = _fm_params(3)
    ladder = BucketLadder.ragged_default(max_rows=16, max_nnz=256, tiers=2)
    eng = _port_fm(params, buckets=ladder, ragged=True)
    eng.warmup_all()
    eng.predict(*_req(np.random.default_rng(0), 3, 4))
    snap = fresh["port"].snapshot()
    assert {k for k in snap if k.startswith("xla.compile.")} == \
        {"xla.compile.ragged-r16x256", "xla.compile.ragged-r8x128"}
    assert snap["xla.cache_hits"]["value"] == 1
    assert gi.bucket_key(16, 256, True) == "ragged-r16x256"
    assert gi.bucket_key(16, 256, False) == "r16x256"


def test_lazy_recapture_after_steady_alerts_and_dumps(fresh, tmp_path):
    params = _fm_params(1)
    req = _req(np.random.default_rng(2), 4, 4)
    got = {}
    for name, make in (("port", lambda: _port_fm(
                            params, buckets=BucketLadder(LADDER))),
                       ("jax", lambda: _jax_fm(params, LADDER))):
        mod, _, fl = PACKAGES[name]
        fl.flight_recorder.arm(str(tmp_path / name))
        fl.flight_recorder._min_interval = 0.0
        first = make()
        first.warmup_all()
        second = make()
        second.warmup_all()          # a declared window: no alert
        quiet = mod.watchdog.alerted
        third = make()
        third.predict(*req)          # captures lazily: a recapture
        got[name] = (quiet, mod.watchdog.alerted,
                     _xla(fresh[name].snapshot()), _notes(fl),
                     sorted(d.rsplit("-", 1)[-1]
                            for d in os.listdir(tmp_path / name)))
    assert got["port"] == got["jax"]
    quiet, alerted, snap, notes, bundles = got["port"]
    assert not quiet and alerted
    assert snap["xla.retrace_alerts"]["value"] == 1
    assert snap["xla.retrace_alert"]["value"] == 1
    assert snap["xla.compiles"]["value"] == 5
    assert [n["kind"] for n in notes] == ["retrace_alert"]
    assert notes[0]["bucket"] == "r8x128"
    assert bundles == ["retrace_alert"]


def test_a_steady_hit_takes_no_lock_and_looks_up_no_metric(fresh):
    wd = gi.watchdog
    reg = fresh["port"]
    wd.note_compile("r8x128", 0.1)
    wd.mark_steady()
    wd.note_hit("r8x128")                      # binds the handle

    class NoLock:
        def __enter__(self):
            raise AssertionError("a steady hit took the lock")

        def __exit__(self, *a):
            return False

    lock, counter = wd._lock, reg.counter
    wd._lock = NoLock()
    reg.counter = lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("a hit looked a metric up"))
    try:
        for _ in range(100):
            wd.note_hit("r8x128")
    finally:
        wd._lock, reg.counter = lock, counter
    assert reg.counter("xla.cache_hits").value == 101
    reg.reset()                                # a new generation: rebinds
    wd.note_hit("r8x128")
    assert reg.counter("xla.cache_hits").value == 1


# ---------------------------------------------------------------------------
# the memory gauges
# ---------------------------------------------------------------------------

def test_sample_memory_without_cuda_sets_nothing_and_inits_nothing():
    reg = tmetrics.MetricsRegistry()
    assert not torch.cuda.is_initialized()
    assert gi.sample_memory(reg) is False
    assert reg.snapshot() == {}
    assert not torch.cuda.is_initialized()


def test_sample_memory_reads_the_allocator(monkeypatch):
    stats = {0: {"reserved_bytes.all.current": 4 << 20,
                 "allocated_bytes.all.current": 3 << 20,
                 "allocated_bytes.all.peak": 5 << 20,
                 "active.all.current": 7},
             1: {"reserved_bytes.all.current": 0},
             2: {"reserved_bytes.all.current": 2 << 20,
                 "allocated_bytes.all.current": 1 << 20,
                 "allocated_bytes.all.peak": 1 << 20,
                 "active.all.current": 2}}
    asked = []

    def mem_get_info(dev):
        asked.append(dev)
        return (1 << 30, (80 + dev) << 30)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: stats[dev])
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    reg = tmetrics.MetricsRegistry()
    assert gi.sample_memory(reg) is True
    snap = {k: v["value"] for k, v in reg.snapshot().items()}
    assert snap.pop("xla.mem.sampled_ts") > 0
    assert snap == {"xla.live_buffers": 9,
                    "xla.mem.0.bytes_in_use": 3 << 20,
                    "xla.mem.0.peak_bytes_in_use": 5 << 20,
                    "xla.mem.0.bytes_limit": 80 << 30,
                    "xla.mem.2.bytes_in_use": 1 << 20,
                    "xla.mem.2.peak_bytes_in_use": 1 << 20,
                    "xla.mem.2.bytes_limit": 82 << 30}
    assert asked == [0, 2]
    # the JAX gauges' names
    assert {k.split(".")[-1] for k in snap if k.startswith("xla.mem.")} == \
        {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


def test_engine_predict_raises_the_ports_request_too_large(fresh):
    eng = _port_fm(_fm_params(0), buckets=BucketLadder(LADDER))
    with pytest.raises(RequestTooLarge) as e:
        eng.predict(*_req(np.random.default_rng(1), 40, 2))
    jeng = _jax_fm(_fm_params(0), LADDER)
    with pytest.raises(jengine.RequestTooLarge) as je:
        jeng.predict(*_req(np.random.default_rng(1), 40, 2))
    assert str(e.value) == str(je.value)
    assert _notes(flight) == [{"kind": "ladder_miss",
                               "detail": str(e.value)}]
