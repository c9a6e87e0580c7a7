"""The port's metric history (``telemetry/timeseries.py``) and the
duration parser of ``telemetry/slo.py``, held against the JAX package's.

* ``parse_tiers`` and ``parse_duration`` give equal values, and each bad
  spec raises in both (exact).
* Two ``HistoryStore``\\ s, one of each package, fed the same seeded
  sequence of snapshots (every metric type, a counter that restarts, a
  stage, more series than ``max_series``) under one injected clock give
  equal series names, queries, ``timeline`` and ``snapshot_doc``
  documents and ``render_timeline_text`` pages, and count equal resets,
  dropped series and samples in their registries (exact).
* The sampler thread starts and stops; ``DMLC_TIMELINE=0`` keeps it off.

The ``history`` fixture stops both packages' process-wide samplers
around each test.
"""

import importlib
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.telemetry import slo as jslo  # noqa: E402
from dmlc_core_tpu.telemetry import timeseries as jts  # noqa: E402
from dmlc_core_tpu.telemetry.anomaly import \
    SloSpecError as JSloSpecError  # noqa: E402
from dmlc_core_tpu_torch.telemetry import slo  # noqa: E402
from dmlc_core_tpu_torch.telemetry import timeseries as ts  # noqa: E402
from dmlc_core_tpu_torch.telemetry.anomaly import SloSpecError  # noqa: E402
from test_torch_exposition import history  # noqa: E402,F401

jmetrics = importlib.import_module("dmlc_core_tpu.utils.metrics").metrics
tmetrics = importlib.import_module("dmlc_core_tpu_torch.utils.metrics").metrics

#: a synthetic epoch, a multiple of every tier step below
T0 = 1_000_000.0
TIERS = [(1.0, 5), (10.0, 4)]


@pytest.mark.parametrize("spec", ["1x300,10x360", " 0.5x10 ", "2x3,4x5,8x6"])
def test_parse_tiers_equal(spec):
    assert ts.parse_tiers(spec) == jts.parse_tiers(spec)


@pytest.mark.parametrize("bad", ["5", "", "0x10", "1xz", "10x5,1x300",
                                 "1x0", "-1x3"])
def test_parse_tiers_bad_specs_raise_in_both(bad):
    with pytest.raises(ts.TierSpecError):
        ts.parse_tiers(bad)
    with pytest.raises(jts.TierSpecError):
        jts.parse_tiers(bad)


@pytest.mark.parametrize("text", ["250ms", "30s", "5m", "1h", "12", " 2.5S ",
                                  "0.5m"])
def test_parse_duration_equal(text):
    assert slo.parse_duration(text) == jslo.parse_duration(text)


@pytest.mark.parametrize("bad", ["soon", "", "ms", "5x", "1.2.3s"])
def test_parse_duration_bad_raise_in_both(bad):
    with pytest.raises(SloSpecError):
        slo.parse_duration(bad)
    with pytest.raises(JSloSpecError):
        jslo.parse_duration(bad)


def _snapshots(seed, n):
    """``n`` snapshot dicts of every type: a counter that restarts twice, a
    gauge, a histogram, a throughput meter, a stage, and a burst of
    short-lived gauges that overflows ``max_series``."""
    rng = np.random.default_rng(seed)
    c = calls = 0
    total = 0.0
    out = []
    for i in range(n):
        c = 0 if i in (13, 29) else c + int(rng.integers(0, 20))
        step = int(rng.integers(0, 3))
        calls += step
        total += step * float(rng.random()) * 0.01
        lat = np.sort(rng.exponential(0.01, 3))
        snap = {
            "reqs": {"type": "counter", "value": c},
            "q.depth": {"type": "gauge", "value": float(rng.integers(0, 9))},
            "lat_s": {"type": "histogram", "count": 10 * i,
                      "p50": float(lat[0]), "p95": float(lat[1]),
                      "p99": float(lat[2]), "mean": float(lat.mean())},
            "bytes": {"type": "throughput", "total": 100 * i,
                      "windowed_rate": float(rng.random() * 1e6)},
            "step": {"type": "stage", "count": calls, "total_sec": total},
            "junk": 7,
        }
        if i % 7 == 3:
            snap[f"burst.{i}"] = {"type": "gauge", "value": 1.0}
        out.append(snap)
    return out


class _Clock:
    """A module's ``time`` with a fixed ``time()``, for the documents'
    ``now`` and cutoffs."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now


def _fed(mod, snaps, max_series=8):
    seq = iter(snaps)
    store = mod.HistoryStore(snapshot_fn=lambda: next(seq), tiers=TIERS,
                             max_series=max_series)
    for i in range(len(snaps)):
        store.sample_once(now=T0 + i)
    return store


def _counts(reg):
    return tuple(reg.counter(k).value for k in (
        "telemetry.counter_resets", "telemetry.timeline.dropped_series",
        "telemetry.timeline.samples"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_history_stores_equal_the_jax_one(seed, monkeypatch):
    snaps = _snapshots(seed, 45)
    c0, j0 = _counts(tmetrics), _counts(jmetrics)
    port = _fed(ts, snaps)
    jax_ = _fed(jts, snaps)
    dc = tuple(a - b for a, b in zip(_counts(tmetrics), c0))
    dj = tuple(a - b for a, b in zip(_counts(jmetrics), j0))
    assert dc == dj and dc[0] == 2 and dc[1] > 0 and dc[2] == len(snaps)
    names = port.series_names()
    assert names == jax_.series_names() and len(names) == 8
    now = T0 + len(snaps) - 1
    for name in names + ["missing"]:
        for since in (None, 3.0, 4.0, 20.0, 40.0, 1e6):
            assert port.query(name, since=since, now=now) == \
                jax_.query(name, since=since, now=now)
    for mod in (ts, jts):
        monkeypatch.setattr(mod, "time", _Clock(now + 0.5))
    for metric in (None, "reqs", "lat_s", "step", "bytes", "q.depth", "x"):
        for since in (None, 4.0, 30.0):
            doc = port.timeline(metric, since)
            assert doc == jax_.timeline(metric, since)
            assert ts.render_timeline_text(doc) == \
                jts.render_timeline_text(doc)
    for since in (None, 10.0):
        assert port.snapshot_doc(since) == jax_.snapshot_doc(since)


def test_render_timeline_text_cases_equal():
    docs = [{"series": ["a", "b.rate"]}, {"series": {}},
            {"series": {"a": {"tiers": [{"step_s": 1.0, "points": []}]}}},
            {"series": {"a": {"tiers": [
                {"step_s": 1.0, "points": [[0, 1.0], [1, 1.0]]},
                {"step_s": 10.0, "points": [[0, 2.0], [10, 5.0]]}]}}}]
    rng = np.random.default_rng(7)
    docs.append({"series": {"z": {"tiers": [
        {"step_s": 1.0, "points": [[i, float(v)] for i, v in
                                   enumerate(rng.normal(size=90))]}]}}})
    for doc in docs:
        assert ts.render_timeline_text(doc) == jts.render_timeline_text(doc)
    assert ts.render_timeline_text({"series": {}}).startswith(
        "timeline: no matching series")


def test_sampler_thread_lifecycle():
    vals = {"v": 1.0}
    store = ts.HistoryStore(
        snapshot_fn=lambda: {"g": {"type": "gauge", "value": vals["v"]}},
        tiers=[(1.0, 30)])
    assert not store.running
    store.start(interval_s=0.02)
    assert store.running and store.start() is store
    try:
        for _ in range(500):
            if store.query("g"):
                break
            time.sleep(0.01)
    finally:
        store.stop()
    assert not store.running and store.query("g")
    store.start(interval_s=0.02)          # a stopped store starts again
    assert store.running
    store.stop()


def test_maybe_start_sampler_honours_dmlc_timeline(monkeypatch, history):
    monkeypatch.setenv("DMLC_TIMELINE", "0")
    assert ts.maybe_start_sampler() is None and not history.running
    monkeypatch.setenv("DMLC_TIMELINE", "1")
    assert ts.maybe_start_sampler() is history and history.running
