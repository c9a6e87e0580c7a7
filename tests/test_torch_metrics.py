"""The port's metrics registry survives a finalizer that records a metric.

The collector runs a finalizer on whatever thread it interrupts, so a
finalizer can run inside the registry's or a metric's critical section.
When that finalizer records a counter on the same lock, a plain lock
deadlocks the thread.  The JAX registry keeps that lock across each
metric's ``snapshot()``; the port's takes no metric call under it and
its locks are re-entrant.  Each case runs in a thread joined for a
bounded time, so a regression fails instead of hanging the run."""

import threading

import pytest

pytest.importorskip("torch")

from dmlc_core_tpu_torch.utils.metrics import (Counter, Histogram,  # noqa
                                                MetricsRegistry,
                                                StageTimer,
                                                ThroughputMeter)

JOIN_S = 10.0


def _bounded(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "the call hung (a lock taken twice)"
    if "err" in box:
        raise box["err"]
    return box["out"]


class _Records:
    """An object whose finalizer records a counter in ``reg``."""

    def __init__(self, reg: MetricsRegistry, name: str) -> None:
        self.reg, self.name = reg, name

    def __del__(self) -> None:
        self.reg.counter(self.name).add(1)


def test_a_finalizer_inside_a_metrics_snapshot_does_not_hang():
    reg = MetricsRegistry()

    class Drops:
        """A metric whose snapshot() drops the last reference to an
        object that records a counter when it is finalized."""

        def __init__(self) -> None:
            self.held = _Records(reg, "finalized")

        def snapshot(self):
            self.held = None        # __del__ runs here, on this thread
            return {"type": "drops"}

    reg.counter("before").add(2)
    reg._get("drops", Drops)
    snap = _bounded(reg.snapshot)
    assert snap["drops"] == {"type": "drops"}
    assert snap["before"] == {"type": "counter", "value": 2}
    assert reg.counter("finalized").value == 1
    # the next snapshot shows the finalizer's counter
    assert _bounded(reg.snapshot)["finalized"]["value"] == 1


def test_a_finalizer_while_a_metric_is_built_does_not_hang():
    reg = MetricsRegistry()

    class BuiltWithGarbage:
        def __init__(self) -> None:
            # the last reference to a recorder dies while this metric is
            # built for the registry
            _Records(reg, "built")

        def snapshot(self):
            return {"type": "x"}

    m = _bounded(lambda: reg._get("x", BuiltWithGarbage))
    assert reg._get("x", BuiltWithGarbage) is m
    assert reg.counter("built").value == 1


@pytest.mark.parametrize("make, record", [
    (Counter, lambda m: m.add(1)),
    (Histogram, lambda m: m.observe(1.0)),
    (ThroughputMeter, lambda m: m.add(1)),
    (StageTimer, lambda m: m.time().__enter__()),
], ids=["counter", "histogram", "throughput", "stage"])
def test_a_metric_admits_its_own_thread_inside_its_lock(make, record):
    """What a finalizer does when it interrupts a metric mid-update and
    records into the same metric: it must not block on the lock its own
    thread holds."""
    m = make()

    def inside():
        with m._lock:
            record(m)
            return m.snapshot()

    snap = _bounded(inside)
    assert snap["type"] in ("counter", "histogram", "throughput", "stage")


def test_reset_and_snapshot_keep_their_results():
    reg = MetricsRegistry()
    reg.counter("a").add(3)
    reg.histogram("h").observe(2.0)
    snap = reg.snapshot()
    assert list(snap) == ["a", "h"]
    assert snap["a"]["value"] == 3 and snap["h"]["count"] == 1
    gen = reg.generation
    reg.reset()
    assert reg.snapshot() == {} and reg.generation == gen + 1
