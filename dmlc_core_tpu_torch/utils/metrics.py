"""Process-wide metrics: counters, gauges, histograms, rates, stage timers.

Counterpart of ``dmlc_core_tpu/utils/metrics.py``, copied so that the
port never imports the JAX package:

* :class:`Counter` / :class:`Gauge` — monotonic / point-in-time values.
* :class:`Histogram` — value distribution with quantile estimation
  (exact up to a sample cap, reservoir-sampled beyond it, with a seeded
  reservoir RNG so a replayed stream reports identical quantiles),
  :meth:`Histogram.merge` of serialized states, and exemplars: the
  trace id of an observation made inside a live trace, one slot per
  value region.
* :class:`ThroughputMeter` — units with total, overall and windowed
  rates.
* :class:`StageTimer` — accumulated wall time of a stage.
* :class:`MetricsRegistry` — named metrics with ``snapshot()``,
  ``state()``, ``report()`` and ``reset()`` (which bumps
  ``generation``, so hot paths that cache handles re-fetch them), and
  the process-global :data:`metrics`.
* :func:`trace_span` — a named host range on the ``torch.profiler``
  timeline (``record_function``), and on the card an NVTX range too,
  opened only while a capture runs: the JAX package's
  ``jax.profiler.TraceAnnotation``.
* :func:`profile_trace` — a ``torch.profiler`` capture of a block (the
  host, and the card's kernels and copies when CUDA is up) written as a
  Chrome trace into a directory: the JAX package's ``jax.profiler``
  trace.

One difference from the JAX module: a finalizer may record a metric.
The collector runs a finalizer on whatever thread it interrupts, inside
any critical section of this module, so every lock here is re-entrant,
the registry builds a metric outside its lock and calls no metric's
``snapshot()`` under it.  The JAX registry holds its plain lock across
each metric's ``snapshot()``: a finalizer that records a counter there
deadlocks its thread (ROADMAP queue C).
"""

from __future__ import annotations

import contextlib
import math
import os
import random
import sys
import threading
import time
from typing import (Any, Callable, ContextManager, Dict, Iterator, List,
                    Optional, Sequence)

from .logging import log_info

__all__ = ["Counter", "Gauge", "Histogram", "ThroughputMeter", "StageTimer",
           "MetricsRegistry", "metrics", "trace_span", "profile_trace"]


class Counter:
    """Monotonic counter (thread-safe)."""

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.RLock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            v = self._v
        return {"type": "counter", "value": v}

    def state(self) -> Dict[str, Any]:
        return self.snapshot()

    @classmethod
    def merge(cls, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        return {"type": "counter",
                "value": sum(int(s.get("value", 0)) for s in states)}


class Gauge:
    """Last-set value."""

    def __init__(self) -> None:
        self._v: float = 0.0

    def set(self, v: float) -> None:
        self._v = v

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self._v}

    def state(self) -> Dict[str, Any]:
        return self.snapshot()

    @classmethod
    def merge(cls, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """The worst (largest) value: health-style gauges encode severity
        as magnitude."""
        vals = [float(s.get("value", 0.0)) for s in states]
        return {"type": "gauge", "value": max(vals) if vals else 0.0}


#: exemplar slots per histogram, one per value region (at most half the
#: mean, at most the mean, at most twice the mean, the tail beyond)
_EXEMPLAR_SLOTS = 4


def _active_trace_hex() -> Optional[str]:
    """Hex trace id of the ambient trace context, or None.  Found through
    ``sys.modules``, so this module never imports the telemetry package
    (which imports it back): a process that never loaded tracing pays
    one dict lookup."""
    tr = sys.modules.get("dmlc_core_tpu_torch.telemetry.trace")
    if tr is None:
        return None
    try:
        return tr.current_trace_id()
    except Exception:
        return None


class Histogram:
    """Value distribution with quantile estimation (thread-safe).

    Exact while the stream fits in ``max_samples``; past that, reservoir
    sampling keeps a uniform sample of everything seen, while count, sum,
    min and max stay exact.

    An observation made inside a live trace context keeps ``(value,
    trace_id, ts)`` as an *exemplar*, in one of :data:`_EXEMPLAR_SLOTS`
    slots by its value against the running mean, so the tail slot always
    names a concrete slow request.  :meth:`snapshot` carries them under
    ``exemplars`` (absent when there are none)."""

    def __init__(self, max_samples: int = 8192, seed: int = 0) -> None:
        if max_samples <= 0:
            raise ValueError("max_samples must be > 0")
        self._cap = int(max_samples)
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._rng = random.Random(seed)
        self._exemplars: List[Any] = [None] * _EXEMPLAR_SLOTS
        self._lock = threading.RLock()

    def observe(self, v: float) -> None:
        v = float(v)
        tid = _active_trace_hex()
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._samples[j] = v
            if tid is not None:
                mean = self._sum / self._count
                slot = (0 if v <= 0.5 * mean else
                        1 if v <= mean else
                        2 if v <= 2.0 * mean else 3)
                self._exemplars[slot] = (v, tid, time.time())

    @contextlib.contextmanager
    def time(self, clock: Callable[[], float] = time.monotonic
             ) -> Iterator[None]:
        """Observe the wall time of a block (seconds)."""
        t0 = clock()
        try:
            yield
        finally:
            self.observe(clock() - t0)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def quantile(self, q: float) -> float:
        return self.quantiles([q])[0]

    @staticmethod
    def _interp(sorted_samples: List[float], qs: Sequence[float]
                ) -> List[float]:
        """Linear interpolation between closest ranks (numpy's default)."""
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile must be in [0, 1], got {q}")
        s = sorted_samples
        if not s:
            return [0.0 for _ in qs]
        out = []
        for q in qs:
            pos = q * (len(s) - 1)
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(s) - 1)
            out.append(s[lo] + (pos - lo) * (s[hi] - s[lo]))
        return out

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        """Quantiles over the (possibly sampled) observation set."""
        with self._lock:
            s = sorted(self._samples)
        return self._interp(s, qs)

    def snapshot(self) -> Dict[str, Any]:
        # one lock for the whole view, so a concurrent observe() cannot
        # tear it (count ahead of sum, a quantile behind max)
        with self._lock:
            count, sum_ = self._count, self._sum
            mn = self._min if count else 0.0
            mx = self._max if count else 0.0
            s = sorted(self._samples)
            ex = [{"value": val, "trace_id": t, "ts": ts}
                  for (val, t, ts) in
                  (e for e in self._exemplars if e is not None)]
        p50, p95, p99 = self._interp(s, [0.5, 0.95, 0.99])
        snap = {"type": "histogram", "count": count,
                "mean": sum_ / count if count else 0.0, "min": mn, "max": mx,
                "p50": p50, "p95": p95, "p99": p99}
        if ex:
            # absent when no traced observation happened, so consumers
            # that never see traces get the same keys as before
            snap["exemplars"] = ex
        return snap

    def state(self) -> Dict[str, Any]:
        """Serialized reservoir state (exact moments and the sample set),
        what :meth:`merge` takes."""
        with self._lock:
            count = self._count
            return {"type": "histogram", "count": count, "sum": self._sum,
                    "min": self._min if count else 0.0,
                    "max": self._max if count else 0.0,
                    "samples": list(self._samples)}

    @classmethod
    def merge(cls, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Merge serialized states into one snapshot-form dict: moments
        exactly, quantiles from the union of reservoirs with each sample
        weighted by the observations it stands for (``count_i /
        len(samples_i)``)."""
        count = 0
        sum_ = 0.0
        mn, mx = math.inf, -math.inf
        weighted: List[Any] = []   # (value, weight) pairs
        for s in states:
            c = int(s.get("count", 0))
            if c <= 0:
                continue
            count += c
            sum_ += float(s.get("sum", 0.0))
            mn = min(mn, float(s.get("min", math.inf)))
            mx = max(mx, float(s.get("max", -math.inf)))
            samples = s.get("samples") or []
            if samples:
                w = c / len(samples)
                weighted.extend((float(v), w) for v in samples)
        if not count:
            return {"type": "histogram", "count": 0, "mean": 0.0,
                    "min": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0}
        weighted.sort(key=lambda vw: vw[0])
        p50, p95, p99 = cls._weighted_quantiles(weighted, [0.5, 0.95, 0.99])
        return {"type": "histogram", "count": count, "mean": sum_ / count,
                "min": mn, "max": mx, "p50": p50, "p95": p95, "p99": p99}

    @staticmethod
    def _weighted_quantiles(sorted_vw: List[Any], qs: Sequence[float]
                            ) -> List[float]:
        """Midpoint rule: sample i sits at cumulative position ``cum_i -
        w_i/2``; interpolate between the bracketing samples."""
        total_w = sum(w for _, w in sorted_vw)
        if total_w <= 0:
            return [0.0 for _ in qs]
        pos = []
        cum = 0.0
        for _, w in sorted_vw:
            pos.append(cum + w / 2.0)
            cum += w
        out = []
        for q in qs:
            target = q * total_w
            if target <= pos[0]:
                out.append(sorted_vw[0][0])
                continue
            if target >= pos[-1]:
                out.append(sorted_vw[-1][0])
                continue
            lo, hi = 0, len(pos) - 1
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if pos[mid] <= target:
                    lo = mid
                else:
                    hi = mid
            v0, v1 = sorted_vw[lo][0], sorted_vw[hi][0]
            span = pos[hi] - pos[lo]
            frac = (target - pos[lo]) / span if span > 0 else 0.0
            out.append(v0 + frac * (v1 - v0))
        return out


class ThroughputMeter:
    """Rate meter: total units, overall and windowed rates."""

    def __init__(self, window_sec: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._start = clock()
        self._total = 0
        self._win_start = self._start
        self._win_total = 0
        self._win_rate = 0.0
        self._win_closed = False
        self._window = window_sec
        self._lock = threading.RLock()

    def add(self, n: int) -> None:
        with self._lock:
            self._total += n
            self._win_total += n
            now = self._clock()
            if now - self._win_start >= self._window:
                self._win_rate = self._win_total / (now - self._win_start)
                self._win_closed = True
                self._win_start = now
                self._win_total = 0

    @property
    def total(self) -> int:
        return self._total

    def _rate_locked(self, now: float) -> float:
        dt = now - self._start
        return self._total / dt if dt > 0 else 0.0

    def _windowed_locked(self, now: float) -> float:
        elapsed = now - self._win_start
        if elapsed >= self._window:
            # window overdue: the rate over the open (maybe stalled) span
            return self._win_total / elapsed
        if self._win_closed:
            return self._win_rate
        return self._rate_locked(now)   # before the first window closes

    def rate(self) -> float:
        """Overall units/sec since construction."""
        with self._lock:
            return self._rate_locked(self._clock())

    def windowed_rate(self) -> float:
        """Units/sec over the current or last window; a stalled stream
        decays toward 0 as its open window ages."""
        with self._lock:
            return self._windowed_locked(self._clock())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            now = self._clock()
            return {"type": "throughput", "total": self._total,
                    "rate": self._rate_locked(now),
                    "windowed_rate": self._windowed_locked(now)}

    def state(self) -> Dict[str, Any]:
        return self.snapshot()

    @classmethod
    def merge(cls, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Totals and rates sum across ranks (parallel streams)."""
        return {"type": "throughput",
                "total": sum(int(s.get("total", 0)) for s in states),
                "rate": sum(float(s.get("rate", 0.0)) for s in states),
                "windowed_rate": sum(float(s.get("windowed_rate", 0.0))
                                     for s in states)}


class StageTimer:
    """Accumulated wall time of one stage: ``with timer.time(): ...`` or
    ``@timer`` on a function; count, total and mean seconds."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._count = 0
        self._total = 0.0
        self._lock = threading.RLock()

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self._count += 1
                self._total += dt

    def __call__(self, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            with self.time():
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped

    @property
    def count(self) -> int:
        return self._count

    @property
    def total_sec(self) -> float:
        return self._total

    @property
    def mean_sec(self) -> float:
        return self._total / self._count if self._count else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._total
        return {"type": "stage", "count": count, "total_sec": total,
                "mean_sec": total / count if count else 0.0}

    def state(self) -> Dict[str, Any]:
        return self.snapshot()

    @classmethod
    def merge(cls, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        count = sum(int(s.get("count", 0)) for s in states)
        total = sum(float(s.get("total_sec", 0.0)) for s in states)
        return {"type": "stage", "count": count, "total_sec": total,
                "mean_sec": total / count if count else 0.0}


class MetricsRegistry:
    """Named metrics (``serving.batcher.batches``, ...) with one-call
    snapshot and report."""

    def __init__(self) -> None:
        self._m: Dict[str, Any] = {}
        self._lock = threading.RLock()
        #: bumped by reset(); hot paths that cache metric handles compare
        #: it (one int read, no lock) and re-fetch when it changes
        self.generation = 0

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._m.get(name)
        if m is None:
            # built outside the lock: a finalizer that runs while it
            # allocates may itself fetch a metric
            made = cls(**kw)
            with self._lock:
                m = self._m.setdefault(name, made)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 8192) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    def throughput(self, name: str,
                   window_sec: float = 5.0) -> ThroughputMeter:
        return self._get(name, ThroughputMeter, window_sec=window_sec)

    def stage(self, name: str) -> StageTimer:
        return self._get(name, StageTimer)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        # each metric's snapshot() runs after the lock is released, as in
        # state(): a finalizer it triggers may record a metric
        with self._lock:
            items = sorted(self._m.items())
        return {k: v.snapshot() for k, v in items}

    def state(self) -> Dict[str, Dict[str, Any]]:
        """Serialized mergeable view of every metric."""
        with self._lock:
            items = sorted(self._m.items())
        return {k: v.state() for k, v in items}

    def report(self) -> None:
        for name, snap in self.snapshot().items():
            log_info("metric %s: %s", name,
                     " ".join(f"{k}={v:.3f}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in snap.items()
                              if k != "type"))

    def reset(self) -> None:
        with self._lock:
            dropped, self._m = self._m, {}
            self.generation += 1
        del dropped


#: process-global registry (modules grab sub-metrics by name)
metrics = MetricsRegistry()


def trace_span(name: str) -> ContextManager[None]:
    """A named host range on the ``torch.profiler`` timeline
    (``record_function``), with an NVTX range around it once CUDA is up
    in this process.  The range is opened only while a ``torch.profiler``
    capture runs (:func:`profile_trace`); otherwise this is a no-op that
    costs one attribute read, as the JAX package's annotation costs
    nothing without ``jax.profiler``."""
    import torch
    if not getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return _NO_RANGE
    return _profiler_range(name)


_NO_RANGE = contextlib.nullcontext()


@contextlib.contextmanager
def _profiler_range(name: str) -> Iterator[None]:
    import torch
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[Any]:
    """Capture the block with ``torch.profiler`` and write it as a Chrome
    trace, ``<log_dir>/trace_<pid>_<random>.json`` (Perfetto and
    ``chrome://tracing`` open it).  The host's ops and :func:`trace_span`
    ranges of every thread are captured, and the card's kernels, copies
    and memsets when CUDA is available.  Yields the profiler; its
    ``trace_path`` names the file once it is written.

    Once the block has run, every later kernel launch of the process
    costs more host time (CUPTI stays attached): profile at the end of a
    run, or in a process of its own."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kw: Dict[str, Any] = {}
    try:
        # the loader's pack and transfer threads are not the caller's
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    os.makedirs(log_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix=f"trace_{os.getpid()}_",
                                suffix=".json", dir=log_dir)
    os.close(fd)
    prof = torch.profiler.profile(activities=acts, **kw)
    prof.trace_path = None
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(path)
        prof.trace_path = path
