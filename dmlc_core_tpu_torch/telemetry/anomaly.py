"""Streaming stall detection over a stage's durations.

Counterpart of the first part of ``dmlc_core_tpu/telemetry/anomaly.py``:
:class:`StreamingStat` (EWMA mean and EWMA absolute deviation, robust
z-scores) and :class:`StallDetector`, which flags a duration whose z
clears ``DMLC_STALL_Z`` (default 8; <= 0 turns flagging off) after a
warm-up, in the gauge ``anomaly.stall_z.<name>`` and the counter
``anomaly.stalls.<name>``.  The autotuner (:mod:`..pipeline.autotune`)
freezes its search while any ``anomaly.stalls.*`` counter moves.

A flagged stall is also noted in the flight recorder where one is
loaded; the port has none until ROADMAP A.12, so the lookup finds
nothing, as in :mod:`..utils.faults`.  The straggler board and the SLO
monitor are A.12 too.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from ..utils.logging import log_warning
from ..utils.metrics import metrics
from ..utils.parameter import get_env

__all__ = ["StreamingStat", "StallDetector"]


class StreamingStat:
    """EWMA mean + EWMA absolute-deviation scale, with robust z-scores.

    MAD-style: the deviation estimate tracks ``|x - mean|`` rather than
    squared error, so one huge outlier cannot inflate the scale enough
    to hide the next one.  ``1.4826`` converts a MAD to a Gaussian
    sigma-equivalent so thresholds read in familiar units.
    """

    __slots__ = ("alpha", "mean", "dev", "n")

    def __init__(self, alpha: float = 0.25) -> None:
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.dev = 0.0
        self.n = 0

    def zscore(self, x: float, rel_floor: float = 0.0) -> float:
        """Robust z of ``x`` against the CURRENT estimate (call before
        :meth:`update` so a sample is judged by its history, not itself).
        ``rel_floor`` sets a minimum scale as a fraction of the mean so
        tiny absolute jitter on a quiet stream can't produce huge z."""
        if self.mean is None or self.n < 1:
            return 0.0
        scale = max(1.4826 * self.dev, rel_floor * abs(self.mean), 1e-12)
        return (x - self.mean) / scale

    def update(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.mean is None:
            self.mean = x
            return
        self.dev += self.alpha * (abs(x - self.mean) - self.dev)
        self.mean += self.alpha * (x - self.mean)


class StallDetector:
    """Per-stage stall flagging from a stream of durations.

    ``observe(dur_s)`` is the whole API: compute the robust z against the
    stage's own history, update the estimate, and when the z clears the
    threshold after a warm-up count, flag it (gauge + counter + flight
    note).  ``DMLC_STALL_Z`` <= 0 disables flagging (observation still
    updates, so re-enabling doesn't start cold).
    """

    def __init__(self, name: str, z_threshold: Optional[float] = None,
                 min_samples: int = 16, alpha: float = 0.25,
                 rel_floor: float = 0.5) -> None:
        self.name = name
        if z_threshold is None:
            z_threshold = get_env("DMLC_STALL_Z", 8.0)
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self.rel_floor = float(rel_floor)
        self._stat = StreamingStat(alpha=alpha)
        self._lock = threading.Lock()
        self._m_gen = -1
        self._bind()

    def _bind(self) -> None:
        self._m_gen = metrics.generation
        self._m_z = metrics.gauge(f"anomaly.stall_z.{self.name}")
        self._m_stalls = metrics.counter(f"anomaly.stalls.{self.name}")

    def observe(self, dur_s: float) -> float:
        """Feed one duration; returns the z-score it was judged at."""
        with self._lock:
            z = self._stat.zscore(dur_s, rel_floor=self.rel_floor)
            self._stat.update(dur_s)
            n = self._stat.n
        if self._m_gen != metrics.generation:
            self._bind()
        self._m_z.set(z)
        if (self.z_threshold > 0 and n > self.min_samples
                and z > self.z_threshold):
            self._m_stalls.add(1)
            log_warning("anomaly: stage %r stalled (%.4fs, z=%.1f over "
                        "EWMA %.4fs)", self.name, dur_s, z,
                        self._stat.mean or 0.0)
            fl = sys.modules.get("dmlc_core_tpu_torch.telemetry.flight")
            if fl is not None:
                fl.note("stage_stall", stage=self.name,
                        dur_s=float(dur_s), z=float(z))
        return z
