"""Telemetry of the port (counterpart of ``dmlc_core_tpu/telemetry``).

Only :class:`~.anomaly.StreamingStat` and :class:`~.anomaly.StallDetector`
are ported, for the ingest worker and the autotuner's freeze signal.  The
rest of the JAX package's telemetry (traces and spans, the exporter, SLO
monitor, flight recorder, straggler board, diagnosis, sampling) is ROADMAP
queue A.12.
"""

from .anomaly import StallDetector, StreamingStat  # noqa: F401

__all__ = ["StreamingStat", "StallDetector"]
