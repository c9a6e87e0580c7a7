"""Host-side batching of the port (counterpart of
``dmlc_core_tpu/pipeline``): fixed-shape and ragged packing, the device
loader with its pack and transfer threads and the fused wire (v2 and the
v3 compact layout), disaggregated ingest (:mod:`.ingest_service`), the
persisted transfer tuning (:mod:`.tuned`), the transfer probe that
persists it (:mod:`.probe`, ``python -m
dmlc_core_tpu_torch.pipeline.probe``) and the closed-loop autotuner
(:mod:`.autotune`).  The data service (ROADMAP A.9) waits for the
serving fleet's reactor (A.11.b); the tracker's liveness board,
``utils/durable.py`` and the endpoint lists it also needs are ported
(A.7.b, A.11.a)."""

from .autotune import (Autotuner, Knob, ingest_knob_space,  # noqa: F401
                       maybe_autotuner, serving_knob_space)
from .fingerprint import autotune_key, host_shape  # noqa: F401
from .ingest_service import (RemoteIngestLoader,  # noqa: F401
                             ingest_worker_main, serve_ingest)
from .loader import DeviceLoader, fused_words, make_decoder  # noqa: F401
from .packing import (PackStats, batch_slices, dedup_ids,  # noqa: F401
                      pack_flat, pack_ragged, pack_rowmajor, ragged_slices)

__all__ = ["DeviceLoader", "make_decoder", "fused_words", "PackStats",
           "batch_slices", "pack_flat", "pack_rowmajor", "pack_ragged",
           "ragged_slices", "dedup_ids", "serve_ingest", "RemoteIngestLoader",
           "ingest_worker_main", "Autotuner", "Knob", "ingest_knob_space",
           "serving_knob_space", "maybe_autotuner", "autotune_key",
           "host_shape"]
