"""Host-side batching of the port (counterpart of
``dmlc_core_tpu/pipeline``): fixed-shape and ragged packing, and the
device loader with its pack and transfer threads and the fused wire."""

from .loader import DeviceLoader, fused_words, make_decoder  # noqa: F401
from .packing import (PackStats, batch_slices, pack_flat,  # noqa: F401
                      pack_ragged, pack_rowmajor, ragged_slices)

__all__ = ["DeviceLoader", "make_decoder", "fused_words", "PackStats",
           "batch_slices", "pack_flat", "pack_rowmajor", "pack_ragged",
           "ragged_slices"]
