"""Host-side batching of the port (counterpart of
``dmlc_core_tpu/pipeline``): fixed-shape packing and the device
loader."""

from .loader import DeviceLoader  # noqa: F401
from .packing import (PackStats, batch_slices, pack_flat,  # noqa: F401
                      pack_rowmajor)

__all__ = ["DeviceLoader", "PackStats", "batch_slices", "pack_flat",
           "pack_rowmajor"]
