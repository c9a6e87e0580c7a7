"""Host utilities of the port (counterpart of ``dmlc_core_tpu/utils``):
logging, device choice, checkpoints."""

from .checkpoint import (CheckpointManager, load_for_inference,  # noqa: F401
                         load_pytree, save_pytree)
from .device import resolve_device  # noqa: F401
from .logging import (DMLCError, IdOverflowError, check,  # noqa: F401
                      log_info, log_warning)

__all__ = ["DMLCError", "IdOverflowError", "check", "log_info",
           "log_warning", "resolve_device",
           "save_pytree", "load_pytree", "CheckpointManager",
           "load_for_inference"]
