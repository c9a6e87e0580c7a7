"""Host utilities of the port (counterpart of ``dmlc_core_tpu/utils``):
logging, device choice, checkpoints."""

from .checkpoint import (CheckpointManager, load_for_inference,  # noqa: F401
                         load_pytree, save_pytree)
from .device import resolve_device  # noqa: F401
from .logging import DMLCError, check, log_info  # noqa: F401

__all__ = ["DMLCError", "check", "log_info", "resolve_device",
           "save_pytree", "load_pytree", "CheckpointManager",
           "load_for_inference"]
