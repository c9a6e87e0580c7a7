"""Host utilities of the port (counterpart of ``dmlc_core_tpu/utils``):
logging, device choice, checkpoints (synchronous and asynchronous), the
binary serializer and in-memory streams, the parameter, config and
registry system of the CLI, and the profiler's ranges and captures
(``trace_span``, ``profile_trace``)."""

from .checkpoint import (CheckpointManager, Serializable,  # noqa: F401
                         fast_forward, flatten_tree, load_for_inference,
                         load_pytree, load_pytree_leaves, save_pytree,
                         unflatten_like)
from .config import Config  # noqa: F401
from .device import resolve_device  # noqa: F401
from .logging import (DMLCError, IdOverflowError, check,  # noqa: F401
                      log_info, log_warning)
from .metrics import profile_trace, trace_span  # noqa: F401
from .parameter import ParamError, Parameter, field  # noqa: F401
from .registry import Registry  # noqa: F401

__all__ = ["DMLCError", "IdOverflowError", "check", "log_info",
           "log_warning", "resolve_device",
           "save_pytree", "load_pytree", "CheckpointManager",
           "load_for_inference", "Serializable", "fast_forward",
           "flatten_tree", "unflatten_like", "load_pytree_leaves", "Config", "Parameter", "field",
           "ParamError", "Registry", "trace_span", "profile_trace"]
