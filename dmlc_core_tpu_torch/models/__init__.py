"""Models of the port (counterpart of ``dmlc_core_tpu/models``)."""

from .convert import params_from_jax, params_to_numpy  # noqa: F401
from .sparse import (FactorizationMachine, SparseLogReg,  # noqa: F401
                     task_loss, weighted_bce, weighted_mse)

__all__ = ["SparseLogReg", "FactorizationMachine", "weighted_bce",
           "weighted_mse", "task_loss", "params_from_jax", "params_to_numpy"]
