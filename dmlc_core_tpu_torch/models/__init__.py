"""Models of the port (counterpart of ``dmlc_core_tpu/models``)."""

from .convert import params_from_jax, params_to_numpy  # noqa: F401
from .dcn import DCNv2  # noqa: F401
from .sparse import (FactorizationMachine, SparseLogReg,  # noqa: F401
                     task_loss, weighted_bce, weighted_mse)
from .train import (adam, auc_from_histograms, evaluate_stream,  # noqa: F401
                    fit_stream, make_eval_step, make_train_step,
                    streaming_auc)

__all__ = ["SparseLogReg", "FactorizationMachine", "DCNv2", "weighted_bce",
           "weighted_mse", "task_loss", "params_from_jax", "params_to_numpy",
           "make_train_step", "make_eval_step", "streaming_auc",
           "auc_from_histograms", "evaluate_stream", "fit_stream", "adam"]
