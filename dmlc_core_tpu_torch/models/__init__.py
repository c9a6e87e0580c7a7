"""Models of the port (counterpart of ``dmlc_core_tpu/models``)."""

from .convert import (adam_state_from_optax,  # noqa: F401
                      adam_state_to_optax, ftrl_state_from_optax,
                      ftrl_state_to_optax, params_from_jax, params_to_numpy)
from .dcn import DCNv2  # noqa: F401
from .deep import DeepFM  # noqa: F401
from .ffm import FieldAwareFM  # noqa: F401
from .ftrl import FTRL  # noqa: F401
from .optim import Adam  # noqa: F401
from .sparse import (FactorizationMachine, SparseLogReg,  # noqa: F401
                     task_loss, weighted_bce, weighted_mse)
from .sharding import ShardPlan  # noqa: F401
from .train import (FusedTrainer, MeshStep, adam,  # noqa: F401
                    auc_from_histograms, batch_sharding, evaluate_stream,
                    fit_stream, gather_params, make_eval_step,
                    make_train_step, make_train_step_fused,
                    make_train_step_kbatch, param_shardings, shard_params,
                    stack_batches, streaming_auc)

__all__ = ["SparseLogReg", "FactorizationMachine", "FieldAwareFM", "DCNv2",
           "DeepFM",
           "weighted_bce", "weighted_mse", "task_loss", "params_from_jax",
           "params_to_numpy", "adam_state_to_optax", "adam_state_from_optax",
           "ftrl_state_to_optax", "ftrl_state_from_optax", "Adam", "FTRL",
           "make_train_step", "make_eval_step", "streaming_auc",
           "auc_from_histograms", "evaluate_stream", "fit_stream", "adam",
           "make_train_step_fused", "FusedTrainer", "make_train_step_kbatch",
           "stack_batches", "batch_sharding", "param_shardings",
           "shard_params", "gather_params", "ShardPlan", "MeshStep"]
