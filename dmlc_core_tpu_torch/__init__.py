"""dmlc_core_tpu_torch — the PyTorch/CUDA port of ``dmlc_core_tpu``.

Runs on an NVIDIA H100 (Hopper, ``sm_90a``) with kernels written by hand
in CUDA C++ where the JAX package had Pallas kernels.  Its layout mirrors
the JAX package (``ops/``, ``models/``, ``serving/``, ``utils/``, plus
``kernels/``), and each module names its JAX counterpart.  It imports
``torch`` and ``numpy`` and nothing of JAX or of ``dmlc_core_tpu``.

Entry points run on ``cuda`` unless given ``device="cpu"``; on the CPU
every op runs its kernel's plain PyTorch version.

This slice serves the factorization machine::

    from dmlc_core_tpu_torch import (FactorizationMachine, InferenceEngine,
                                     MicroBatcher)
    model = FactorizationMachine(num_features=1 << 20, dim=32)
    engine = InferenceEngine(model, postprocess="sigmoid", warmup=True)
    with MicroBatcher(engine) as batcher:
        scores = batcher.submit(ids, vals, row_ptr).result()
"""

from . import kernels, models, ops, serving, utils  # noqa: F401
from .models import (FactorizationMachine, SparseLogReg,  # noqa: F401
                     params_from_jax, params_to_numpy)
from .serving import (BucketLadder, InferenceEngine,  # noqa: F401
                      MicroBatcher)
from .utils import CheckpointManager, DMLCError  # noqa: F401

__version__ = "0.1.0"

__all__ = ["FactorizationMachine", "SparseLogReg", "params_from_jax",
           "params_to_numpy", "InferenceEngine", "BucketLadder",
           "MicroBatcher", "CheckpointManager", "DMLCError"]
