"""Online inference serving of the port (counterpart of
``dmlc_core_tpu/serving``): the bucketed :mod:`engine` (one captured
CUDA graph a bucket on the card), the :mod:`batcher`, the TCP
:mod:`server` and :mod:`client` on the JAX package's wire, and the
fleet's control plane (:mod:`fleet`: the registry, its agent and canary
rollouts; its router is ROADMAP queue A.11.b)."""

from .engine import (BucketLadder, InferenceEngine,  # noqa: F401
                     RequestTooLarge, ShapeBucket)
from .batcher import (DeadlineExceeded, MicroBatcher,  # noqa: F401
                      Overloaded, Shutdown)
from .server import PredictionServer  # noqa: F401
from .client import (PredictClient, ServerOverloaded,  # noqa: F401
                     ServerRejected, run_load)
from .fleet import (ReplicaAgent, ReplicaRegistry,  # noqa: F401
                    RolloutManager, fleet_rpc)

__all__ = ["ShapeBucket", "BucketLadder", "InferenceEngine",
           "RequestTooLarge", "MicroBatcher", "Overloaded",
           "DeadlineExceeded", "Shutdown", "PredictionServer",
           "PredictClient", "ServerOverloaded", "ServerRejected",
           "run_load", "ReplicaRegistry", "ReplicaAgent", "fleet_rpc",
           "RolloutManager"]
