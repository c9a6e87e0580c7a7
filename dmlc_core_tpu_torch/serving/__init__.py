"""Online inference serving of the port (counterpart of
``dmlc_core_tpu/serving``): the bucketed :mod:`engine` (one captured
CUDA graph a bucket on the card), the :mod:`batcher`, and the TCP
:mod:`server` and :mod:`client` on the JAX package's wire.  The serving
fleet (registry, router, rollout) is not ported yet."""

from .engine import (BucketLadder, InferenceEngine,  # noqa: F401
                     RequestTooLarge, ShapeBucket)
from .batcher import (DeadlineExceeded, MicroBatcher,  # noqa: F401
                      Overloaded, Shutdown)
from .server import PredictionServer  # noqa: F401
from .client import (PredictClient, ServerOverloaded,  # noqa: F401
                     ServerRejected, run_load)

__all__ = ["ShapeBucket", "BucketLadder", "InferenceEngine",
           "RequestTooLarge", "MicroBatcher", "Overloaded",
           "DeadlineExceeded", "Shutdown", "PredictionServer",
           "PredictClient", "ServerOverloaded", "ServerRejected",
           "run_load"]
