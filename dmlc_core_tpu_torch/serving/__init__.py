"""Online inference serving of the port (counterpart of
``dmlc_core_tpu/serving``): the bucketed :mod:`engine` and the
:mod:`batcher`.  The TCP server and client come in a later slice."""

from .engine import (BucketLadder, InferenceEngine,  # noqa: F401
                     RequestTooLarge, ShapeBucket)
from .batcher import (DeadlineExceeded, MicroBatcher,  # noqa: F401
                      Overloaded, Shutdown)

__all__ = ["ShapeBucket", "BucketLadder", "InferenceEngine",
           "RequestTooLarge", "MicroBatcher", "Overloaded",
           "DeadlineExceeded", "Shutdown"]
