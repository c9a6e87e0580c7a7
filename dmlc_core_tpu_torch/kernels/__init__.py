"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

One ``.cu`` source per kernel, built with ``nvcc`` for ``sm_90a`` at
first use (:mod:`.build`) and bound with ctypes:

* :mod:`.ragged_gather` — counterpart of
  ``dmlc_core_tpu/ops/ragged_csr.py::_ragged_gather_kernel``;
* :mod:`.fm_terms` — counterpart of
  ``dmlc_core_tpu/ops/pallas_embed.py::_fm_kernel`` (forward).

Nothing is compiled or loaded at import time.
"""

from .common import launch_counts, reset_launch_counts  # noqa: F401
from .fm_terms import fm_terms, fm_terms_reference  # noqa: F401
from .ragged_gather import (ragged_gather,  # noqa: F401
                            ragged_gather_reference)

__all__ = ["ragged_gather", "ragged_gather_reference", "fm_terms",
           "fm_terms_reference", "launch_counts", "reset_launch_counts"]
