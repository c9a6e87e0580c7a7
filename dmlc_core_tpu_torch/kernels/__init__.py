"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

One ``.cu`` source per kernel family, built with ``nvcc`` for ``sm_90a``
at first use (:mod:`.build`) and bound with ctypes:

* :mod:`.ragged_gather` — counterpart of
  ``dmlc_core_tpu/ops/ragged_csr.py::_ragged_gather_kernel``, forward
  (``ragged_gather.cu``) and backward (``ragged_gather_grad.cu``);
* :mod:`.fm_terms` — counterpart of
  ``dmlc_core_tpu/ops/pallas_embed.py::_fm_kernel``, forward and the
  backward of its custom VJP (``fm_terms.cu``);
* :mod:`.embed_bag` — counterpart of
  ``dmlc_core_tpu/ops/pallas_embed.py::_kernel``, forward and backward
  (``embed_bag.cu``);
* :mod:`.optim` — the fused Adam and FTRL steps (``optim.cu``), which
  have no Pallas counterpart (the JAX package leaves them to XLA);
* :mod:`.wire_decode` — the decode of the v3 compact wire
  (``wire_decode.cu``), also XLA in the JAX package.

Nothing is compiled or loaded at import time.
"""

from .common import launch_counts, reset_launch_counts  # noqa: F401
from .optim import (adam_step, adam_step_reference,  # noqa: F401
                    ftrl_step, ftrl_step_reference)
from .embed_bag import (embed_bag_forward, embed_bag_grad,  # noqa: F401
                        embed_bag_grad_reference, embed_bag_reference)
from .fm_terms import (fm_terms, fm_terms_grad,  # noqa: F401
                       fm_terms_grad_reference, fm_terms_reference)
from .ragged_gather import (ragged_gather,  # noqa: F401
                            ragged_gather_grad, ragged_gather_grad_reference,
                            ragged_gather_reference,
                            ragged_gather_table_grad)
from .wire_decode import wire_decode, wire_decode_reference  # noqa: F401

__all__ = ["ragged_gather", "ragged_gather_reference", "ragged_gather_grad",
           "ragged_gather_grad_reference", "ragged_gather_table_grad",
           "fm_terms", "fm_terms_reference", "fm_terms_grad",
           "fm_terms_grad_reference",
           "embed_bag_forward", "embed_bag_reference", "embed_bag_grad",
           "embed_bag_grad_reference", "adam_step", "adam_step_reference",
           "ftrl_step", "ftrl_step_reference", "wire_decode",
           "wire_decode_reference", "launch_counts",
           "reset_launch_counts"]
