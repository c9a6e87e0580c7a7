"""Sparse ops of the port (counterpart of ``dmlc_core_tpu/ops``)."""

from .csr import (csr_dense_matvec, csr_embed_sum,  # noqa: F401
                  fm_pairwise, fm_reduce)
from .embed import embed_bag_reference, fm_embed_terms  # noqa: F401
from .ragged_csr import (mask_batch, mask_ragged,  # noqa: F401
                         ragged_dense_matvec, ragged_embed_sum,
                         ragged_fm_pairwise, ragged_segment_sum)

__all__ = ["csr_dense_matvec", "csr_embed_sum", "fm_pairwise", "fm_reduce",
           "fm_embed_terms", "embed_bag_reference", "mask_ragged",
           "mask_batch", "ragged_segment_sum", "ragged_dense_matvec",
           "ragged_embed_sum", "ragged_fm_pairwise"]
