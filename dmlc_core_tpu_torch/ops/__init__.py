"""Sparse ops of the port (counterpart of ``dmlc_core_tpu/ops``)."""

from .csr import (csr_dense_matvec, csr_embed_sum,  # noqa: F401
                  csr_fm_terms, fm_pairwise, fm_reduce)
from .embed import (embed_bag, embed_bag_reference,  # noqa: F401
                    fm_embed_terms)
from .ragged_csr import (mask_batch, mask_ragged,  # noqa: F401
                         ragged_dense_matvec, ragged_embed_grad,
                         ragged_embed_sum, ragged_fm_pairwise,
                         ragged_segment_sum)

__all__ = ["csr_dense_matvec", "csr_embed_sum", "csr_fm_terms",
           "fm_pairwise", "fm_reduce",
           "embed_bag", "fm_embed_terms", "embed_bag_reference",
           "mask_ragged", "mask_batch", "ragged_segment_sum",
           "ragged_dense_matvec", "ragged_embed_sum", "ragged_embed_grad",
           "ragged_fm_pairwise"]
