"""Embedding-bag ops over row-padded ``[B, K]`` batches.

Counterpart of ``dmlc_core_tpu/ops/pallas_embed.py``, for
``fm_embed_terms`` (forward) and ``embed_bag_reference``.  Padding
entries carry id 0 and value 0.  ``fm_embed_terms`` runs the fm-terms
kernel on CUDA tensors and its plain version on CPU tensors.
``embed_bag`` with its own kernel comes with the model-zoo slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.common import clamp_ids
from ..kernels.fm_terms import fm_terms

__all__ = ["fm_embed_terms", "embed_bag_reference"]


def fm_embed_terms(ids: torch.Tensor, vals: torch.Tensor,
                   table: torch.Tensor, engine: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FM pair ``(Σ_k v·x, Σ_k v²·x²)``, each ``[B, D]``, from one
    pass over the gathered rows."""
    return fm_terms(ids, vals, table, engine=engine)


def embed_bag_reference(ids: torch.Tensor, vals: torch.Tensor,
                        table: torch.Tensor, square: bool = False
                        ) -> torch.Tensor:
    """out[b] = Σ_k vals[b,k]·f(table[ids[b,k]]), f = x² when
    ``square`` (only the gathered rows are squared)."""
    g = table[clamp_ids(ids, table.shape[0])]
    if square:
        g = g * g
    return torch.einsum("bk,bkd->bd", vals, g)
