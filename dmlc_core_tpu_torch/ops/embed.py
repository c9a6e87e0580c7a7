"""Embedding-bag ops over row-padded ``[B, K]`` batches.

Counterpart of ``dmlc_core_tpu/ops/pallas_embed.py``: ``embed_bag``
(with the custom VJP of ``_embed_bag_pallas_diff``), ``fm_embed_terms``
(with its custom VJP) and ``embed_bag_reference``.  Padding entries carry
id 0 and value 0.  On CUDA tensors ``embed_bag`` runs the embed-bag
kernels and ``fm_embed_terms`` the fm-terms kernels, forward and
backward; on CPU tensors both run their kernels' plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.common import use_kernel
from ..kernels.embed_bag import (embed_bag_forward, embed_bag_grad,
                                 embed_bag_reference)
from ..kernels.fm_terms import fm_terms, fm_terms_grad

__all__ = ["embed_bag", "fm_embed_terms", "embed_bag_reference"]


class _FMTerms(torch.autograd.Function):
    """The fm-terms forward and backward from the engine's choice, as the
    JAX custom VJP of ``fm_embed_terms`` pairs the Pallas forward with its
    own backward; the differentiable surface is (vals, table)."""

    @staticmethod
    def forward(ctx, vals, table, ids, engine):
        ctx.save_for_backward(vals, table, ids)
        ctx.engine = engine
        return fm_terms(ids, vals, table, engine)

    @staticmethod
    def backward(ctx, g1, g2):
        vals, table, ids = ctx.saved_tensors
        dvals, dtable = fm_terms_grad(
            ids, vals, table, g1.contiguous(), g2.contiguous(),
            need_dvals=ctx.needs_input_grad[0],
            need_dtable=ctx.needs_input_grad[1], engine=ctx.engine)
        return dvals, dtable, None, None


def fm_embed_terms(ids: torch.Tensor, vals: torch.Tensor,
                   table: torch.Tensor, engine: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FM pair ``(Σ_k v·x, Σ_k v²·x²)``, each ``[B, D]``, from one
    pass over the gathered rows.  Differentiable with respect to ``vals``
    and ``table``: under autograd the call goes through a
    ``torch.autograd.Function`` whose backward is the fm-terms backward
    on the same engine."""
    use_kernel(engine, table.device)               # rejects a bad engine
    if torch.is_grad_enabled() and (table.requires_grad
                                    or vals.requires_grad):
        return _FMTerms.apply(vals, table, ids, engine)
    return fm_terms(ids, vals, table, engine)


class _EmbedBag(torch.autograd.Function):
    """Forward and backward from the engine's choice, as the JAX custom
    VJP pairs the Pallas forward with its own backward; ``ids`` (integer)
    has no gradient, so the differentiable surface is (vals, table)."""

    @staticmethod
    def forward(ctx, vals, table, ids, square, engine):
        ctx.save_for_backward(vals, table, ids)
        ctx.square, ctx.engine = square, engine
        return embed_bag_forward(ids, vals, table, square, engine)

    @staticmethod
    def backward(ctx, g):
        vals, table, ids = ctx.saved_tensors
        dvals, dtable = embed_bag_grad(
            ids, vals, table, g.contiguous(), ctx.square,
            need_dvals=ctx.needs_input_grad[0],
            need_dtable=ctx.needs_input_grad[1], engine=ctx.engine)
        return dvals, dtable, None, None, None


def embed_bag(ids: torch.Tensor, vals: torch.Tensor, table: torch.Tensor,
              engine: str = "auto", square: bool = False) -> torch.Tensor:
    """Weighted embedding bag over row-padded batches:
    ``out[b] = Σ_k vals[b,k]·f(table[ids[b,k]])`` with ``f = x²`` when
    ``square`` (only the gathered rows are squared).  Differentiable with
    respect to ``vals`` and ``table``."""
    use_kernel(engine, table.device)               # rejects a bad engine
    if torch.is_grad_enabled() and (table.requires_grad
                                    or vals.requires_grad):
        return _EmbedBag.apply(vals, table, ids, square, engine)
    return embed_bag_forward(ids, vals, table, square, engine)
