"""Sparse models: logistic regression and the factorization machine.

Counterpart of ``dmlc_core_tpu/models/sparse.py``.  Each model is an
``nn.Module`` whose parameters carry the JAX package's parameter names
(``w``, ``b`` for logreg; ``w0``, ``w``, ``v`` for FM), so a JAX param
tree loads with ``load_state_dict`` (see :mod:`.convert`).

Both batch layouts are served and trained: flat CSR (``ids[nnz]`` +
``segments``, the ragged-gather kernels on CUDA) and row-padded
``ids[B, K]`` (the fm-terms kernels on CUDA), forward and backward on
every engine.  ``engine`` picks kernel or plain PyTorch as in
:mod:`dmlc_core_tpu_torch.kernels.common`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.common import gather_rows
from ..ops.csr import csr_dense_matvec, fm_pairwise, fm_reduce
from ..ops.embed import fm_embed_terms
from ..utils.device import resolve_device
from ..utils.logging import check

__all__ = ["SparseLogReg", "FactorizationMachine", "weighted_bce",
           "weighted_mse", "task_loss"]

Batch = Dict[str, torch.Tensor]
Device = Optional[Union[str, torch.device]]


def _is_rowmajor(batch: Batch) -> bool:
    return batch["ids"].dim() == 2


def _rowmajor_matvec(batch: Batch, w: torch.Tensor) -> torch.Tensor:
    # the [B, K] gather of a weight vector is tiny next to the factor
    # table: plain PyTorch on every engine, as XLA in the JAX package;
    # gather_rows gives it XLA's gradient rule for out-of-range ids
    picked = gather_rows(w, batch["ids"])
    return torch.einsum("bk,bk->b", batch["vals"], picked)


def _denominator(weights: torch.Tensor,
                 wsum: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.clamp(weights.sum(), min=1e-9) if wsum is None else wsum


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor,
                 wsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example-weighted binary cross-entropy on {0,1} or {-1,1}
    labels; rows of weight 0 drop out of numerator and count.  ``wsum``
    replaces the batch's clamped weight sum as the denominator (a
    data-parallel rank divides by the global batch's)."""
    y = (labels > 0).to(logits.dtype)
    per = -(y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
    return (per * weights).sum() / _denominator(weights, wsum)


def weighted_mse(pred: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor,
                 wsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    return ((weights * (pred - labels) ** 2).sum()
            / _denominator(weights, wsum))


def task_loss(out: torch.Tensor, batch: Batch, task: str, l2: float,
              *regs: torch.Tensor, wsum: Optional[torch.Tensor] = None,
              reg_scale: float = 1.0) -> torch.Tensor:
    """Binary BCE or regression MSE, plus l2 on the given tensors.

    A data-parallel rank passes ``wsum``, the global batch's clamped
    weight sum, and ``reg_scale`` = 1 / world: summed over the ranks,
    the losses (and gradients) are the global batch's, l2 counted
    once."""
    if task == "binary":
        base = weighted_bce(out, batch["labels"], batch["weights"], wsum)
    else:
        base = weighted_mse(out, batch["labels"], batch["weights"], wsum)
    if l2:
        base = base + (l2 * reg_scale) * sum(torch.sum(r ** 2) for r in regs)
    return base


class SparseLogReg(nn.Module):
    """w·x + b over flat-CSR or row-major batches."""

    def __init__(self, num_features: int, l2: float = 0.0,
                 engine: str = "auto", device: Device = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.num_features = num_features
        self.l2 = l2
        self.engine = engine
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.b = nn.Parameter(torch.zeros((), device=dev))

    def forward(self, batch: Batch) -> torch.Tensor:
        if _is_rowmajor(batch):
            return _rowmajor_matvec(batch, self.w) + self.b
        num_rows = batch["labels"].shape[0]
        z = csr_dense_matvec(batch["ids"], batch["vals"], batch["segments"],
                             self.w, num_rows, engine=self.engine)
        return z + self.b

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        reg = ((self.l2 * reg_scale) * torch.sum(self.w ** 2) if self.l2
               else 0.0)
        return weighted_bce(self(batch), batch["labels"],
                            batch["weights"], wsum) + reg


class FactorizationMachine(nn.Module):
    """Second-order FM: w0 + Σ w_i x_i + ½Σ_d[(Σ v_id x_i)² − Σ v_id² x_i²].

    ``v`` is drawn from ``init_scale · N(0, 1)`` with ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 when omitted)."""

    def __init__(self, num_features: int, dim: int = 16, l2: float = 0.0,
                 init_scale: float = 0.01, task: str = "binary",
                 engine: str = "auto", device: Device = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        check(task in ("binary", "regression"), f"bad task {task!r}")
        dev = resolve_device(device)
        self.num_features = num_features
        self.dim = dim
        self.l2 = l2
        self.task = task
        self.engine = engine
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        v = torch.empty(num_features, dim, device=dev)
        v.normal_(generator=generator).mul_(init_scale)
        self.w0 = nn.Parameter(torch.zeros((), device=dev))
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.v = nn.Parameter(v)

    def forward(self, batch: Batch) -> torch.Tensor:
        if _is_rowmajor(batch):
            linear = _rowmajor_matvec(batch, self.w)
            s1, s2 = fm_embed_terms(batch["ids"], batch["vals"], self.v,
                                    engine=self.engine)
            return self.w0 + linear + fm_reduce(s1, s2)
        num_rows = batch["labels"].shape[0]
        linear = csr_dense_matvec(batch["ids"], batch["vals"],
                                  batch["segments"], self.w, num_rows,
                                  engine=self.engine)
        pair = fm_pairwise(batch["ids"], batch["vals"], batch["segments"],
                           self.v, num_rows, engine=self.engine)
        return self.w0 + linear + pair

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, self.task, self.l2, self.w,
                         self.v, wsum=wsum, reg_scale=reg_scale)
