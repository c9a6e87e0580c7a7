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

Placed on a mesh with ``mp`` (:func:`.sharding.shard_params`), a model
runs the same kernels on its shard and adds the collectives of its
table mode (:mod:`.sharding`): in dim mode FM sums its pairwise term's
partials over ``mp``; in rows mode each rank keeps the entries of its
rows and ``s1``, ``s2`` and the linear term are summed over ``mp`` in
one all-reduce, laid end to end, before the pairwise formula.  Logreg
has no ``v``: replicated in dim mode, its ``w`` split by rows in rows
mode.  ``l2_names`` names the parameters the l2 penalty covers.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.common import gather_rows
from ..ops.csr import (csr_dense_matvec, csr_embed_sum, csr_fm_terms,
                       fm_reduce)
from ..ops.embed import embed_bag, fm_embed_terms
from ..utils.device import resolve_device
from ..utils.logging import check
from .sharding import mp_plan

__all__ = ["SparseLogReg", "FactorizationMachine", "weighted_bce",
           "weighted_mse", "task_loss", "l2_tensors"]

Batch = Dict[str, torch.Tensor]
Device = Optional[Union[str, torch.device]]


def _is_rowmajor(batch: Batch) -> bool:
    return batch["ids"].dim() == 2


def l2_tensors(model: nn.Module):
    """The tensors the model's l2 penalty covers (its ``l2_names``)."""
    return [model.get_parameter(n) for n in model.l2_names]


def sparse_terms(model: nn.Module, batch: Batch, fm: bool = True):
    """``(linear[B], s1[B, D], s2[B, D])`` of ``model``'s ``w`` and ``v``
    over either batch layout (``s2`` None unless ``fm``; with ``fm``
    False, ``s1`` is the embedding bag ``Σ v·x``): this rank's partials
    where the model is sharded by rows, its columns in dim mode."""
    plan = mp_plan(model)
    ids, vals = batch["ids"], batch["vals"]
    num_rows = batch["labels"].shape[0]
    segs = batch.get("segments")
    if plan is not None:
        ids, vals, segs = plan.local(ids, vals, segs, num_rows)
    v = getattr(model, "v", None)
    if ids.dim() == 2:
        linear = _rowmajor_matvec({"ids": ids, "vals": vals}, model.w)
        if v is None:
            return linear, None, None
        if fm:
            s1, s2 = fm_embed_terms(ids, vals, v, engine=model.engine)
            return linear, s1, s2
        return linear, embed_bag(ids, vals, v, engine=model.engine), None
    linear = csr_dense_matvec(ids, vals, segs, model.w, num_rows,
                              engine=model.engine)
    if v is None:
        return linear, None, None
    if fm:
        s1, s2 = csr_fm_terms(ids, vals, segs, v, num_rows,
                              engine=model.engine)
        return linear, s1, s2
    return linear, csr_embed_sum(ids, vals, segs, v, num_rows,
                                 engine=model.engine), None


def whole_terms(model: nn.Module, linear: torch.Tensor,
                s1: Optional[torch.Tensor], s2: Optional[torch.Tensor],
                need_s1: bool = False):
    """``(linear, pair, s1)`` of the whole model from this rank's
    :func:`sparse_terms`: the pairwise FM term ``½Σ_d(s1² − s2)`` (None
    without ``s2``) and, with ``need_s1``, the whole ``s1`` (else None).
    Dim mode: the pair's partials summed over ``mp``, or, with
    ``need_s1``, gathered beside ``s1``'s columns in one all-gather.
    Rows mode: ``s1``, ``s2`` and ``linear`` summed over ``mp`` in one
    all-reduce."""
    plan = mp_plan(model)
    if plan is not None and plan.mode == "rows":
        parts = [linear[:, None]] + [t for t in (s1, s2) if t is not None]
        got = plan.sum(torch.cat(parts, 1))
        linear = got[:, 0]
        if s1 is not None:
            d = s1.shape[1]
            s1 = got[:, 1:1 + d]
            s2 = got[:, 1 + d:] if s2 is not None else None
        plan = None
    pair = fm_reduce(s1, s2) if s2 is not None else None
    if plan is None:
        return linear, pair, s1 if need_s1 else None
    if s2 is None:
        return linear, None, plan.gather(s1) if need_s1 else None
    if not need_s1:
        return linear, plan.sum(pair), None
    B, d = s1.shape
    got = plan.gather(torch.cat([s1, pair[:, None]], 1)).view(B, -1, d + 1)
    return linear, got[..., d].sum(1), got[..., :d].reshape(B, -1)


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

    l2_names = ("w",)

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
        linear, _, _ = whole_terms(self, *sparse_terms(self, batch))
        return linear + self.b

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, "binary", self.l2,
                         *l2_tensors(self), wsum=wsum, reg_scale=reg_scale)


class FactorizationMachine(nn.Module):
    """Second-order FM: w0 + Σ w_i x_i + ½Σ_d[(Σ v_id x_i)² − Σ v_id² x_i²].

    ``v`` is drawn from ``init_scale · N(0, 1)`` with ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 when omitted)."""

    l2_names = ("w", "v")

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
        linear, pair, _ = whole_terms(self, *sparse_terms(self, batch))
        return self.w0 + linear + pair

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, self.task, self.l2,
                         *l2_tensors(self), wsum=wsum, reg_scale=reg_scale)
