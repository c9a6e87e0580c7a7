"""Field-aware factorization machine over libfm batches.

Counterpart of ``dmlc_core_tpu/models/ffm.py``.  One latent vector per
(feature, field) pair, ``v[F, nf, d]``:

    ŷ = w0 + Σᵢ wᵢxᵢ + Σ_{i<j} ⟨v[idᵢ, fⱼ], v[idⱼ, fᵢ]⟩ xᵢxⱼ

computed, as in the JAX package, from the field-bucket sums
``G[b, g, h, :] = Σ_{k in row b, f_k = g} x_k · v[id_k, h, :]``:

    pair = ½ (Σ_{g,h} ⟨G[b,g,h], G[b,h,g]⟩ − Σ_k x_k² ‖v[id_k, f_k]‖²)

The bucket sum is, term for term, the embed variant of the ragged-gather
kernel: the table is ``v`` seen as ``[F, nf·d]`` and the segment of an
entry is ``row·nf + f``, so ``G`` is :func:`..ops.csr.csr_embed_sum`
over ``num_rows·nf`` segments, seen as ``[B, nf, nf, d]``, and its
gradient is the ragged-gather backward kernel at D = nf·d.  On the flat
layout padding entries (segment ``num_rows``) land on the kernel's
scratch row or past it and are dropped, as the JAX version cuts
``[:num_rows]``; the row-major layout ``[B, K]`` is flattened into the
same call with segment ``b·nf + f`` (no one-hot tensors).  The cross
term is a transpose and a reduction, the diagonal term a ``[nnz, d]``
gather: plain PyTorch, as XLA computes them in the JAX package.  The
linear term is :func:`..ops.csr.csr_dense_matvec` (flat) or the plain
row-major matvec.

Field ids are clipped into ``[0, nf - 1]``; ids follow XLA's two rules
(:mod:`..kernels.common`): the forward reads row ``clamp(id)``, the
backward drops an out-of-range id.

Placed on a mesh with ``mp`` (:mod:`.sharding`): in dim mode each rank
holds ``v[F, nf, d/mp]``, so ``G`` is the same kernel at ``D = nf·d/mp``
and the cross and diagonal terms are sums over the rank's ``d/mp``
columns, summed over ``mp``.  In rows mode each rank's ``G`` is a
partial sum over its rows' entries; the cross term is quadratic in
``G``, so ``G`` itself is summed over ``mp`` (``B·nf²·d`` floats, in one
all-reduce with the diagonal and linear partials) before it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels.common import clamp_ids, grad_rows, scatter_rows
from ..ops.csr import csr_dense_matvec, csr_embed_sum
from ..ops.ragged_csr import ragged_segment_sum
from ..utils.device import resolve_device
from ..utils.logging import check
from .sharding import mp_plan
from .sparse import _is_rowmajor, _rowmajor_matvec, l2_tensors, task_loss

__all__ = ["FieldAwareFM"]

Batch = Dict[str, torch.Tensor]
Device = Optional[Union[str, torch.device]]


def _check_fields(batch: Batch) -> torch.Tensor:
    if "fields" not in batch:
        raise KeyError(
            "FieldAwareFM needs a 'fields' batch array — construct the "
            "DeviceLoader with fields=True over libfm-format data")
    return batch["fields"]


class _FieldRows(torch.autograd.Function):
    """``v[ids, f]`` (``[n, d]``) with XLA's id rules on ``ids``: the
    forward reads ``v[clamp(id), f]``, the backward sends nothing for an
    id out of range (a negative id wraps once).  The composite row
    ``id·nf + f`` is built from the clamped id only."""

    @staticmethod
    def forward(ctx, v, ids, f):
        F, nf, d = v.shape
        ctx.save_for_backward(ids, f)
        ctx.shape = (F, nf, d)
        rows = clamp_ids(ids, F) * nf + f.long()
        return v.reshape(F * nf, d).index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        ids, f = ctx.saved_tensors
        F, nf, d = ctx.shape
        r = grad_rows(ids, F)                    # F: dropped
        rows = torch.where(r < F, r * nf + f.long(), F * nf)
        return scatter_rows(rows, g, F * nf).view(F, nf, d), None, None


class FieldAwareFM(nn.Module):
    """FFM with per-(feature, field) latent vectors ``v[F, nf, d]``, over
    flat or row-major batches that carry ``fields``
    (``DeviceLoader(..., fields=True)`` over libfm text).

    ``v`` is drawn from ``init_scale · N(0, 1)`` with ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 when omitted).
    ``engine`` picks kernel or plain PyTorch as in
    :mod:`dmlc_core_tpu_torch.kernels.common`."""

    l2_names = ("w", "v")

    def __init__(self, num_features: int, num_fields: int, dim: int = 4,
                 l2: float = 0.0, init_scale: float = 0.01,
                 task: str = "binary", engine: str = "auto",
                 device: Device = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        check(task in ("binary", "regression"), f"bad task {task!r}")
        check(num_fields >= 1, f"num_fields must be >= 1, got {num_fields}")
        dev = resolve_device(device)
        self.num_features = num_features
        self.num_fields = num_fields
        self.dim = dim
        self.l2 = l2
        self.task = task
        self.engine = engine
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        v = torch.empty(num_features, num_fields, dim, device=dev)
        v.normal_(generator=generator).mul_(init_scale)
        self.w0 = nn.Parameter(torch.zeros((), device=dev))
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.v = nn.Parameter(v)

    def _pair(self, ids: torch.Tensor, vals: torch.Tensor, f: torch.Tensor,
              target: torch.Tensor, num_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pairwise term's two parts from flat ``[n]`` entries whose
        bucket is ``target = row·nf + f``: the field-bucket sums ``G``
        (``[num_rows, nf, nf, d]``, of this rank's shard of ``v``) and
        the diagonal term per entry (``[n]``)."""
        Fl, nf, d = self.v.shape
        G = csr_embed_sum(ids, vals, target, self.v.view(Fl, nf * d),
                          num_rows * nf, engine=self.engine)
        own = _FieldRows.apply(self.v, ids, f)               # [n, d]
        return (G.view(num_rows, nf, nf, d),
                vals * vals * (own * own).sum(dim=-1))

    def forward(self, batch: Batch) -> torch.Tensor:
        fields = _check_fields(batch)
        nf = self.num_fields
        ids, vals = batch["ids"], batch["vals"]
        f = fields.clamp(0, nf - 1).to(torch.int32)
        num_rows = batch["labels"].shape[0]
        plan = mp_plan(self)
        segments = batch.get("segments")
        if plan is not None:
            ids, vals, segments = plan.local(ids, vals, segments, num_rows)
        if ids.dim() == 2:
            linear = _rowmajor_matvec({"ids": ids, "vals": vals}, self.w)
            rows = torch.arange(num_rows, dtype=torch.int32,
                                device=ids.device)[:, None]
            G, diag = self._pair(ids.reshape(-1), vals.reshape(-1),
                                 f.reshape(-1),
                                 (rows * nf + f).reshape(-1), num_rows)
            diag = diag.view(ids.shape).sum(dim=1)
        else:
            linear = csr_dense_matvec(ids, vals, segments, self.w, num_rows,
                                      engine=self.engine)
            G, diag = self._pair(ids, vals, f, segments * nf + f, num_rows)
            diag = ragged_segment_sum(diag, segments, ids.shape[0],
                                      num_rows)
        if plan is not None and plan.mode == "rows":
            got = plan.sum(torch.cat([G.reshape(num_rows, -1),
                                      diag[:, None], linear[:, None]], 1))
            G = got[:, :-2].view(G.shape)
            diag, linear = got[:, -2], got[:, -1]
        pair = 0.5 * ((G * G.transpose(1, 2)).sum(dim=(1, 2, 3)) - diag)
        if plan is not None and plan.mode == "dim":
            pair = plan.sum(pair)
        return self.w0 + linear + pair

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, self.task, self.l2,
                         *l2_tensors(self), wsum=wsum, reg_scale=reg_scale)
