"""DeepFM: the factorization machine plus a deep tower over its embedding.

Counterpart of ``dmlc_core_tpu/models/deep.py``::

    ŷ = w0 + Σ wᵢxᵢ + ½Σ_d[(Σ vx)² − Σ v²x²] + head(tower(Σ vx))

The tower input is the FM's first-order sum ``s1[B, D]``, already
computed for the pairwise term.  Parameters carry the JAX tree's names —
``w0``, ``w``, ``v``, ``tower.w [L, D, D]``, ``tower.b [L, D]``,
``head.w [D]``, ``head.b []`` — so ``params_from_jax`` of a JAX
``DeepFM.init`` tree loads with ``load_state_dict``.

The sparse gather is the only kernel work: on row-major batches the
fm-terms kernels (forward and backward) through ``fm_embed_terms``; on
flat batches ONE pass of the ragged gather's fm variant
(``csr_fm_terms``), which yields ``s1`` and ``s2 = Σ (v·x)²`` together.
The JAX package makes two ``csr_embed_sum`` calls there, the second on
``v*v`` against a materialised ``table*table`` (``Σ v²·x²``): the sums
agree up to rounding, and the port saves an ``[F, D]`` temporary (128 MiB
at F = 2^20, D = 32) a step.  The tower is a loop of
``tanh(h @ w + b)`` with ``torch.matmul``, as the JAX package leaves it
to XLA (``lax.scan``).  ``with_pipelined_tower`` (the tower GPipe-style
over a mesh axis) waits for the port's multi-GPU slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.csr import csr_dense_matvec, csr_fm_terms, fm_reduce
from ..ops.embed import fm_embed_terms
from ..utils.device import resolve_device
from ..utils.logging import check
from .dcn import _Linear
from .sparse import Batch, Device, _is_rowmajor, _rowmajor_matvec, task_loss

__all__ = ["DeepFM"]


class DeepFM(nn.Module):
    """FM + ``layers``-deep tower of width ``dim`` on the embedded
    features.

    ``v``, ``tower.w`` and ``head.w`` are drawn from ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 when omitted) with
    the JAX init's scales: ``init_scale·N(0,1)`` and ``N(0,1)/√dim``.
    ``engine`` picks kernel or plain PyTorch for the sparse gather, as in
    :mod:`dmlc_core_tpu_torch.kernels.common`."""

    def __init__(self, num_features: int, dim: int = 16, layers: int = 2,
                 l2: float = 0.0, init_scale: float = 0.01,
                 task: str = "binary", engine: str = "auto",
                 device: Device = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        check(task in ("binary", "regression"), f"bad task {task!r}")
        dev = resolve_device(device)
        self.num_features = num_features
        self.dim = dim
        self.layers = layers
        self.l2 = l2
        self.task = task
        self.engine = engine
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def normal(*shape):
            return torch.empty(*shape, device=dev).normal_(
                generator=generator)

        scale = 1.0 / math.sqrt(dim)
        self.w0 = nn.Parameter(torch.zeros((), device=dev))
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.v = nn.Parameter(normal(num_features, dim).mul_(init_scale))
        self.tower = _Linear(normal(layers, dim, dim).mul_(scale),
                             torch.zeros(layers, dim, device=dev))
        self.head = _Linear(normal(dim).mul_(scale),
                            torch.zeros((), device=dev))

    def _terms(self, batch: Batch):
        """``(linear[B], s1[B, D], s2[B, D])`` for either batch layout."""
        if _is_rowmajor(batch):
            linear = _rowmajor_matvec(batch, self.w)
            s1, s2 = fm_embed_terms(batch["ids"], batch["vals"], self.v,
                                    engine=self.engine)
            return linear, s1, s2
        num_rows = batch["labels"].shape[0]
        ids, vals, segs = batch["ids"], batch["vals"], batch["segments"]
        linear = csr_dense_matvec(ids, vals, segs, self.w, num_rows,
                                  engine=self.engine)
        s1, s2 = csr_fm_terms(ids, vals, segs, self.v, num_rows,
                              engine=self.engine)
        return linear, s1, s2

    def _tower(self, h: torch.Tensor) -> torch.Tensor:
        for w, b in zip(self.tower.w, self.tower.b):
            h = torch.tanh(h @ w + b)
        return h

    def forward(self, batch: Batch) -> torch.Tensor:
        linear, s1, s2 = self._terms(batch)
        deep = self._tower(s1) @ self.head.w + self.head.b
        return self.w0 + linear + fm_reduce(s1, s2) + deep

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, self.task, self.l2, self.w,
                         self.v, self.tower.w, self.head.w,
                         wsum=wsum, reg_scale=reg_scale)
