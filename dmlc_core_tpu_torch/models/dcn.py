"""Deep & Cross Network v2 over sparse streaming batches.

Counterpart of ``dmlc_core_tpu/models/dcn.py``::

    x_{l+1} = x_0 ⊙ (W_l x_l + b_l) + x_l,        x_0 = Σ_k v_k·E[id_k]

plus a linear wide term.  Parameters carry the JAX tree's names —
``w0``, ``w``, ``v``, ``cross.w [L, D, D]``, ``cross.b [L, D]``,
``head.w [D]``, ``head.b []`` — so ``params_from_jax`` of a JAX
``DCNv2.init`` tree loads with ``load_state_dict``.

The sparse gather is the only kernel work: the embed-bag kernels
(forward and backward) on row-major batches, the ragged-gather kernels
on flat batches.  The cross layers are a loop of ``torch.matmul`` over
the ``[L, D, D]`` stack, as the JAX package leaves them to XLA.

Placed on a mesh with ``mp`` (:mod:`.sharding`), each rank gathers with
its shard of ``v`` and ``x0`` is made whole before the cross network:
all-gathered over ``mp`` in dim mode (each rank holds ``x0``'s columns),
summed with the linear term's partials in rows mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.logging import check
from .sparse import (Batch, Device, l2_tensors, sparse_terms, task_loss,
                     whole_terms)

__all__ = ["DCNv2"]


class _Linear(nn.Module):
    """A ``{"w", "b"}`` sub-tree of the JAX parameters."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor) -> None:
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class DCNv2(nn.Module):
    """Cross network (v2, full-matrix) + linear wide term.

    ``layers`` is the cross depth.  ``v``, ``cross.w`` and ``head.w`` are
    drawn from ``generator`` (a ``torch.Generator`` on the model's
    device; seed 0 when omitted) with the JAX init's scales:
    ``init_scale·N(0,1)`` and ``N(0,1)/√dim``.  ``engine`` picks kernel
    or plain PyTorch for the sparse gather, as in
    :mod:`dmlc_core_tpu_torch.kernels.common`."""

    l2_names = ("w", "v", "cross.w", "head.w")

    def __init__(self, num_features: int, dim: int = 16, layers: int = 3,
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
        self.cross = _Linear(normal(layers, dim, dim).mul_(scale),
                             torch.zeros(layers, dim, device=dev))
        self.head = _Linear(normal(dim).mul_(scale),
                            torch.zeros((), device=dev))

    def _embed(self, batch: Batch):
        """``(linear[B], x0[B, D])`` for either batch layout."""
        linear, x0, _ = sparse_terms(self, batch, fm=False)
        linear, _, x0 = whole_terms(self, linear, x0, None, need_s1=True)
        return linear, x0

    def _cross(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for w, b in zip(self.cross.w, self.cross.b):
            x = x0 * (x @ w + b) + x
        return x

    def forward(self, batch: Batch) -> torch.Tensor:
        linear, x0 = self._embed(batch)
        xL = self._cross(x0)
        return self.w0 + linear + xL @ self.head.w + self.head.b

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, self.task, self.l2,
                         *l2_tensors(self), wsum=wsum, reg_scale=reg_scale)
