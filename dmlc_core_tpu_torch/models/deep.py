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
to XLA (``lax.scan``).

On a mesh (:mod:`.sharding`): with ``mp``, ``s1`` is made whole as
DCNv2's ``x0`` is (dim mode: all-gathered, the pairwise term's partials
riding in the same all-gather; rows mode: ``s1``, ``s2`` and the linear
term summed in one all-reduce), and the pairwise term is FM's.
``with_pipelined_tower`` runs the tower GPipe-style over a ``pp`` axis
(:func:`..parallel.pipeline.make_pipeline`), one layer a stage.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from ..parallel.mesh import Mesh
from ..parallel.pipeline import make_pipeline, split_microbatches
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, check
from .dcn import _Linear
from .sparse import (Batch, Device, l2_tensors, sparse_terms, task_loss,
                     whole_terms)

__all__ = ["DeepFM"]


@dataclass(frozen=True)
class _Pipeline:
    """A tower pipelined over ``axis`` of ``mesh``, ``microbatches``
    microbatches a batch."""

    mesh: Mesh
    axis: str
    microbatches: int
    run: Callable


def _layer(p, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p["w"] + p["b"])


def _shallow(module: nn.Module) -> nn.Module:
    """A copy of ``module`` over the same parameter tensors, with its own
    containers (and its submodules copied so): setting a parameter or a
    submodule on one leaves the other as it was."""
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._buffers = dict(module._buffers)
    out._modules = {k: _shallow(m) for k, m in module._modules.items()}
    return out


class DeepFM(nn.Module):
    """FM + ``layers``-deep tower of width ``dim`` on the embedded
    features.

    ``v``, ``tower.w`` and ``head.w`` are drawn from ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 when omitted) with
    the JAX init's scales: ``init_scale·N(0,1)`` and ``N(0,1)/√dim``.
    ``engine`` picks kernel or plain PyTorch for the sparse gather, as in
    :mod:`dmlc_core_tpu_torch.kernels.common`."""

    l2_names = ("w", "v", "tower.w", "head.w")
    _pipeline: Optional[_Pipeline] = None

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

    def with_pipelined_tower(self, mesh: Mesh, axis: str = "pp",
                             microbatches: int = 4) -> "DeepFM":
        """A DeepFM over the same parameter tensors whose tower runs
        GPipe-style over ``axis`` of ``mesh``, one layer a stage:
        ``layers`` must equal the axis's size, and each batch's rows
        must divide by ``microbatches`` (a ``ValueError`` otherwise, as
        in the JAX package).  Place it with ``shard_params`` before
        training, so each rank keeps its stage's layer; a model already
        placed is refused."""
        if mesh.size(axis) != self.layers:
            raise ValueError(
                f"pipelined tower needs layers == mesh['{axis}'] "
                f"({self.layers} != {mesh.size(axis)})")
        check(axis in mesh.axis_names, f"axis {axis!r} not in mesh "
              f"{mesh.axis_names}")
        if getattr(self, "_mesh_plan", None) is not None:
            raise DMLCError("pipeline the tower before placing the model "
                            "(shard_params): the placement splits the "
                            "tower by stage")
        clone = _shallow(self)
        clone._pipeline = _Pipeline(mesh, axis, microbatches,
                                    make_pipeline(mesh, axis, _layer))
        return clone

    def _terms(self, batch: Batch):
        """``(linear[B], s1[B, D], s2[B, D])`` for either batch layout
        (this rank's partials or columns on an ``mp`` mesh)."""
        return sparse_terms(self, batch)

    def _tower(self, h: torch.Tensor) -> torch.Tensor:
        pipe = self._pipeline
        if pipe is not None:
            xs = split_microbatches(h, pipe.microbatches)
            return pipe.run({"w": self.tower.w, "b": self.tower.b},
                            xs).reshape(h.shape)
        for w, b in zip(self.tower.w, self.tower.b):
            h = torch.tanh(h @ w + b)
        return h

    def forward(self, batch: Batch) -> torch.Tensor:
        linear, pair, s1 = whole_terms(self, *self._terms(batch),
                                       need_s1=True)
        deep = self._tower(s1) @ self.head.w + self.head.b
        return self.w0 + linear + pair + deep

    def loss(self, batch: Batch, wsum: Optional[torch.Tensor] = None,
             reg_scale: float = 1.0) -> torch.Tensor:
        return task_loss(self(batch), batch, self.task, self.l2,
                         *l2_tensors(self), wsum=wsum, reg_scale=reg_scale)
