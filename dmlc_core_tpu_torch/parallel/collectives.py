"""Rabit-style collectives over one axis of a process mesh.

Counterpart of ``dmlc_core_tpu/parallel/collectives.py``.  The JAX
package lowers rabit's ``Allreduce(op)`` / ``Broadcast(root)`` to XLA
collectives over a device mesh; the port runs them through
``torch.distributed`` over the mesh axis's process group: NCCL on the
card, gloo on the CPU.  No kernel is written here, as none was in the
JAX package.

Two tiers, as in the JAX module:

* functions (:func:`allreduce`, :func:`broadcast`, :func:`allgather`,
  :func:`reduce_scatter`, :func:`all_to_all`) over one tensor a rank,
  with the semantics of the JAX in-jit functions under ``shard_map``;
* :class:`MeshCollectives`, the literal rabit API.

Two more are differentiable, for the sharded models
(:mod:`..models.sharding`): :func:`sum_partials` (forward an all-reduce,
backward the identity) and :func:`gather_dim` (forward an all-gather,
backward this rank's slice).  Both are the transposes ``shard_map``
gives a value that is replicated over the axis: every rank computes the
same loss from the result, so the cotangent each rank holds is already
the whole one, and summing it over the ranks would count it once a
rank.  Any axis's group serves; along an axis of one rank every function
returns its input's value without a collective.

Where the JAX functions see one process holding every rank's block, the
port is SPMD: each process passes its own block and gets its own
result, on the device its block is on.  A backend that lacks a
collective for the block's device (gloo has no ``reduce_scatter`` for
CUDA tensors in some builds) raises a :class:`DMLCError` that says so:
nothing is staged through the host behind the caller's back.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Tuple, Union

import numpy as np
import torch

from ..utils.logging import DMLCError, check
from .mesh import Mesh

__all__ = ["allreduce", "broadcast", "allgather", "reduce_scatter",
           "all_to_all", "sum_partials", "gather_dim", "MeshCollectives",
           "OPS", "record_collectives"]

#: the reductions of :func:`allreduce`
OPS = ("sum", "max", "min")

Block = Union[torch.Tensor, np.ndarray]


def _op(op: str):
    import torch.distributed as dist
    if op not in OPS:
        raise DMLCError(f"unknown allreduce op {op!r}; have {list(OPS)}")
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


#: ``.rec``: while :func:`record_collectives` is open on a thread, the
#: ``(kind, axis, elements of the rank's input)`` of every collective
#: that thread runs here
_recording = threading.local()


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Tuple[str, str, int]]]:
    """Around a call on this thread (a sharded forward, say): yields the
    list of the ``(kind, axis, elements)`` of every collective this
    module runs meanwhile on the same thread, in order; other threads'
    (autograd's backward on the card, say) are not seen.  A measuring
    aid for tests and the card's smoke run; one recording a thread at a
    time (a nested one raises)."""
    if getattr(_recording, "rec", None) is not None:
        raise DMLCError("record_collectives is open on this thread "
                        "already")
    rec: List[Tuple[str, str, int]] = []
    _recording.rec = rec
    try:
        yield rec
    finally:
        _recording.rec = None


def _run(kind: str, mesh: Mesh, x: torch.Tensor, fn, axis: str) -> None:
    """Call the collective over ``axis``; a backend without it for
    ``x``'s device raises, saying which."""
    rec = getattr(_recording, "rec", None)
    if rec is not None:
        rec.append((kind, axis, int(x.numel())))
    try:
        fn()
    except RuntimeError as e:
        text = str(e).lower()
        if "support" in text or "not implemented" in text:
            raise DMLCError(
                f"the {mesh.backend} backend has no {kind} for "
                f"{x.device.type} tensors ({e}); the port does not stage "
                "it through the host") from e
        raise


def _chunks(x: torch.Tensor, world: int, axis: int) -> List[torch.Tensor]:
    check(x.shape[axis] % world == 0,
          f"axis {axis} of {tuple(x.shape)} does not split over {world} "
          "ranks")
    return [c.contiguous() for c in torch.chunk(x, world, dim=axis)]


def _gather(mesh: Mesh, axis_name: str, x: torch.Tensor
            ) -> List[torch.Tensor]:
    """Every rank's ``x`` (contiguous) along the axis, in its order."""
    import torch.distributed as dist
    if mesh.size(axis_name) == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis_name))]
    _run("allgather", mesh, x, lambda: dist.all_gather(
        parts, x, group=mesh.group(axis_name)), axis_name)
    return parts


def allreduce(x: torch.Tensor, mesh: Mesh, axis_name: str = "dp",
              op: str = "sum") -> torch.Tensor:
    """The ranks' blocks reduced by ``op``; the same on every rank."""
    import torch.distributed as dist
    out = x.clone()
    red = _op(op)
    if mesh.size(axis_name) > 1:
        _run("allreduce", mesh, out, lambda: dist.all_reduce(
            out, op=red, group=mesh.group(axis_name)), axis_name)
    return out


def broadcast(x: torch.Tensor, mesh: Mesh, axis_name: str = "dp",
              root: int = 0) -> torch.Tensor:
    """Rank ``root``'s block, on every rank."""
    import torch.distributed as dist
    check(0 <= root < mesh.size(axis_name), f"bad root {root}")
    out = x.clone()
    if mesh.size(axis_name) > 1:
        src = mesh.line(axis_name)[root]
        _run("broadcast", mesh, out, lambda: dist.broadcast(
            out, src=src, group=mesh.group(axis_name)), axis_name)
    return out


def allgather(x: torch.Tensor, mesh: Mesh, axis_name: str = "dp",
              axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's block, in rank order: concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    x = x.contiguous()
    parts = _gather(mesh, axis_name, x)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis_name: str = "dp",
                   axis: int = 0) -> torch.Tensor:
    """``axis`` cut into one chunk a rank; rank ``r`` gets the sum over
    the ranks of their chunk ``r`` (JAX's tiled ``psum_scatter``)."""
    import torch.distributed as dist
    chunks = _chunks(x, mesh.size(axis_name), axis)
    if len(chunks) == 1:
        return chunks[0]
    out = torch.empty_like(chunks[0])
    _run("reduce_scatter", mesh, x, lambda: dist.reduce_scatter(
        out, chunks, group=mesh.group(axis_name)), axis_name)
    return out


def all_to_all(x: torch.Tensor, mesh: Mesh, axis_name: str = "dp",
               split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
    """``split_axis`` cut into one chunk a rank, chunk ``d`` sent to rank
    ``d``; the chunks received, in rank order, concatenated along
    ``concat_axis`` (JAX's tiled ``all_to_all``)."""
    import torch.distributed as dist
    ins = _chunks(x, mesh.size(axis_name), split_axis)
    if len(ins) == 1:
        return torch.cat(ins, concat_axis)
    outs = [torch.empty_like(c) for c in ins]
    _run("all_to_all", mesh, x, lambda: dist.all_to_all(
        outs, ins, group=mesh.group(axis_name)), axis_name)
    return torch.cat(outs, concat_axis)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        import torch.distributed as dist
        out = x.clone()
        _run("allreduce", mesh, out, lambda: dist.all_reduce(
            out, group=mesh.group(axis_name)), axis_name)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_partials(x: torch.Tensor, mesh: Mesh, axis_name: str = "mp"
                 ) -> torch.Tensor:
    """The sum over ``axis_name``'s ranks of each rank's partial ``x``,
    the same on every rank (an all-reduce).  Differentiable: the
    gradient of each rank's partial is the result's own, as the
    transpose of JAX's ``psum`` to a replicated value gives it."""
    if mesh.size(axis_name) == 1:
        return x
    return _SumPartials.apply(x, mesh, axis_name)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.index = mesh.coord(axis_name)
        return torch.cat(_gather(mesh, axis_name, x.contiguous()), dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None)


def gather_dim(x: torch.Tensor, mesh: Mesh, axis_name: str = "mp",
               dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name``, concatenated along ``dim``
    in rank order, the same on every rank (an all-gather).
    Differentiable: the gradient of this rank's ``x`` is its own slice
    of the result's, not a reduce-scatter (the result is replicated, so
    that would count it once a rank)."""
    if mesh.size(axis_name) == 1:
        return x
    return _GatherDim.apply(x, mesh, axis_name, dim % x.dim())


class MeshCollectives:
    """Rabit-style collectives over one mesh axis, SPMD.

    >>> coll = MeshCollectives(mesh, "dp")
    >>> y = coll.allreduce(x)             # sum over the dp axis
    >>> z = coll.broadcast(x, root=0)

    The JAX class takes ``per_rank[world, ...]`` from one process and
    returns the global result; here each rank passes its own row of that
    array (a tensor, or numpy moved to the mesh's device) and gets a
    tensor: the JAX result for ``allreduce``, ``broadcast`` and
    ``allgather`` (the whole ``[world, ...]`` stack), and its own row of
    it for ``all_to_all`` (``out[s] = in_s[rank]``, the JAX
    ``out[d] = in[:, d]`` seen from rank ``d``)."""

    def __init__(self, mesh: Mesh, axis_name: str = "dp") -> None:
        check(axis_name in mesh.axis_names,
              f"axis {axis_name!r} not in mesh {mesh.axis_names}")
        self.mesh = mesh
        self.axis_name = axis_name

    @property
    def world_size(self) -> int:
        return self.mesh.size(self.axis_name)

    def _block(self, x: Block) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                self.mesh.device)
        return x

    def allreduce(self, x: Block, op: str = "sum") -> torch.Tensor:
        """Rabit Allreduce: the same reduced block on every rank."""
        return allreduce(self._block(x), self.mesh, self.axis_name, op)

    def broadcast(self, x: Block, root: int = 0) -> torch.Tensor:
        return broadcast(self._block(x), self.mesh, self.axis_name, root)

    def allgather(self, x: Block) -> torch.Tensor:
        """The ``[world, ...]`` stack of the ranks' blocks."""
        return allgather(self._block(x), self.mesh, self.axis_name,
                         tiled=False)

    def all_to_all(self, x: Block) -> torch.Tensor:
        """``x[d]`` is this rank's chunk for rank ``d``; returns this
        rank's inbox, ``out[s]`` the chunk rank ``s`` sent it."""
        x = self._block(x)
        check(x.dim() >= 1 and x.shape[0] == self.world_size,
              f"all_to_all wants [world, ...], got {tuple(x.shape)}")
        return all_to_all(x, self.mesh, self.axis_name)
