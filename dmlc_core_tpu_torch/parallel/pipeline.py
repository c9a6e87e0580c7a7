"""Pipeline parallelism over a ``pp`` mesh axis (GPipe-style).

Counterpart of ``dmlc_core_tpu/parallel/pipeline.py``.  Rank *s* along
``pp`` owns stage *s*'s parameters; microbatches stream through the
stages.  The schedule is the JAX one, fill and drain: with S stages and
M microbatches the run takes ``T = M + S − 1`` ticks, and at tick *t*
stage *s* works on microbatch ``t − s`` (bubble ticks compute on what
they hold and are masked out of the result).

Where the JAX package runs the ticks as one ``lax.scan`` inside a
``shard_map`` and hands activations on with ``ppermute``, each rank of
the port runs the ticks as a Python loop of autograd operations, and a
hand-off is one all-gather over the ``pp`` group a tick, of which rank
*s* keeps stage ``s − 1``'s block: one code path over NCCL and gloo (gloo
has no ``send``/``recv`` for CUDA tensors), in lockstep like the scan,
``S × mb × D × 4`` bytes a tick.  Every rank runs the same operations in
the same order, rank-dependent choices are ``torch.where`` on a flag
rather than branches, so autograd's backward runs every rank's
collectives in one order too.  The transposes are ``shard_map``'s:

* a hand-off's backward all-gathers the gradients and keeps stage
  ``s + 1``'s block (the gradient of what this stage handed on);
* the inputs ``xs`` are replicated over ``pp`` but only stage 0 reads
  them, so their backward sums the gradient over ``pp`` (stage 0's value
  plus zeros, on every rank);
* the outputs are the last stage's, summed over ``pp`` so that every
  rank holds them (JAX's ``psum``); their backward is the identity.

Contract.  ``stage_fn(stage_params, x) -> y`` keeps the microbatch's
shape.  ``stage_params`` are this rank's stage's tensors, each with a
leading stage axis of length 1 (this rank's slice of the stacked axis,
what :func:`..models.sharding.shard_params` leaves), or the whole stack
of S (forward use: the rank takes its own slice).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..utils.logging import check
from .collectives import _gather, _run, sum_partials
from .mesh import Mesh

__all__ = ["make_pipeline", "split_microbatches", "stack_stage_params",
           "stage_sharding"]


def split_microbatches(x: torch.Tensor, num_microbatches: int
                       ) -> torch.Tensor:
    """``[B, ...]`` → ``[M, B/M, ...]`` (B must divide evenly; a
    ``ValueError`` otherwise, as in the JAX package)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by M={num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def stack_stage_params(per_stage: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``[{leaf: tensor}, ...]`` a stage → ``{leaf: tensor[S, ...]}``."""
    out: Dict[str, Any] = {}
    for key, first in per_stage[0].items():
        if isinstance(first, dict):
            out[key] = stack_stage_params([p[key] for p in per_stage])
        else:
            out[key] = torch.stack([p[key] for p in per_stage])
    return out


def stage_sharding(mesh: Mesh, axis: str = "pp") -> str:
    """The placement of stacked stage parameters: their leading stage
    axis split over ``axis`` (the form of
    :func:`..models.sharding.param_shardings`)."""
    check(axis in mesh.axis_names, f"axis {axis!r} not in mesh "
          f"{mesh.axis_names}")
    return f"{axis}:0"


class _Handoff(torch.autograd.Function):
    """Stage ``s − 1``'s ``y`` on rank ``s`` (rank 0 gets the last
    stage's, which the schedule masks); backward: stage ``s + 1``'s
    gradient of what this rank handed on."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        s, n = mesh.coord(axis), mesh.size(axis)
        return _gather(mesh, axis, y.contiguous())[(s - 1) % n]

    @staticmethod
    def backward(ctx, g):
        s, n = ctx.mesh.coord(ctx.axis), ctx.mesh.size(ctx.axis)
        return (_gather(ctx.mesh, ctx.axis, g.contiguous())[(s + 1) % n],
                None, None)


class _ReplicatedIn(torch.autograd.Function):
    """A value replicated over the axis, read by some of its ranks: the
    forward is the identity, the backward sums the gradient over the
    axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        out = g.contiguous().clone()
        _run("allreduce", ctx.mesh, out, lambda: dist.all_reduce(
            out, group=ctx.mesh.group(ctx.axis)), ctx.axis)
        return out, None, None


def _stage_leaf(t: torch.Tensor, s: int, n: int) -> torch.Tensor:
    if t.shape[0] == 1:
        return t[0]
    check(t.shape[0] == n, f"a stage parameter's leading axis is "
          f"{t.shape[0]}: neither this rank's stage (1) nor all {n}")
    return t[s]


def make_pipeline(mesh: Mesh, axis: str, stage_fn: Callable
                  ) -> Callable[[Dict[str, Any], torch.Tensor],
                                torch.Tensor]:
    """Build ``run(stage_params, xs) -> ys``: microbatches ``xs[M, mb,
    F]`` through the ``S = mesh.size(axis)`` stages of ``stage_fn``.
    Returns ``[M, mb, F]``, the same on every rank of the axis; ``xs``
    must be the same on every rank of the axis (shard the batch over
    ``dp``, not ``pp``: the two axes compose in a 2-D mesh).
    Differentiable with respect to ``stage_params`` and ``xs``."""
    check(axis in mesh.axis_names, f"axis {axis!r} not in mesh "
          f"{mesh.axis_names}")
    S, s = mesh.size(axis), mesh.coord(axis)

    def run(stage_params: Dict[str, Any], xs: torch.Tensor) -> torch.Tensor:
        params = {k: _stage_leaf(v, s, S) for k, v in stage_params.items()}
        M = xs.shape[0]
        if S > 1:
            xs = _ReplicatedIn.apply(xs, mesh, axis)
        # fills, not copies from the host: the run may be captured
        first = torch.full((), s == 0, dtype=torch.bool, device=xs.device)
        last = torch.full((), s == S - 1, dtype=torch.bool,
                          device=xs.device)
        cur = torch.where(first, xs[0], torch.zeros_like(xs[0]))
        outs = []
        ticks = M + S - 1
        for t in range(ticks):
            y = stage_fn(params, cur)
            if t >= S - 1:
                outs.append(y)     # the last stage finished microbatch t-S+1
            if t + 1 < ticks:
                handed = _Handoff.apply(y, mesh, axis) if S > 1 else y
                cur = torch.where(first, xs[min(t + 1, M - 1)], handed)
        ys = torch.stack(outs)
        if S == 1:
            return ys
        return sum_partials(torch.where(last, ys, torch.zeros_like(ys)),
                            mesh, axis)
    return run
