"""A model's parameters on a process mesh: where each lives, the shard
each rank keeps, the collectives a sharded forward adds, and the gathers
back to whole parameters.

Counterpart of ``param_shardings`` / ``shard_params`` in
``dmlc_core_tpu/models/train.py``, with the JAX recipe's placements:

* ``table_shard="dim"`` (on a mesh with ``mp``): the factor table ``v``
  splits its trailing factor dim over ``mp`` (FM and DCNv2 ``v[F, D]``,
  FFM ``v[F, nf, d]``);
* ``table_shard="rows"``: ``v`` and the linear ``w`` split their feature
  axis over ``mp`` (ps-lite style); ``num_features`` must divide by the
  ``mp`` size;
* a DeepFM whose tower is pipelined over an axis
  (``DeepFM.with_pipelined_tower``) splits ``tower.*`` by stage over it;
* everything else is replicated.

A placement is ``"replicated"`` or ``"<axis>:<dim>"`` (``v`` in dim mode
is ``"mp:1"``, the JAX ``P(None, "mp")``).  Where XLA's GSPMD inserts the
collectives of a sharded step, the port's models run them themselves
from the :class:`ShardPlan` that :func:`shard_params` leaves on the
model:

* dim mode: each rank gathers with its own columns; a sum over the
  factor dim (FM's pairwise term, FFM's cross and diagonal terms) is
  summed over ``mp`` (:func:`..parallel.sum_partials`), a vector that
  feeds dense layers (DCNv2's ``x0``, DeepFM's ``s1``) is all-gathered
  (:func:`..parallel.gather_dim`);
* rows mode: each rank keeps the entries whose row it owns, remapped to
  its local rows (:meth:`ShardPlan.local`), and the partial sums of the
  rows (``s1``, ``s2``, ``x0``, FFM's ``G``, the linear term) are summed
  over ``mp`` before anything nonlinear.

How the gradients of shards and replicas are summed is the train step's
(:class:`.train.MeshStep`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..parallel.collectives import _gather, gather_dim, sum_partials
from ..parallel.mesh import Mesh
from ..utils.logging import DMLCError, check

__all__ = ["ShardPlan", "TABLE_SHARDS", "param_shardings", "shard_params",
           "gather_params", "local_shard", "mesh_plan", "mp_plan",
           "split_of", "unplaced_splits"]

#: the modes of ``table_shard``
TABLE_SHARDS = ("dim", "rows")

REPLICATED = "replicated"


def split_of(placement: str) -> Optional[Tuple[str, int]]:
    """``(axis, dim)`` of a split placement, None for a replicated one."""
    if placement == REPLICATED:
        return None
    axis, dim = placement.split(":")
    return axis, int(dim)


@dataclass
class ShardPlan:
    """Where a sharded model's parameters live on ``mesh``: each one's
    placement (by its dotted name), the table mode, and the table rows
    ``[start, stop)`` this rank holds (all of them unless rows mode)."""

    mesh: Mesh
    table_shard: str
    placements: Dict[str, str]
    num_features: int
    rows: Tuple[int, int]

    @property
    def mode(self) -> Optional[str]:
        """``"dim"`` or ``"rows"`` where ``v`` (or logreg's ``w``) is
        split over ``mp``, else None."""
        for name in ("v", "w"):
            got = split_of(self.placements.get(name, REPLICATED))
            if got is not None and got[0] == "mp":
                return self.table_shard
        return None

    def shards(self, name: str) -> int:
        """Into how many pieces the parameter ``name`` is split."""
        got = split_of(self.placements.get(name, REPLICATED))
        return 1 if got is None else self.mesh.size(got[0])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s partials summed over ``mp`` (backward: identity)."""
        return sum_partials(x, self.mesh, "mp")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s trailing dim gathered over ``mp`` (backward: this
        rank's columns)."""
        return gather_dim(x, self.mesh, "mp", -1)

    def local(self, ids: torch.Tensor, vals: torch.Tensor,
              segments: Optional[torch.Tensor] = None,
              num_rows: int = 0):
        """Rows mode: the batch's entries as this rank's rows see them,
        ``(ids, vals, segments)``.  XLA's id rules are applied to the
        GLOBAL id first (:mod:`..kernels.common`): the forward reads row
        ``clamp(id)``, which decides the owner; the backward drops an id
        out of range after one wrap.  An owned entry's local id keeps
        both rules on the local table (an id past the table becomes
        ``stop - start``, which the forward clamps to the last row and the
        backward drops; one below it ``-2·rows - 1``).  Another rank's
        entry gets value 0 and the local id ``stop - start`` (read as 0,
        dropped by the backward) and, on the flat layout, the scratch
        segment ``num_rows``.  Outside rows mode, the batch as it is."""
        if self.mode != "rows":
            return ids, vals, segments
        F = self.num_features
        start, stop = self.rows
        n = stop - start
        wrapped = torch.where(ids < 0, ids + F, ids)
        read = wrapped.clamp(0, F - 1)
        own = (read >= start) & (read < stop)
        local = torch.where(wrapped >= F, n,
                            torch.where(wrapped < 0, -2 * n - 1,
                                        wrapped - start))
        local = torch.where(own, local, n).to(ids.dtype)
        vals = torch.where(own, vals, torch.zeros((), dtype=vals.dtype,
                                                  device=vals.device))
        if segments is not None:
            segments = torch.where(own, segments, num_rows).to(
                segments.dtype)
        return local, vals, segments


def mesh_plan(model: nn.Module) -> Optional[ShardPlan]:
    """The plan :func:`shard_params` left on ``model``, or None."""
    return getattr(model, "_mesh_plan", None)


def mp_plan(model: nn.Module) -> Optional[ShardPlan]:
    """The model's plan where its table is split over ``mp``, else
    None: what a model's forward asks."""
    plan = mesh_plan(model)
    return plan if plan is not None and plan.mode is not None else None


def _pipeline_axis(model: nn.Module, mesh: Mesh) -> Optional[str]:
    pipe = getattr(model, "_pipeline", None)
    if pipe is None:
        return None
    if pipe.mesh is not mesh:
        raise DMLCError("the model's tower is pipelined over another mesh")
    return pipe.axis


def param_shardings(model: nn.Module, mesh: Optional[Mesh],
                    table_shard: str = "dim") -> Optional[Dict[str, str]]:
    """Each parameter's placement on ``mesh`` under the JAX recipe (the
    module's docstring), by dotted name; None without a mesh.  A bad
    ``table_shard`` raises ``ValueError``, as in the JAX package, and a
    split that does not divide raises (rows mode: pad
    ``num_features``)."""
    if table_shard not in TABLE_SHARDS:
        raise ValueError(f"table_shard must be 'dim' or 'rows', "
                         f"got {table_shard!r}")
    if mesh is None:
        return None
    stage_axis = _pipeline_axis(model, mesh)
    out: Dict[str, str] = {}
    for name, p in model.named_parameters():
        place = REPLICATED
        if "mp" in mesh.axis_names:
            if name == "v" and p.dim() in (2, 3):
                place = ("mp:0" if table_shard == "rows"
                         else f"mp:{p.dim() - 1}")
            elif name == "w" and p.dim() == 1 and table_shard == "rows":
                place = "mp:0"
        if stage_axis is not None and name.startswith("tower."):
            place = f"{stage_axis}:0"
        got = split_of(place)
        if got is not None:
            axis, dim = got
            n = mesh.size(axis)
            if p.shape[dim] % n:
                if axis == "mp" and dim == 0:
                    raise DMLCError(
                        f"{name} has {p.shape[0]} feature rows, which do "
                        f"not split over mp = {n}: pad num_features up to "
                        f"a multiple of {n} (padding rows are never "
                        "gathered)")
                raise DMLCError(f"{name} {tuple(p.shape)}: dim {dim} does "
                                f"not split over {axis} = {n}")
        out[name] = place
    return out


def unplaced_splits(model: nn.Module, mesh: Mesh) -> List[str]:
    """The parameters that placing ``model`` on ``mesh`` (dim mode) would
    split but that it still holds whole, because it is not placed: a
    step on such a model would take a whole table or tower for a shard.
    Empty for a placed model and wherever everything is replicated."""
    if mesh_plan(model) is not None:
        return []
    return [name for name, place in param_shardings(model, mesh).items()
            if place != REPLICATED]


def _params(model: nn.Module):
    params = [p for p in model.parameters() if p.requires_grad]
    dtypes = {p.dtype for p in params}
    check(len(dtypes) == 1, f"training on a mesh wants one parameter "
          f"dtype, got {sorted(map(str, dtypes))}")
    return params


def _slice(t: torch.Tensor, placement: str, mesh: Mesh) -> torch.Tensor:
    got = split_of(placement)
    if got is None:
        return t
    axis, dim = got
    n = t.shape[dim] // mesh.size(axis)
    return t.narrow(dim, mesh.coord(axis) * n, n)


def local_shard(model: nn.Module, name: str, full: torch.Tensor
                ) -> torch.Tensor:
    """This rank's slice of the whole parameter ``full`` named ``name``
    (``full`` itself where the model is not sharded or the parameter is
    replicated)."""
    plan = mesh_plan(model)
    if plan is None:
        return full
    return _slice(full, plan.placements.get(name, REPLICATED), plan.mesh)


def shard_params(model: nn.Module, mesh: Optional[Mesh],
                 table_shard: str = "dim") -> None:
    """Place ``model``'s parameters on ``mesh``: rank 0's values are
    broadcast to every rank (one collective), then each rank keeps its
    own slice of every split parameter as the model's own
    ``nn.Parameter`` of the slice's shape (so an optimizer built
    afterwards holds shard-sized state), and the model carries the
    :class:`ShardPlan` its forward and the train step read.  A model is
    placed once."""
    if mesh is None:
        return
    import torch.distributed as dist
    if mesh_plan(model) is not None:
        raise DMLCError("the model's parameters are placed on a mesh "
                        "already")
    placements = param_shardings(model, mesh, table_shard)
    params = _params(model)
    with torch.no_grad():
        if mesh.world > 1:
            flat = torch.cat([p.reshape(-1) for p in params])
            dist.broadcast(flat, src=0, group=mesh.world_group)
            at = 0
            for p in params:
                p.copy_(flat[at:at + p.numel()].view_as(p))
                at += p.numel()
            del flat
        for name, place in placements.items():
            if place == REPLICATED:
                continue
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            old = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(
                _slice(old.detach(), place, mesh).clone(),
                requires_grad=old.requires_grad))
    F = int(getattr(model, "num_features", 0))
    rows = (0, F)
    if placements.get("v", placements.get("w")) == "mp:0":
        n = F // mesh.size("mp")
        rows = (mesh.coord("mp") * n, (mesh.coord("mp") + 1) * n)
    model._mesh_plan = ShardPlan(mesh, table_shard, placements, F, rows)


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole of every parameter of a sharded model, by dotted name,
    on every rank (an all-gather of each split one, over its axis), so
    ``params_to_numpy(gather_params(model), nested=True)`` is the JAX
    param tree a checkpoint holds.  Every rank must call it, in the same
    order."""
    plan = mesh_plan(model)
    out: Dict[str, torch.Tensor] = {}
    for name, t in model.named_parameters():
        got = None if plan is None else split_of(
            plan.placements.get(name, REPLICATED))
        if got is None:
            out[name] = t.detach()
            continue
        axis, dim = got
        out[name] = torch.cat(_gather(plan.mesh, axis,
                                      t.detach().contiguous()), dim)
    return out
