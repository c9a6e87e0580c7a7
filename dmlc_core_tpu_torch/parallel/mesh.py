"""Named meshes of processes, one device each.

Counterpart of ``dmlc_core_tpu/parallel/mesh.py``.  The JAX package
drives every device of a host from one process, as a named
``jax.sharding.Mesh``; the port runs PyTorch's idiom instead: one
process a device, joined by a ``torch.distributed`` process group.  A
rank is the reference's ``DMLC_TASK_ID``, the world its
``DMLC_NUM_WORKER``, and the input is cut by ``ResetPartition(rank,
world)`` over the ``dp`` axis.

Three axes are ported: ``dp`` (data parallelism: each rank a slice of
the global batch, the gradients all-reduced), ``mp`` (the factor table
sharded by its factor dim or by its rows) and ``pp`` (DeepFM's tower,
one stage a rank).  Ranks are laid out row-major over the spec's axis
order, as the JAX package reshapes its device list, and each line of
ranks along an axis has a process group of its own.  ``sp`` waits for
ROADMAP A.10; a spec naming it is refused.

The pure layout helpers (:func:`parse_mesh_spec`, :func:`row_partition`,
:func:`row_owners`, :func:`remap_rows`, :func:`remap_deltas`) are copies
of the JAX package's.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.logging import DMLCError, check, log_info

__all__ = ["Mesh", "DataSharding", "make_mesh", "data_parallel_mesh",
           "parse_mesh_spec", "process_mesh_info", "row_partition",
           "row_owners", "remap_rows", "remap_deltas", "refuse_axes",
           "axis_lines", "AXES", "DEFAULT_TIMEOUT_S"]

#: seconds any collective of a mesh may wait before it fails
DEFAULT_TIMEOUT_S = 300.0

#: the axes a mesh may have
AXES = ("dp", "mp", "pp")

#: the queue item that ports each axis the port refuses
_LATER = {"sp": "ROADMAP A.10 (ring attention and ulysses)"}


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse 'dp=4,mp=2' → {'dp': 4, 'mp': 2} (-1 allowed once: infer)."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise DMLCError(f"bad mesh spec component {part!r}")
        k, v = part.split("=", 1)
        out[k.strip()] = int(v)
    check(list(out.values()).count(-1) <= 1, "at most one -1 axis")
    return out


def refuse_axes(axes) -> None:
    """Raise for any axis but ``dp``, ``mp`` and ``pp``, naming the queue
    item that ports it."""
    for axis in axes:
        if axis not in AXES:
            later = _LATER.get(axis, "no queue item: unknown axis")
            raise DMLCError(f"mesh axis {axis!r} is not ported (only "
                            f"{', '.join(AXES)} are); it waits for {later}")


def row_partition(n_rows: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal ``[start, stop)`` row ranges — the
    reference's ``ResetPartition(rank, nsplit)`` contract.  The first
    ``n_rows % parts`` ranges carry one extra row, so the layout is a
    pure function of ``(n_rows, parts)``."""
    check(parts > 0, f"row_partition needs parts > 0, got {parts}")
    check(n_rows >= 0, f"row_partition needs n_rows >= 0, got {n_rows}")
    base, extra = divmod(n_rows, parts)
    out: List[Tuple[int, int]] = []
    start = 0
    for r in range(parts):
        stop = start + base + (1 if r < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def row_owners(n_rows: int, parts: int, rows) -> np.ndarray:
    """For each global row id in ``rows``, the rank whose
    :func:`row_partition` range owns it (a closed form)."""
    check(parts > 0, f"row_owners needs parts > 0, got {parts}")
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise DMLCError(f"row_owners: row ids outside [0, {n_rows})")
    base, extra = divmod(n_rows, parts)
    if base == 0:
        # parts > n_rows: row r lives alone in range r
        return rows.copy()
    fat = extra * (base + 1)          # rows covered by the +1 ranges
    return np.where(rows < fat, rows // (base + 1),
                    extra + (rows - fat) // base)


def remap_rows(n_rows: int, old_parts: int, new_parts: int
               ) -> List[List[Tuple[int, int, int]]]:
    """For each NEW rank, the ``(old_rank, start, stop)`` global row
    ranges that feed its new shard when the cohort resizes; both layouts
    are :func:`row_partition`."""
    old = row_partition(n_rows, old_parts)
    plan: List[List[Tuple[int, int, int]]] = []
    for (ns, ne) in row_partition(n_rows, new_parts):
        feeds: List[Tuple[int, int, int]] = []
        for old_rank, (os_, oe) in enumerate(old):
            lo, hi = max(ns, os_), min(ne, oe)
            if lo < hi:
                feeds.append((old_rank, lo, hi))
        plan.append(feeds)
    return plan


def remap_deltas(n_rows: int, old_parts: int, new_parts: int
                 ) -> List[List[Tuple[int, int, int]]]:
    """Like :func:`remap_rows`, minus the rows each new rank already
    holds in its own old range: only the ranges it must fetch."""
    old = row_partition(n_rows, old_parts)
    plan: List[List[Tuple[int, int, int]]] = []
    for new_rank, feeds in enumerate(remap_rows(n_rows, old_parts,
                                                new_parts)):
        own_s, own_e = (old[new_rank] if new_rank < old_parts
                        else (0, 0))
        deltas: List[Tuple[int, int, int]] = []
        for old_rank, lo, hi in feeds:
            if old_rank == new_rank:
                continue                      # already resident
            # clip away any overlap with rows this rank already holds
            if own_s < own_e and lo < own_e and hi > own_s:
                if lo < own_s:
                    deltas.append((old_rank, lo, own_s))
                if hi > own_e:
                    deltas.append((old_rank, own_e, hi))
            else:
                deltas.append((old_rank, lo, hi))
        plan.append(deltas)
    return plan


@dataclass(frozen=True)
class DataSharding:
    """Where a rank's batches live: this rank's slice (``rank`` of
    ``world``) of the global batch, on ``device``.  The port's
    ``NamedSharding(mesh, P("dp"))``; :class:`~..pipeline.DeviceLoader`
    takes it as ``sharding=``."""

    rank: int
    world: int
    device: torch.device
    axis: str = "dp"


def axis_lines(axes: Dict[str, int], axis: str) -> List[List[int]]:
    """Every line of ranks along ``axis`` of a mesh of ``axes`` (ranks
    row-major over the axes' order, the last axis fastest), each in the
    order of its coordinate along ``axis``."""
    shape = tuple(axes.values())
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    at = list(axes).index(axis)
    lines = np.moveaxis(grid, at, -1).reshape(-1, shape[at])
    return [[int(r) for r in line] for line in lines]


class Mesh:
    """A named mesh of processes, one device each: this process's
    ``rank`` of ``world``, its ``device``, its coordinate along each axis
    and the process group of its line of ranks along each axis.  Built
    by :func:`make_mesh`.  An axis the mesh does not name has size 1.
    ``timeout_s`` is the group's collective timeout, None where the mesh
    joined a group made elsewhere (whose own timeout applies)."""

    def __init__(self, axes: Dict[str, int], rank: int, world: int,
                 device: torch.device, backend: str,
                 groups: Optional[Dict[str, Any]],
                 timeout_s: Optional[float], owns_group: bool,
                 store_path: Optional[str] = None) -> None:
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend
        self.timeout_s = timeout_s
        coords = np.unravel_index(rank, tuple(axes.values())) if axes else ()
        self._coords = {a: int(c) for a, c in zip(axes, coords)}
        self._groups = dict(groups or {})
        self._owns_group = owns_group
        self._store_path = store_path

    def size(self, axis: str = "dp") -> int:
        """The number of ranks along ``axis`` (1 for an axis the mesh
        does not name)."""
        check(axis in AXES or axis in self.shape,
              f"unknown mesh axis {axis!r}")
        return self.shape.get(axis, 1)

    def coord(self, axis: str = "dp") -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh does
        not name)."""
        self.size(axis)
        return self._coords.get(axis, 0)

    def line(self, axis: str = "dp") -> List[int]:
        """The ranks of this rank's line along ``axis``, in the order of
        their coordinate."""
        if axis not in self.shape:
            self.size(axis)
            return [self.rank]
        return axis_lines(self.shape, axis)[self._line_index(axis)]

    def _line_index(self, axis: str) -> int:
        others = [a for a in self.shape if a != axis]
        sizes = [self.shape[a] for a in others]
        return int(np.ravel_multi_index([self._coords[a] for a in others],
                                        sizes)) if others else 0

    def group(self, axis: str = "dp"):
        """The process group of this rank's line along ``axis``: the
        default group where the line is every rank, None where the line
        is this rank alone in a larger world (nothing to reduce)."""
        self.size(axis)
        if axis in self._groups:
            return self._groups[axis]
        import torch.distributed as dist
        return dist.group.WORLD if self.world == 1 else None

    @property
    def world_group(self):
        """The group of every rank of the mesh."""
        import torch.distributed as dist
        return dist.group.WORLD

    @property
    def capturable(self) -> bool:
        """Whether the mesh's collectives can be captured in a CUDA graph
        (NCCL can; gloo and the CPU cannot)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def close(self) -> None:
        """Destroy the process groups, and the file of the store, that
        :func:`make_mesh` created."""
        import torch.distributed as dist
        if dist.is_initialized():
            if self._owns_group:
                dist.destroy_process_group()
            else:
                for g in set(self._groups.values()) - {dist.group.WORLD,
                                                        None}:
                    dist.destroy_process_group(g)
        self._groups = {}
        self._owns_group = False
        if self._store_path is not None:
            try:
                os.unlink(self._store_path)
            except FileNotFoundError:
                pass
            self._store_path = None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def _env_rank_world() -> Optional[Tuple[int, int]]:
    """``(rank, world)`` from torchrun's ``RANK``/``WORLD_SIZE``, else the
    reference launcher's ``DMLC_TASK_ID``/``DMLC_NUM_WORKER``."""
    for r, w in (("RANK", "WORLD_SIZE"), ("DMLC_TASK_ID", "DMLC_NUM_WORKER")):
        if os.environ.get(r) is not None and os.environ.get(w) is not None:
            return int(os.environ[r]), int(os.environ[w])
    return None


def _init_group(backend: str, init_method: Optional[str],
                rank: Optional[int], world_size: Optional[int],
                timeout: datetime.timedelta) -> Optional[str]:
    """Initialise the default group; the path of its store's file where
    that file is this process's own."""
    import torch.distributed as dist
    if (rank is None) != (world_size is None):
        raise DMLCError("give rank and world_size together")
    if rank is None:
        got = _env_rank_world()
        if got is not None:
            rank, world_size = got
    if rank is not None:
        if init_method is None:
            if not (os.environ.get("MASTER_ADDR")
                    and os.environ.get("MASTER_PORT")):
                raise DMLCError(
                    f"rank {rank} of {world_size} but no rendezvous: set "
                    "MASTER_ADDR and MASTER_PORT or pass init_method "
                    "(tcp://host:port)")
            init_method = "env://"
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
        return None
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=0,
                                world_size=1, timeout=timeout)
        return None
    # a process on its own: world 1 over a store in a file of its own
    fd, path = tempfile.mkstemp(prefix="dmlc-mesh-")
    os.close(fd)
    os.unlink(path)
    store = dist.FileStore(path, 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=timeout)
    return path


def _axis_sizes(axes: Dict[str, int], n: int) -> Dict[str, int]:
    """JAX's rules: one -1 axis takes what the fixed axes leave, and
    unused capacity folds into the first axis."""
    known = 1
    for v in axes.values():
        if v > 0:
            known *= v
    if -1 in axes.values():
        check(n % known == 0,
              f"{n} processes not divisible by fixed axes product {known}")
        axes = {k: (n // known if v == -1 else v) for k, v in axes.items()}
    total = int(np.prod(list(axes.values())))
    check(total <= n, f"mesh wants {total} processes, have {n}")
    if total < n and n % total == 0:
        # fold unused capacity into the first axis so no process idles
        first = next(iter(axes))
        axes[first] *= n // total
        total = n
    if total != n:
        raise DMLCError(f"a mesh of {total} over {n} processes would leave "
                        f"{n - total} outside it (the JAX mesh leaves such "
                        "devices out; a process cannot be)")
    return axes


def _axis_groups(sizes: Dict[str, int], me: int, world: int,
                 timeout_s: Optional[float]) -> Dict[str, Any]:
    """This rank's group along each axis longer than 1: the default group
    where the line is every rank, else a new group.  Every rank calls
    ``new_group`` for every line, in the same order, as it must."""
    import torch.distributed as dist
    kw = ({} if timeout_s is None else
          {"timeout": datetime.timedelta(seconds=float(timeout_s))})
    groups: Dict[str, Any] = {}
    for axis, n in sizes.items():
        if n == world:
            groups[axis] = dist.group.WORLD
            continue
        if n == 1:
            continue
        for line in axis_lines(sizes, axis):
            g = dist.new_group(ranks=line, **kw)
            if me in line:
                groups[axis] = g
    return groups


def make_mesh(spec: str = "dp=-1", *,
              device: Optional[Union[str, torch.device]] = None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout_s: Optional[float] = None) -> Mesh:
    """Build a named mesh over the processes of a ``torch.distributed``
    group, one device each.

    ``backend`` is ``"nccl"`` (the default on ``cuda``) or ``"gloo"``
    (the default on ``device="cpu"``, or asked for by name, e.g. two
    ranks on one card); NCCL on the CPU is refused, and nothing falls
    back from NCCL to gloo or from the card to the CPU.

    Without a process group, one is initialised: from ``init_method``
    (``tcp://host:port``) with ``rank`` and ``world_size``; else from
    the launcher's environment (torchrun's ``RANK``/``WORLD_SIZE``, or
    the reference's ``DMLC_TASK_ID``/``DMLC_NUM_WORKER``, with
    ``MASTER_ADDR``/``MASTER_PORT`` unless ``init_method`` is given);
    else world 1 over a ``FileStore`` (its file removed by
    :meth:`Mesh.close`).  Every collective of a group made here fails
    after ``timeout_s`` (default ``DEFAULT_TIMEOUT_S``) rather than
    block.  An existing group must run the backend asked for; its own
    timeout applies, so a ``timeout_s`` passed with it is refused.

    ``device`` defaults to ``cuda:LOCAL_RANK`` (else ``rank`` modulo the
    cards).  Every rank makes the group of every line of every axis
    longer than 1 (:func:`axis_lines`), in one order, and keeps its own.
    The mesh's first collectives, a one-element all-reduce over every
    rank and then over each of this rank's groups, run here, so a hung
    rendezvous fails in this call and NCCL's communicators exist before
    any graph capture."""
    import torch.distributed as dist
    axes = parse_mesh_spec(spec)
    refuse_axes(axes)
    check(len(axes) > 0, f"mesh spec {spec!r} names no axis")
    if not dist.is_available():
        raise DMLCError("this torch has no torch.distributed")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DMLCError("no CUDA device is available; pass device='cpu' "
                        "(gloo) to build a mesh on the CPU")
    check(dev.type in ("cuda", "cpu"), f"unsupported device {dev}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    check(backend in ("nccl", "gloo"), f"bad backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise DMLCError("NCCL runs on CUDA tensors only; use "
                        "backend='gloo' on the CPU")
    owns = not dist.is_initialized()
    store_path = None
    if owns:
        if timeout_s is None:
            timeout_s = DEFAULT_TIMEOUT_S
        store_path = _init_group(
            backend, init_method, rank, world_size,
            datetime.timedelta(seconds=float(timeout_s)))
    else:
        if timeout_s is not None:
            raise DMLCError("a process group exists already and its own "
                            "timeout applies; build the mesh without "
                            "timeout_s, or before the group")
        have = dist.get_backend()
        if have != backend:
            raise DMLCError(f"the process group runs {have!r}, the mesh "
                            f"asks for {backend!r}")
    me, world = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else me % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sizes = _axis_sizes(axes, world)
    groups = _axis_groups(sizes, me, world, timeout_s if owns else None)
    for name, group in [("every rank", dist.group.WORLD)] + [
            (a, g) for a, g in groups.items() if g is not dist.group.WORLD]:
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe, group=group)
        want = world if group is dist.group.WORLD else sizes[name]
        if float(probe) != want:
            raise DMLCError(f"the mesh's first all-reduce over {name} gave "
                            f"{float(probe)}, not {want}")
    mesh = Mesh(sizes, me, world, dev, backend, groups,
                None if timeout_s is None else float(timeout_s), owns,
                store_path)
    log_info("mesh %s: rank %d of %d on %s over %s", sizes, me, world, dev,
             backend)
    return mesh


def data_parallel_mesh(**kw: Any) -> Mesh:
    """``make_mesh("dp=-1", **kw)``: every rank on the ``dp`` axis."""
    return make_mesh("dp=-1", **kw)


def process_mesh_info() -> Dict[str, int]:
    """This process's rank and world (the reference's ``DMLC_TASK_ID`` /
    ``DMLC_NUM_WORKER``), in the JAX function's keys: one device a
    process, so the world counts the mesh's devices."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_device_count": (torch.cuda.device_count()
                               if torch.cuda.is_available() else 1),
        "global_device_count": world,
    }
