"""Elastic rejoin for the port's process mesh.

Counterpart of ``dmlc_core_tpu/parallel/elastic.py`` (``ElasticJaxMesh``).
A ``torch.distributed`` process group has no elasticity of its own: a
dead rank wedges every collective of its group, and a group cannot admit
a late joiner.  The reference solves the same problem for rabit through
the always-up tracker: a reborn worker registers ``recover``, the
tracker bumps the link generation, and the survivors re-link.  This
module carries that protocol over to the mesh, with the JAX package's
split of planes:

* **control plane** — the rabit collectives (brokered TCP through the
  tracker) outlive a process's death: the reborn process re-registers
  with ``recover`` and the survivors re-link inside
  ``RabitContext._with_recovery``.  The generation is agreed by a rabit
  ``allreduce(max)``, the one piece of state that must outlive a broken
  data plane.  Unchanged from the JAX package: two ``allreduce(max)``
  rounds in :meth:`ElasticTorchMesh.resync`, the ordered barriers of
  :meth:`~ElasticTorchMesh.ensure` and :meth:`~ElasticTorchMesh.close`,
  so a cohort may mix both packages' meshes on its control plane.
* **data plane** — generation ``g`` is the port's :class:`~.mesh.Mesh`
  from ``make_mesh(spec, init_method="tcp://host:base_port+g", rank=,
  world_size=, device=)``: a ``TCPStore`` hosted by rank 0 (the JAX
  coordination service's place) and the ``dp`` / ``mp`` / ``pp`` groups,
  made in the same order on every rank.  :attr:`ElasticTorchMesh.mesh`
  is the current generation's.  A rebuild tears the old generation down
  (followers first, the store's host last) and builds the next one at
  the next port with the same rank and world.

What torch needs that JAX does not:

* **Survivors outlive a peer's death** (JAX's
  ``jax_enable_recoverability``): NCCL's asynchronous error handling
  tears the whole process down by default (``TORCH_NCCL_ASYNC_ERROR_
  HANDLING`` 3) when a communicator fails.  Before a generation is
  built, :meth:`ensure` sets it to 2 ("clean up only": the failed
  communicators are aborted and the error raised, the process lives).
  Gloo has no such watchdog.
* **A bounded teardown** (JAX's bounded shutdown barrier): NCCL's
  communicators are aborted (``ncclCommAbort``, through
  ``torch.distributed``'s ``_abort_process_group`` where this torch has
  it), which waits on no peer; gloo's destroy is local.  The teardown
  runs on a thread joined for at most ``DMLC_ELASTIC_SHUTDOWN_S``
  seconds; past that its handles are left behind (as the JAX package
  leaks its coordination handles) and the default group forgotten, so
  the next generation can start.
* **No** ``clear_backends``: card tensors outlive a process group in
  torch, so nothing of the JAX package's ``jax.extend.backend.
  clear_backends`` calls has a counterpart here, and a reborn rank that
  computed before it joined needs no reset.
* **Nothing uses a torn-down generation**: :meth:`~.mesh.Mesh.close`
  marks the old ``Mesh`` closed, so every call on it (a collective, a
  ``make_train_step(mesh=)`` step, a ``make_train_step_kbatch(mesh=)``
  CUDA graph captured over its NCCL communicators) raises a
  :class:`DMLCError` that names its generation.  Anything built on an
  old generation is built again on :attr:`ElasticTorchMesh.mesh`.

Environment (the JAX package's names and defaults):
``DMLC_ELASTIC_BASE_PORT`` (the launcher's; generation ``g`` binds
``base + g``), ``DMLC_ELASTIC_HOST`` (127.0.0.1), ``DMLC_RESHARD`` (0:
rebuild only), ``DMLC_ELASTIC_DATA_PLANE`` (0: the protocol without a
process group), ``DMLC_RESHARD_OVERLAP`` (0: redistribute after the
rebuild, not beside it), ``DMLC_ELASTIC_HEARTBEAT_S`` (10: in torch the
timeout of each generation's group, its rendezvous included, so a
collective stuck on a dead peer fails in that many seconds rather than
``DEFAULT_TIMEOUT_S``) and ``DMLC_ELASTIC_SHUTDOWN_S`` (10: in torch the
bound on a generation's teardown, above).

**Checkpoint-free recovery** (:mod:`.reshard`): with a
:class:`~.reshard.StateHandle` registered (:meth:`register_state`),
survivors snapshot their state to host memory before the teardown, the
new cohort agrees a shard-ownership map over the control plane, and
missing shards move point-to-point to reborn ranks, with leaf-granular
checkpoint reads only for shards no survivor holds; ``resync()`` then
returns the restored state (:class:`ResyncResult`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.logging import check, log_info, log_warning
from ..utils.metrics import metrics
from ..utils.parameter import env_int, get_env, parse_lenient_bool
from . import reshard as _reshard
from .mesh import Mesh, make_mesh
from .rabit import RabitContext

__all__ = ["ElasticTorchMesh", "ResyncResult"]

#: NCCL's "clean up only" error handling: abort, raise, keep the process
_NCCL_ERROR_HANDLING = "2"

# handles of generations whose teardown outlived DMLC_ELASTIC_SHUTDOWN_S:
# kept alive, never released (see _teardown)
_ZOMBIE_HANDLES: list = []


def _reshard_enabled() -> bool:
    """``DMLC_RESHARD=0`` kill switch: rebuild only; callers restore
    from their checkpoint."""
    v = parse_lenient_bool("DMLC_RESHARD")
    return True if v is None else v


def _data_plane_enabled() -> bool:
    """``DMLC_ELASTIC_DATA_PLANE=0`` runs the elastic protocol —
    generation agreement, ordered barriers, live resharding — without a
    process group: for cohorts whose collectives all ride the control
    plane."""
    v = parse_lenient_bool("DMLC_ELASTIC_DATA_PLANE")
    return True if v is None else v


def _forget_default_group() -> None:
    """Drop ``torch.distributed``'s record of a default group whose
    teardown never returned, so that the next generation can initialise
    one.  Private state: degrade to a warning where it moved."""
    try:
        import torch.distributed as dist
        c10d = dist.distributed_c10d
        world = c10d._world
        for name in ("pg_map", "pg_names", "pg_group_ranks",
                     "pg_backend_config", "pg_coalesce_state"):
            table = getattr(world, name, None)
            if hasattr(table, "clear"):
                table.clear()
        c10d._update_default_pg(None)
    except Exception as e:  # noqa: BLE001 — private-API drift
        log_warning("elastic: could not forget the hung generation's "
                    "process group (%s) — private API moved?", e)


class ResyncResult:
    """Outcome of a sync point — truthy iff the mesh was rebuilt, so
    ``if mesh.resync():`` call sites work.  On a rebuild with a
    registered :class:`~.reshard.StateHandle`, ``state`` is the
    redistributed tree (None when nothing was restored) and ``stats``
    the :class:`~.reshard.ReshardStats` for the round."""

    __slots__ = ("rebuilt", "generation", "state", "stats")

    def __init__(self, rebuilt: bool, generation: int,
                 state: Any = None, stats: Any = None) -> None:
        self.rebuilt = rebuilt
        self.generation = generation
        self.state = state
        self.stats = stats

    def __bool__(self) -> bool:
        return self.rebuilt

    def __repr__(self) -> str:
        return (f"ResyncResult(rebuilt={self.rebuilt}, "
                f"generation={self.generation}, "
                f"state={'<restored>' if self.state is not None else None}, "
                f"stats={self.stats})")


class ElasticTorchMesh:
    """Generation-addressed ``torch.distributed`` membership with rejoin.

    Parameters
    ----------
    ctx:        the process's :class:`RabitContext` (control plane).
    base_port:  the store port of generation 0; generation ``g`` binds
                ``base_port + g`` (a dead generation's socket may linger
                in TIME_WAIT, so each generation gets a fresh port).
    host:       the store's host (rank 0's address; default from
                ``DMLC_ELASTIC_HOST`` or 127.0.0.1).
    num_processes/process_id: the mesh's world and this rank; default
                from the rabit context.
    spec, device, backend: what each generation's :func:`make_mesh`
                gets (``device`` None: ``cuda:LOCAL_RANK``; pass
                ``"cpu"`` for gloo on the CPU).

    :attr:`mesh` is the current generation's :class:`~.mesh.Mesh` (None
    before the first join, without a data plane, and after
    :meth:`close`).  :attr:`timings` holds the last rebuild's seconds:
    ``teardown_s`` (the old generation, barriers excluded), ``init_s``
    (the new one's ``make_mesh``) and ``reshard_s`` (the redistribute
    round, or the wait for it past ``init_s`` when it overlaps);
    :attr:`joined_at` the wall-clock time (``time.time()``) this process
    joined its current generation."""

    def __init__(self, ctx: RabitContext, base_port: int = 0,
                 host: str = "", num_processes: int = 0,
                 process_id: Optional[int] = None, *,
                 spec: str = "dp=-1",
                 device: Optional[Union[str, torch.device]] = None,
                 backend: Optional[str] = None) -> None:
        self.ctx = ctx
        if not base_port:
            # the gpu launcher exports one base for the whole cohort so
            # every process derives identical generation addresses
            base_port = get_env("DMLC_ELASTIC_BASE_PORT", 0)
            check(base_port > 0, "ElasticTorchMesh needs base_port (or the "
                                 "launcher's DMLC_ELASTIC_BASE_PORT env)")
        self.base_port = int(base_port)
        self.host = host or get_env("DMLC_ELASTIC_HOST", "127.0.0.1")
        self.num_processes = num_processes or ctx.world_size
        self.process_id = ctx.rank if process_id is None else process_id
        self.spec, self.device, self.backend = spec, device, backend
        self.generation = -1            # not initialized yet
        self.mesh: Optional[Mesh] = None
        self.timings = {"teardown_s": 0.0, "init_s": 0.0, "reshard_s": 0.0}
        self.joined_at = 0.0
        # a reborn process must drag the cohort forward: its previous
        # incarnation died inside some generation g, so it proposes g+1.
        # DMLC_NUM_ATTEMPT is the launcher's rebirth marker (every backend
        # sets it on retry) — the same signal that flips rabit to recover.
        self._dirty = get_env("DMLC_NUM_ATTEMPT", 0) > 0
        self._state_handle: Optional[_reshard.StateHandle] = None
        self._last_reshard: Tuple[Any, Any] = (None, None)

    def register_state(self, handle: "_reshard.StateHandle") -> None:
        """Register the live state to preserve across generation bumps.

        With a handle registered, ``ensure()`` snapshots
        ``handle.get_state()`` to host memory BEFORE tearing the data
        plane down and redistributes it across the new cohort afterwards
        (:func:`~.reshard.redistribute`), so :meth:`resync` returns the
        restored state instead of just "rebuilt".  COLLECTIVE: register
        at the same point relative to control-plane collectives on every
        rank — the redistribute rounds run inside ``ensure()`` cohort-wide
        (register on all ranks or none; ``DMLC_RESHARD=0`` disables
        uniformly via the env)."""
        self._state_handle = handle

    # -- data-plane lifecycle --------------------------------------------
    def _init_method(self, gen: int) -> str:
        return f"tcp://{self.host}:{self.base_port + gen}"

    def _teardown(self) -> None:
        """Close the current generation's mesh within
        ``DMLC_ELASTIC_SHUTDOWN_S``: NCCL aborted, gloo destroyed."""
        mesh = self.mesh
        self.mesh = None
        if mesh is None:
            return
        t0 = time.monotonic()
        box: dict = {}

        def run() -> None:
            try:
                mesh.close(abort=True)
            except Exception as e:  # noqa: BLE001 — reported below
                box["err"] = e

        budget = env_int("DMLC_ELASTIC_SHUTDOWN_S", 10, minimum=1)
        t = threading.Thread(target=run, name="elastic-teardown",
                             daemon=True)
        t.start()
        t.join(budget)
        if t.is_alive():
            metrics.counter("elastic.teardown_timeouts").add(1)
            log_warning("elastic: teardown of generation %d outlived %d s "
                        "— leaving its handles behind", mesh.generation,
                        budget)
            mesh.closed = True
            _ZOMBIE_HANDLES.append((mesh, t))
            _forget_default_group()
        elif "err" in box:
            log_warning("elastic: teardown of generation %d raised (%s) — "
                        "proceeding", mesh.generation, box["err"])
            import torch.distributed as dist
            if dist.is_initialized():
                _forget_default_group()
        self.timings["teardown_s"] = time.monotonic() - t0

    def _build(self, gen: int) -> None:
        t0 = time.monotonic()
        mesh = make_mesh(
            self.spec, device=self.device, backend=self.backend,
            init_method=self._init_method(gen), rank=self.process_id,
            world_size=self.num_processes,
            timeout_s=float(env_int("DMLC_ELASTIC_HEARTBEAT_S", 10,
                                    minimum=1)))
        mesh.generation = gen
        self.mesh = mesh
        self.timings["init_s"] = time.monotonic() - t0

    def _barrier(self, tag: str) -> None:
        """Control-plane rendezvous (cheap host allreduce; the rabit layer
        re-links around dead/reborn peers on its own).  A failed barrier
        means the teardown ordering it was pacing is NOT guaranteed —
        count it and mark the mesh dirty so the next sync point forces a
        generation bump instead of silently desyncing the cohort."""
        try:
            self.ctx.allreduce(np.array([0], np.int64), "max")
        except Exception as e:  # noqa: BLE001
            metrics.counter("elastic.barrier_failures").add(1)
            self._dirty = True
            log_warning("elastic: %s barrier failed (%s) — mesh marked "
                        "dirty, next sync point will bump", tag, e)

    def ensure(self, gen: int) -> None:
        """Make this process a member of mesh generation ``gen``.

        COLLECTIVE: every cohort member must call this with the same
        target generation (``resync`` guarantees it) — the teardown of
        the previous generation is ORDERED over the control plane: the
        followers leave while rank 0, which hosts the generation's
        store, still serves it, and rank 0 leaves last.  The barriers
        are cohort-wide, so a reborn member (nothing to tear down) still
        paces the rendezvous and the rabit seq counters stay aligned.
        """
        check(gen >= 0, "generation must be >= 0")
        if gen == self.generation:
            return
        handle = self._state_handle
        reshard_on = handle is not None and _reshard_enabled()
        snap = None
        if reshard_on:
            # snapshot the live state to HOST memory before anything is
            # torn down.  A failed snapshot degrades this rank to a
            # non-holder (peers/checkpoint cover it), never blocks the
            # rebuild.
            try:
                if getattr(handle, "snapshot", None) is not None:
                    # row-sharded owners hand back a ready HostSnapshot
                    # with ranged + replica blocks
                    snap = handle.snapshot()
                else:
                    state = handle.get_state()
                    if state is not None:
                        snap = _reshard.snapshot_tree(state)
            except Exception as e:  # noqa: BLE001 — degrade, don't wedge
                log_warning("elastic: state snapshot failed (%s) — this "
                            "rank recovers from peers/checkpoint", e)
                snap = None
        data_plane = _data_plane_enabled()
        if data_plane:
            # NCCL's watchdog would otherwise take the whole process down
            # when a peer's death fails a communicator: survivors must
            # outlive it to rejoin.  Read when a group is made.
            was = os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING")
            if was != _NCCL_ERROR_HANDLING:
                if was is not None:
                    log_warning("elastic: TORCH_NCCL_ASYNC_ERROR_HANDLING="
                                "%s would end a survivor; using %s", was,
                                _NCCL_ERROR_HANDLING)
                os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = \
                    _NCCL_ERROR_HANDLING
        self._barrier("pre-rebuild")
        self.timings["teardown_s"] = 0.0
        if self.process_id != 0:
            if data_plane:
                self._teardown()
            self._barrier("followers-down")
        else:
            self._barrier("followers-down")
            if data_plane:
                self._teardown()
        log_info("elastic: joining mesh generation %d at %s "
                 "(process %d/%d%s)", gen, self._init_method(gen),
                 self.process_id, self.num_processes,
                 "" if data_plane else ", control plane only")
        overlap = (reshard_on and data_plane and
                   parse_lenient_bool("DMLC_RESHARD_OVERLAP") is not False)
        reshard_box: dict = {}
        reshard_thread = None

        def _redistribute() -> Tuple[Any, Any]:
            return _reshard.redistribute(
                self.ctx, snap, plan=handle.plan,
                checkpoint=handle.resolve_checkpoint(),
                checkpoint_step=handle.checkpoint_step,
                template=handle.resolve_template(), generation=gen)

        if overlap:
            # redistribute rides the rabit control plane ONLY (brokered
            # TCP through the tracker — never the process group), so its
            # fetch rounds run while the new generation's group forms.
            # The cohort is already agreed (barriers above); only this
            # thread touches ctx collectives until the join below.
            def _run_redistribute() -> None:
                try:
                    reshard_box["out"] = _redistribute()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    reshard_box["err"] = e

            reshard_thread = threading.Thread(
                target=_run_redistribute, name="reshard-overlap",
                daemon=True)
            reshard_thread.start()
            metrics.counter("elastic.reshard_overlaps").add(1)
        self.timings["init_s"] = 0.0
        try:
            if data_plane:
                self._build(gen)
        except BaseException:
            if reshard_thread is not None:
                # let the round end, so no thread of ours is still inside
                # a rabit collective when the error propagates
                reshard_thread.join()
            raise
        self.generation = gen
        self._dirty = False
        t0 = time.monotonic()
        if reshard_on:
            if reshard_thread is not None:
                reshard_thread.join()
                if "err" in reshard_box:
                    raise reshard_box["err"]
                restored, stats = reshard_box["out"]
            else:
                # sequential path (DMLC_RESHARD_OVERLAP=0, or control
                # plane only): redistribute after the new generation is
                # up; peers → leaf-granular checkpoint → cohort-wide
                # error (see reshard.redistribute)
                restored, stats = _redistribute()
            self._last_reshard = (restored, stats)
            if restored is not None and handle.set_state is not None:
                handle.set_state(restored)
        else:
            self._last_reshard = (None, None)
        self.timings["reshard_s"] = time.monotonic() - t0
        self.joined_at = time.time()

    # -- failure handling -------------------------------------------------
    def mark_failed(self) -> None:
        """Record that a data-plane collective failed (caller caught the
        exception); the next :meth:`resync` proposes a bump."""
        self._dirty = True

    def resync(self) -> "ResyncResult":
        """Sync point: agree on the cohort's generation over the control
        plane and re-initialize if it moved.  Returns a
        :class:`ResyncResult` — truthy iff the mesh was rebuilt.  With a
        :meth:`register_state` handle, a rebuild carries the
        redistributed state in ``.state`` (survivor shards reassembled
        over the control plane; checkpoint only for shards no survivor
        held).

        Two host ``allreduce(max)`` rounds — the rabit layer re-links
        around dead/reborn peers on its own (tracker ``recover``), so this
        works exactly when the data plane is broken:

        1. *learn*: max over every process's current generation — a reborn
           process arrives at generation -1 and must not guess the
           cohort's position;
        2. *agree*: dirty processes (reborn, or survivors whose last
           collective raised) propose cohort+1, the rest cohort; the max
           wins and everyone below it rebuilds.
        """
        cohort = int(self.ctx.allreduce(
            np.array([self.generation], np.int64), "max")[0])
        propose = cohort + 1 if self._dirty else cohort
        agreed = int(self.ctx.allreduce(
            np.array([propose], np.int64), "max")[0])
        agreed = max(agreed, 0)   # first-ever sync point: start at gen 0
        if agreed == self.generation:
            return ResyncResult(False, self.generation)
        self.ensure(agreed)
        restored, stats = self._last_reshard
        return ResyncResult(True, self.generation, restored, stats)

    def initialize(self) -> None:
        """First join: generation 0, or — when reborn — whatever the
        surviving cohort agrees at the sync point.

        REBIRTH CAVEAT: on rebirth this resyncs immediately, which is
        only frame-aligned when the survivors' next control-plane
        collective is ALSO resync (they crashed past their last sync
        point).  If survivors run other collectives first (e.g. an
        epoch-loss allreduce before their resync, as the port's
        ``examples/elastic_train.py`` does), a reborn process must SKIP
        initialize(), redo its work, run the same collectives the
        survivors are blocked in, and let the shared sync point's
        :meth:`resync` perform the join — mixing resync's allreduce with
        a different collective at the same frame corrupts both."""
        if self._dirty:
            # don't guess the cohort's current generation; ask it
            self.resync()
        else:
            self.ensure(0)

    def close(self) -> None:
        """Graceful ORDERED cohort exit: (1) a barrier, everyone has
        finished computing; (2) the followers tear down, their store
        clients leaving while rank 0 still serves the store; (3) a
        barrier, the followers are out; (4) rank 0 tears down last."""
        if self.generation < 0:
            return
        self._barrier("pre-close")
        data_plane = _data_plane_enabled()
        if self.process_id != 0:
            if data_plane:
                self._teardown()
            self._barrier("followers-out")
        else:
            self._barrier("followers-out")
            if data_plane:
                self._teardown()
        self.generation = -1
