"""Training and evaluation loops, per step and k steps at a time.

Counterpart of ``dmlc_core_tpu/models/train.py``, for one card or a
``dp`` mesh of them:
``make_train_step``, ``make_eval_step``, ``streaming_auc``,
``auc_from_histograms``, ``evaluate_stream``, ``fit_stream``, and the
k-step trainer: ``make_train_step_fused``, ``FusedTrainer``,
``make_train_step_kbatch`` and ``stack_batches``, each with the JAX
function's ``mesh=`` (data parallelism, below), and ``batch_sharding``,
``param_shardings`` and ``shard_params``.  A model is an
``nn.Module`` with ``forward(batch)`` and ``loss(batch)``; the optimizer
is one of the port's (:class:`.optim.Adam`, the port's ``optax.adam``,
or :class:`.ftrl.FTRL`), or anything with ``zero_grad`` and ``step``.

No step reads a value back to the host: losses and eval sums stay on
the device until the caller reads them.

Where the JAX package runs k steps as one jitted ``lax.scan``, the port
runs them as one CUDA graph: the k steps' Python (decode, forward,
backward, optimizer) runs once, at capture, and each dispatch is one
replay over static inputs.  Before its capture a graph warms up with one
forward and backward on a side stream over its first inputs (cuBLAS
handles, autograd's buffers), whose gradients are dropped: the warm-up
takes no optimizer step, and the optimizers allocate their state when
they are built, so the trajectory is the per-step loop's.  Parameters,
optimizer state and the static inputs are never reallocated, since the
graph holds their addresses.  The graphs of one trainer share one memory
pool and run one after another on the caller's stream.  Launch counts of
the kernels (:func:`..kernels.launch_counts`) are recorded at capture and
added at each replay.  On the CPU the same k steps run eagerly.

Training on a mesh (``mesh=``, a mesh of :mod:`..parallel.mesh`, one
process a device; the model placed by :func:`.sharding.shard_params`):
each rank steps on its ``dp`` slice of the global batch and computes
what the JAX mesh step computes on the whole of it (:class:`MeshStep`).
Before the forward, one all-reduce over ``dp`` of ``[weight sum, has
data]`` gives the global batch's weight sum, by which each rank divides
its local loss numerator, l2 entering at ``1 / dp`` a rank.  Over
``dp`` the ranks see different rows, so gradients are summed.  Over
``mp`` and ``pp`` every rank computes the same loss, so a replicated
parameter's gradient is already whole on each of them, and differs only
in the last bits (the kernels add with atomics): one all-reduce over
every rank, scaled by ``1 / (mp·pp)``, makes it the dp sum and the same
bits everywhere, so the replicas stay bit-equal.  A split parameter's
gradient (a shard of the table, a pipeline stage) is summed over ``dp``
alone.  DDP's divide-by-world is not used: it is wrong when ranks hold
unequal weights.
"""

from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..kernels.common import add_launches, record_launches
from ..parallel.mesh import DataSharding, Mesh
from ..pipeline.loader import _fused_words_meta, make_decoder
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, log_info
from .optim import Adam
from .sharding import (_params, gather_params, mesh_plan,  # noqa: F401
                       param_shardings, shard_params, unplaced_splits)

__all__ = ["make_train_step", "make_eval_step", "streaming_auc",
           "auc_from_histograms", "evaluate_stream", "fit_stream", "adam",
           "make_train_step_fused", "FusedTrainer", "make_train_step_kbatch",
           "stack_batches", "batch_sharding", "param_shardings",
           "shard_params", "gather_params", "MeshStep"]

Batch = Dict[str, torch.Tensor]


def adam(model: torch.nn.Module, lr: float = 1e-3,
         engine: str = "auto") -> Adam:
    """The port's ``optax.adam(lr)`` over ``model``'s parameters: the
    fused kernel on the card, its plain version on the CPU."""
    return Adam(model.parameters(), lr=lr, engine=engine)


def batch_sharding(mesh: Optional[Mesh]) -> Optional[DataSharding]:
    """Batches shard their leading (row / nnz) axis over ``dp``: this
    rank's ``dp`` slice, on its device (``DeviceLoader(sharding=)``).
    The ranks of a line along ``mp`` or ``pp`` read the same slice."""
    if mesh is None:
        return None
    return DataSharding(mesh.coord("dp"), mesh.size("dp"), mesh.device)


def _all_reduce(t: torch.Tensor, group) -> None:
    """Sum ``t`` in place over ``group`` (None: a line of one rank)."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=group)


def _check_optimizer(model: torch.nn.Module, optimizer) -> None:
    """Refuse an optimizer that holds a tensor the model no longer has:
    :func:`shard_params` replaces each split parameter by its shard, and
    an optimizer built before it would step the old whole tensors, whose
    gradients stay None, while the shards never move."""
    held = getattr(optimizer, "params", None)
    if held is None:
        held = [p for g in getattr(optimizer, "param_groups", ())
                for p in g["params"]]
    mine = {id(p) for p in model.parameters()}
    if any(id(p) not in mine for p in held):
        raise DMLCError("the optimizer holds tensors that are not the "
                        "model's parameters (shard_params replaced the "
                        "split ones by their shards): build it after "
                        "placing the model")


class MeshStep:
    """``step(batch, stats=None) -> loss``: one gradient step of a rank
    of a mesh (see the module's docstring); the loss returned is the
    global batch's, the same on every rank, l2 counted once for every
    parameter however it is split.  :meth:`agree` is the step's first
    all-reduce, ``[global weight sum, dp ranks with data]``, which a
    loop over uneven partitions takes first and hands to the step.  A
    model that the mesh would split (``mp``, a pipelined tower) must be
    placed on it first (:func:`shard_params`), and the optimizer built
    after: both are refused otherwise.  A model the mesh only replicates
    (a ``dp`` mesh) needs no placing."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 mesh: Mesh) -> None:
        plan = mesh_plan(model)
        if plan is not None and plan.mesh is not mesh:
            raise DMLCError("the model is placed on another mesh")
        split = unplaced_splits(model, mesh)
        if split:
            raise DMLCError(
                f"{', '.join(split)} split on this mesh but the model "
                "holds them whole: place it with shard_params(model, mesh, "
                "table_shard=) and build its optimizer after")
        _check_optimizer(model, optimizer)
        self.model, self.optimizer, self.mesh = model, optimizer, mesh
        self.group = mesh.group("dp")
        dp = mesh.size("dp")
        self.reg_scale = 1.0 / dp
        self.copies = mesh.world // dp          # mp·pp: a replica's copies
        names = {id(p): n for n, p in model.named_parameters()}
        self.params = _params(model)
        dev = self.params[0].device
        if dev != mesh.device:
            raise DMLCError(f"the model is on {dev}, this rank's device "
                            f"is {mesh.device}")
        shards = {n: (plan.shards(n) if plan is not None else 1)
                  for n in names.values()}
        self.replicated = [p for p in self.params if shards[names[id(p)]]
                           == 1]
        self.split = [p for p in self.params if shards[names[id(p)]] > 1]
        # the split parameters' l2, counted once a shard: see _report
        l2 = float(getattr(model, "l2", 0.0) or 0.0)
        regs = set(getattr(model, "l2_names", ()))
        self.split_l2 = [(model.get_parameter(n), l2 * (k - 1) / mesh.world)
                         for n, k in shards.items() if k > 1 and n in regs
                         and l2]

    def agree(self, batch: Batch, live: bool = True) -> torch.Tensor:
        self.mesh.check_open()
        w = batch["weights"]
        # a fill, not a copy from the host: the step may be captured
        stats = torch.stack([w.sum(), torch.full((), float(live),
                                                 dtype=w.dtype,
                                                 device=w.device)])
        _all_reduce(stats, self.group)
        return stats

    def _report(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global loss: summed over every rank
        it is the global batch's loss.  Each rank's loss holds its dp
        slice's data term, once a copy over mp·pp, and the l2 of what it
        holds at 1/dp: a replica's l2 is counted once a copy, a shard's
        once a shard, so split parameters add their other shards' share
        here."""
        out = loss.detach() / self.copies
        for p, scale in self.split_l2:
            out = out + scale * torch.sum(p.detach() ** 2)
        return out.reshape(1)

    def __call__(self, batch: Batch,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
        self.mesh.check_open()
        if stats is None:
            stats = self.agree(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss(batch, wsum=torch.clamp(stats[0], min=1e-9),
                               reg_scale=self.reg_scale)
        loss.backward()

        def flat(params):
            return [p.grad.reshape(-1) if p.grad is not None
                    else torch.zeros(p.numel(), dtype=p.dtype,
                                     device=p.device) for p in params]
        rep = torch.cat(flat(self.replicated) + [self._report(loss)])
        _all_reduce(rep, self.mesh.world_group)
        n = rep.numel() - 1
        if self.copies > 1:
            rep[:n] *= 1.0 / self.copies
        at = 0
        for p in self.replicated:
            p.grad = rep[at:at + p.numel()].view_as(p)
            at += p.numel()
        if self.split and self.group is None:
            for p in self.split:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        elif self.split:
            sh = torch.cat(flat(self.split))
            _all_reduce(sh, self.group)
            at = 0
            for p in self.split:
                p.grad = sh[at:at + p.numel()].view_as(p)
                at += p.numel()
        self.optimizer.step()
        return rep[n]


def make_train_step(model: torch.nn.Module, optimizer,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[Batch], torch.Tensor]:
    """``step(batch) -> loss``: one gradient step; the loss is a 0-d
    tensor on the model's device (no host sync).  With a mesh, a
    :class:`MeshStep` (the loss then the global batch's)."""
    if mesh is not None:
        return MeshStep(model, optimizer, mesh)

    def step(batch: Batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(batch)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def _mesh_sum(mesh: Optional[Mesh], parts: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """``parts`` summed over the ``dp`` ranks, in one all-reduce (the
    ranks along ``mp`` and ``pp`` hold the same sums)."""
    if mesh is None:
        return parts
    flat = torch.cat([p.reshape(-1) for p in parts])
    _all_reduce(flat, mesh.group("dp"))
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    return out


def make_eval_step(model: torch.nn.Module, mesh: Optional[Mesh] = None
                   ) -> Callable[[Batch], Tuple[torch.Tensor, torch.Tensor]]:
    """``evaluate(batch) -> (correct, total)``: weighted count of rows
    whose sign of the score matches the label, and the weight; with a
    mesh, summed over the ``dp`` ranks' slices of the global batch
    (every rank of the mesh calls it: a sharded forward has
    collectives)."""
    @torch.no_grad()
    def evaluate(batch: Batch):
        return tuple(_mesh_sum(mesh, list(_accuracy(model(batch), batch))))
    return evaluate


def _accuracy(out: torch.Tensor, batch: Batch):
    w = batch["weights"]
    pred = (out > 0).to(w.dtype)
    y = (batch["labels"] > 0).to(w.dtype)
    return (w * (pred == y).to(w.dtype)).sum(), w.sum()


#: bins of :func:`streaming_auc`'s histograms
AUC_BINS = 1024


def streaming_auc(scores: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor, num_bins: int = AUC_BINS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch's weighted positive / negative histograms over fixed
    ``[0, 1]`` bins of ``sigmoid(score)``; batches add up.  Combine with
    :func:`auc_from_histograms`."""
    p = torch.sigmoid(scores)
    idx = torch.clamp((p * num_bins).to(torch.int64), 0, num_bins - 1)
    y = (labels > 0).to(weights.dtype)
    pos = weights.new_zeros(num_bins).index_add_(0, idx, weights * y)
    neg = weights.new_zeros(num_bins).index_add_(0, idx,
                                                 weights * (1.0 - y))
    return pos, neg


def auc_from_histograms(pos: torch.Tensor, neg: torch.Tensor
                        ) -> torch.Tensor:
    """AUC of the binned distributions (trapezoid over the ROC steps;
    ties within a bin count half)."""
    total_pos = torch.clamp(pos.sum(), min=1e-12)
    total_neg = torch.clamp(neg.sum(), min=1e-12)
    neg_below = torch.cat([neg.new_zeros(1), torch.cumsum(neg, 0)[:-1]])
    wins = (pos * (neg_below + 0.5 * neg)).sum()
    return wins / (total_pos * total_neg)


def evaluate_stream(model: torch.nn.Module, loader, *,
                    mesh: Optional[Mesh] = None,
                    auc: bool = True) -> Dict[str, float]:
    """One pass over ``loader``: weighted accuracy and, with ``auc``, the
    streaming binned ROC-AUC, from one forward per batch.  Sums stay on
    the device until the end; with a mesh, ``correct``, ``total`` and
    the AUC histograms are summed over the ``dp`` ranks (one all-reduce)
    before the AUC is taken, and a rank whose slice is empty adds
    zeros.  Every rank of a line along ``mp`` or ``pp`` reads the same
    slice, so their sharded forwards run in step."""
    correct = total = pos = neg = None
    with torch.no_grad():
        for batch in loader:
            out = model(batch)
            c, t = _accuracy(out, batch)
            correct = c if correct is None else correct + c
            total = t if total is None else total + t
            if auc:
                a, b = streaming_auc(out, batch["labels"], batch["weights"])
                pos = a if pos is None else pos + a
                neg = b if neg is None else neg + b
    if mesh is not None:
        zero = torch.zeros((), device=_model_device(model))
        parts = [zero if correct is None else correct,
                 zero if total is None else total]
        if auc:
            bins = zero.new_zeros(AUC_BINS)
            parts += [bins if pos is None else pos,
                      bins if neg is None else neg]
        got = _mesh_sum(mesh, parts)
        correct, total = got[:2]
        if auc:
            pos, neg = got[2:]
    if correct is None:
        out = {"accuracy": 0.0, "weight": 0.0}
        if auc:
            out["auc"] = 0.0
        return out
    total_f = float(total)
    out = {"accuracy": float(correct) / max(total_f, 1e-9),
           "weight": total_f}
    if auc:
        out["auc"] = float(auc_from_histograms(pos, neg))
    return out


# -- k steps a dispatch --------------------------------------------------------

Inputs = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _model_device(model: torch.nn.Module) -> torch.device:
    try:
        return next(model.parameters()).device
    except StopIteration:
        raise DMLCError("the model has no parameters") from None


def _copy_into(static: Inputs, inputs: Inputs) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(inputs, non_blocking=True)
        return
    if set(static) != set(inputs):
        raise DMLCError(f"inputs {sorted(inputs)} differ from the "
                        f"captured {sorted(static)}")
    for key, t in static.items():
        t.copy_(inputs[key], non_blocking=True)


class KSteps:
    """``kstep(inputs) -> losses[k]``: k train steps of ``model`` and
    ``optimizer``, step ``i`` on ``batch_of(inputs, i)``, in order.

    On the card the k steps are one CUDA graph over static inputs of the
    given shapes (``static``), captured at the first call from its inputs
    and replayed at every call; :meth:`run` replays over whatever
    ``static`` holds and returns the static losses (overwritten by the
    next replay).  ``__call__`` copies its inputs in and returns a copy of
    the losses.  On the CPU, or with ``capture=False``, the steps run
    eagerly.  ``step`` is one step (:func:`make_train_step`'s, by
    default)."""

    def __init__(self, model: torch.nn.Module, optimizer, k: int,
                 static: Inputs, batch_of: Callable[[Inputs, int], Batch],
                 pool=None, step: Optional[Callable[[Batch],
                                                    torch.Tensor]] = None,
                 capture: bool = True) -> None:
        if k < 1:
            raise DMLCError(f"k must be >= 1, got {k}")
        self.model, self.optimizer, self.k = model, optimizer, int(k)
        self.device = _model_device(model)
        self.step = step or make_train_step(model, optimizer)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.static = static
        self.batch_of = batch_of
        self.pool = pool
        self.losses = torch.empty(self.k, device=self.device)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Dict[str, int] = {}   # a replay's kernel launches
        self.capture_s = 0.0                 # warm-up + capture, host clock

    def _steps(self, inputs: Inputs, losses: torch.Tensor) -> None:
        for i in range(self.k):
            losses[i].copy_(self.step(self.batch_of(inputs, i)))

    def _capture(self) -> None:
        t0 = time.perf_counter()
        opt, dev = self.optimizer, self.device
        # warm-up: forward and backward only, on a side stream; the
        # gradients are dropped and no optimizer step is taken
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        opt.zero_grad(set_to_none=True)
        with torch.cuda.stream(side):
            self.model.loss(self.batch_of(self.static, 0)).backward()
        torch.cuda.current_stream(dev).wait_stream(side)
        opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads may copy on their own
        # streams while this thread captures
        with record_launches() as launches:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                self._steps(self.static, self.losses)
        # the captured gradients live in the graph's pool: nothing outside
        # the graph may keep them
        opt.zero_grad(set_to_none=True)
        self.graph, self.launches = graph, launches
        self.capture_s = time.perf_counter() - t0
        mesh = getattr(self.step, "mesh", None)
        if mesh is not None:
            # the graph holds the mesh's NCCL communicators: closing the
            # mesh releases it first
            mesh.hold_graph(self)

    def release(self) -> None:
        """Free the captured graph (after the device's queued work); the
        next :meth:`run` captures again."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None

    def run(self) -> torch.Tensor:
        """Replay the k steps over the static inputs (capturing them at
        the first call); returns the static losses."""
        if not self.capture:
            raise DMLCError("run() replays a CUDA graph; eager k steps "
                            "(the CPU, capture=False) take kstep(inputs)")
        mesh = getattr(self.step, "mesh", None)
        if mesh is not None:
            # a graph captured over a torn-down generation's NCCL
            # communicators must never replay
            mesh.check_open()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_launches(self.launches)
        return self.losses

    def __call__(self, inputs: Inputs) -> torch.Tensor:
        if not self.capture:
            losses = torch.empty(self.k, device=self.device)
            self._steps(inputs, losses)
            return losses
        _copy_into(self.static, inputs)
        return self.run().clone()


def make_train_step_fused(model: torch.nn.Module, optimizer, *, rows: int,
                          meta: int, k: int, pool=None) -> KSteps:
    """k train steps in one dispatch over a stack of k fused wire buffers
    (``[k, words]`` int32, the loader's layout for ``rows`` and ``meta``:
    v2, or v3 compact), each decoded inside the steps with
    :func:`make_decoder` (one ``searchsorted`` for v2, one launch of the
    decode kernel for v3 on the card).  Returns ``kstep(bufs) -> losses[k]`` (a
    :class:`KSteps`): on the card one CUDA graph whose input is the static
    ``kstep.static`` buffer, on the CPU the same steps run eagerly.  The
    model's parameters and the optimizer's state update in place.  Graphs
    that share ``pool`` (``torch.cuda.graph_pool_handle()``) must replay
    one at a time."""
    decode = make_decoder(rows, meta)
    words = _fused_words_meta(rows, meta)
    dev = _model_device(model)
    static = (torch.empty(k, words, dtype=torch.int32, device=dev)
              if dev.type == "cuda" else None)
    return KSteps(model, optimizer, k, static,
                  lambda bufs, i: decode(bufs[i]), pool)


class FusedTrainer:
    """Stream-order k-step training over a host-emitting DeviceLoader.

    Consumes ``("fused", buf, meta, rows)`` items of a loader built with
    ``emit="host"``, groups CONSECUTIVE same-meta buffers up to ``k``, and
    dispatches each group as one copy and one k-step call
    (:func:`make_train_step_fused`).  A meta change flushes the open group,
    and partial groups step with their own length, so steps run in stream
    order: the per-step loop's trajectory with fewer dispatches.

    On the card each group is stacked into a pinned staging buffer the
    trainer owns (two, used in turn; one is refilled only once its last
    copy has completed), the loader's buffers are recycled right after,
    and one non-blocking copy moves the group into the graph's static
    input.  One graph is captured per ``(meta, group length)``, all in
    one memory pool; v3 metas vary more than v2 ones (the id width in
    nibble steps, the dictionary's bits on an even ladder of at most 8),
    so :attr:`graph_keys` says what an epoch captured.  ``params`` and ``opt_state`` are the model's and the
    optimizer's own tensors, updated in place; ``losses`` is a copy of the
    last dispatch's ``[kk]`` losses."""

    def __init__(self, model: torch.nn.Module, optimizer, loader, *,
                 k: int = 16) -> None:
        if k < 1:
            raise DMLCError(f"k must be >= 1, got {k}")
        self.model = model
        self.optimizer = optimizer
        self.loader = loader
        self.k = int(k)
        self.rows = loader.batch_rows
        self.device = _model_device(model)
        self._cuda = self.device.type == "cuda"
        self.losses: Optional[torch.Tensor] = None
        self.steps = 0
        self.rows_dispatched = 0
        self._kstep_cache: Dict[Tuple[int, int], KSteps] = {}
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._group: List[Tuple[np.ndarray, Optional[int]]] = []
        self._group_meta: Optional[int] = None
        self._staging: List[Optional[torch.Tensor]] = [None, None]
        self._copied: List[Optional["torch.cuda.Event"]] = [None, None]
        self._turn = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def opt_state(self):
        return self.optimizer.state

    @property
    def graph_keys(self) -> List[Tuple[int, int]]:
        """The ``(meta, group length)`` of every k-step graph built so
        far: one capture each on the card."""
        return list(self._kstep_cache)

    def _kstep(self, meta: int, kk: int) -> KSteps:
        key = (meta, kk)
        fn = self._kstep_cache.get(key)
        if fn is None:
            fn = make_train_step_fused(self.model, self.optimizer,
                                       rows=self.rows, meta=meta, k=kk,
                                       pool=self._pool)
            self._kstep_cache[key] = fn
        return fn

    def _stage(self, words: int) -> Tuple[torch.Tensor, int]:
        """The next pinned staging buffer of at least ``words``, once its
        last copy has completed."""
        turn = self._turn
        self._turn ^= 1
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()
        buf = self._staging[turn]
        if buf is None or buf.numel() < words:
            buf = torch.empty(words, dtype=torch.int32, pin_memory=True)
            self._staging[turn] = buf
        return buf, turn

    def _flush_group(self) -> None:
        if not self._group:
            return
        meta, kk = self._group_meta, len(self._group)
        words = _fused_words_meta(self.rows, meta)
        fn = self._kstep(meta, kk)
        if self._cuda:
            buf, turn = self._stage(kk * words)
            stacked = buf[:kk * words].view(kk, words)
            host = stacked.numpy()
            for i, (b, _) in enumerate(self._group):
                host[i] = b[:words]
        else:
            stacked = torch.from_numpy(
                np.stack([b[:words] for b, _ in self._group]))
        for b, _ in self._group:
            self.loader.recycle(b)
        if self._cuda:
            fn.static.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._copied[turn] = event
            self.losses = fn.run().clone()
        else:
            self.losses = fn(stacked)
        self.steps += kk
        self.rows_dispatched += sum(
            r if r is not None else self.rows for _, r in self._group)
        self._group = []
        self._group_meta = None

    def feed(self, item) -> None:
        """Add one host-emitted loader item; dispatches when a group fills
        or the wire meta changes (stream order is kept either way)."""
        kind, buf, meta, rows_real = item
        if kind != "fused":
            raise DMLCError(f"FusedTrainer needs fused host items, got "
                            f"{kind!r}")
        if self._group and (meta != self._group_meta
                            or len(self._group) >= self.k):
            self._flush_group()
        self._group_meta = meta
        self._group.append((buf, rows_real))
        if len(self._group) >= self.k:
            self._flush_group()

    def flush(self) -> None:
        """Dispatch any open partial group (end of stream / epoch)."""
        self._flush_group()

    def finish(self) -> float:
        """Flush the tail group and read back the last loss."""
        self._flush_group()
        return float(self.losses[-1]) if self.losses is not None else 0.0

    def run_epoch(self) -> float:
        """One pass over the loader; returns the final loss (read back)."""
        for item in self.loader:
            self.feed(item)
        return self.finish()


def make_train_step_kbatch(model: torch.nn.Module, optimizer,
                           mesh: Optional[Mesh] = None
                           ) -> Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor]:
    """k steps a dispatch over device batches stacked leaf-wise
    (``batches[leaf].shape == (k, ...)``, see :func:`stack_batches`):
    ``kstep(batches) -> losses[k]``, step ``i`` on ``{leaf: v[i]}``.  On
    the card one CUDA graph per set of leaf shapes and dtypes, captured at
    its first call; on the CPU the steps run eagerly.

    With a mesh each step is a :class:`MeshStep` over this rank's
    slices: over NCCL its collectives (and those of a sharded forward and
    backward) are captured inside the graph; over gloo (which cannot be
    captured) or on the CPU the k steps run eagerly.  ``kstep.route``
    says which: ``"graph"`` or ``"eager"``."""
    graphs: Dict[tuple, KSteps] = {}
    dev = _model_device(model)
    step = None if mesh is None else MeshStep(model, optimizer, mesh)
    capture = dev.type == "cuda" and (mesh is None or mesh.capturable)
    pool = torch.cuda.graph_pool_handle() if capture else None

    def batch_of(batches: Dict[str, torch.Tensor], i: int) -> Batch:
        return {key: v[i] for key, v in batches.items()}

    def kstep(batches: Dict[str, torch.Tensor]) -> torch.Tensor:
        k = {int(v.shape[0]) for v in batches.values()}
        if len(k) != 1:
            raise DMLCError(f"stacked leaves disagree on k: {sorted(k)}")
        key = tuple(sorted((name, tuple(v.shape), v.dtype)
                           for name, v in batches.items()))
        fn = graphs.get(key)
        if fn is None:
            static = ({name: torch.empty_like(v, device=dev)
                       for name, v in batches.items()}
                      if capture else None)
            fn = graphs[key] = KSteps(model, optimizer, k.pop(), static,
                                      batch_of, pool, step=step,
                                      capture=capture)
        return fn(batches)
    kstep.route = "graph" if capture else "eager"
    return kstep


def stack_batches(batches: Sequence[Dict[str, Any]],
                  device: Optional[Union[str, torch.device]] = None,
                  sharding: Optional[DataSharding] = None
                  ) -> Dict[str, torch.Tensor]:
    """Stack same-shaped batch dicts leaf-wise along a new leading k axis,
    for :func:`make_train_step_kbatch`.  Numpy leaves stack on the host
    and cross to ``device`` (the card unless ``"cpu"`` is given; with a
    ``sharding``, this rank's device) in one copy; tensor leaves stack
    where they are."""
    if sharding is not None:
        if device is not None and resolve_device(device) != sharding.device:
            raise DMLCError(f"device {device} is not the sharding's "
                            f"{sharding.device}")
        device = sharding.device
    out = {}
    for key in batches[0]:
        leaves = [b[key] for b in batches]
        if isinstance(leaves[0], np.ndarray):
            out[key] = torch.from_numpy(np.stack(leaves)).to(
                resolve_device(device))
        else:
            out[key] = torch.stack(leaves)
    return out


def _idle_batch(template: Optional[Batch], layout: str,
                dev: torch.device, rows: int = 1) -> Batch:
    """What a ``dp`` rank whose slice has run out steps on: its last
    batch with every weight 0, or (no batch at all) ``rows`` empty rows
    of ``layout`` on ``dev`` (the loader's batch rows: a pipelined tower
    splits them into microbatches).  Either adds nothing to the global
    batch."""
    if template is not None:
        return {**template, "weights": torch.zeros_like(template["weights"])}
    zf = torch.zeros(rows, device=dev)
    zi = torch.zeros(1, dtype=torch.int32, device=dev)
    if layout == "rowmajor":
        return {"ids": zi.expand(rows, 1).contiguous(),
                "vals": zf.view(rows, 1), "labels": zf, "weights": zf.clone()}
    # the one entry points at the scratch row past the batch's rows
    return {"ids": zi, "vals": zf[:1], "segments": zi + rows,
            "row_ptr": torch.zeros(rows + 1, dtype=torch.int32, device=dev),
            "labels": zf, "weights": zf.clone()}


def _check_loader_sharding(loader, mesh: Mesh) -> None:
    sharding = getattr(loader, "sharding", None)
    if sharding is None:
        if mesh.size("dp") > 1:
            raise DMLCError(
                f"a mesh of {mesh.size('dp')} dp ranks needs a loader built "
                "with sharding=batch_sharding(mesh): each rank must read "
                "its own partition")
        return
    if sharding != batch_sharding(mesh):
        raise DMLCError(f"the loader's sharding {sharding} is not this "
                        f"rank's: {mesh}")


def _dp_epoch(step_fn: MeshStep, loader, epoch: int, step: int,
              log_every: int, history: List[float]) -> int:
    """One epoch of ``dp`` steps.  Each step the ranks agree, in the
    step's first all-reduce, on whether any of them still has a batch
    (a host read each step); one that has run out steps on an idle
    batch, so no rank waits on a collective the others never reach, and
    no step of the others is lost."""
    it = iter(loader)
    template = None
    while True:
        batch = next(it, None)
        live = batch is not None
        if live:
            template = batch
        else:
            batch = _idle_batch(template, getattr(loader, "layout", "flat"),
                                step_fn.params[0].device,
                                getattr(loader, "batch_rows", 1))
        stats = step_fn.agree(batch, live)
        if float(stats[1]) == 0:
            return step
        loss = step_fn(batch, stats)
        step += 1
        if log_every and step % log_every == 0:
            history.append(float(loss))
            log_info("epoch %d step %d loss %.5f", epoch, step, history[-1])


def fit_stream(model: torch.nn.Module, loader, *, epochs: int = 1,
               optimizer=None, mesh: Optional[Mesh] = None,
               log_every: int = 100,
               kstep: Optional[int] = None) -> List[float]:
    """Streaming training, one pass of the loader per epoch.  The
    optimizer defaults to Adam(1e-2), as the JAX package's
    ``optax.adam(1e-2)``.

    A loader built with ``emit="host"`` trains through
    :class:`FusedTrainer`, ``kstep`` steps a dispatch (default 16); the
    history then holds one end-of-epoch loss per epoch when
    ``log_every`` is nonzero.  That path is single-card: with a ``mesh``
    it raises, as the JAX function does.  A device-emitting loader runs
    one step a batch and samples the loss every ``log_every`` steps
    (reading one back syncs the host); ``kstep`` there raises rather
    than being ignored.

    With a mesh, a model not yet placed on it is placed first
    (:func:`shard_params`, dim mode: rank 0's parameters broadcast, each
    rank keeping its shards; place it yourself for ``table_shard=
    "rows"``), and then the default optimizer is built.  An optimizer
    passed in must be built after the placing, so where the mesh splits
    a parameter of an unplaced model it is refused (before anything is
    placed).  The loader must read this rank's ``dp`` partition
    (``sharding=batch_sharding(mesh)``; with one ``dp`` rank any
    loader), and each step is a :class:`MeshStep`; ranks whose partition
    ends early step on idle batches until every rank is done, and the
    history holds the global batch's losses."""
    history: List[float] = []
    host = getattr(loader, "emit", "device") == "host"
    if host and mesh is not None:
        raise DMLCError("fused k-step training over the host wire is "
                        "single-card; use a device-emitting loader with "
                        "mesh")
    if mesh is not None:
        _check_loader_sharding(loader, mesh)
        if optimizer is not None and unplaced_splits(model, mesh):
            raise DMLCError(
                "the mesh splits parameters of this unplaced model, and "
                "placing it would replace the tensors the optimizer "
                "holds: place it (shard_params(model, mesh, table_shard=))"
                " before building the optimizer, or let fit_stream build "
                "it")
        if mesh_plan(model) is None:
            shard_params(model, mesh)
    optimizer = optimizer or adam(model, 1e-2)
    if host:
        trainer = FusedTrainer(model, optimizer, loader,
                               k=16 if kstep is None else kstep)
        for epoch in range(epochs):
            t0 = time.monotonic()
            loss = trainer.run_epoch()
            loader.before_first()
            if log_every:
                history.append(loss)
            log_info("epoch %d done in %.2fs (%d steps, loss %.5f)", epoch,
                     time.monotonic() - t0, trainer.steps, loss)
        return history
    if kstep is not None:
        raise DMLCError(
            "kstep requires a loader built with emit='host' (the fused "
            "wire); this loader emits device batches, so the k-step "
            "dispatch cannot engage")
    step_fn = make_train_step(model, optimizer, mesh)
    step = 0
    for epoch in range(epochs):
        t0 = time.monotonic()
        if mesh is not None:
            step = _dp_epoch(step_fn, loader, epoch, step, log_every,
                             history)
        else:
            for batch in loader:
                loss = step_fn(batch)
                step += 1
                if log_every and step % log_every == 0:
                    history.append(float(loss))
                    log_info("epoch %d step %d loss %.5f", epoch, step,
                             history[-1])
        loader.before_first()
        log_info("epoch %d done in %.2fs (%d steps)", epoch,
                 time.monotonic() - t0, step)
    return history
