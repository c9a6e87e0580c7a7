"""Elastic data-parallel training that SURVIVES a worker crash — with
checkpoint-free recovery.

Counterpart of the JAX package's ``examples/elastic_train.py``: the same
command line, the same ``EPOCH {json}`` records, the same crash flags
and ``elastic.epoch`` fault point.  Usage (the launcher respawns crashed
ranks; ``--elastic`` is required)::

    python -m dmlc_core_tpu_torch.parallel.launcher.submit \\
        --cluster gpu -n 3 --elastic --max-attempts 2 -- \\
        python -m dmlc_core_tpu_torch.examples.elastic_train <uri> \\
            [--epochs E] [--crash-rank R --crash-epoch E] \\
            [--state-ckpt-dir D] [--device cpu]

Each rank trains a :class:`FactorizationMachine` with the port's Adam
through ``FusedTrainer(k=8)`` over a ``DeviceLoader(emit="host")`` of
ITS partition of the input (the reference's ``ResetPartition(rank, n)``
contract), on its card (``cuda:LOCAL_RANK``) or, with ``--device cpu``,
on the CPU, its data plane NCCL where every rank has a card of its own
and gloo otherwise; the cohort synchronizes by elastic averaging at every epoch
boundary, with three planes of fault tolerance working together:

* **control plane** — rabit collectives through the tracker: epoch-loss
  reduction, parameter averaging (float64 host copies), a tiny position
  checkpoint (seq fast-forward on rebirth);
* **data plane** — :class:`ElasticTorchMesh`: every epoch boundary is a
  sync point (``resync``); when a rank dies mid-epoch, the launcher
  respawns it with a bumped ``DMLC_NUM_ATTEMPT`` and the WHOLE cohort
  rebuilds its process group at the next generation (gloo where ranks
  share a card or run on the CPU, NCCL with a card a rank);
* **state plane** — a :class:`StateHandle` registered on the mesh: on a
  generation bump, survivors' model + optimizer state moves to the
  reborn rank over the control plane (``parallel/reshard.py``) — NO
  epoch is replayed and NO checkpoint is read while any survivor holds
  the state.  The rabit checkpoint carries only the epoch number; the
  optional ``--state-ckpt-dir`` arms the per-leaf last-resort path.

The state is the JAX example's tree, ``{"params": {"w0", "w", "v"},
"opt_state": ((count, mu, nu), ())}`` (``optax.adam``'s layout, see
:mod:`..models.convert`), so its digests, leaf paths and checkpoints are
the JAX package's.  The reborn rank skips compute on its join epoch (it
contributes zeros to the averaging collectives to stay frame-aligned)
and receives the full averaged state bit-equal to the survivors' via the
resharder.  ``--crash-rank/--crash-epoch`` inject a one-shot crash
(first attempt only); the ``fault_point("elastic.epoch")`` probe site
arms the same kill through ``DMLC_FAULT_SPEC`` (e.g.
``elastic.epoch:error=1:times=1:after=1`` kills on the second epoch).
``--init`` loads the initial parameters from an ``.npz`` of the JAX
param tree (the JAX example starts from ``init(PRNGKey(0))``; without
it the port's seed-0 draw is used).

:func:`train` runs the protocol for a caller (``hook(event, **info)``
sees ``"crash"`` before the injected exit and ``"synced"`` after each
sync point, with the mesh, the record and the epoch's times).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = ["build_parser", "train", "main", "digest", "state_tree",
           "zero_state", "backend_for", "print_line"]

#: the JAX example's optax.adam(5e-2)
LR = 5e-2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.examples.elastic_train",
        description="Elastic data-parallel FM training that survives a "
                    "worker crash (run under dmlc-submit --elastic).")
    ap.add_argument("uri")
    ap.add_argument("--features", type=int, default=1 << 16)
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-rows", type=int, default=128)
    ap.add_argument("--nnz-cap", type=int, default=0,
                    help="entries a batch (default 16 a row, the JAX "
                         "example's)")
    ap.add_argument("--crash-rank", type=int, default=-1)
    ap.add_argument("--crash-epoch", type=int, default=-1)
    ap.add_argument("--state-ckpt-dir", default="",
                    help="arm the resharder's per-leaf checkpoint fallback")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the rank's card, cuda:LOCAL_RANK) or cpu")
    ap.add_argument("--init", default="",
                    help=".npz of the initial param tree (w0, w, v)")
    return ap


def digest(tree: Any) -> str:
    """The JAX example's state digest: sha1 over the sorted leaf paths,
    dtypes and bytes."""
    from ..utils.checkpoint import flatten_tree
    flat = flatten_tree(tree)
    h = hashlib.sha1()
    for p in sorted(flat):
        a = np.ascontiguousarray(flat[p])
        h.update(p.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def state_tree(model, optimizer) -> Dict[str, Any]:
    """The live state as the JAX example holds it, in host numpy."""
    from ..models.convert import adam_state_to_optax, params_to_numpy
    return {"params": params_to_numpy(model, nested=True),
            "opt_state": adam_state_to_optax(model, optimizer)}


def zero_state(features: int, dim: int) -> Dict[str, Any]:
    """Zeros in the state's structure and dtypes, identical on every
    rank: a joining rank's contribution to the averaging, and the
    resharder's container template."""
    def params():
        return {"w0": np.zeros((), np.float32),
                "w": np.zeros((features,), np.float32),
                "v": np.zeros((features, dim), np.float32)}
    return {"params": params(),
            "opt_state": ((np.zeros((), np.int32), params(), params()), ())}


def _load_state(model, optimizer, host: Dict[str, Any]) -> None:
    """Copy a host state into the model's and the optimizer's own tensors
    (in place: captured graphs hold their addresses)."""
    from ..models.convert import adam_state_from_optax, params_from_jax
    dev = next(model.parameters()).device
    model.load_state_dict(params_from_jax(host["params"], dev))
    adam_state_from_optax(model, optimizer, host["opt_state"])


def _device(name: str, rank: int):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % max(torch.cuda.device_count(), 1))
    return dev


def backend_for(dev, world: int) -> str:
    """The data plane's backend: NCCL where every rank has a card of its
    own, else gloo (ranks sharing a card, or on the CPU: NCCL refuses
    two ranks on one card)."""
    if dev.type != "cuda":
        return "gloo"
    import torch
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def print_line(line: str) -> None:
    """``line`` and its newline to stdout in one write: the ranks under a
    launcher share its stdout pipe, and a write of a whole line (under
    the pipe's atomic size) keeps their lines apart, also when stdout is
    unbuffered."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def train(args: argparse.Namespace,
          hook: Optional[Callable[..., None]] = None,
          out: Callable[[str], None] = print_line) -> Dict[str, Any]:
    """Run the elastic epochs of ``args`` (:func:`build_parser`'s) as this
    process's rank; returns ``{"records", "model", "optimizer",
    "generation"}`` once the cohort has closed its mesh and left the
    tracker."""
    import torch

    from ..data import create_parser
    from ..models import FactorizationMachine, FusedTrainer, adam
    from ..models.convert import params_from_jax
    from ..parallel import ElasticTorchMesh, RabitContext, StateHandle
    from ..pipeline import DeviceLoader
    from ..utils.checkpoint import flatten_tree, unflatten_like
    from ..utils.faults import FaultInjected, fault_point

    def call(event: str, **info: Any) -> None:
        if hook is not None:
            hook(event, **info)

    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    ctx = RabitContext.from_env()
    start_epoch = 0
    joining = False
    if attempt > 0:
        saved = ctx.load_checkpoint()     # rabit seq fast-forwards here
        if saved is not None:
            start_epoch = saved["epoch"] + 1
            joining = True
        out(f"rank {ctx.rank} reborn (attempt {attempt}), "
             f"resuming at epoch {start_epoch}")
    dev = _device(args.device, ctx.rank)
    mesh = ElasticTorchMesh(ctx, device=dev,
                            backend=backend_for(dev, ctx.world_size))
    if attempt == 0:
        mesh.initialize()
        # checkpoint the post-join position IMMEDIATELY: a rank that
        # crashes during epoch 0 must still restore a rabit seq that
        # matches the survivors, who ran ensure(0)'s two control-plane
        # barriers before epoch 0's first collective
        ctx.checkpoint({"epoch": -1})
    # A REBORN rank must NOT initialize here: survivors are blocked in the
    # epoch-loss allreduce, so the reborn's next collective must be that
    # same allreduce — the mesh join happens at the shared sync point's
    # resync(), where the frame positions line up.

    model = FactorizationMachine(args.features, args.dim, device=dev)
    if args.init:
        with np.load(args.init) as z:
            model.load_state_dict(params_from_jax(dict(z), dev))
    opt = adam(model, LR)
    template = zero_state(args.features, args.dim)

    # the state plane: box["state"] is this rank's live host-side state;
    # None while joining, so the reborn recovers WHOLLY from peers
    box: Dict[str, Any] = {"state": None}
    handle = StateHandle(lambda: box["state"], template=template,
                         checkpoint=args.state_ckpt_dir or None)
    mesh.register_state(handle)

    records: List[Dict[str, Any]] = []
    for epoch in range(start_epoch, args.epochs):
        contributing = not (joining and epoch == start_epoch)
        loss, steps = 0.0, 0
        t0 = time.perf_counter()
        if contributing:
            with DeviceLoader(
                    create_parser(args.uri, ctx.rank, ctx.world_size,
                                  "libsvm"),
                    args.batch_rows, args.nnz_cap or args.batch_rows * 16,
                    id_mod=args.features, device=dev,
                    emit="host") as loader:
                trainer = FusedTrainer(model, opt, loader, k=8)
                loss = trainer.run_epoch()
                steps = trainer.steps
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        if (attempt == 0 and ctx.rank == args.crash_rank
                and epoch == args.crash_epoch):
            out(f"rank {ctx.rank} CRASHING at epoch {epoch}")
            call("crash", epoch=epoch)
            os._exit(7)
        try:
            # chaos kill site: armed by DMLC_FAULT_SPEC, fires AFTER local
            # compute and BEFORE the sync collectives — the shape of a real
            # mid-epoch death (survivors block in the loss allreduce until
            # the launcher respawns this rank)
            fault_point("elastic.epoch")
        except FaultInjected:
            out(f"rank {ctx.rank} CRASHING at epoch {epoch}")
            call("crash", epoch=epoch)
            os._exit(7)

        # Epoch sync point, in collective order — identical on every rank:
        # (1) loss + liveness reduction, (2) elastic averaging of every
        # state leaf (joining ranks contribute zeros), (3) mesh resync —
        # a death anywhere surfaces here, the data plane rebuilds, and the
        # resharder hands reborn ranks the averaged state — then (4) the
        # rabit position checkpoint LAST, so a reborn rank's restored seq
        # equals the survivors' seq at the next epoch's entry.
        t1 = time.perf_counter()
        flag = 1.0 if contributing else 0.0
        agg = ctx.allreduce(np.array([loss * flag, flag], np.float64))
        live = max(agg[1], 1.0)
        mean_loss = float(agg[0]) / live
        host = state_tree(model, opt) if contributing else template
        flat = flatten_tree(host)
        avg = {}
        for path in sorted(flat):
            leaf = flat[path]
            summed = ctx.allreduce(np.ascontiguousarray(
                np.atleast_1d(leaf), dtype=np.float64))
            mean = summed / live
            if np.issubdtype(leaf.dtype, np.integer):
                mean = np.rint(mean)
            avg[path] = mean.astype(leaf.dtype).reshape(leaf.shape)
        host = unflatten_like(template, avg)
        avg_s = time.perf_counter() - t1
        box["state"] = host if contributing else None
        t2 = time.perf_counter()
        res = mesh.resync()
        resync_s = time.perf_counter() - t2
        if res.rebuilt and res.state is not None:
            host = res.state              # survivors: own snapshot back;
        box["state"] = host               # reborn: peers' averaged state
        _load_state(model, opt, host)
        joining = False
        ctx.checkpoint({"epoch": epoch})
        stats = res.stats
        rec = {"rank": ctx.rank, "epoch": epoch, "loss": round(mean_loss, 6),
               "gen": mesh.generation, "rebuilt": bool(res),
               "contributed": bool(contributing), "digest": digest(host),
               "from_peers": getattr(stats, "leaves_from_peers", 0),
               "from_ckpt": getattr(stats, "leaves_from_checkpoint", 0),
               "bytes_moved": getattr(stats, "bytes_moved", 0)}
        records.append(rec)
        out("EPOCH " + json.dumps(rec))
        out(f"rank {ctx.rank} epoch {epoch} mean_loss {mean_loss:.5f}"
             + (f" [mesh rebuilt -> gen {mesh.generation}]"
                if res.rebuilt else ""))
        call("synced", epoch=epoch, record=rec, result=res, mesh=mesh,
             host=host, times={"train_s": train_s, "steps": steps,
                               "average_s": avg_s, "resync_s": resync_s,
                               **(mesh.timings if res.rebuilt else {})})

    generation = mesh.generation
    out(f"rank {ctx.rank} DONE gen={generation}")
    mesh.close()
    ctx.shutdown()
    return {"records": records, "model": model, "optimizer": opt,
            "generation": generation}


def main(argv: Optional[List[str]] = None) -> int:
    train(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
