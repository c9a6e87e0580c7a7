"""DLRM-style training over a SHARDED embedding table — the table is
bigger than any one rank, and a rank death costs zero checkpoint reads.

Counterpart of the JAX package's ``examples/train_embed_shard.py``: the
same command line, the same ``EPOCH {json}`` records (loss, digest,
``from_ckpt``, ``resident``, ``rebuilt``, ``gen``, ``from_peers``,
``bytes_moved``), the same crash flags and ``embed.epoch`` fault point,
and the same epoch sync order.  Usage (the launcher respawns crashed
ranks; the job passes the elastic base port)::

    python -m dmlc_core_tpu_torch.parallel.launcher.submit \\
        --cluster ssh -n 3 --host-file hosts --max-attempts 2 \\
        --env DMLC_ELASTIC_BASE_PORT=29800 -- \\
        python -m dmlc_core_tpu_torch.examples.train_embed_shard <uri> \\
            [--features N --dim D --hidden H --epochs E] \\
            [--crash-rank R --crash-epoch E] [--device cpu] [--report DIR]

(``--cluster gpu --elastic`` reserves the base port itself.)

The model is pooled-embedding + MLP: each ragged CSR batch looks up a
:class:`~dmlc_core_tpu_torch.embed.ShardedEmbeddingTable` (deduped
fan-out exchange to the owning ranks, hot-row cache, replica failover;
the pooled gather on the card through the ragged-gather kernel), the
pooled ``[batch_rows, dim]`` output feeds a small dense tower (an
``nn.Module`` on the rank's device, ``cuda:LOCAL_RANK`` by default, or
``--device cpu``), and the pooled gradient flows back through
``table.backward`` (the ragged-gather backward kernel) as sparse
per-row updates that only cross the wire at the epoch flush.  The
tower's initial weights are the JAX tower's own draw
(``numpy.random.default_rng(7)``), so both examples start from the same
bits.

**Determinism contract.**  The table is FROZEN within an epoch —
lookups are read-only and gradients accumulate host-side — and the
epoch flush is collective (every holder applies every rank's grads in
rank order), so primaries and replicas stay bit-equal.  On the plain
path (``--device cpu``) a run is bit-reproducible kill-or-no-kill, as
the JAX example's.  On the card the backward kernel adds a row's
entries with atomics, so kill and no-kill agree to rounding, not to the
bit.  A reborn rank COMPUTES its join epoch: it restores the epoch
number, dense tower, and shard-server addresses from the tiny rabit
checkpoint, looks up every row remotely (its own shard is served by
replica holders while it owns nothing), and contributes gradients
exactly as the dead rank would have.  No embedding row is ever read
from a checkpoint — ``from_ckpt`` stays 0 in the EPOCH records.

Epoch sync point, in collective order — identical on every rank:
(1) loss allreduce, (2) dense-tower averaging allreduces, (3) the
collective ``table.flush``, (4) ``mesh.resync()`` — on a rebuild the
resharder redistributes shards live (``remap_rows`` intervals), then
``sync_addresses`` + ``rebuild_replicas`` restore the serving layout —
and (5) the rabit position checkpoint LAST.

``--dispatcher`` (the JAX example's data-service feed) is refused: the
data service is ROADMAP A.9.  ``--crash-rank/--crash-epoch`` inject a
one-shot crash (first attempt only) at the TOP of the epoch loop;
``fault_point("embed.epoch")`` arms the same kill via
``DMLC_FAULT_SPEC`` (e.g. ``embed.epoch:error=1:times=1:after=1`` kills
entering epoch 1, after epoch 0 is fully synced and checkpointed).
``--report DIR`` writes, beside the records, ``DIR/embed_r<R>.jsonl`` (a
line an epoch and incarnation: times, the ``embed.*`` counters' deltas,
each held block's digest, the reshard's stats, the kernels' launches),
``DIR/crash_r<R>.json`` just before an injected crash and
``DIR/rank<R>.json`` at the end.
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

from .elastic_train import _device, backend_for, print_line

__all__ = ["build_parser", "train", "main", "init_dense", "block_digests"]

#: the embed.* counters an epoch's report line carries, as deltas
COUNTERS = ("lookup_ids", "dedup_saved", "lookup_rows", "cache_hits",
            "cache_misses", "exchange_bytes", "exchange_rows", "update_rows",
            "flushes", "failovers")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.examples.train_embed_shard",
        description="Pooled-embedding + MLP training over a sharded "
                    "embedding table that survives a rank's death.")
    ap.add_argument("uri")
    ap.add_argument("--features", type=int, default=1 << 16)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-rows", type=int, default=128)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.1,
                    help="dense-tower SGD step")
    ap.add_argument("--embed-lr", type=float, default=0.05,
                    help="embedding-row SGD step (applied at flush)")
    ap.add_argument("--crash-rank", type=int, default=-1)
    ap.add_argument("--crash-epoch", type=int, default=-1)
    ap.add_argument("--state-ckpt-dir", default="",
                    help="arm the resharder's per-leaf checkpoint fallback")
    ap.add_argument("--dispatcher", default="",
                    help="refused: the data service is ROADMAP A.9")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the rank's card, cuda:LOCAL_RANK) or cpu")
    ap.add_argument("--report", default="",
                    help="directory for the per-epoch report files")
    return ap


def init_dense(dim: int, hidden: int) -> Dict[str, np.ndarray]:
    """The dense tower's initial weights: the JAX example's draw, the same
    on every rank."""
    rng = np.random.default_rng(7)
    return {
        "w1": (rng.standard_normal((dim, hidden))
               / np.sqrt(dim)).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": (rng.standard_normal(hidden)
               / np.sqrt(hidden)).astype(np.float32),
        "b2": np.zeros((), np.float32),
    }


def block_digests(table) -> Dict[str, str]:
    """``{"start:stop": sha1}`` of every block the table holds, primaries
    and replicas: holders of one interval must agree."""
    out = {}
    for shard, (s, e) in enumerate(table.partition):
        block = (table.read_block(s, e)
                 if s < e and table.rank in table.holders_of(shard) else None)
        if block is not None:
            out[f"{s}:{e}"] = hashlib.sha1(block.tobytes()).hexdigest()[:16]
    return out


def _tower(dense: Dict[str, np.ndarray], dev):
    """The dense tower as an ``nn.Module`` whose parameters are named as
    the JAX example's dict keys."""
    import torch
    from torch import nn

    class Tower(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            for k in sorted(dense):
                self.register_parameter(k, nn.Parameter(
                    torch.from_numpy(np.array(dense[k])).to(dev)))

        def forward(self, pooled, labels, weights):
            h = torch.tanh(pooled @ self.w1 + self.b1)
            logit = h @ self.w2 + self.b2
            ll = (labels * torch.nn.functional.logsigmoid(logit)
                  + (1.0 - labels) * torch.nn.functional.logsigmoid(-logit))
            return -(weights * ll).sum()

    return Tower()


def _host(tower) -> Dict[str, np.ndarray]:
    return {k: p.detach().cpu().numpy().copy()
            for k, p in tower.named_parameters()}


def _load(tower, dense: Dict[str, np.ndarray]) -> None:
    import torch
    with torch.no_grad():
        for k, p in tower.named_parameters():
            p.copy_(torch.from_numpy(np.array(dense[k])).reshape(p.shape))


def train(args: argparse.Namespace,
          out: Callable[[str], None] = print_line) -> List[Dict[str, Any]]:
    """Run this process's rank of the cohort; returns its EPOCH records
    once the cohort has closed its mesh and left the tracker."""
    import torch

    from ..data import create_parser
    from ..embed import ShardedEmbeddingTable
    from ..kernels import launch_counts
    from ..parallel import ElasticTorchMesh, RabitContext
    from ..pipeline.packing import pack_ragged, ragged_slices
    from ..utils.faults import FaultInjected, fault_point
    from ..utils.logging import DMLCError
    from ..utils.metrics import metrics

    if args.dispatcher:
        raise DMLCError("--dispatcher feeds batches from the data service, "
                        "which waits for ROADMAP A.9; run without it (each "
                        "rank parses its own partition)")
    nnz_cap = args.batch_rows * 16
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    ctx = RabitContext.from_env()
    rank, world = ctx.rank, ctx.world_size
    dev = _device(args.device, rank)
    report = args.report
    if report:
        os.makedirs(report, exist_ok=True)

    dense = init_dense(args.dim, args.hidden)
    start_epoch = 0
    saved_addrs = None
    if attempt > 0:
        saved = ctx.load_checkpoint()     # rabit seq fast-forwards here
        if saved is not None:
            start_epoch = saved["epoch"] + 1
            dense = {k: np.asarray(v) for k, v in saved["dense"].items()}
            saved_addrs = saved["addrs"]
        out(f"rank {rank} reborn (attempt {attempt}), "
            f"resuming at epoch {start_epoch}")

    # A reborn rank holds NOTHING (hold=False): its shard lives on the
    # survivors' replicas until the next resync redistributes it back.
    # It still serves (empty answers make clients fail over) and still
    # COMPUTES its join epoch via remote lookups.
    table = ShardedEmbeddingTable(
        args.features, args.dim, rank=rank, world=world,
        replicas=args.replicas, lr=args.embed_lr, hold=(attempt == 0),
        flush_every=0, serve=True, device=dev)
    if saved_addrs is not None:
        table.set_addresses(saved_addrs)

    # the launcher (or the job's --env) provides the base port
    mesh = ElasticTorchMesh(ctx, device=dev, backend=backend_for(dev, world))
    mesh.register_state(table.state_handle(
        checkpoint=args.state_ckpt_dir or None))
    if attempt == 0:
        mesh.initialize()
        table.sync_addresses(ctx)
        # checkpoint the post-join position IMMEDIATELY so a rank that
        # dies before its first epoch checkpoint still restores a rabit
        # seq (and address map) matching the survivors
        ctx.checkpoint({"epoch": -1, "dense": dense,
                        "addrs": table.addresses})
    # A REBORN rank must NOT initialize here: survivors are blocked in
    # the epoch-loss allreduce, so the reborn's next rabit collective
    # must be that same allreduce (table lookups are point-to-point TCP
    # and don't consume rabit frames).

    tower = _tower(dense, dev)

    def batches():
        with create_parser(args.uri, rank, world, "libsvm") as parser:
            for block in parser:
                for sl in ragged_slices(block, args.batch_rows, nnz_cap):
                    yield pack_ragged(sl, args.batch_rows, nnz_cap,
                                      id_mod=args.features)

    def digest() -> str:
        h = hashlib.sha1()
        for k in sorted(dense):
            h.update(k.encode())
            h.update(np.ascontiguousarray(dense[k]).tobytes())
        s, e = table.partition[rank]
        block = table.read_block(s, e) if s < e else None
        h.update(block.tobytes() if block is not None else b"")
        return h.hexdigest()[:16]

    def counters() -> Dict[str, int]:
        return {k: metrics.counter("embed." + k).value for k in COUNTERS}

    def crash(epoch: int) -> None:
        out(f"rank {rank} CRASHING at epoch {epoch}")
        if report:
            with open(os.path.join(report, f"crash_r{rank}.json"), "w") as f:
                json.dump({"time": time.time(), "epoch": epoch}, f)
        os._exit(7)

    def sync(t: float) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t

    records: List[Dict[str, Any]] = []
    for epoch in range(start_epoch, args.epochs):
        if (attempt == 0 and rank == args.crash_rank
                and epoch == args.crash_epoch):
            crash(epoch)
        try:
            # chaos kill site: TOP of the epoch loop — epoch e-1 is fully
            # synced and checkpointed, epoch e not yet computed, nothing
            # pending.  The reborn recomputes THIS epoch from the rabit
            # checkpoint + remote lookups; survivors block in the loss
            # allreduce until the launcher respawns it.
            fault_point("embed.epoch")
        except FaultInjected:
            crash(epoch)

        before = counters()
        times = {"lookup_s": 0.0, "tower_s": 0.0, "backward_s": 0.0}
        loss_sum = 0.0
        weight_sum = 0.0
        steps = 0
        t_epoch = time.perf_counter()
        for batch in batches():
            t = time.perf_counter()
            pooled = table.lookup(batch)
            times["lookup_s"] += time.perf_counter() - t
            t = time.perf_counter()
            p = torch.from_numpy(pooled).to(dev).requires_grad_(True)
            loss = tower(p, torch.from_numpy(batch["labels"]).to(dev),
                         torch.from_numpy(batch["weights"]).to(dev))
            loss.backward()
            with torch.no_grad():
                for prm in tower.parameters():
                    prm -= args.lr * prm.grad
                    prm.grad = None
            times["tower_s"] += sync(t)
            t = time.perf_counter()
            table.backward(batch, p.grad)
            times["backward_s"] += time.perf_counter() - t
            loss_sum += float(loss)
            weight_sum += float(batch["weights"].sum())
            steps += 1
        times["train_s"] = time.perf_counter() - t_epoch
        dense = _host(tower)

        # Epoch sync point — see module docstring for the collective order.
        t = time.perf_counter()
        agg = ctx.allreduce(np.array([loss_sum, weight_sum], np.float64))
        mean_loss = float(agg[0]) / max(float(agg[1]), 1.0)
        for k in sorted(dense):
            summed = ctx.allreduce(np.ascontiguousarray(
                np.atleast_1d(dense[k]), dtype=np.float64))
            dense[k] = ((summed / world).astype(np.float32)
                        .reshape(dense[k].shape))
        _load(tower, dense)
        times["average_s"] = time.perf_counter() - t
        t = time.perf_counter()
        table.flush(ctx)
        times["flush_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res = mesh.resync()
        times["resync_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if res.rebuilt:
            # adopt_restored already ran via the state handle; re-agree
            # the (possibly new) server addresses, then refetch replica
            # blocks from the new primaries
            table.sync_addresses(ctx)
            table.rebuild_replicas()
        times["rebuild_s"] = time.perf_counter() - t
        ctx.checkpoint({"epoch": epoch, "dense": dense,
                        "addrs": table.addresses})
        stats = res.stats
        rec = {"rank": rank, "epoch": epoch, "loss": round(mean_loss, 6),
               "gen": mesh.generation, "rebuilt": bool(res),
               "digest": digest(),
               "from_peers": getattr(stats, "leaves_from_peers", 0),
               "from_ckpt": getattr(stats, "leaves_from_checkpoint", 0),
               "bytes_moved": getattr(stats, "bytes_moved", 0),
               "resident": table.resident_bytes}
        records.append(rec)
        out("EPOCH " + json.dumps(rec))
        out(f"rank {rank} epoch {epoch} mean_loss {mean_loss:.5f}"
            + (f" [mesh rebuilt -> gen {mesh.generation}]"
               if res.rebuilt else ""))
        if report:
            after = counters()
            line = {**rec, "attempt": attempt, "steps": steps,
                    "times": times, "joined_at": mesh.joined_at,
                    "mesh_times": dict(mesh.timings) if res.rebuilt else {},
                    "counters": {k: after[k] - before[k] for k in COUNTERS},
                    "blocks": block_digests(table),
                    "stats": stats.as_dict() if stats is not None else None,
                    "launches": launch_counts()}
            with open(os.path.join(report, f"embed_r{rank}.jsonl"),
                      "a") as f:
                f.write(json.dumps(line) + "\n")

    out(f"rank {rank} DONE gen={mesh.generation}")
    if report:
        with open(os.path.join(report, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "attempt": attempt,
                       "launches": launch_counts()}, f)
    table.close()
    mesh.close()
    ctx.shutdown()
    return records


def main(argv: Optional[List[str]] = None) -> int:
    train(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
