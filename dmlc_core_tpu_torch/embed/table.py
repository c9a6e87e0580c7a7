"""ShardedEmbeddingTable: a ``(num_rows, dim)`` table partitioned across ranks.

The recommendation workload this stack exists for keys on embedding
tables that exceed single-host memory.  This module shards one giant
table by rows over the elastic cohort using the same interval math the
resharder speaks (:func:`~..parallel.mesh.row_partition`), so shard
boundaries are a pure function of ``(num_rows, world)`` and every rank
computes them without communicating.

**Ownership.**  Rank ``r`` holds the primary copy of partition range
``r`` plus replica copies of the ``replicas`` preceding ranges (shard
``s`` is replicated on ranks ``s+1 … s+replicas mod world``).  Replicas
make death survivable without checkpoints: a reborn rank's shard is
reassembled from a surviving replica by the checkpoint-free resharder,
and lookups that hit a dead primary fail over to a replica holder in
the meantime.

**Lookup.**  Ragged CSR batches (``ops/ragged_csr.py`` layout) are
deduped (:func:`~..pipeline.packing.dedup_ids`) before anything touches
the wire; unique ids resolve from (1) locally-held blocks, (2) the
per-rank hot-row cache (``DMLC_EMBED_CACHE_ROWS``), (3) peer shard
servers via the fan-out exchange (``DMLC_EMBED_FANOUT``).  The gathered
unique-row matrix then feeds :func:`~..ops.ragged_csr.ragged_embed_sum`
with the remapped position ids — the local pooled gather is exactly the
single-host ragged path, run over a compacted table.

**Update.**  ``backward()`` turns the pooled-output gradient into
per-unique-row gradients (:func:`~..ops.ragged_csr.ragged_embed_grad`)
and accumulates them host-side; only touched rows ever cross the
network.  Two flush modes: ``flush(ctx)`` is collective — every rank's
pending grads travel once over rabit broadcast rounds and every holder
applies them **in rank order**, so primaries and replicas stay
bit-identical and a run is reproducible kill-or-no-kill; direct mode
(``DMLC_EMBED_FLUSH_EVERY`` > 0) sends updates point-to-point to every
holder on a cadence for throughput-bound training.

**Elasticity.**  ``state_handle()`` registers the held blocks with
:meth:`~..parallel.elastic.ElasticTorchMesh.register_state` via the
ranged-snapshot hook: on a generation bump the resharder moves only the
intervals whose owner changed (``remap_rows`` math), replicas are
rebuilt from the new primaries, and a rank whose snapshot would exceed
``DMLC_RESHARD_MAX_BYTES`` degrades to a non-holder exactly like the
dense path.

Counterpart of ``dmlc_core_tpu/embed/table.py``.  The layout and the
state are the JAX package's: the blocks, the hot-row cache and the
pending gradients stay host-side numpy, ``lookup`` / ``backward`` /
``flush`` take and return numpy, and the snapshot and the resharder's
``DMRS1`` wire carry numpy, so JAX and port ranks serve each other.  The
device work is the port's: ``lookup`` copies the bucketed unique-row
matrix and the batch's position ids to the table's ``device`` (``cuda``
by default) and runs :func:`~..ops.ragged_csr.ragged_embed_sum` there,
``backward`` runs :func:`~..ops.ragged_csr.ragged_embed_grad` over
``_bucket(uniq.size)`` rows, both the ragged-gather kernels on the card
(``engine="auto"``; the JAX table picks XLA there).  Their plain
versions run only under ``device="cpu"`` or ``engine="torch"``.  The
kernels' backward adds a row's entries with atomics, so on the card two
runs agree to rounding, not to the bit; every holder still applies the
same flushed payloads in rank order, so primaries and replicas stay
bit-equal.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.ragged_csr import ragged_embed_grad, ragged_embed_sum
from ..parallel.mesh import row_owners, row_partition
from ..parallel.reshard import HostSnapshot, StateHandle, _my_host
from ..pipeline.packing import dedup_ids
from ..telemetry import trace as teltrace
from ..utils.checkpoint import flatten_tree
from ..utils.device import resolve_device
from ..utils.logging import DMLCError, check, log_warning
from ..utils.metrics import metrics
from ..utils.parameter import env_int
from . import exchange

__all__ = ["ShardedEmbeddingTable"]

#: deterministic-init granularity: rows are generated in global-index
#: keyed chunks so any (world, rank) layout materializes bit-identical
#: rows without ever holding the whole table anywhere
_INIT_CHUNK = 2048


def _init_rows(num_rows: int, dim: int, start: int, stop: int,
               seed: int, dtype) -> np.ndarray:
    """Rows ``[start, stop)`` of the deterministic initial table: chunk
    ``c`` always comes from ``default_rng([seed, c])`` whatever shard
    asks, so grow/shrink layouts agree on untouched rows bit-for-bit."""
    out = np.empty((stop - start, dim), dtype)
    if stop <= start:
        return out
    scale = float(dim) ** -0.5
    c = start // _INIT_CHUNK
    while c * _INIT_CHUNK < stop:
        cs = c * _INIT_CHUNK
        ce = min(cs + _INIT_CHUNK, num_rows)
        rng = np.random.default_rng([seed, c])
        chunk = (rng.standard_normal((ce - cs, dim)) * scale).astype(dtype)
        lo, hi = max(cs, start), min(ce, stop)
        out[lo - start:hi - start] = chunk[lo - cs:hi - cs]
        c += 1
    return out


def _bucket(n: int) -> int:
    """Next power-of-two capacity (min 8) for the unique-row matrix: the
    JAX table compiles its gather once a bucket; here the bucket sets the
    backward's dense ``[cap, dim]`` gradient, kept for the same
    numbers."""
    cap = 8
    while cap < n:
        cap <<= 1
    return cap


class ShardedEmbeddingTable:
    """One row-sharded embedding table held cooperatively by a cohort.

    ``world == 1`` is the degenerate single-host mode: every lookup is
    local, nothing touches the wire, and the numerics are identical to
    a dense table — the migration path for ``train_fm``/``train_dcn``
    style single-host trainers (see docs/distributed.md).

    ``device`` is where the pooled gather and its backward run (``cuda``
    by default, raising without a card; ``"cpu"`` for the plain
    version), ``engine`` the ragged ops' (``auto``: the kernels on the
    card; ``torch``: the plain version; ``kernel``).
    """

    def __init__(self, num_rows: int, dim: int, *, rank: int = 0,
                 world: int = 1, seed: int = 0, lr: float = 0.05,
                 dtype=np.float32, replicas: int = 1, hold: bool = True,
                 name: str = "embed", cache_rows: Optional[int] = None,
                 flush_every: Optional[int] = None,
                 serve: bool = False, device: Any = "cuda",
                 engine: str = "auto") -> None:
        check(num_rows > 0 and dim > 0, "table wants positive num_rows/dim")
        check(0 <= rank < world, f"rank {rank} outside world {world}")
        self.num_rows, self.dim = int(num_rows), int(dim)
        self.rank, self.world = int(rank), int(world)
        self.seed, self.lr = int(seed), float(lr)
        self.dtype = np.dtype(dtype)
        self.replicas = min(max(0, int(replicas)), self.world - 1)
        self.name = str(name)
        self.leaf = f"{self.name}/table"
        self.cache_rows = (env_int("DMLC_EMBED_CACHE_ROWS", 65536,
                                   minimum=0)
                           if cache_rows is None else max(0, int(cache_rows)))
        self.flush_every = (env_int("DMLC_EMBED_FLUSH_EVERY", 0, minimum=0)
                            if flush_every is None else max(0, int(flush_every)))
        self.device = resolve_device(device)
        self.engine = engine
        self.version = 0
        self._lock = threading.Lock()
        self._blocks: Dict[Tuple[int, int], np.ndarray] = {}
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._pending: Dict[int, np.ndarray] = {}
        self._accum_steps = 0
        self._addrs: Dict[int, Tuple[str, int]] = {}
        self.partition = row_partition(self.num_rows, self.world)
        if hold:
            with self._lock:
                for s, e in self._held_intervals():
                    self._blocks[(s, e)] = _init_rows(
                        self.num_rows, self.dim, s, e, self.seed, self.dtype)
                self._resident_locked()
        self.server: Optional[exchange.ShardServer] = None
        if serve:
            self.serve()

    # -- layout ----------------------------------------------------------
    def _held_intervals(self) -> List[Tuple[int, int]]:
        """Primary range + the ``replicas`` preceding ranges (mod world),
        non-empty only."""
        out = []
        for i in range(self.replicas + 1):
            s, e = self.partition[(self.rank - i) % self.world]
            if s < e and (s, e) not in out:
                out.append((s, e))
        return out

    def holders_of(self, shard: int) -> List[int]:
        """Ranks holding shard ``shard``'s rows: primary first, then its
        replica holders in distance order."""
        return [(shard + i) % self.world
                for i in range(self.replicas + 1)][:self.world]

    def set_layout(self, rank: int, world: int) -> None:
        """Adopt a new cohort layout (resize) — the next restore/rebuild
        installs blocks for this layout."""
        check(0 <= rank < world, f"rank {rank} outside world {world}")
        self.rank, self.world = int(rank), int(world)
        self.replicas = min(self.replicas, self.world - 1)
        self.partition = row_partition(self.num_rows, self.world)

    def _resident_locked(self) -> int:
        n = sum(a.nbytes for a in self._blocks.values())
        metrics.gauge("embed.resident_bytes").set(n)
        return n

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(a.nbytes for a in self._blocks.values())

    # -- server-side block access (called from exchange threads) ---------
    def read_rows(self, ids: np.ndarray) -> Optional[np.ndarray]:
        """Gather ``table[ids]`` from held blocks; None when any id is
        not held here (client fails over)."""
        out = np.empty((ids.shape[0], self.dim), self.dtype)
        with self._lock:
            done = np.zeros(ids.shape[0], bool)
            for (s, e), arr in self._blocks.items():
                m = (ids >= s) & (ids < e)
                if m.any():
                    out[m] = arr[ids[m] - s]
                    done |= m
            if not done.all():
                return None
        return out

    def read_block(self, start: int, stop: int) -> Optional[np.ndarray]:
        with self._lock:
            for (s, e), arr in self._blocks.items():
                if s <= start and stop <= e:
                    return arr[start - s:stop - s].copy()
        return None

    def apply_update(self, ids: np.ndarray, grads: np.ndarray, *,
                     lr: Optional[float] = None) -> int:
        """SGD scatter-update every held block covering ``ids`` (primary
        and replica alike — identical math keeps them bit-equal).
        Returns rows applied; bumps the version and drops the hot-row
        cache (the cached rows may now be stale)."""
        step = self.lr if lr is None else float(lr)
        ids = np.asarray(ids, dtype=np.int64)
        applied = 0
        with self._lock:
            for (s, e), arr in self._blocks.items():
                m = (ids >= s) & (ids < e)
                if m.any():
                    arr[ids[m] - s] -= (step * grads[m]).astype(self.dtype)
                    applied += int(m.sum())
            self.version += 1
            self._cache.clear()
        return applied

    # -- exchange plumbing ------------------------------------------------
    def serve(self) -> "exchange.ShardServer":
        if self.server is None:
            self.server = exchange.ShardServer(self)
        return self.server

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None

    def sync_addresses(self, ctx) -> None:
        """COLLECTIVE: agree the cohort's shard-server addresses over
        rabit broadcast rounds (same shape as the resharder's manifest
        agreement).  Call after construction and after every accepted
        generation bump."""
        mine = ([_my_host(ctx), self.server.port]
                if self.server is not None else None)
        infos = [ctx.broadcast(mine if r == ctx.rank else None, root=r)
                 for r in range(ctx.world_size)]
        with self._lock:
            self._addrs.clear()
            self._addrs.update({r: (a[0], int(a[1]))
                                for r, a in enumerate(infos) if a})

    @property
    def addresses(self) -> Dict[int, Tuple[str, int]]:
        """The agreed shard-server address map (checkpointable: a reborn
        rank restores it via :meth:`set_addresses` so its join-epoch
        lookups reach the survivors before the next collective
        :meth:`sync_addresses`)."""
        with self._lock:
            return dict(self._addrs)

    def set_addresses(self, addrs: Dict[int, Tuple[str, int]]) -> None:
        """Install an address map out-of-band (from a rabit checkpoint on
        rebirth).  Entries for dead peers are harmless — fetches fail
        over to replica holders."""
        with self._lock:
            self._addrs.clear()
            self._addrs.update({int(r): (a[0], int(a[1]))
                                for r, a in addrs.items() if a})

    def _fetch_from_holders(self, shard: int, fn) -> Any:
        """Run ``fn(addr)`` against shard ``shard``'s holders, primary
        first; replicas are the failover path while a primary is being
        reborn."""
        last: Optional[Exception] = None
        for i, holder in enumerate(self.holders_of(shard)):
            if holder == self.rank:
                continue
            addr = self._addrs.get(holder)
            if addr is None:
                continue
            try:
                got = fn(addr)
                if i > 0:
                    metrics.counter("embed.failovers").add(1)
                return got
            except (OSError, DMLCError) as e:
                last = e
                log_warning("embed: holder %d of shard %d failed (%s) — "
                            "trying next", holder, shard, e)
        raise DMLCError(f"embed: no live holder for shard {shard}: {last}")

    # -- lookup -----------------------------------------------------------
    def _gather_unique(self, uniq: np.ndarray) -> np.ndarray:
        """Resolve unique global ids to rows: held blocks → hot-row cache
        → peer exchange (fan-out, with replica failover)."""
        out = np.empty((uniq.shape[0], self.dim), self.dtype)
        need: List[int] = []
        hits = 0
        with self._lock:
            done = np.zeros(uniq.shape[0], bool)
            for (s, e), arr in self._blocks.items():
                m = (uniq >= s) & (uniq < e)
                if m.any():
                    out[m] = arr[uniq[m] - s]
                    done |= m
            for i in np.nonzero(~done)[0]:
                row = self._cache.get(int(uniq[i]))
                if row is not None:
                    out[i] = row
                    self._cache.move_to_end(int(uniq[i]))
                    done[i] = True
                    hits += 1
                else:
                    need.append(int(i))
        if hits:
            metrics.counter("embed.cache_hits").add(hits)
        if not need:
            return out
        metrics.counter("embed.cache_misses").add(len(need))
        need_idx = np.asarray(need, dtype=np.int64)
        owners = row_owners(self.num_rows, self.world, uniq[need_idx])
        by_owner: Dict[int, np.ndarray] = {
            int(o): need_idx[owners == o] for o in np.unique(owners)}

        def one(item):
            shard, idxs = item
            ids = uniq[idxs]
            return idxs, self._fetch_from_holders(
                shard, lambda addr: exchange.fetch_rows(addr, ids))

        with teltrace.span("embed.exchange", rank=self.rank,
                           owners=len(by_owner), rows=len(need)):
            results = exchange.fanout_map(one, sorted(by_owner.items()))
        with self._lock:
            for idxs, rows in results:
                out[idxs] = rows
                if self.cache_rows:
                    for j, i in enumerate(idxs):
                        self._cache[int(uniq[i])] = rows[j]
                    while len(self._cache) > self.cache_rows:
                        self._cache.popitem(last=False)
        return out

    def _dedup(self, batch) -> Tuple[np.ndarray, np.ndarray, int]:
        nnz = int(batch["nnz_used"])
        uniq, pos = dedup_ids(batch["ids"], nnz)
        if uniq.size and (uniq[0] < 0 or uniq[-1] >= self.num_rows):
            raise DMLCError(
                f"embed: batch ids outside [0, {self.num_rows}) — "
                f"hash/mod ids upstream (id_mod) before lookup")
        return uniq, pos, nnz

    def _entries(self, batch, pos: np.ndarray, nnz: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The batch's entries on the table's device: the position ids
        (``pos`` over the live prefix, zeros past it), values and
        segments."""
        pos_ids = np.zeros(batch["ids"].shape[0], np.int32)
        pos_ids[:nnz] = pos
        dev = self.device
        return (torch.from_numpy(pos_ids).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    batch["vals"], np.float32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    batch["segments"], np.int32)).to(dev))

    def lookup(self, batch: Dict[str, np.ndarray],
               engine: Optional[str] = None) -> np.ndarray:
        """Pooled embedding for one ragged batch: ``out[r] = Σ vals[i] ·
        table[ids[i]]`` over live entries with ``segments[i] == r``.
        Returns ``[batch_rows, dim]`` float32 (rows past ``rows_used``
        are exact zeros, the masked-ragged contract).  ``engine``
        overrides the table's for this call."""
        uniq, pos, nnz = self._dedup(batch)
        rows_cap = int(batch["labels"].shape[0])
        with teltrace.span("embed.lookup", rank=self.rank, nnz=nnz,
                           uniq=int(uniq.size)):
            metrics.counter("embed.lookup_ids").add(nnz)
            metrics.counter("embed.dedup_saved").add(nnz - int(uniq.size))
            metrics.counter("embed.lookup_rows").add(
                int(batch["rows_used"]))
            rows = self._gather_unique(uniq)
            ucap = _bucket(uniq.size)
            mat = np.zeros((ucap, self.dim), self.dtype)
            mat[:uniq.size] = rows
            ids, vals, segs = self._entries(batch, pos, nnz)
            pooled = ragged_embed_sum(
                ids, vals, segs, nnz,
                torch.from_numpy(mat).to(self.device), num_rows=rows_cap,
                engine=engine or self.engine)
        return pooled.cpu().numpy()

    # -- sparse update -----------------------------------------------------
    def backward(self, batch: Dict[str, np.ndarray],
                 g_pooled: Any) -> int:
        """Accumulate the table gradient for one batch from the pooled
        output's upstream grad ``g_pooled[batch_rows, dim]`` (numpy, or a
        tensor on any device).  Only the batch's unique rows are touched;
        grads stay host-side until a flush.  Returns the number of unique
        rows accumulated."""
        uniq, pos, nnz = self._dedup(batch)
        ucap = _bucket(uniq.size)
        ids, vals, segs = self._entries(batch, pos, nnz)
        g_rows = (g_pooled if isinstance(g_pooled, torch.Tensor)
                  else torch.from_numpy(np.asarray(g_pooled, np.float32)))
        g = ragged_embed_grad(ids, vals, segs, nnz,
                              g_rows.to(self.device, torch.float32),
                              num_table_rows=ucap, engine=self.engine)
        g = g[:uniq.size].cpu().numpy()
        flush_now = False
        with self._lock:
            for i, gid in enumerate(uniq):
                cur = self._pending.get(int(gid))
                if cur is None:
                    self._pending[int(gid)] = g[i].copy()
                else:
                    cur += g[i]
            self._accum_steps += 1
            if self.flush_every and self._accum_steps >= self.flush_every:
                self._accum_steps = 0
                flush_now = True
        metrics.counter("embed.update_rows").add(int(uniq.size))
        if flush_now:
            self.flush_direct()
        return int(uniq.size)

    def _drain_pending(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            items = sorted(self._pending.items())
            self._pending.clear()
            self._accum_steps = 0
        if not items:
            return (np.empty((0,), np.int64),
                    np.empty((0, self.dim), np.float32))
        ids = np.array([k for k, _ in items], np.int64)
        grads = np.stack([v for _, v in items]).astype(np.float32)
        return ids, grads

    def flush(self, ctx) -> int:
        """COLLECTIVE deterministic flush: every rank's pending grads
        travel once over rabit broadcast rounds and every holder applies
        every payload **in rank order** — primaries and their replicas
        stay bit-identical, and the result is independent of wire
        timing.  Every rank must call this at the same point (a reborn
        rank with nothing pending still participates)."""
        ids, grads = self._drain_pending()
        applied = 0
        with teltrace.span("embed.flush", rank=self.rank, mode="collective",
                           rows=int(ids.shape[0])):
            for r in range(ctx.world_size):
                payload = ((ids, grads) if r == ctx.rank else None)
                got = ctx.broadcast(payload, root=r)
                gi, gg = got
                if gi is not None and gi.shape[0]:
                    applied += self.apply_update(gi, gg)
            # apply-completion barrier: without it a fast rank can exit
            # and LOOK UP a row from a peer that is still applying the
            # last payload — a torn read the collective contract forbids
            ctx.allreduce(np.zeros(1, np.float32), "sum")
            metrics.counter("embed.flushes").add(1)
            metrics.counter("embed.exchange_bytes").add(
                int(ids.nbytes + grads.nbytes))
        return applied

    def flush_direct(self) -> int:
        """Direct (non-collective) flush: pending grads go point-to-point
        to EVERY holder of their owning shard and are applied on
        arrival.  Throughput mode — apply order across concurrent
        writers is not deterministic (use :meth:`flush` when
        reproducibility matters)."""
        ids, grads = self._drain_pending()
        if not ids.shape[0]:
            return 0
        owners = row_owners(self.num_rows, self.world, ids)
        applied = 0
        with teltrace.span("embed.flush", rank=self.rank, mode="direct",
                           rows=int(ids.shape[0])):
            tasks = []
            for shard in np.unique(owners):
                m = owners == shard
                sid, sgr = ids[m], grads[m]
                for holder in self.holders_of(int(shard)):
                    if holder == self.rank:
                        applied += self.apply_update(sid, sgr)
                    else:
                        addr = self._addrs.get(holder)
                        if addr is not None:
                            tasks.append((addr, sid, sgr))
            exchange.fanout_map(
                lambda t: exchange.send_update(t[0], t[1], t[2], self.lr),
                tasks)
            metrics.counter("embed.flushes").add(1)
        return applied

    # -- elasticity --------------------------------------------------------
    def build_snapshot(self, extra: Any = None) -> Optional[HostSnapshot]:
        """Host snapshot of every held block (ranged, replica blocks
        included) plus optional replicated ``extra`` state — the payload
        the checkpoint-free resharder redistributes.  Honors
        ``DMLC_RESHARD_MAX_BYTES`` exactly like ``snapshot_tree``: over
        budget ⇒ this rank degrades to a non-holder."""
        budget = env_int("DMLC_RESHARD_MAX_BYTES", 4 << 30, minimum=0)
        snap = HostSnapshot()
        with self._lock:
            blocks = [(s, e, arr.copy()) for (s, e), arr
                      in sorted(self._blocks.items())]
        for s, e, arr in blocks:
            snap.add(self.leaf, arr, start=s, global_rows=self.num_rows)
        if extra is not None:
            for path, arr in flatten_tree(extra).items():
                snap.add(path, np.array(arr, copy=True))
        if snap.nbytes > budget:
            metrics.counter("reshard.snapshot_skipped").add(1)
            log_warning("embed: held blocks exceed snapshot budget "
                        "(%d > %d bytes) — this rank will not serve "
                        "shards this round", snap.nbytes, budget)
            return None
        return snap

    def plan(self, path: str, gshape: Tuple[int, ...]
             ) -> Optional[Tuple[int, int]]:
        """Reshard plan: this rank wants exactly its primary interval of
        the table leaf; anything else (dense towers) stays replicated."""
        if path == self.leaf:
            return self.partition[self.rank]
        return None

    def adopt_restored(self, restored: Optional[Dict[str, np.ndarray]]
                       ) -> None:
        """Install the redistributed primary block.  Replica blocks whose
        interval is still wanted under the (possibly new) layout are KEPT
        — every restore happens right after the collective flush, when
        primaries and replicas are bit-equal, so a surviving replica is
        as good as a refetch; :meth:`rebuild_replicas` refetches only the
        missing ones."""
        if restored is None:
            return
        arr = restored.get(self.leaf)
        s, e = self.partition[self.rank]
        with self._lock:
            wanted = set(self._held_intervals())
            for k in [k for k in self._blocks
                      if k not in wanted or k == (s, e)]:
                del self._blocks[k]
            if arr is not None and s < e:
                check(arr.shape[0] == e - s,
                      f"restored shard rows {arr.shape[0]} != {e - s}")
                self._blocks[(s, e)] = np.ascontiguousarray(
                    arr, dtype=self.dtype)
            self._cache.clear()
            self.version += 1
            self._resident_locked()

    def rebuild_replicas(self) -> int:
        """Refetch replica blocks from the (new) primary holders after a
        reshard.  Point-to-point bulk reads; returns bytes moved.  Call
        after :meth:`sync_addresses` on the new generation."""
        moved = 0
        with teltrace.span("embed.replicate", rank=self.rank,
                           replicas=self.replicas):
            for i in range(1, self.replicas + 1):
                shard = (self.rank - i) % self.world
                s, e = self.partition[shard]
                if s >= e:
                    continue
                with self._lock:
                    have = (s, e) in self._blocks
                if have:
                    continue
                block = self._fetch_from_holders(
                    shard, lambda addr: exchange.fetch_block(addr, s, e))
                with self._lock:
                    self._blocks[(s, e)] = np.ascontiguousarray(
                        block, dtype=self.dtype)
                    self._resident_locked()
                moved += block.nbytes
        return moved

    def state_handle(self, extra_get: Optional[Callable[[], Any]] = None,
                     extra_set: Optional[Callable[[Dict[str, np.ndarray]],
                                                  None]] = None,
                     checkpoint: Any = None) -> StateHandle:
        """The :class:`~..parallel.reshard.StateHandle` that makes this
        table's shards first-class elastic state: register it via
        ``ElasticTorchMesh.register_state`` and every generation bump
        redistributes shards live.  ``extra_get``/``extra_set`` ride
        replicated extra state (a dense tower) along in the same
        snapshot."""

        def _snap() -> Optional[HostSnapshot]:
            return self.build_snapshot(
                extra_get() if extra_get is not None else None)

        def _set(restored) -> None:
            self.adopt_restored(restored)
            if extra_set is not None and restored is not None:
                extra_set(restored)

        return StateHandle(lambda: None, _set, plan=self.plan,
                           snapshot=_snap, checkpoint=checkpoint)

    # -- reference -------------------------------------------------------
    @classmethod
    def reference_rows(cls, num_rows: int, dim: int, seed: int = 0,
                       dtype=np.float32) -> np.ndarray:
        """The full deterministic initial table (tests/single-host
        reference) — bit-equal to the union of any cohort's shards."""
        return _init_rows(num_rows, dim, 0, num_rows, seed,
                          np.dtype(dtype))
