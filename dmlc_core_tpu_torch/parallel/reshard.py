"""Checkpoint-free elastic resharding: live state redistribution on a
generation bump (PAPERS.md arxiv 2112.01075 portable collective
redistribution, arxiv 2403.07128 DrJAX mapreduce framing).

Counterpart of ``dmlc_core_tpu/parallel/reshard.py``, with the same
wire (``DMRS1``), the same round plan (:mod:`..transport.plan`), the
same manifests over rabit, fault point, metrics and span, so that a rank
of either package serves a rank of the other.  Surviving a worker death
would otherwise mean every process reloads model and optimizer state
from the last checkpoint, although the survivors hold a complete copy of
the state between them.  The resharder turns a generation bump into a
data movement problem instead:

1. **snapshot** — before :meth:`~.elastic.ElasticTorchMesh.ensure`
   tears the data plane down, each survivor copies its live state to
   host memory (:func:`snapshot_tree`: card tensors, CPU tensors and
   numpy leaves; bounded by ``DMLC_RESHARD_MAX_BYTES``).  The snapshot,
   the wire and the restored tree are numpy, as in the JAX package.
2. **agree** — after the mesh rebuilds at the new generation, the cohort
   agrees on a shard-ownership map over the rabit control plane: every
   rank broadcasts its leaf schema, held row ranges, and a transfer
   address (world broadcast rounds — uniform collective order on every
   rank, so the rabit seq frames stay aligned).
3. **redistribute** — each rank assembles its target shard of every leaf
   from (a) its own host pieces, (b) point-to-point TCP fetches from
   peers that hold the missing row ranges (owners spread round-robin so
   one survivor does not serve the whole reborn rank alone), and only
   then (c) leaf-granular checkpoint reads
   (:meth:`~..utils.checkpoint.CheckpointManager.restore_leaves`, which
   reads a checkpoint of either package) for shards NO survivor holds.
4. **verify** — a final allreduce agrees the cohort-wide count of
   unrecoverable ranges; any gap anywhere raises on EVERY rank (a
   half-restored cohort must not train), with a flight-recorder incident
   bundle capturing the failed recovery.

Shard model: leaves are blocks of CONTIGUOUS rows of axis 0 — replicated
leaves are one whole block, row-sharded tables carry ``(start, stop)``
ranges against the global shape (the reference's ``ResetPartition``
contract; ``mesh.row_partition`` computes the target ranges when the
cohort shrinks or grows).  0-d leaves are treated as one row.

Telemetry: ``elastic.reshard_wall_s`` gauge, ``reshard.bytes_moved`` /
``reshard.leaves_from_peers`` / ``reshard.leaves_from_checkpoint``
counters, and a ``reshard`` span with per-phase events so the flight
recorder captures failed recoveries.  ``fault_point("reshard.fetch")``
arms the chaos harness on every peer fetch.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import flight as telflight
from ..telemetry import trace as teltrace
from ..transport import plan as transport_plan
from ..transport.frames import send_all as _send_all
from ..utils.logging import DMLCError, log_info, log_warning
from ..utils.checkpoint import (CheckpointManager, flatten_tree,
                                unflatten_like)
from ..utils.faults import fault_point
from ..utils.metrics import metrics
from ..utils.parameter import env_int, get_env

__all__ = ["StateHandle", "ReshardStats", "HostSnapshot", "snapshot_tree",
           "redistribute"]

_MAGIC = b"DMRS1"
#: rank sentinel for "nobody holds state" in the holder-agreement round
_NOBODY = 1 << 30
#: default host-snapshot budget: 4 GiB (DMLC_RESHARD_MAX_BYTES overrides)
_DEFAULT_BUDGET = 4 << 30


def _rows(shape: Tuple[int, ...]) -> int:
    return int(shape[0]) if shape else 1


def _timeout_s() -> float:
    return float(env_int("DMLC_RESHARD_TIMEOUT_S", 60, minimum=1))


def _apply_sock_buf(sock: socket.socket) -> None:
    """Honor ``DMLC_SOCK_BUF_KB`` (lenient env_int, 0 = kernel default):
    both directions sized, on the transfer server's listener (accepted
    sockets inherit) and on every fetch dial — reshard moves tens of MB
    per connection, where default buffers leave WAN bandwidth idle."""
    kb = env_int("DMLC_SOCK_BUF_KB", 0, minimum=0)
    if kb <= 0:
        return
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, kb * 1024)
        except OSError:
            pass    # the kernel clamps or refuses; either is fine


# ---------------------------------------------------------------------------
# host snapshot
# ---------------------------------------------------------------------------

class HostSnapshot:
    """Host-side copies of the shards this rank holds.

    ``pieces[path]`` is a list of ``(start, stop, array)`` blocks covering
    row ranges ``[start, stop)`` of axis 0 of the GLOBAL leaf;
    ``schema[path]`` is ``(global_shape, dtype_str)``.  A replicated leaf
    is one whole block; 0-d leaves are stored as shape ``(1,)`` blocks
    with a ``()`` global shape so slicing stays uniform."""

    def __init__(self) -> None:
        self.pieces: Dict[str, List[Tuple[int, int, np.ndarray]]] = {}
        self.schema: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        self.nbytes = 0

    def add(self, path: str, arr: np.ndarray, *, start: int = 0,
            global_rows: Optional[int] = None) -> None:
        """Record a held block: rows ``[start, start+len)`` of a leaf whose
        global leading dim is ``global_rows`` (default: this block ends
        the leaf — i.e. a whole replicated leaf when ``start`` is 0)."""
        # check ndim BEFORE ascontiguousarray: its contract is "at least
        # 1-d", which would silently turn a 0-d leaf into shape (1,)
        if arr.ndim == 0:
            gshape: Tuple[int, ...] = ()
            arr = np.ascontiguousarray(arr).reshape((1,))
            start, stop = 0, 1
        else:
            arr = np.ascontiguousarray(arr)
            stop = start + arr.shape[0]
            grows = stop if global_rows is None else int(global_rows)
            gshape = (grows,) + tuple(arr.shape[1:])
        prev = self.schema.get(path)
        if prev is not None and prev != (gshape, str(arr.dtype)):
            raise DMLCError(f"snapshot schema conflict for {path!r}: "
                            f"{prev} vs {(gshape, str(arr.dtype))}")
        self.schema[path] = (gshape, str(arr.dtype))
        self.pieces.setdefault(path, []).append((int(start), int(stop), arr))
        self.nbytes += arr.nbytes


def snapshot_tree(tree: Any, *, max_bytes: Optional[int] = None
                  ) -> Optional[HostSnapshot]:
    """Copy a live tree's array leaves (card tensors, CPU tensors, numpy
    arrays) to host numpy as whole (replicated) blocks.  Copies are
    taken eagerly so an in-place step or a data-plane teardown cannot
    invalidate them.  Returns None — "this rank holds nothing" — when
    the state exceeds the ``DMLC_RESHARD_MAX_BYTES`` budget, demoting
    recovery to the checkpoint path instead of OOMing the host
    mid-teardown."""
    budget = (env_int("DMLC_RESHARD_MAX_BYTES", _DEFAULT_BUDGET, minimum=0)
              if max_bytes is None else int(max_bytes))
    snap = HostSnapshot()
    for path, arr in flatten_tree(tree).items():
        snap.add(path, np.array(arr, copy=True))
        if snap.nbytes > budget:
            metrics.counter("reshard.snapshot_skipped").add(1)
            log_warning("reshard: state exceeds snapshot budget "
                        "(%d > %d bytes) — this rank will not serve "
                        "shards; recovery falls back to checkpoint",
                        snap.nbytes, budget)
            return None
    return snap


# ---------------------------------------------------------------------------
# state handle (what ElasticTorchMesh snapshots and restores)
# ---------------------------------------------------------------------------

class StateHandle:
    """Live-state registration for :class:`~.elastic.ElasticTorchMesh`.

    ``get_state()`` returns the pytree to preserve across a rebuild (or
    None when this rank currently holds nothing — e.g. a reborn process);
    ``set_state(state)`` — optional — receives the restored tree after the
    rebuild (callers may instead read ``resync()``'s ``.state``).

    ``template`` (pytree or zero-arg callable) supplies the container
    structure for the restored tree; without it the restore is the flat
    ``{path: array}`` mapping.  ``plan(path, global_shape) -> (start,
    stop) | None`` maps each leaf to this rank's target row range (None =
    whole leaf, the replicated default).  ``checkpoint`` (manager or
    directory) is the last-resort source for shards no survivor holds.

    ``snapshot`` — optional zero-arg callable returning a ready
    :class:`HostSnapshot` (or None for "holds nothing") — replaces the
    default ``snapshot_tree(get_state())`` path.  It exists for state
    that is *already row-sharded in host memory* (the sharded embedding
    table): such owners record ranged blocks via ``HostSnapshot.add(...,
    start=, global_rows=)`` — including replica blocks of peers' shards —
    which the whole-leaf ``snapshot_tree`` copy cannot express.

    COLLECTIVE CONTRACT: register the handle at the same point relative
    to control-plane collectives on every rank — the redistribute rounds
    run inside ``ensure()`` and must execute uniformly cohort-wide.
    """

    def __init__(self, get_state: Callable[[], Any],
                 set_state: Optional[Callable[[Any], None]] = None, *,
                 template: Any = None,
                 plan: Optional[Callable[[str, Tuple[int, ...]],
                                         Optional[Tuple[int, int]]]] = None,
                 checkpoint: Any = None,
                 checkpoint_step: Optional[int] = None,
                 snapshot: Optional[Callable[[], Optional["HostSnapshot"]]]
                 = None) -> None:
        self.get_state = get_state
        self.set_state = set_state
        self.template = template
        self.plan = plan
        self.checkpoint = checkpoint
        self.checkpoint_step = checkpoint_step
        self.snapshot = snapshot

    def resolve_template(self) -> Any:
        t = self.template
        return t() if callable(t) else t

    def resolve_checkpoint(self) -> Optional[CheckpointManager]:
        c = self.checkpoint
        if c is None:
            return None
        return c if isinstance(c, CheckpointManager) else CheckpointManager(
            str(c))


class ReshardStats:
    """Outcome of one redistribute round (attached to ``resync()``)."""

    __slots__ = ("wall_s", "bytes_moved", "leaves_from_peers",
                 "leaves_local", "leaves_from_checkpoint", "world")

    def __init__(self) -> None:
        self.wall_s = 0.0
        self.bytes_moved = 0
        self.leaves_from_peers = 0
        self.leaves_local = 0
        self.leaves_from_checkpoint = 0
        self.world = 0

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={getattr(self, k)}" for k in self.__slots__)
        return f"ReshardStats({body})"


# ---------------------------------------------------------------------------
# wire helpers (point-to-point shard transfer)
# ---------------------------------------------------------------------------

def _recv_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket — recv_into straight into the target
    buffer (an assembled leaf's own memory on the fetch path), no
    intermediate bytes objects."""
    while view.nbytes:
        got = sock.recv_into(view)
        if not got:
            raise DMLCError("reshard transfer stream truncated")
        view = view[got:]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def _my_host(ctx) -> str:
    """The address peers can dial for shard fetches: explicit override,
    else the interface that routes to the tracker (the UDP-connect trick
    — nothing is sent), else loopback."""
    override = get_env("DMLC_RESHARD_HOST", "").strip()
    if override:
        return override
    try:
        tracker = getattr(ctx, "tracker_addr", None)
        if tracker:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((tracker[0], int(tracker[1])))
                return s.getsockname()[0]
            finally:
                s.close()
    except OSError:
        pass
    return "127.0.0.1"


class _XferServer:
    """One-generation shard server: answers ``(path, start, stop)``
    requests from the local :class:`HostSnapshot` until closed.  Requests
    are sliced from a single held block (the fetch planner never splits a
    request across blocks), so a miss means the peer's ownership map was
    stale — answered with a miss byte, not a hang."""

    def __init__(self, snap: HostSnapshot) -> None:
        self._snap = snap
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        _apply_sock_buf(self._sock)
        self._sock.bind(("", 0))
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="reshard-xfer", daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_one, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(_timeout_s())
                magic = _recv_exact(conn, len(_MAGIC))
                if magic != _MAGIC:
                    return
                (nreq,) = struct.unpack("<I", _recv_exact(conn, 4))
                req = json.loads(_recv_exact(conn, nreq).decode())
                path = req["path"]
                start, stop = int(req["start"]), int(req["stop"])
                block = None
                for (s, e, arr) in self._snap.pieces.get(path, ()):
                    if s <= start and stop <= e:
                        block = arr[start - s:stop - s]
                        break
                if block is None:
                    _send_all(conn, b"\x00")
                    return
                block = np.ascontiguousarray(block)
                meta = json.dumps({"dtype": str(block.dtype),
                                   "shape": list(block.shape)}).encode()
                _send_all(conn, b"\x01" + struct.pack("<I", len(meta))
                          + meta + struct.pack("<Q", block.nbytes))
                # send straight from the snapshot block's buffer — a
                # .tobytes() here would copy each served shard once more
                _send_all(conn, memoryview(block).cast("B"))
        except (OSError, ValueError, KeyError, DMLCError):
            pass        # a broken fetcher retries against another holder

    def close(self) -> None:
        if self._stop:
            return
        self._stop = True
        try:
            # wake a blocked accept() NOW instead of waiting out its 0.2s
            # poll — close() sits on every rank's redistribute exit path
            with socket.create_connection(("127.0.0.1", self.port),
                                          timeout=0.5):
                pass
        except OSError:
            pass
        self._accept.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)


def _fetch(addr: Tuple[str, int], path: str, start: int, stop: int
           ) -> np.ndarray:
    """Dial a peer's transfer server for rows [start, stop) of a leaf."""
    fault_point("reshard.fetch")
    timeout = _timeout_s()
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        _apply_sock_buf(s)
        req = json.dumps({"path": path, "start": start,
                          "stop": stop}).encode()
        _send_all(s, _MAGIC + struct.pack("<I", len(req)) + req)
        status = _recv_exact(s, 1)
        if status != b"\x01":
            raise DMLCError(f"peer {addr} does not hold {path!r} "
                            f"[{start}:{stop})")
        (nmeta,) = struct.unpack("<I", _recv_exact(s, 4))
        meta = json.loads(_recv_exact(s, nmeta).decode())
        (nbytes,) = struct.unpack("<Q", _recv_exact(s, 8))
        out = np.empty(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]))
        if out.nbytes != nbytes:
            raise DMLCError(f"reshard fetch size mismatch for {path!r}: "
                            f"peer sends {nbytes} bytes, shape/dtype say "
                            f"{out.nbytes}")
        if nbytes:
            # recv_into the destination array itself — no intermediate
            # bytes object, no frombuffer+copy
            _recv_into(s, memoryview(out).cast("B"))
    return out


# ---------------------------------------------------------------------------
# the redistribute protocol
# ---------------------------------------------------------------------------

def _merge_infos(infos: List[Optional[Dict[str, Any]]]):
    """Union the per-rank manifests into (schema, holders, addrs).  A
    schema conflict is a divergence bug — every rank sees the same infos,
    so the raise is uniform cohort-wide."""
    schema: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    holders: Dict[str, List[Tuple[int, int, int]]] = {}
    addrs: Dict[int, Tuple[str, int]] = {}
    for r, info in enumerate(infos):
        if not info:
            continue
        if info.get("addr"):
            addrs[r] = (info["addr"][0], int(info["addr"][1]))
        for path, (gshape, dt) in info["schema"].items():
            entry = (tuple(int(d) for d in gshape), dt)
            if path in schema and schema[path] != entry:
                raise DMLCError(
                    f"reshard: schema conflict for {path!r}: "
                    f"{schema[path]} vs {entry} (rank {r})")
            schema[path] = entry
        for path, ranges in info["holds"].items():
            for s, e in ranges:
                holders.setdefault(path, []).append((r, int(s), int(e)))
    return schema, holders, addrs


def _plan_leaf(target: Tuple[int, int],
               local: List[Tuple[int, int, np.ndarray]],
               remote: List[Tuple[int, int, int]], spread: int):
    """Cover [target) rows from local blocks first, then remote holders,
    and report any gap.  Returns (segments, fetches, gaps) where segments
    is ``[(start, array-or-None placeholder index)]`` ordered by start:
    local slices materialize now, fetches later.  Remote choice among
    equally-covering holders rotates with ``spread`` so one survivor does
    not serve every leaf of a reborn rank."""
    segments: List[Tuple[int, Optional[np.ndarray]]] = []
    fetches: List[Tuple[int, int, int, List[int]]] = []  # start,stop,rank,alts
    gaps: List[Tuple[int, int]] = []
    pos, stop = target
    n = 0
    while pos < stop:
        best_local = None
        for (s, e, arr) in local:
            if s <= pos < e and (best_local is None or e > best_local[1]):
                best_local = (s, e, arr)
        if best_local is not None:
            s, e, arr = best_local
            upto = min(e, stop)
            segments.append((pos, arr[pos - s:upto - s]))
            pos = upto
            continue
        covering = [(r, s, e) for (r, s, e) in remote if s <= pos < e]
        if covering:
            far = max(e for (_, _, e) in covering)
            ties = sorted(r for (r, _, e) in covering if e == far)
            owner = ties[(spread + n) % len(ties)]
            alts = [r for r in ties if r != owner] + sorted(
                r for (r, _, e) in covering if e != far)
            upto = min(far, stop)
            fetches.append((pos, upto, owner, alts))
            segments.append((pos, None))
            pos = upto
            n += 1
            continue
        # uncovered: skip forward to the next held row (or give up)
        nxt = stop
        for (s, e, _) in local:
            if s > pos:
                nxt = min(nxt, s)
        for (_, s, e) in remote:
            if s > pos:
                nxt = min(nxt, s)
        gaps.append((pos, nxt))
        segments.append((pos, None))
        pos = nxt
    return segments, fetches, gaps


def redistribute(ctx, snap: Optional[HostSnapshot], *,
                 plan: Optional[Callable[[str, Tuple[int, ...]],
                                         Optional[Tuple[int, int]]]] = None,
                 checkpoint: Optional[CheckpointManager] = None,
                 checkpoint_step: Optional[int] = None,
                 template: Any = None,
                 generation: int = -1,
                 ) -> Tuple[Optional[Any], ReshardStats]:
    """Redistribute live state across the cohort (COLLECTIVE — every rank
    calls with the same collective order; ``plan``/``snap`` may differ).

    ``snap`` is this rank's host snapshot (None = holds nothing, e.g. a
    reborn process).  ``plan`` maps leaf path + global shape to this
    rank's target row range (None = replicated whole; ``(x, x)`` = wants
    nothing, the departing-rank case on shrink).  Returns ``(state,
    stats)`` — state is ``unflatten_like(template, ...)`` when a template
    is given, else the flat ``{path: array}`` mapping, or None when the
    cohort holds no state at all and no checkpoint is configured.

    Decision tree per leaf range: local host blocks → peer fetch (spread
    round-robin over holders) → leaf-granular checkpoint read → a
    cohort-wide DMLCError (agreed by allreduce, so no rank trains on a
    half-restored state)."""
    t0 = time.monotonic()
    stats = ReshardStats()
    stats.world = ctx.world_size
    rank = ctx.rank
    has = snap is not None and bool(snap.schema)
    server: Optional[_XferServer] = None
    try:
        with teltrace.span("reshard", generation=generation, rank=rank,
                           world=ctx.world_size, holder=has):
            if has:
                server = _XferServer(snap)
            my_info: Dict[str, Any] = {
                "schema": {p: [list(g), d]
                           for p, (g, d) in snap.schema.items()} if has else {},
                "holds": {p: [[s, e] for (s, e, _) in blocks]
                          for p, blocks in snap.pieces.items()} if has else {},
                "addr": [_my_host(ctx), server.port] if server else None,
            }
            # ownership map: world broadcast rounds (uniform collective
            # order; O(world) tiny messages — cohorts here are hosts, not
            # chips)
            infos = [ctx.broadcast(my_info if r == rank else None, root=r)
                     for r in range(ctx.world_size)]
            schema, holders, addrs = _merge_infos(infos)
            teltrace.add_event("reshard.agreed", leaves=len(schema),
                               holders=len(addrs))

            # my targets
            targets: Dict[str, Tuple[int, int]] = {}
            for path, (gshape, _) in schema.items():
                rows = _rows(gshape)
                tgt = (0, rows) if plan is None else plan(path, gshape)
                if tgt is None:
                    tgt = (0, rows)
                tgt = (max(0, int(tgt[0])), min(rows, int(tgt[1])))
                if tgt[0] < tgt[1]:
                    targets[path] = tgt

            # plan every leaf first, then run ALL peer fetches through one
            # small thread pool: recv_into releases the GIL, so a reborn
            # rank pulls from several survivors concurrently instead of
            # draining leaves one socket at a time
            planned = []          # (path, parts, gaps, fetched_any-box)
            tasks = []            # (planned-index, start, stop, owner, alts)
            for li, path in enumerate(sorted(targets)):
                local = snap.pieces.get(path, []) if has else []
                remote = [h for h in holders.get(path, [])
                          if h[0] != rank and h[0] in addrs]
                segments, fetches, gaps = _plan_leaf(
                    targets[path], local, remote, spread=li + rank)
                parts: Dict[int, np.ndarray] = {
                    s: a for (s, a) in segments if a is not None}
                planned.append([path, parts, gaps, False])
                for (s, e, owner, alts) in fetches:
                    tasks.append((len(planned) - 1, s, e, owner, alts))

            def run_fetch(task):
                idx, s, e, owner, alts = task
                path = planned[idx][0]
                for candidate in [owner] + alts:
                    try:
                        return idx, s, e, _fetch(addrs[candidate], path, s, e)
                    except (OSError, DMLCError) as err:
                        log_warning("reshard: fetch %s[%d:%d) from rank %d "
                                    "failed (%s) — trying next holder",
                                    path, s, e, candidate, err)
                return idx, s, e, None

            if tasks:
                # planned collective schedule (arxiv 2112.01075): group
                # the fetches into holder-balanced rounds whose in-flight
                # bytes stay under DMLC_RESHARD_MAX_BYTES — a reborn rank
                # no longer pulls the whole state at once, and no single
                # survivor serves every fetcher in the same instant.
                # Deterministic planning; execution order cannot change
                # the assembled result (results key on (idx, start)).
                def _row_bytes(path: str) -> int:
                    gshape, dt = schema[path]
                    per = int(np.dtype(dt).itemsize)
                    for d in gshape[1:]:
                        per *= int(d)
                    return per

                budget = env_int("DMLC_RESHARD_MAX_BYTES",
                                 _DEFAULT_BUDGET, minimum=0)
                transfers = [
                    transport_plan.Transfer(
                        planned[idx][0], s, e, owner, alts,
                        nbytes=max(1, e - s) * _row_bytes(planned[idx][0]),
                        tag=task)
                    for task in tasks
                    for (idx, s, e, owner, alts) in (task,)]
                rounds = transport_plan.plan_rounds(
                    transfers, max_bytes=budget if budget > 0 else None,
                    per_holder=env_int("DMLC_RESHARD_PER_HOLDER", 2,
                                       minimum=0))
                metrics.gauge("reshard.rounds").set(float(len(rounds)))
                pool = min(len(tasks),
                           env_int("DMLC_RESHARD_FETCH_THREADS", 8,
                                   minimum=1))
                results = []
                if pool == 1:
                    for rno, rnd in enumerate(rounds):
                        teltrace.add_event(
                            "reshard.round", round=rno, fetches=len(rnd),
                            bytes=sum(t.nbytes for t in rnd))
                        results.extend(run_fetch(t.tag) for t in rnd)
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(pool) as ex:
                        for rno, rnd in enumerate(rounds):
                            teltrace.add_event(
                                "reshard.round", round=rno,
                                fetches=len(rnd),
                                bytes=sum(t.nbytes for t in rnd))
                            results.extend(
                                ex.map(run_fetch, [t.tag for t in rnd]))
                for idx, s, e, got in results:
                    if got is None:
                        planned[idx][2].append((s, e))
                    else:
                        planned[idx][1][s] = got
                        planned[idx][3] = True
                        stats.bytes_moved += got.nbytes

            assembled: Dict[str, np.ndarray] = {}
            from_ckpt: List[str] = []
            failed: List[str] = []
            for path, parts, gaps, fetched_any in planned:
                gshape, dt = schema[path]
                if gaps and checkpoint is not None:
                    try:
                        _, loaded = checkpoint.restore_leaves(
                            [path], step=checkpoint_step)
                    except DMLCError as err:
                        log_warning("reshard: checkpoint fallback for %s "
                                    "failed (%s)", path, err)
                        loaded = {}
                    if path in loaded:
                        whole = loaded[path]
                        if whole.ndim == 0:
                            whole = whole.reshape((1,))
                        for (s, e) in gaps:
                            parts[s] = whole[s:e]
                        gaps = []
                        from_ckpt.append(path)
                if gaps:
                    failed.append(path)
                    continue
                t0r, t1r = targets[path]
                ordered = [parts[s] for s in sorted(parts)]
                out = (ordered[0] if len(ordered) == 1
                       else np.concatenate(ordered, axis=0))
                if gshape == ():
                    out = out.reshape(())
                expect = ((t1r - t0r,) + tuple(gshape[1:])
                          if gshape else ())
                if tuple(out.shape) != tuple(expect):
                    raise DMLCError(
                        f"reshard: assembled {path!r} has shape "
                        f"{out.shape}, want {expect}")
                out = out.astype(np.dtype(dt), copy=False)
                if out.ndim and not out.flags["C_CONTIGUOUS"]:
                    out = np.ascontiguousarray(out)   # 0-d would gain a dim
                assembled[path] = out
                if path in from_ckpt:
                    stats.leaves_from_checkpoint += 1
                elif fetched_any:
                    stats.leaves_from_peers += 1
                else:
                    stats.leaves_local += 1
            teltrace.add_event(
                "reshard.assembled", from_peers=stats.leaves_from_peers,
                local=stats.leaves_local,
                from_checkpoint=stats.leaves_from_checkpoint,
                bytes_moved=stats.bytes_moved, failed=len(failed))

            # outcome agreement — doubles as the fetch-completion barrier:
            # after it, no peer will dial our server again
            total_failed = int(ctx.allreduce(
                np.array([len(failed)], np.int64), "sum")[0])
            if total_failed:
                metrics.counter("reshard.failures").add(1)
                telflight.dump_incident(
                    "reshard_failed", rank=rank, generation=generation,
                    failed_here=failed[:16], cohort_failed=total_failed)
                raise DMLCError(
                    f"reshard: {total_failed} leaf range(s) unrecoverable "
                    f"cohort-wide (no surviving holder and no checkpoint) "
                    f"— local: {failed[:8]}")
    finally:
        if server is not None:
            server.close()

    stats.wall_s = time.monotonic() - t0
    metrics.gauge("elastic.reshard_wall_s").set(stats.wall_s)
    metrics.counter("reshard.bytes_moved").add(stats.bytes_moved)
    metrics.counter("reshard.leaves_from_peers").add(stats.leaves_from_peers)
    metrics.counter("reshard.leaves_from_checkpoint").add(
        stats.leaves_from_checkpoint)
    if not assembled:
        return None, stats
    log_info("reshard: gen %d restored %d leaves (%d local, %d from peers, "
             "%d from checkpoint, %d bytes moved) in %.3fs", generation,
             len(assembled), stats.leaves_local, stats.leaves_from_peers,
             stats.leaves_from_checkpoint, stats.bytes_moved, stats.wall_s)
    if template is not None:
        return unflatten_like(template, assembled), stats
    return assembled, stats
