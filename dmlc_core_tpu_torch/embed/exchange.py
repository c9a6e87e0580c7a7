"""Wire layer for the sharded embedding table: shard servers + fan-out client.

The cross-process exchange mirrors the reshard transfer plane
(``parallel/reshard._XferServer``): length-prefixed JSON headers over
plain TCP with raw array payloads, addresses agreed over the rabit
control plane (``ShardedEmbeddingTable.sync_addresses``), and recv
straight into preallocated numpy buffers.  Three ops:

* ``rows``   — gather: int64 global row ids → float32 rows.  Read-only;
  any holder of the owning interval (primary or replica) can answer, so
  a client fails over to replicas when the primary is mid-rebirth.
* ``update`` — direct-mode sparse update: (ids, grads, lr) applied by
  the holder on arrival under its lock.  Used by the throughput path
  (``DMLC_EMBED_FLUSH_EVERY``); the deterministic trainer path instead
  flushes collectively over rabit broadcast rounds (see
  ``ShardedEmbeddingTable.flush``) so every holder applies every rank's
  grads in rank order.
* ``block``  — bulk range read ``[start, stop)``: replica rebuild after
  a reshard, and the bench's resident-bytes audit.

Connections are per-request (dial, one op, close) exactly like the
reshard fetch path — the fan-out pool (``DMLC_EMBED_FANOUT``) hides the
dial latency and keeps the failure model trivial: a dead peer is a
connect error, not a poisoned persistent socket.

Counterpart of ``dmlc_core_tpu/embed/exchange.py``, copied as it is: the
same ``DMEB1`` frames, so a port client reads rows from a JAX
``ShardServer`` and a JAX client from a port one.  The table behind a
server keeps its blocks in host numpy in both packages.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..transport.frames import send_all
from ..utils.logging import DMLCError
from ..utils.metrics import metrics
from ..utils.parameter import env_int

__all__ = ["ShardServer", "fetch_rows", "send_update", "fetch_block",
           "fanout_map"]

_MAGIC = b"DMEB1"


def _timeout_s() -> float:
    return float(env_int("DMLC_RESHARD_TIMEOUT_S", 60, minimum=1))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    while view.nbytes:
        got = sock.recv_into(view)
        if not got:
            raise DMLCError("embed exchange stream truncated")
        view = view[got:]
    return bytes(buf)


def _recv_array(sock: socket.socket, shape: Tuple[int, ...],
                dtype: str) -> np.ndarray:
    out = np.empty(shape, dtype=np.dtype(dtype))
    view = memoryview(out).cast("B")
    while view.nbytes:
        got = sock.recv_into(view)
        if not got:
            raise DMLCError("embed exchange stream truncated")
        view = view[got:]
    return out


def _send_msg(sock: socket.socket, header: Dict,
              payloads: Tuple[np.ndarray, ...] = ()) -> None:
    meta = json.dumps(header).encode()
    send_all(sock, _MAGIC + struct.pack("<I", len(meta)) + meta)
    for arr in payloads:
        send_all(sock, memoryview(np.ascontiguousarray(arr)).cast("B"))


def _recv_msg(sock: socket.socket) -> Dict:
    magic = _recv_exact(sock, len(_MAGIC))
    if magic != _MAGIC:
        raise DMLCError("embed exchange: bad magic")
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n).decode())


class ShardServer:
    """Serves one table's held blocks until closed.  ``store`` is the
    owning :class:`~.table.ShardedEmbeddingTable` — the server calls its
    ``read_rows`` / ``read_block`` / ``apply_update`` methods, which do
    their own locking; the server holds no table state of its own."""

    def __init__(self, store) -> None:
        self._store = store
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", 0))
        self._sock.listen(64)
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="embed-shard", daemon=True)
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
                                 name="embed-shard-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(_timeout_s())
                req = _recv_msg(conn)
                op = req.get("op")
                if op == "rows":
                    n = int(req["n"])
                    ids = _recv_array(conn, (n,), "int64")
                    rows = self._store.read_rows(ids)
                    if rows is None:
                        _send_msg(conn, {"ok": 0, "err": "not held"})
                        return
                    _send_msg(conn, {"ok": 1, "dim": rows.shape[1],
                                     "dtype": str(rows.dtype),
                                     "version": self._store.version},
                              (rows,))
                elif op == "update":
                    n, dim = int(req["n"]), int(req["dim"])
                    ids = _recv_array(conn, (n,), "int64")
                    grads = _recv_array(conn, (n, dim), req["dtype"])
                    applied = self._store.apply_update(
                        ids, grads, lr=float(req["lr"]))
                    _send_msg(conn, {"ok": 1, "applied": applied,
                                     "version": self._store.version})
                elif op == "block":
                    block = self._store.read_block(int(req["start"]),
                                                   int(req["stop"]))
                    if block is None:
                        _send_msg(conn, {"ok": 0, "err": "not held"})
                        return
                    _send_msg(conn, {"ok": 1, "shape": list(block.shape),
                                     "dtype": str(block.dtype),
                                     "version": self._store.version},
                              (block,))
                else:
                    _send_msg(conn, {"ok": 0, "err": f"bad op {op!r}"})
        except (OSError, ValueError, KeyError, DMLCError):
            pass        # a broken client retries against another holder

    def close(self) -> None:
        if self._stop:
            return
        self._stop = True
        try:
            # wake a blocked accept() now instead of waiting out its poll
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


def fetch_rows(addr: Tuple[str, int], ids: np.ndarray) -> np.ndarray:
    """Gather ``table[ids]`` from one holder.  Raises on miss/socket
    failure — the caller owns failover to the next holder."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    timeout = _timeout_s()
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        _send_msg(s, {"op": "rows", "n": int(ids.shape[0])}, (ids,))
        resp = _recv_msg(s)
        if not resp.get("ok"):
            raise DMLCError(f"peer {addr} cannot serve rows: "
                            f"{resp.get('err')}")
        rows = _recv_array(s, (ids.shape[0], int(resp["dim"])),
                           resp["dtype"])
    metrics.counter("embed.exchange_bytes").add(ids.nbytes + rows.nbytes)
    metrics.counter("embed.exchange_rows").add(int(ids.shape[0]))
    return rows


def send_update(addr: Tuple[str, int], ids: np.ndarray, grads: np.ndarray,
                lr: float) -> int:
    """Direct-mode sparse update at one holder; returns rows applied."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    grads = np.ascontiguousarray(grads)
    timeout = _timeout_s()
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        _send_msg(s, {"op": "update", "n": int(ids.shape[0]),
                      "dim": int(grads.shape[1]),
                      "dtype": str(grads.dtype), "lr": float(lr)},
                  (ids, grads))
        resp = _recv_msg(s)
        if not resp.get("ok"):
            raise DMLCError(f"peer {addr} rejected update: "
                            f"{resp.get('err')}")
    metrics.counter("embed.exchange_bytes").add(ids.nbytes + grads.nbytes)
    return int(resp.get("applied", 0))


def fetch_block(addr: Tuple[str, int], start: int, stop: int) -> np.ndarray:
    """Bulk range read ``[start, stop)`` from one holder (replica
    rebuild)."""
    timeout = _timeout_s()
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        _send_msg(s, {"op": "block", "start": int(start),
                      "stop": int(stop)})
        resp = _recv_msg(s)
        if not resp.get("ok"):
            raise DMLCError(f"peer {addr} does not hold "
                            f"[{start}:{stop}): {resp.get('err')}")
        block = _recv_array(s, tuple(resp["shape"]), resp["dtype"])
    metrics.counter("embed.exchange_bytes").add(block.nbytes)
    return block


def fanout_map(fn, tasks: List, fanout: Optional[int] = None) -> List:
    """Run peer requests through a bounded scoped pool
    (``DMLC_EMBED_FANOUT``): the sockets release the GIL, so one lookup
    pulls from several owners concurrently.  Returns results in task
    order; exceptions propagate (the caller decided failover per-task
    inside ``fn``)."""
    if not tasks:
        return []
    pool = (env_int("DMLC_EMBED_FANOUT", 4, minimum=1)
            if fanout is None else max(1, int(fanout)))
    pool = min(pool, len(tasks))
    if pool == 1:
        return [fn(t) for t in tasks]
    with ThreadPoolExecutor(pool) as ex:
        return list(ex.map(fn, tasks))
