"""Durable state of the control plane: an fsync'd write-ahead journal,
atomic snapshots and fenced leases.

Counterpart of ``dmlc_core_tpu/utils/durable.py``, copied whole: the
port's :class:`~dmlc_core_tpu_torch.parallel.tracker.RabitTracker`
journals its rank assignments, worker addresses and link generation
through :class:`StateJournal`, and the files are the JAX package's byte
for byte, so either package replays a journal the other wrote.

* ``<prefix>.log``: append-only JSON lines (``json.dumps(...,
  sort_keys=True, default=str)``), each fsync'd *before* the caller's
  in-memory mutation proceeds (write-ahead ordering).  A torn tail (a
  crash inside a write) is tolerated: replay stops at the first line
  that does not decode.
* ``<prefix>.snap``: the whole state as one JSON document under a
  ``schema`` key, written as ``.tmp.<pid>`` + fsync + ``os.replace``, so
  a crash mid-snapshot leaves the previous snapshot intact; a snapshot
  of another schema is discarded on :meth:`StateJournal.load`.
* ``<prefix>.lease``: a fencing lease (:class:`FencedLease`): the
  primary refreshes ``{"owner", "control_epoch", "ts"}`` atomically; a
  standby takes over once it is stale and bumps ``control_epoch``, and a
  primary that finds a higher epoch on disk has been fenced.

Records carry resulting values rather than deltas, so replay is
idempotent: a crash between the snapshot's replace and the log's
truncation re-applies records the snapshot already holds and lands on
the same state.  :class:`StateJournal` is thread-safe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["StateJournal", "FencedLease", "LEASE_SCHEMA"]


class StateJournal:
    """Append-only journal + snapshot pair under one path prefix.

    ``snap_schema`` names the snapshot document schema; a snapshot whose
    schema does not match is discarded on :meth:`load` (the log alone
    rebuilds state from genesis).  ``on_append`` / ``on_snapshot`` are
    optional callbacks (typically ``metrics.counter(...).add``) fired
    after each durable append / compaction so each owner keeps its own
    literal metric names.
    """

    def __init__(self, prefix: str, *, snap_schema: str,
                 on_append: Optional[Callable[[int], Any]] = None,
                 on_snapshot: Optional[Callable[[int], Any]] = None):
        self.prefix = str(prefix)
        self.log_path = self.prefix + ".log"
        self.snap_path = self.prefix + ".snap"
        self.snap_schema = str(snap_schema)
        self._on_append = on_append
        self._on_snapshot = on_snapshot
        d = os.path.dirname(os.path.abspath(self.log_path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.log_path, "ab")
        self.appends_since_snapshot = 0

    # -- write side ------------------------------------------------------
    def append(self, record: Dict[str, Any]) -> None:
        """One fsync'd JSON line; durable before the caller's in-memory
        mutation proceeds (write-ahead ordering)."""
        line = json.dumps(record, sort_keys=True, default=str) + "\n"
        with self._lock:
            self._f.write(line.encode("utf-8"))
            self._f.flush()
            os.fsync(self._f.fileno())
            self.appends_since_snapshot += 1
        if self._on_append is not None:
            self._on_append(1)

    def compact(self, state: Dict[str, Any]) -> None:
        """Atomic-rename snapshot of ``state``, then truncate the log.
        Crash windows: before the replace → old snapshot + full log
        (nothing lost); between replace and truncation → new snapshot +
        old log, whose records re-apply idempotently."""
        doc = {"schema": self.snap_schema, **state}
        tmp = f"{self.snap_path}.tmp.{os.getpid()}"
        with self._lock:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, sort_keys=True, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            self._f.close()
            self._f = open(self.log_path, "wb")
            os.fsync(self._f.fileno())
            self.appends_since_snapshot = 0
        if self._on_snapshot is not None:
            self._on_snapshot(1)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    # -- read side -------------------------------------------------------
    def load(self) -> Tuple[Optional[Dict[str, Any]],
                            List[Dict[str, Any]]]:
        """``(snapshot|None, records)`` as found on disk.  A snapshot
        that fails to parse is discarded (the log alone rebuilds state
        from genesis); replay of the log stops at the first torn line."""
        snap: Optional[Dict[str, Any]] = None
        try:
            with open(self.snap_path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema") == self.snap_schema:
                snap = doc
        except (OSError, ValueError):
            snap = None
        records: List[Dict[str, Any]] = []
        try:
            with open(self.log_path, encoding="utf-8") as f:
                for line in f:
                    if not line.endswith("\n"):
                        break               # torn tail: crash mid-append
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break
                    if isinstance(rec, dict):
                        records.append(rec)
        except OSError:
            pass
        return snap, records


LEASE_SCHEMA = "dmlc.control.lease/1"


class FencedLease:
    """Atomic fencing lease beside a :class:`StateJournal`.

    The primary stamps ``{"owner", "control_epoch", "ts"}`` into
    ``<prefix>.lease`` with the same ``.tmp.<pid>`` + ``os.replace``
    idiom the snapshot uses; a standby polls :meth:`read` and considers
    the lease expired once ``ts`` is older than ``ttl_s``.  Epochs are
    monotonic: a takeover writes ``control_epoch + 1``, and any primary
    that later wakes up sees a higher epoch than its own on its next
    :meth:`refresh` and must stop serving writes (it has been fenced).
    Wall-clock ``ts`` is fine here — primary and standby share a journal
    prefix, hence a filesystem, hence (in this tree) a clock.
    """

    def __init__(self, path: str, *, ttl_s: float):
        self.path = str(path)
        self.ttl_s = float(ttl_s)

    def read(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or doc.get("schema") != LEASE_SCHEMA:
            return None
        return doc

    def refresh(self, owner: str, control_epoch: int) -> bool:
        """Re-stamp the lease.  Returns ``False`` (without writing) when
        the on-disk lease already carries a *higher* epoch — the caller
        has been fenced by a standby takeover and must stand down."""
        cur = self.read()
        if cur is not None and int(cur.get("control_epoch", 0)) > int(control_epoch):
            return False
        doc = {"schema": LEASE_SCHEMA, "owner": str(owner),
               "control_epoch": int(control_epoch), "ts": time.time()}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return True

    def expired(self, now: Optional[float] = None) -> bool:
        doc = self.read()
        if doc is None:
            return True
        return (now if now is not None else time.time()) - float(doc.get("ts", 0.0)) > self.ttl_s

    def current_epoch(self) -> int:
        doc = self.read()
        return int(doc.get("control_epoch", 0)) if doc else 0
