"""Dynamic micro-batcher: aggregate concurrent requests into engine calls.

Counterpart of ``dmlc_core_tpu/serving/batcher.py`` without its
telemetry spans and metrics.  A micro-batch is cut on whichever trigger
fires first:

* **size** — queued true rows/values would fill the largest bucket, or
* **delay** — the oldest queued request has waited ``max_delay_s``.

The queue is bounded: :meth:`MicroBatcher.submit` rejects with
:class:`Overloaded` beyond ``max_queue``.  Requests that expire while
queued fail with :class:`DeadlineExceeded` without taking an engine slot.
``close(drain=True)`` serves everything queued before the worker exits;
``drain=False`` fails it with :class:`Shutdown`.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from ..utils.logging import DMLCError, check
from .engine import InferenceEngine, RequestTooLarge

__all__ = ["MicroBatcher", "Overloaded", "DeadlineExceeded", "Shutdown"]


class Overloaded(DMLCError):
    """Bounded queue full: request rejected at admission."""


class DeadlineExceeded(DMLCError):
    """Request expired before the engine could run it."""


class Shutdown(DMLCError):
    """Batcher is shutting down; request not served."""


class _Pending:
    __slots__ = ("ids", "vals", "row_ptr", "rows", "nnz", "deadline",
                 "t_enq", "future")

    def __init__(self, ids, vals, row_ptr, deadline, t_enq):
        self.ids = ids
        self.vals = vals
        self.row_ptr = row_ptr
        self.rows = len(row_ptr) - 1
        self.nnz = len(ids)
        self.deadline = deadline
        self.t_enq = t_enq
        self.future: Future = Future()


class MicroBatcher:
    """max-batch-size OR max-queue-delay, whichever first.

    ``max_batch_rows``/``max_batch_nnz`` default to the ladder's largest
    bucket, so a cut batch always fits one engine call."""

    def __init__(self, engine: InferenceEngine, *,
                 max_delay_s: float = 0.002,
                 max_batch_rows: int = 0, max_batch_nnz: int = 0,
                 max_queue: int = 256,
                 default_deadline_s: float = 1.0) -> None:
        self.engine = engine
        self.max_delay_s = float(max_delay_s)
        self.max_batch_rows = int(max_batch_rows or engine.ladder.max_rows)
        self.max_batch_nnz = int(max_batch_nnz or engine.ladder.max_nnz)
        check(self.max_batch_rows <= engine.ladder.max_rows
              and self.max_batch_nnz <= engine.ladder.max_nnz,
              "batch budget exceeds the engine's largest bucket")
        self.max_queue = int(max_queue)
        self.default_deadline_s = float(default_deadline_s)
        self._q: List[_Pending] = []
        self._cv = threading.Condition()
        self._closing = False
        self._drain = True
        self.batches = 0
        self._worker = threading.Thread(target=self._run,
                                        name="serving-batcher", daemon=True)
        self._worker.start()

    # -- producer side ---------------------------------------------------
    def submit(self, ids: np.ndarray, vals: np.ndarray,
               row_ptr: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one CSR request; the Future resolves to its float32
        scores or raises Overloaded/DeadlineExceeded/Shutdown.  Oversized
        and malformed requests fail here, before they can join a
        batch."""
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        if row_ptr is None:
            row_ptr = np.array([0, len(ids)], np.int64)
        row_ptr = np.asarray(row_ptr, np.int64)
        rows, nnz = len(row_ptr) - 1, len(ids)
        f: Future = Future()
        if rows < 1 or len(ids) != len(vals) or int(row_ptr[0]) != 0 \
                or int(row_ptr[-1]) != nnz:
            f.set_exception(DMLCError("malformed CSR request"))
            return f
        if rows > self.max_batch_rows or nnz > self.max_batch_nnz:
            f.set_exception(RequestTooLarge(
                f"request ({rows} rows, {nnz} nnz) exceeds the batch "
                f"budget ({self.max_batch_rows} rows, "
                f"{self.max_batch_nnz} nnz)"))
            return f
        now = time.monotonic()
        p = _Pending(ids, vals, row_ptr,
                     now + (self.default_deadline_s if deadline_s is None
                            else deadline_s), now)
        with self._cv:
            if self._closing:
                p.future.set_exception(Shutdown("batcher is shut down"))
                return p.future
            if len(self._q) >= self.max_queue:
                p.future.set_exception(Overloaded(
                    f"queue full ({self.max_queue} requests) — retry with "
                    f"backoff"))
                return p.future
            self._q.append(p)
            self._cv.notify()
        return p.future

    # -- worker side -----------------------------------------------------
    def _cut_batch(self) -> Optional[List[_Pending]]:
        """Block until a batch is due (size/delay/shutdown) and pop it;
        None once closed and empty."""
        with self._cv:
            while True:
                if self._q:
                    if self._closing:
                        break
                    rows = nnz = 0
                    full = False
                    for p in self._q:
                        rows += p.rows
                        nnz += p.nnz
                        if rows >= self.max_batch_rows \
                                or nnz >= self.max_batch_nnz:
                            full = True
                            break
                    due = self._q[0].t_enq + self.max_delay_s
                    now = time.monotonic()
                    if full or now >= due:
                        break
                    self._cv.wait(timeout=due - now)
                elif self._closing:
                    return None
                else:
                    self._cv.wait(timeout=0.1)
            batch: List[_Pending] = []
            rows = nnz = 0
            while self._q:
                p = self._q[0]
                if batch and (rows + p.rows > self.max_batch_rows
                              or nnz + p.nnz > self.max_batch_nnz):
                    break
                batch.append(self._q.pop(0))
                rows += p.rows
                nnz += p.nnz
            return batch

    def _run(self) -> None:
        while True:
            batch = self._cut_batch()
            if batch is None:
                return
            now = time.monotonic()
            live: List[_Pending] = []
            for p in batch:
                if p.deadline < now:
                    p.future.set_exception(DeadlineExceeded(
                        f"request expired after {now - p.t_enq:.3f}s in "
                        f"queue"))
                elif not self._drain and self._closing:
                    p.future.set_exception(Shutdown("batcher shut down"))
                else:
                    live.append(p)
            if not live:
                continue
            ids = np.concatenate([p.ids for p in live])
            vals = np.concatenate([p.vals for p in live])
            ptrs = [np.zeros(1, np.int64)]
            off = 0
            for p in live:
                ptrs.append(p.row_ptr[1:] + off)
                off += p.nnz
            row_ptr = np.concatenate(ptrs)
            try:
                scores = self.engine.predict(ids, vals, row_ptr)
            except Exception as e:  # noqa: BLE001 — fan out, keep serving
                for p in live:
                    if not p.future.done():
                        p.future.set_exception(e)
                continue
            self.batches += 1
            r0 = 0
            for p in live:
                p.future.set_result(scores[r0:r0 + p.rows])
                r0 += p.rows

    # -- lifecycle -------------------------------------------------------
    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admissions; ``drain=True`` serves what is queued first,
        ``drain=False`` fails it."""
        with self._cv:
            self._closing = True
            self._drain = drain
            if not drain:
                for p in self._q:
                    p.future.set_exception(Shutdown("batcher shut down"))
                self._q.clear()
            self._cv.notify_all()
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
