"""Dynamic micro-batcher: aggregate concurrent requests into engine calls.

Counterpart of ``dmlc_core_tpu/serving/batcher.py``.  A micro-batch is
cut on whichever trigger fires first:

* **size** — queued true rows/values would fill the largest bucket, or
* **delay** — the oldest queued request has waited ``max_delay_s``.

The queue is bounded: :meth:`MicroBatcher.submit` rejects with
:class:`Overloaded` beyond ``max_queue``.  Requests that expire while
queued fail with :class:`DeadlineExceeded` without taking an engine slot.
``close(drain=True)`` serves everything queued before the worker exits;
``drain=False`` fails it with :class:`Shutdown`.  :meth:`MicroBatcher.
apply_knobs` changes the triggers live.

Metrics, as the JAX batcher's: ``serving.batcher.queue_depth``,
``.occupancy``, ``.overloads``, ``.deadline_drops``, ``.batches``,
``.requests``, ``.batch_nnz``, ``.batch_fill`` and ``serving.latency_s``
(enqueue to answer).  A request carries its trace context (``trace_ctx``,
the submitter's own by default) across to the worker thread, which runs
each engine call under the context of the batch's first traced request,
so the engine's ``serving.engine.forward`` span joins that request's
trace.

A request's Future carries ``wide``, the facts only the batcher knows,
for the server's wide event: ``queue_ms`` (enqueue to answer, or to its
failure), and for an answered request ``batch_rows`` and ``batch_nnz``
of the engine call that served it.  An engine call that raises (other
than :class:`~.engine.RequestTooLarge`) is noted in the port's flight
recorder and dumps an ``engine_failure`` bundle when it is armed; the
worker catches ``Exception`` (the JAX one ``BaseException``), so an
interpreter exit is not swallowed.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from ..telemetry import trace as teltrace
from ..utils.logging import DMLCError, check
from ..utils.metrics import metrics
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
                 "t_enq", "future", "ctx")

    def __init__(self, ids, vals, row_ptr, deadline, t_enq, ctx=None):
        self.ids = ids
        self.vals = vals
        self.row_ptr = row_ptr
        self.rows = len(row_ptr) - 1
        self.nnz = len(ids)
        self.deadline = deadline
        self.t_enq = t_enq
        self.future: Future = Future()
        self.ctx = ctx                 # the request's trace context, or None


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
        self._bind_metrics()
        self._worker = threading.Thread(target=self._run,
                                        name="serving-batcher", daemon=True)
        self._worker.start()

    def _bind_metrics(self) -> None:
        m = metrics
        self._m_gen = m.generation
        self._m_depth = m.gauge("serving.batcher.queue_depth")
        self._m_occ = m.gauge("serving.batcher.occupancy")
        self._m_overload = m.counter("serving.batcher.overloads")
        self._m_expired = m.counter("serving.batcher.deadline_drops")
        self._m_batches = m.counter("serving.batcher.batches")
        self._m_reqs = m.throughput("serving.batcher.requests")
        self._m_latency = m.histogram("serving.latency_s")
        self._m_nnz = m.histogram("serving.batcher.batch_nnz")
        self._m_fill = m.gauge("serving.batcher.batch_fill")

    def _maybe_rebind(self) -> None:
        if self._m_gen != metrics.generation:
            self._bind_metrics()

    # -- producer side ---------------------------------------------------
    def submit(self, ids: np.ndarray, vals: np.ndarray,
               row_ptr: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None,
               trace_ctx: Optional[teltrace.TraceContext] = None) -> Future:
        """Enqueue one CSR request; the Future resolves to its float32
        scores or raises Overloaded/DeadlineExceeded/Shutdown.  Oversized
        and malformed requests fail here, before they can join a
        batch.  ``trace_ctx`` (the ambient context by default) crosses to
        the worker with the request."""
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        if row_ptr is None:
            row_ptr = np.array([0, len(ids)], np.int64)
        row_ptr = np.asarray(row_ptr, np.int64)
        self._maybe_rebind()
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
        if trace_ctx is None:
            trace_ctx = teltrace.current()
        p = _Pending(ids, vals, row_ptr,
                     now + (self.default_deadline_s if deadline_s is None
                            else deadline_s), now, trace_ctx)
        with self._cv:
            if self._closing:
                p.future.set_exception(Shutdown("batcher is shut down"))
                return p.future
            if len(self._q) >= self.max_queue:
                self._m_overload.add(1)
                p.future.set_exception(Overloaded(
                    f"queue full ({self.max_queue} requests) — retry with "
                    f"backoff"))
                return p.future
            self._q.append(p)
            self._m_depth.set(len(self._q))
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
            self._m_depth.set(len(self._q))
            return batch

    def _run(self) -> None:
        while True:
            batch = self._cut_batch()
            if batch is None:
                return
            self._maybe_rebind()
            now = time.monotonic()
            live: List[_Pending] = []
            for p in batch:
                if p.deadline < now:
                    self._m_expired.add(1)
                    p.future.wide = {
                        "queue_ms": round((now - p.t_enq) * 1e3, 3)}
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
            # one engine call serves the batch: it runs under the first
            # traced request's context, so its forward span joins that
            # trace
            ctx = next((p.ctx for p in live if p.ctx is not None), None)
            try:
                with teltrace.activate(ctx):
                    scores = self.engine.predict(ids, vals, row_ptr)
            except Exception as e:  # noqa: BLE001 — fan out, keep serving
                # an engine failure is incident evidence: note it (and
                # dump, when armed) so the batch that died is in the black
                # box.  The port's recorder, by the port's module name
                fl = sys.modules.get("dmlc_core_tpu_torch.telemetry.flight")
                if fl is not None and not isinstance(e, RequestTooLarge):
                    fl.flight_recorder.note(
                        "engine_failure", error=f"{type(e).__name__}: {e}",
                        requests=len(live),
                        rows=int(sum(p.rows for p in live)))
                    fl.dump_incident("engine_failure",
                                     error=f"{type(e).__name__}: {e}")
                fail_t = time.monotonic()
                for p in live:
                    if not p.future.done():
                        p.future.wide = {
                            "queue_ms": round((fail_t - p.t_enq) * 1e3, 3)}
                        p.future.set_exception(e)
                continue
            self.batches += 1
            self._m_batches.add(1)
            batch_rows = sum(p.rows for p in live)
            self._m_occ.set(batch_rows / max(1, self.max_batch_rows))
            self._m_nnz.observe(len(ids))
            self._m_fill.set(len(ids) / max(1, self.max_batch_nnz))
            done_t = time.monotonic()
            r0 = 0
            for p in live:
                # the request's wide event reads these in the server's
                # completion callback
                p.future.wide = {
                    "queue_ms": round((done_t - p.t_enq) * 1e3, 3),
                    "batch_rows": batch_rows,
                    "batch_nnz": len(ids),
                }
                # counted before the answer is out: a client holding its
                # answer finds its request in the metrics
                self._m_latency.observe(done_t - p.t_enq)
                self._m_reqs.add(1)
                p.future.set_result(scores[r0:r0 + p.rows])
                r0 += p.rows

    # -- knobs -------------------------------------------------------------
    def apply_knobs(self, *, max_delay_s: Optional[float] = None,
                    max_batch_rows: Optional[int] = None,
                    max_batch_nnz: Optional[int] = None) -> None:
        """Change the cut triggers live, under the queue lock, bounded as
        the constructor bounds them (a batch budget never exceeds the
        engine's largest bucket); the worker reads them at its next
        cut."""
        with self._cv:
            if max_delay_s is not None:
                check(max_delay_s >= 0, "max_delay_s must be >= 0")
                self.max_delay_s = float(max_delay_s)
            if max_batch_rows is not None:
                check(1 <= max_batch_rows <= self.engine.ladder.max_rows,
                      "max_batch_rows outside [1, ladder max]")
                self.max_batch_rows = int(max_batch_rows)
            if max_batch_nnz is not None:
                check(1 <= max_batch_nnz <= self.engine.ladder.max_nnz,
                      "max_batch_nnz outside [1, ladder max]")
                self.max_batch_nnz = int(max_batch_nnz)
            self._cv.notify_all()

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
                self._m_depth.set(0)
            self._cv.notify_all()
        self._worker.join(timeout=timeout)

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
