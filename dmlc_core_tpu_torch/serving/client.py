"""Prediction client and load generator for the serving wire.

Counterpart of ``dmlc_core_tpu/serving/client.py``, on the same wire as
:mod:`.server` (and the JAX server).  :class:`PredictClient` holds one
TCP connection; a reader thread hands each response, by ``req_id``, to
its request's future, so the client serves both the blocking
:meth:`~PredictClient.predict` and pipelined
:meth:`~PredictClient.submit`.  Server conditions surface as typed
errors (:class:`ServerOverloaded`: back off and retry;
:class:`ServerRejected`: a request the server refuses).  A request
carries the ambient trace context in its header (:func:`..telemetry.
trace.wire_ids`, 0 when untraced), and :meth:`~PredictClient.predict`
opens the ``serving.client.predict`` span around its retries, so the
server's request span and the engine's forward join the caller's trace.

:func:`run_load` is the load generator: N connections, each keeping a
number of requests in flight, report QPS and latency quantiles.

    python -m dmlc_core_tpu_torch.serving.client HOST:PORT [requests=N] \\
        [concurrency=N] [pipeline_depth=N] [rows_per_req=N] ...
"""

from __future__ import annotations

import socket
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import trace as teltrace
from ..transport.frames import send_all
from ..utils.logging import DMLCError
from ..utils.metrics import Histogram, metrics
from ..utils.parameter import get_env
from ..utils.retry import (CircuitBreaker, Deadline, DeadlineExpired,
                           RetriesExhausted, RetryPolicy)
from .server import (HELLO_REQ_ID, REQ_HEADER, RSP_HEADER,
                     STATUS_DEADLINE, STATUS_NAMES, STATUS_OK,
                     STATUS_OVERLOADED, STATUS_SHUTDOWN, _recv_exact,
                     pack_hello)

__all__ = ["PredictClient", "ServerOverloaded", "ServerRejected",
           "run_load", "load_main"]


class ServerOverloaded(DMLCError):
    """The server shed this request (admission control or deadline):
    retry with backoff."""


class ServerRejected(DMLCError):
    """The server refused this request for a reason a retry cannot fix."""


class PredictClient:
    """One pipelined connection to a prediction server.

    Resilience contract (the JAX client's):

    * :meth:`predict` retries :class:`ServerOverloaded` under the
      ``DMLC_SERVING_RETRIES`` / ``_BACKOFF_*`` budget, every attempt
      inside the one ``timeout`` the caller passed.  A timed-out request
      is abandoned: removed from the pending map and its future failed.
    * A lost connection is redialled and every request in flight is sent
      again on the new one (a prediction is pure, so a duplicate is
      harmless; its late answer is dropped).  Redials follow the
      ``DMLC_SERVING_RECONNECT_*`` schedule behind a circuit breaker
      (``DMLC_SERVING_BREAKER_*``); when the budget is spent the futures
      in flight fail with the transport error.
      ``DMLC_SERVING_RECONNECT=0`` fails fast instead.
    * :meth:`submit` stays raw (one frame, no retries), so that a
      pipelining caller such as the load generator sees every shed.
    * ``endpoints`` makes every (re)dial an ordered sweep: ``(host,
      port)`` first, then each fallback; landing anywhere but the last
      address counts on ``serving.client.failovers``.
    * ``model_id`` sends the hello on every new connection, so a server
      of another model refuses at dial time.
    * Each connect is bounded by ``DMLC_IO_CONNECT_TIMEOUT`` seconds (10,
      as for the I/O layer's HTTP requests).  The first dial is made
      again, on the reconnect schedule and within ``connect_timeout``,
      while its connects time out; a refused one fails at once.  A
      reconnect retries any failed dial (the reconnect schedule).

    Counters: ``retry.serving.client.*``, ``retry.serving.connect.*``,
    ``serving.client.reconnects``, ``serving.client.failovers``,
    ``circuit.serving.reconnect.*``.
    """

    def __init__(self, host: str, port: int,
                 connect_timeout: float = 30.0, *,
                 reconnect: Optional[bool] = None,
                 endpoints: Optional[List[Tuple[str, int]]] = None,
                 model_id: Optional[str] = None) -> None:
        self._host = host
        self._port = int(port)
        self._connect_timeout = connect_timeout
        self._model_id = model_id
        self._endpoints: List[Tuple[str, int]] = [(host, int(port))]
        for ep in endpoints or []:
            addr = (str(ep[0]), int(ep[1]))
            if addr not in self._endpoints:
                self._endpoints.append(addr)
        self._last_ep: Optional[Tuple[str, int]] = None
        if reconnect is None:
            reconnect = get_env("DMLC_SERVING_RECONNECT", True)
        self._reconnect_enabled = bool(reconnect)
        self._overload_retry = RetryPolicy.from_env(
            "DMLC_SERVING", name="serving.client",
            retryable=lambda e: isinstance(e, ServerOverloaded))
        self._conn_retry = RetryPolicy(
            max_attempts=get_env("DMLC_SERVING_RECONNECT_RETRIES", 8),
            base_delay_s=get_env("DMLC_SERVING_RECONNECT_BACKOFF", 0.1),
            max_delay_s=2.0,
            retryable=lambda e: isinstance(e, OSError),
            name="serving.reconnect")
        self._breaker = CircuitBreaker.from_env("DMLC_SERVING",
                                                name="serving.reconnect")
        self._attempt_s = get_env("DMLC_IO_CONNECT_TIMEOUT", 10.0)
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        # req_id → (future, wire frame): a reconnect resends the frames
        self._pending: Dict[int, Tuple[Future, bytes]] = {}
        self._next_id = 0
        self._closed = False
        self._dead: Optional[DMLCError] = None   # the reader's last error
        self._gen = 0              # bumps on every (re)connection
        self._sock = self._first_dial()
        self._start_reader(self._gen)

    def _first_dial(self) -> socket.socket:
        """The first connection: a sweep whose connect timed out (about
        one loopback connect in a thousand never completes on some
        hosts) is made again on the reconnect schedule, within
        ``connect_timeout``; any other dial error is raised at once."""
        dl = Deadline(self._connect_timeout)
        first = RetryPolicy(
            max_attempts=self._conn_retry.max_attempts,
            base_delay_s=self._conn_retry.base_delay_s,
            max_delay_s=self._conn_retry.max_delay_s,
            retryable=lambda e: isinstance(e, TimeoutError),
            name="serving.connect")
        try:
            return first.call(self._dial, dl, deadline=dl)
        except (RetriesExhausted, DeadlineExpired) as e:
            raise e.__cause__ from None

    def _dial(self, deadline: Optional[Deadline] = None) -> socket.socket:
        """One sweep over the endpoints, each connect bounded by
        ``DMLC_IO_CONNECT_TIMEOUT`` (and what is left of ``deadline``);
        raises the last dial error only when every endpoint failed."""
        dl = deadline or Deadline(self._connect_timeout)
        last_exc: Optional[OSError] = None
        for addr in self._endpoints:
            try:
                sock = socket.create_connection(
                    addr, timeout=dl.clamp(self._attempt_s))
            except OSError as e:
                last_exc = e
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            if self._model_id is not None:
                try:
                    send_all(sock, pack_hello(self._model_id))
                except OSError as e:
                    last_exc = e
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
            if self._last_ep is not None and addr != self._last_ep:
                metrics.counter("serving.client.failovers").add(1)
            self._last_ep = addr
            return sock
        raise last_exc if last_exc is not None else OSError(
            "no endpoints configured")

    def _start_reader(self, gen: int) -> None:
        self._reader = threading.Thread(
            target=self._read_loop, args=(self._sock, gen),
            name="serving-client-reader", daemon=True)
        self._reader.start()

    # -- receive side ----------------------------------------------------
    @staticmethod
    def _resolve(fut: Future, result=None, exc=None) -> None:
        # an abandon may have settled the future already: the answer to
        # an abandoned request is dropped
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # noqa: BLE001 — InvalidStateError
            pass

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        try:
            while True:
                head = _recv_exact(sock, RSP_HEADER.size)
                if head is None:
                    raise DMLCError("server closed the connection")
                req_id, status, n = RSP_HEADER.unpack(head)
                payload = _recv_exact(sock, 4 * n if status ==
                                      STATUS_OK else n)
                if payload is None:
                    raise DMLCError("server died mid-response")
                if req_id == HELLO_REQ_ID:
                    # only a refused hello is answered; a redial cannot
                    # fix a model mismatch
                    self._reconnect_enabled = False
                    raise DMLCError("model hello rejected: "
                                    + payload.decode("utf-8", "replace"))
                if status == STATUS_SHUTDOWN and self._reconnect_enabled:
                    # a draining replica answers SHUTDOWN for what it will
                    # never serve: keep those pending and redial, so the
                    # resend lands them on its replacement
                    raise DMLCError(
                        "server shutting down: "
                        + payload.decode("utf-8", "replace"))
                with self._plock:
                    entry = self._pending.pop(req_id, None)
                if entry is None:
                    continue           # the answer to an abandoned request
                fut = entry[0]
                if status == STATUS_OK:
                    self._resolve(fut,
                                  result=np.frombuffer(payload, np.float32))
                else:
                    msg = payload.decode("utf-8", "replace")
                    name = STATUS_NAMES.get(status, str(status))
                    exc = (ServerOverloaded if status in
                           (STATUS_OVERLOADED, STATUS_DEADLINE)
                           else ServerRejected)
                    self._resolve(fut, exc=exc(f"{name}: {msg}"))
        except (OSError, DMLCError) as e:
            self._on_conn_lost(gen, e)

    # -- reconnect -------------------------------------------------------
    def _on_conn_lost(self, gen: int, exc: BaseException) -> None:
        with self._plock:
            if self._closed or gen != self._gen:
                return                 # close() or a stale reader
            self._gen += 1             # this thread owns the reconnect
            new_gen = self._gen
        if self._reconnect_enabled:
            try:
                self._reestablish(new_gen)
                return
            except Exception as e:  # noqa: BLE001 — budget exhausted
                exc = e
        self._fail_all_pending(
            DMLCError(f"serving connection lost: {exc}"))

    def _reestablish(self, gen: int) -> None:
        """Dial a new connection and resend every frame in flight."""

        def dial_once() -> socket.socket:
            self._breaker.allow()
            try:
                s = self._dial()
            except BaseException:
                self._breaker.record_failure()
                raise
            self._breaker.record_success()
            return s

        sock = self._conn_retry.call(dial_once)
        with self._plock:
            if self._closed:
                sock.close()
                raise DMLCError("client closed during reconnect")
            self._sock = sock
            frames = [frame for (_fut, frame) in self._pending.values()]
        metrics.counter("serving.client.reconnects").add(1)
        self._start_reader(gen)
        try:
            with self._wlock:
                for frame in frames:
                    send_all(sock, frame)
        except OSError:
            pass    # died again mid-resend: the new reader owns that

    def _fail_all_pending(self, err: DMLCError) -> None:
        # no reader runs after this, so mark the client dead under the
        # same lock that swaps the pending map: a later submit fails
        # instead of waiting forever
        with self._plock:
            self._dead = err
            pending, self._pending = self._pending, {}
        for fut, _frame in pending.values():
            self._resolve(fut, exc=err)

    # -- send side -------------------------------------------------------
    def submit(self, ids: np.ndarray, vals: np.ndarray,
               row_ptr: Optional[np.ndarray] = None) -> Future:
        """Pipeline one request; returns a Future of float32 scores."""
        ids = np.ascontiguousarray(ids, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        if row_ptr is None:
            row_ptr = np.array([0, len(ids)], np.int32)
        row_ptr = np.ascontiguousarray(row_ptr, np.int32)
        rows, nnz = len(row_ptr) - 1, len(ids)
        fut: Future = Future()
        frame_tail = row_ptr.tobytes() + ids.tobytes() + vals.tobytes()
        with self._plock:
            if self._closed:
                fut.set_exception(DMLCError("client closed"))
                return fut
            if self._dead is not None:
                fut.set_exception(self._dead)
                return fut
            req_id = self._next_id
            self._next_id += 1
            # the ambient trace context rides the header (0, 0 untraced);
            # a resent frame keeps its ids: a reconnect is the same
            # logical request
            trace_id, parent = teltrace.wire_ids()
            frame = REQ_HEADER.pack(req_id, trace_id, parent, rows,
                                    nnz) + frame_tail
            fut._dmlc_req_id = req_id          # predict()'s abandon handle
            self._pending[req_id] = (fut, frame)
            sock = self._sock
        try:
            with self._wlock:
                send_all(sock, frame)
        except OSError as e:
            # registered before the send, so the reader's reconnect
            # resends it; only a fail-fast client settles it here
            if not self._reconnect_enabled:
                with self._plock:
                    self._pending.pop(req_id, None)
                self._resolve(fut, exc=DMLCError(f"send failed: {e}"))
        return fut

    def _abandon(self, fut: Future) -> None:
        """Give up on a request in flight: unhook it, so a late answer is
        dropped, and settle its future."""
        req_id = getattr(fut, "_dmlc_req_id", None)
        if req_id is None:
            return
        with self._plock:
            self._pending.pop(req_id, None)
        self._resolve(fut, exc=DMLCError("request abandoned on timeout"))

    def predict(self, ids: np.ndarray, vals: np.ndarray,
                row_ptr: Optional[np.ndarray] = None,
                timeout: float = 30.0) -> np.ndarray:
        """Blocking single request → scores ``[rows]``.  ``timeout`` is
        the whole budget: overload retries and the waits draw from it."""
        dl = Deadline(timeout)

        def once() -> np.ndarray:
            fut = self.submit(ids, vals, row_ptr)
            try:
                wait = None if timeout is None else dl.clamp(timeout)
                return fut.result(timeout=wait)
            except FutureTimeout:
                self._abandon(fut)
                raise
        # the call's span, a new root or a child of the caller's: submit
        # packs it into the header, so the server's and the engine's
        # spans join this trace; overload retries are its events
        with teltrace.span(
                "serving.client.predict",
                rows=(len(row_ptr) - 1 if row_ptr is not None else 1)):
            try:
                return self._overload_retry.call(once, deadline=dl)
            except (RetriesExhausted, DeadlineExpired) as e:
                cause = e.__cause__
                if isinstance(cause, ServerOverloaded):
                    raise cause        # overload stays typed
                raise

    def close(self) -> None:
        with self._plock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)
        self._fail_all_pending(DMLCError("connection closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

def _gen_request(rng: np.random.Generator, rows: int, nnz_per_row: int,
                 features: int):
    """One synthetic CSR request: ``rows`` examples, nnz ~U[1, cap]."""
    counts = rng.integers(1, nnz_per_row + 1, size=rows)
    total = int(counts.sum())
    ids = rng.integers(0, features, size=total).astype(np.int32)
    vals = rng.random(total, dtype=np.float32)
    row_ptr = np.zeros(rows + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return ids, vals, row_ptr


def run_load(host: str, port: int, *, requests: int = 2000,
             concurrency: int = 4, pipeline_depth: int = 8,
             rows_per_req: int = 4, nnz_per_row: int = 32,
             features: int = 1 << 16, seed: int = 0,
             timeout: float = 60.0,
             endpoints: Optional[List[Tuple[str, int]]] = None,
             model_id: Optional[str] = None) -> Dict[str, Any]:
    """Drive a serving endpoint and measure it.

    ``concurrency`` connections each keep ``pipeline_depth`` requests in
    flight (closed loop: an answer admits the next request), splitting
    ``requests`` between them.  Overload answers are counted, not
    retried.  Returns a JSON-ready dict: qps, rows/s, latency quantiles
    (ms), and the counts of each outcome."""
    per_worker = [requests // concurrency] * concurrency
    per_worker[0] += requests - sum(per_worker)
    hist = Histogram(max_samples=min(requests, 65536))
    counts = {"ok": 0, "overload": 0, "rejected": 0}
    clock = time.monotonic
    lock = threading.Lock()
    errors: List[str] = []

    def worker(widx: int, n: int) -> None:
        rng = np.random.default_rng(seed + widx)
        try:
            client = PredictClient(host, port, connect_timeout=timeout,
                                   endpoints=endpoints,
                                   model_id=model_id)
        except OSError as e:
            with lock:
                errors.append(f"connect: {e}")
            return
        inflight: List[tuple] = []      # (future, t_sent)

        def reap() -> None:
            fut, t0 = inflight.pop(0)
            try:
                fut.result(timeout=timeout)
                with lock:
                    counts["ok"] += 1
            except ServerOverloaded:
                with lock:
                    counts["overload"] += 1
            except Exception as e:  # noqa: BLE001 — tally, keep loading
                with lock:
                    counts["rejected"] += 1
                    if len(errors) < 5:
                        errors.append(repr(e))
            hist.observe(clock() - t0)

        try:
            for _ in range(n):
                if len(inflight) >= pipeline_depth:
                    reap()
                ids, vals, row_ptr = _gen_request(
                    rng, rows_per_req, nnz_per_row, features)
                inflight.append((client.submit(ids, vals, row_ptr),
                                 clock()))
            while inflight:
                reap()
        finally:
            client.close()

    threads = [threading.Thread(target=worker, args=(i, n), daemon=True)
               for i, n in enumerate(per_worker)]
    t_start = clock()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(clock() - t_start, 1e-9)
    p50, p95, p99 = hist.quantiles([0.5, 0.95, 0.99])
    return {
        "requests": requests, "concurrency": concurrency,
        "pipeline_depth": pipeline_depth, "rows_per_req": rows_per_req,
        "nnz_per_row": nnz_per_row,
        "ok": counts["ok"], "overload": counts["overload"],
        "rejected": counts["rejected"], "errors": errors,
        "wall_s": wall,
        "qps": counts["ok"] / wall,
        "rows_per_s": counts["ok"] * rows_per_req / wall,
        "latency_ms": {"p50": p50 * 1e3, "p95": p95 * 1e3,
                       "p99": p99 * 1e3, "mean": hist.mean * 1e3},
    }


def load_main(argv=None) -> int:
    """CLI: ``python -m dmlc_core_tpu_torch.serving.client host:port
    [requests=N] [concurrency=N] ...``: run the load generator and print
    its JSON report."""
    import json
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or ":" not in args[0]:
        print("usage: serving.client <host:port> [requests=N] "
              "[concurrency=N] [pipeline_depth=N] [rows_per_req=N] "
              "[nnz_per_row=N] [features=N] [seed=N]", file=sys.stderr)
        return 2
    host, _, port = args[0].rpartition(":")
    kw = {k: int(v) for k, v in (a.split("=", 1) for a in args[1:])}
    report = run_load(host, int(port), **kw)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(load_main())
