"""Threaded TCP prediction server over the engine and the micro-batcher.

Counterpart of ``dmlc_core_tpu/serving/server.py``, on the same wire,
byte for byte, so that the JAX package's client talks to this server and
this package's client to the JAX server.  Length-prefixed little-endian
frames over TCP with ``TCP_NODELAY``; requests and responses are matched
by a client-chosen ``req_id``, so one connection can pipeline many
requests and receive the answers in completion order::

    request:   [req_id u64][trace_id u64][parent_span u64][rows u32][nnz u32]
               [row_ptr i32 × (rows+1)][ids i32 × nnz][vals f32 × nnz]
    response:  [req_id u64][status u8][n u32]
               status 0 (OK):  [scores f32 × n]      (n == rows)
               status ≠ 0:     [utf-8 message × n]
    statuses:  0 OK, 1 OVERLOADED, 2 DEADLINE_EXCEEDED, 3 TOO_LARGE,
               4 SHUTDOWN, 5 BAD_REQUEST
    hello:     a request frame with req_id == (1<<64)-1 declares the
               model: rows == 0 and the payload is nnz utf-8 bytes naming
               the model_id (see pack_hello); a server of another model
               answers BAD_REQUEST and drops the connection

Overload is an answer, not a dropped connection, so that a client can
tell "back off and retry" from "server died".  ``trace_id`` /
``parent_span`` carry the client's trace context (0 = untraced): a
traced request opens ``serving.server.request``, parented on the wire's
context, which parents the engine's ``serving.engine.forward``, so
client, server and engine share one trace.  The server span ends with
the request's status (``OK``, ``OVERLOADED``, ``DEADLINE_EXCEEDED``,
``TOO_LARGE``, ``SHUTDOWN``, ``BAD_REQUEST``, or ``DISCONNECT`` for a
client gone mid-frame).

Hot reload: :meth:`PredictionServer.reload_from_checkpoint` swaps the
weights mid-stream, and :meth:`PredictionServer.watch_checkpoints` polls a
checkpoint directory (local, or on a remote store: ``s3://``,
``hdfs://``, ...) and reloads whenever a trainer publishes a new step.

Chaos: each request crosses the ``serving.server.admit`` fault point
(:mod:`..utils.faults`, ``DMLC_FAULT_SPEC``) before it is admitted; an
injected error sheds it exactly as admission control would, answered
``OVERLOADED`` and counted in ``serving.server.shed``.

Telemetry: ``metrics_port=`` (else ``DMLC_METRICS_PORT``; 0 binds an
ephemeral port, unset is off) mounts a
:class:`~..telemetry.exposition.TelemetryServer` on the server's own
host, started and stopped with the server: ``/metrics`` (the port's
registry), ``/healthz`` (:meth:`PredictionServer.health_doc`, 503 when
overloaded), ``/spans`` and ``/timeline`` (starting the metric-history
sampler).  ``DMLC_SLO_SPEC`` (plain and burn-rate rules,
:mod:`..telemetry.anomaly` and :mod:`..telemetry.slo`) compiles at
construction, raising on a malformed spec, and its monitor runs from
:meth:`PredictionServer.start` to :meth:`PredictionServer.stop`; a
breached rule degrades :attr:`PredictionServer.health` and freezes the
serving autotuner.

Incidents: ``DMLC_FLIGHT_DIR`` arms the flight recorder at construction
(:mod:`..telemetry.flight`; with ``DMLC_FLIGHT_HOOKS`` unset or 1 it
also chains onto ``sys.excepthook``, ``threading.excepthook``, SIGTERM
and SIGABRT), so an injected fault, an SLO breach, an engine failure, a
fatal signal or an unhandled exception leaves an incident bundle there;
``DMLC_TRACE_SAMPLE`` installs the tail sampler
(:mod:`..telemetry.sampling`).  Every request the server reads emits one
``serving.request`` wide event (:mod:`..telemetry.wide_events`: model,
conn, req_id, rows, nnz, dur_ms, outcome, the batcher's queue_ms,
batch_rows and batch_nnz, the trace id), an admission shed included;
the exporter serves them at ``/events`` and a bundle at ``/flight``.

Fleet membership: ``DMLC_ROUTER_REGISTRY=host:port`` (or a
``host:port,host:port`` list, a primary and its standbys) joins the
replica to a :class:`~.fleet.ReplicaRegistry` through a
:class:`~.fleet.ReplicaAgent` made at construction, started by
:meth:`PredictionServer.start` and deregistered by
:meth:`PredictionServer.stop` before the port goes away; it heartbeats
every ``DMLC_ROUTER_HEARTBEAT`` s and applies the registry's reload
directives (canary rollouts).

Autotuning: with ``DMLC_AUTOTUNE`` opted in, :meth:`PredictionServer.
serve_forever` (and so ``serve_main``) tunes the micro-batcher's cut
triggers one window at a time (:mod:`..pipeline.autotune`);
``DMLC_AUTOTUNE=0`` is the kill switch.

    python -m dmlc_core_tpu_torch.serving.server ckpt_dir=DIR features=N \\
        [model=fm] [dim=16] [port=0] [device=cuda|cpu] ...
"""

from __future__ import annotations

import socket
import struct
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..telemetry import anomaly as telanomaly
from ..telemetry import flight as telflight
from ..telemetry import sampling as telsampling
from ..telemetry import trace as teltrace
from ..telemetry.exposition import TelemetryServer
from ..telemetry.wide_events import wide_event
from ..transport.frames import send_all
from ..transport.listener import Listener, serve_connection
from ..utils.faults import FaultInjected, fault_point
from ..utils.logging import DMLCError, log_info, log_warning
from ..utils.metrics import metrics
from ..utils.parameter import get_env
from .batcher import DeadlineExceeded, MicroBatcher, Overloaded, Shutdown
from .engine import InferenceEngine, RequestTooLarge

__all__ = ["PredictionServer", "REQ_HEADER", "RSP_HEADER", "STATUS_OK",
           "STATUS_OVERLOADED", "STATUS_DEADLINE", "STATUS_TOO_LARGE",
           "STATUS_SHUTDOWN", "STATUS_BAD_REQUEST", "STATUS_NAMES",
           "HELLO_REQ_ID", "pack_hello", "serve_main"]

REQ_HEADER = struct.Struct("<QQQII")    # req_id, trace_id, parent_span,
                                        # rows, nnz (trace ids 0 = untraced)
RSP_HEADER = struct.Struct("<QBI")      # req_id, status, n

#: reserved req_id of the hello preamble: the header's ``nnz`` counts the
#: utf-8 model_id bytes that follow (rows and trace fields are 0).  Real
#: req_ids are small counters, so it never collides.
HELLO_REQ_ID = (1 << 64) - 1
_MAX_MODEL_ID = 4096


def pack_hello(model_id: str) -> bytes:
    """The model-declaration frame, sent once per connection before the
    first request."""
    blob = model_id.encode("utf-8")[:_MAX_MODEL_ID]
    return REQ_HEADER.pack(HELLO_REQ_ID, 0, 0, 0, len(blob)) + blob


STATUS_OK = 0
STATUS_OVERLOADED = 1
STATUS_DEADLINE = 2
STATUS_TOO_LARGE = 3
STATUS_SHUTDOWN = 4
STATUS_BAD_REQUEST = 5
STATUS_NAMES = {0: "OK", 1: "OVERLOADED", 2: "DEADLINE_EXCEEDED",
                3: "TOO_LARGE", 4: "SHUTDOWN", 5: "BAD_REQUEST"}

#: parse-time caps: a corrupt header must not allocate gigabytes
_MAX_ROWS = 1 << 20
_MAX_NNZ = 1 << 26

def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            return None
        got += r
    return bytes(buf)


def _status_of(exc: BaseException) -> int:
    if isinstance(exc, Overloaded):
        return STATUS_OVERLOADED
    if isinstance(exc, DeadlineExceeded):
        return STATUS_DEADLINE
    if isinstance(exc, RequestTooLarge):
        return STATUS_TOO_LARGE
    if isinstance(exc, Shutdown):
        return STATUS_SHUTDOWN
    return STATUS_BAD_REQUEST


class PredictionServer:
    """Accept loop and one reader thread a connection; answers are
    written from the batcher's completion callbacks under a
    per-connection write lock (pipelined requests finish out of order).
    ``metrics_port`` mounts the telemetry exporter (see the module's
    docstring)."""

    def __init__(self, engine: InferenceEngine, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_delay_s: float = 0.002, max_queue: int = 256,
                 default_deadline_s: float = 1.0,
                 warmup: bool = True, backlog: int = 64,
                 metrics_port: Optional[int] = None,
                 model_id: Optional[str] = None) -> None:
        # DMLC_SLO_SPEC compiles first (a bad spec raises before any
        # socket or thread exists); its monitor runs from start() to stop()
        self.slo_monitor: Optional[telanomaly.SloMonitor] = \
            telanomaly.maybe_monitor_from_env(autostart=False)
        # the incident companions, each an exact no-op when its variable
        # is unset: DMLC_FLIGHT_DIR arms the flight recorder (and its
        # fatal-path hooks), DMLC_TRACE_SAMPLE installs the tail sampler
        telflight.maybe_arm_from_env()
        telsampling.maybe_install_from_env()
        self.engine = engine
        # which checkpoint lineage this replica serves; "default" keeps
        # single-replica deployments hello-free
        self.model_id = model_id or "default"
        if warmup:
            engine.warmup_all()
        self.batcher = MicroBatcher(
            engine, max_delay_s=max_delay_s, max_queue=max_queue,
            default_deadline_s=default_deadline_s)
        self._listener = Listener(host, port, backlog=backlog)
        self.host, self.port = self._listener.host, self._listener.port
        self._conns: Dict[int, socket.socket] = {}
        self._conn_lock = threading.Lock()
        self._next_conn = 0
        self._stopping = False
        self._accept_thread: Optional[threading.Thread] = None
        self._watcher: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._m_conns = metrics.gauge("serving.server.connections")
        self._inflight = 0             # submitted, not yet answered
        self._inflight_lock = threading.Lock()
        self._m_inflight = metrics.gauge("serving.server.inflight")
        # the queue-depth fraction above which health degrades before
        # admission control starts shedding
        self._degraded_ratio = float(
            get_env("DMLC_SERVING_DEGRADED_RATIO", 0.75))
        # the exporter: metrics_port, else DMLC_METRICS_PORT (0 =
        # ephemeral, unset = off), on the server's own host; /healthz
        # serves the whole health doc, which a balancer weights on
        if metrics_port is None:
            p = get_env("DMLC_METRICS_PORT", -1)
            metrics_port = p if p >= 0 else None
        self.telemetry: Optional[TelemetryServer] = None
        if metrics_port is not None:
            self.telemetry = TelemetryServer(
                port=int(metrics_port), host=self.host,
                health_fn=self.health_doc)
        # fleet membership: an agent that registers, heartbeats and
        # applies the registry's reload directives
        self._agent = None
        reg = str(get_env("DMLC_ROUTER_REGISTRY", ""))
        if reg:
            from .fleet.registry import ReplicaAgent
            self._agent = ReplicaAgent(self, reg, model_id=self.model_id)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "PredictionServer":
        if self.telemetry is not None:
            self.telemetry.start()     # a failed bind raises before accept
        if self.slo_monitor is not None:
            self.slo_monitor.start()
        self._accept_thread = self._listener.spawn(
            self._on_conn, name="serving-accept",
            stopping=lambda: self._stopping)
        if self._agent is not None:
            self._agent.start()
        log_info("serving: listening on %s:%d (%d buckets, queue=%d)",
                 self.host, self.port, len(self.engine.ladder),
                 self.batcher.max_queue)
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown: stop accepting, drain the batcher (requests
        in flight get their answers), then drop the connections."""
        self._stopping = True
        self._watch_stop.set()
        if self._agent is not None:
            self._agent.stop()         # deregister before the port goes
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
        self._listener.close()
        self.batcher.close(drain=drain, timeout=timeout)
        with self._conn_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._watcher is not None:
            self._watcher.join(timeout=5.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def serve_forever(self, window_s: float = 5.0,
                      max_windows: Optional[int] = None) -> int:
        """Block until :meth:`stop` (or ``max_windows`` windows of
        ``window_s``); returns the windows run.

        With ``DMLC_AUTOTUNE`` opted in, each window is one epoch of the
        serving autotuner over the batcher's live knobs
        (:func:`..pipeline.autotune.serving_knob_space`, applied through
        ``MicroBatcher.apply_knobs``), judged by the window's QPS / (1 +
        p99 latency in seconds): a cut trigger that buys throughput by
        letting requests wait pays for the latency.  A window with no
        traffic, or cut short by a stop, is aborted and judges nothing.
        Without it (unset or ``0``) the loop only sleeps."""
        from ..pipeline.autotune import maybe_autotuner, serving_knob_space
        from ..pipeline.fingerprint import autotune_key
        tuner = maybe_autotuner(lambda: serving_knob_space(self.batcher),
                                key=autotune_key(None, platform="serving"),
                                gate="auto")
        m_reqs = metrics.throughput("serving.batcher.requests")
        m_lat = metrics.histogram("serving.latency_s")
        windows = 0
        while (not self._stopping
               and (max_windows is None or windows < max_windows)):
            if tuner is not None:
                tuner.begin_epoch()     # pushes this window's knob values
                base = m_reqs.total
            t0 = time.monotonic()
            while not self._stopping and time.monotonic() - t0 < window_s:
                time.sleep(min(0.05, window_s))
            if tuner is not None:
                dt = max(1e-9, time.monotonic() - t0)
                delta = m_reqs.total - base
                if delta <= 0 or self._stopping:
                    tuner.abort_epoch()
                else:
                    p99 = float(m_lat.snapshot()["p99"])
                    tuner.end_epoch((delta / dt) / (1.0 + p99))
            windows += 1
        if tuner is not None:
            tuner.abort_epoch()         # drop a half-judged mutation
        return windows

    # -- health ----------------------------------------------------------
    @property
    def health(self) -> str:
        """``ok`` | ``degraded`` | ``overloaded`` from the batcher's queue
        depth and the live SLO breaches: ``degraded`` from
        ``DMLC_SERVING_DEGRADED_RATIO`` (0.75) of ``max_queue``,
        ``overloaded`` once admission sheds; a breached
        ``DMLC_SLO_SPEC`` rule (``slo.active_breaches`` > 0) degrades an
        otherwise-ok server, so a balancer drains a replica that misses
        its objectives.  Also the gauge ``serving.server.health`` (0 / 1
        / 2)."""
        depth = self.batcher.queue_depth
        cap = max(1, self.batcher.max_queue)
        if depth >= cap:
            state, level = "overloaded", 2
        elif depth >= self._degraded_ratio * cap:
            state, level = "degraded", 1
        else:
            state, level = "ok", 0
        if level == 0 and metrics.gauge("slo.active_breaches").value > 0:
            state, level = "degraded", 1
        metrics.gauge("serving.server.health").set(level)
        return state

    def health_doc(self) -> Dict[str, object]:
        """The health status word plus the load facts a balancer weights
        on: queue depth, its fraction of ``max_queue``, requests in
        flight."""
        depth = self.batcher.queue_depth
        cap = max(1, self.batcher.max_queue)
        with self._inflight_lock:
            inflight = self._inflight
        return {"status": self.health, "model_id": self.model_id,
                "queue_depth": depth,
                "queue_fraction": round(depth / cap, 4),
                "inflight": inflight}

    # -- hot reload ------------------------------------------------------
    def reload_from_checkpoint(self, directory: str,
                               step: Optional[int] = None) -> int:
        return self.engine.reload_from_checkpoint(directory, step)

    def watch_checkpoints(self, directory: str,
                          interval_s: float = 10.0) -> None:
        """Load the directory's latest checkpoint now, then poll its
        manifest and hot-reload each newer step.  A failed poll or
        reload logs and keeps serving the current weights."""
        from ..utils.checkpoint import CheckpointManager
        mgr = CheckpointManager(directory)
        state = {"step": None}

        def poll_once() -> None:
            latest = mgr.latest_step
            if latest is not None and latest != state["step"]:
                self.reload_from_checkpoint(directory, latest)
                state["step"] = latest

        try:
            poll_once()
        except DMLCError as e:
            log_warning("serving: initial checkpoint load failed: %s", e)

        def run() -> None:
            while not self._watch_stop.wait(interval_s):
                try:
                    poll_once()
                except DMLCError as e:
                    log_warning("serving: checkpoint watch failed "
                                "(%s) — keeping current weights", e)

        self._watcher = threading.Thread(target=run, name="serving-watch",
                                         daemon=True)
        self._watcher.start()

    # -- connections -----------------------------------------------------
    def _on_conn(self, conn: socket.socket, _addr) -> None:
        with self._conn_lock:
            cid = self._next_conn
            self._next_conn += 1
            self._conns[cid] = conn
            self._m_conns.set(len(self._conns))
        serve_connection(self._serve_conn, cid, conn,
                         name=f"serving-conn-{cid}")

    def _drop_conn(self, cid: int, conn: socket.socket) -> None:
        with self._conn_lock:
            self._conns.pop(cid, None)
            self._m_conns.set(len(self._conns))
        try:
            conn.close()
        except OSError:
            pass

    def _serve_conn(self, cid: int, conn: socket.socket) -> None:
        wlock = threading.Lock()

        def respond(req_id: int, status: int, payload: bytes) -> None:
            # n counts SCORES for OK (payload is n×f32), BYTES otherwise
            n = len(payload) // 4 if status == STATUS_OK else len(payload)
            try:
                with wlock:
                    send_all(conn, RSP_HEADER.pack(req_id, status, n)
                             + payload)
            except OSError:
                pass                   # client gone; the reader notices

        def on_done(req_id: int, fut, span: Optional[teltrace.Span],
                    rows: int, nnz: int, t0: float) -> None:
            with self._inflight_lock:
                self._inflight -= 1
                self._m_inflight.set(self._inflight)
            exc = fut.exception()
            if exc is None:
                scores = np.ascontiguousarray(fut.result(),
                                              dtype=np.float32)
                outcome = "OK"
                if span is not None:
                    span.end(status="OK")
                respond(req_id, STATUS_OK, scores.tobytes())
            else:
                status = _status_of(exc)
                if status == STATUS_OVERLOADED:
                    metrics.counter("serving.server.shed").add(1)
                outcome = STATUS_NAMES.get(status, str(status))
                if span is not None:
                    span.end(status=outcome)
                respond(req_id, status, str(exc).encode("utf-8", "replace"))
            # the canonical log line: one wide event a request, emitted
            # after span.end (a trace this server roots has its verdict by
            # then) and after the answer is sent.  The batcher's facts
            # ride in on the future
            wide_event("serving.request", model=self.model_id, conn=cid,
                       req_id=req_id, rows=rows, nnz=nnz,
                       dur_ms=round((time.monotonic() - t0) * 1e3, 3),
                       outcome=outcome,
                       trace_id=(teltrace.format_id(span.trace_id)
                                 if span is not None else None),
                       debug=(bool(span.trace_id & telsampling.DEBUG_BIT)
                              if span is not None else None),
                       **getattr(fut, "wide", {}))

        try:
            while True:
                head = _recv_exact(conn, REQ_HEADER.size)
                if head is None:
                    return
                req_id, trace_id, parent_span, rows, nnz = \
                    REQ_HEADER.unpack(head)
                if req_id == HELLO_REQ_ID:
                    # checked before the rows == 0 guard: a hello has
                    # rows 0 and nnz utf-8 bytes of model_id, not CSR
                    if nnz > _MAX_MODEL_ID:
                        respond(req_id, STATUS_BAD_REQUEST,
                                b"oversized hello")
                        return
                    blob = _recv_exact(conn, nnz)
                    if blob is None:
                        return
                    wanted = blob.decode("utf-8", "replace") or "default"
                    if wanted != self.model_id:
                        respond(req_id, STATUS_BAD_REQUEST,
                                f"model {wanted!r} not served here "
                                f"(this is {self.model_id!r})".encode())
                        return         # wrong fleet: drop the connection
                    continue
                # a traced request (non-zero trace id) gets a span parented
                # on the wire's context; it travels with the request and
                # ends with its answer (requests finish out of order)
                span = None
                if trace_id:
                    span = teltrace.start_span(
                        "serving.server.request",
                        parent=teltrace.TraceContext(trace_id, parent_span),
                        req_id=req_id, rows=rows, nnz=nnz, conn=cid)
                if rows == 0 or rows > _MAX_ROWS or nnz > _MAX_NNZ:
                    if span is not None:
                        span.end(status="BAD_REQUEST")
                    respond(req_id, STATUS_BAD_REQUEST,
                            f"bad header rows={rows} nnz={nnz}".encode())
                    return             # framing is broken: drop the conn
                try:
                    payload = _recv_exact(conn, 4 * (rows + 1) + 8 * nnz)
                except BaseException as e:
                    if span is not None:
                        span.end(status="DISCONNECT",
                                 error=f"{type(e).__name__}: {e}")
                    raise
                if payload is None:
                    if span is not None:
                        span.end(status="DISCONNECT")
                    return
                row_ptr = np.frombuffer(payload, np.int32, rows + 1, 0)
                ids = np.frombuffer(payload, np.int32, nnz,
                                    4 * (rows + 1))
                vals = np.frombuffer(payload, np.float32, nnz,
                                     4 * (rows + 1) + 4 * nnz)
                try:
                    # an injected error sheds the request as admission
                    # control would: a deterministic OVERLOADED burst
                    fault_point("serving.server.admit")
                except FaultInjected as e:
                    metrics.counter("serving.server.shed").add(1)
                    if span is not None:
                        span.end(status="OVERLOADED", injected=True)
                    wide_event("serving.request", model=self.model_id,
                               conn=cid, req_id=req_id, rows=rows,
                               nnz=nnz, outcome="OVERLOADED",
                               trace_id=(teltrace.format_id(span.trace_id)
                                         if span is not None else None))
                    respond(req_id, STATUS_OVERLOADED, str(e).encode())
                    continue
                with self._inflight_lock:
                    self._inflight += 1
                    self._m_inflight.set(self._inflight)
                t_req = time.monotonic()
                try:
                    fut = self.batcher.submit(
                        ids, vals, row_ptr.astype(np.int64),
                        trace_ctx=span.context if span else None)
                except BaseException as e:
                    with self._inflight_lock:
                        self._inflight -= 1
                        self._m_inflight.set(self._inflight)
                    if span is not None:
                        span.end(error=f"{type(e).__name__}: {e}")
                    raise
                fut.add_done_callback(
                    lambda f, rid=req_id, sp=span, r=rows, z=nnz,
                    t0=t_req: on_done(rid, f, sp, r, z, t0))
        except OSError as e:
            log_info("serving: connection %d ended: %r", cid, e)
        finally:
            self._drop_conn(cid, conn)


# neither package can serve FieldAwareFM: its forward needs each entry's
# field, and a request frame (REQ_HEADER, then ids, vals, row_ptr) has none
_FFM_UNSERVABLE = ("model=ffm cannot be served: the serving wire "
                   "(REQ_HEADER, then ids, vals and row_ptr) carries no "
                   "libfm fields, and FieldAwareFM needs each entry's field")


def serve_main(argv=None) -> int:
    """CLI: ``python -m dmlc_core_tpu_torch.serving.server ckpt_dir=DIR
    features=N [model=fm] [dim=16] [port=N] [watch_s=SEC] [device=cuda]
    ...``: build the model, load the latest checkpoint, serve until
    interrupted.  ``DMLC_METRICS_PORT`` mounts the exporter (its port is
    printed after the serving one), ``DMLC_SLO_SPEC`` the SLO monitor
    and ``DMLC_ROUTER_REGISTRY`` joins a fleet, as in the JAX CLI.  The
    model's weights before the first load come from a
    ``torch.Generator`` seeded with 0 (the JAX CLI's ``PRNGKey(0)``)."""
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None
                                          else argv))
    if not args.get("ckpt_dir") or not args.get("features"):
        print("usage: serving.server ckpt_dir=DIR features=N [model=fm] "
              "[dim=16] [task=binary] [port=0] [host=0.0.0.0] "
              "[watch_s=10] [max_delay_ms=2] [max_queue=256] "
              "[model_id=default] [ragged=0|1] [device=cuda|cpu]   (env "
              "DMLC_SERVE_RAGGED=1 is the default for ragged=)",
              file=sys.stderr)
        return 2
    import torch

    from ..models.cli import MODEL_REGISTRY, TrainParams
    from ..utils.device import resolve_device
    p = TrainParams()
    try:
        p.init({"data": "unused", "model": args.get("model", "fm"),
                "features": args["features"], "dim": args.get("dim", "16"),
                "task": args.get("task", "binary"),
                "device": args.get("device", "cuda")})
        if p.model == "ffm":
            raise DMLCError(_FFM_UNSERVABLE)
        device = resolve_device(p.device)
    except DMLCError as e:
        print(f"serving.server: {e}", file=sys.stderr)
        return 2
    gen = torch.Generator(device=device).manual_seed(0)
    model = MODEL_REGISTRY[p.model](p, device, gen)
    # the ragged engine: the key wins, the env var is the fleet default
    ragged = args.get("ragged", get_env("DMLC_SERVE_RAGGED", "0"))
    engine = InferenceEngine(
        model, postprocess="sigmoid" if p.task == "binary" else "none",
        ragged=str(ragged).lower() in ("1", "true", "yes", "on"),
        device=device)
    srv = PredictionServer(
        engine, host=args.get("host", "0.0.0.0"),
        port=int(args.get("port", "0")),
        max_delay_s=float(args.get("max_delay_ms", "2")) / 1e3,
        max_queue=int(args.get("max_queue", "256")),
        model_id=args.get("model_id"))
    srv.watch_checkpoints(args["ckpt_dir"],
                          interval_s=float(args.get("watch_s", "10")))
    srv.start()
    print(f"serving on {srv.host}:{srv.port}", flush=True)
    if srv.telemetry is not None:
        print(f"telemetry on {srv.host}:{srv.telemetry.port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
