"""Disaggregated ingest: parse and pack on worker processes, train here.

Counterpart of ``dmlc_core_tpu/pipeline/ingest_service.py``::

    worker N: InputSplit(part=N) → native parse → packer → fused wire
              buffers  (DeviceLoader(emit="host"), on the host only)
        │  TCP frames: [meta u64][words u32][rows u32][payload]
        ▼
    trainer:  RemoteIngestLoader → one copy to the card + the decode
              (the transfer stage of DeviceLoader)

The payload is the fused wire itself (v2, or the v3 compact layout), so
bytes go from the worker's packer to the card's copy untouched, and the
frames are the JAX package's byte for byte: either package's worker
feeds the other's loader.  Each worker serves its byte-range partition
(``part/nparts``), so the union of the workers' rows is the file's.

One connection is one epoch over the worker's partition (a frame with
``words == 0`` ends it); the loader reconnects for the next epoch
(:meth:`RemoteIngestLoader.before_first`).  Batches interleave across
workers by arrival: a data-parallel stream, not a fixed sequence.  A
reader whose stream breaks reconnects under a :class:`RetryPolicy`
(``DMLC_INGEST_READER_RETRIES``, ``DMLC_INGEST_READER_BACKOFF``), and
the worker serves its partition again from the start, so frames it had
already sent may arrive twice.

The worker is host-only: its ``device`` (the trainer's device type)
only resolves ``wire_compact="auto"`` (:func:`.tuned.resolve`: v3 for
``cuda``, v2 for ``cpu``) and never touches a card.  With
``DMLC_AUTOTUNE`` opted in, :func:`serve_ingest` tunes its parser
threads, prefetch and page-cache knobs one connection at a time
(:mod:`.autotune`).  :class:`RemoteIngestLoader` publishes the JAX
loader's metrics: the ``remote_ingest.h2d`` stage timer, the
``remote_ingest.batches`` counter, the ``remote_ingest.rows`` throughput,
and ``transport.buffer_reuse``, the frames whose header was received into
the connection's one header buffer.  Traced as in the JAX package: the
worker records one ``ingest.serve_epoch`` span a connection (``part``,
``nparts``, ``peer``, ``frames``), which parents its loader's spans, and
the loader one ``remote_ingest.h2d`` span a transferred frame
(``rows``) under the trace context live at its construction.

    python -m dmlc_core_tpu_torch.pipeline.ingest_service URI PART NPARTS \\
        FMT PORT [batch_rows=N] [nnz_cap=N] [id_mod=N] [max_epochs=N] \\
        [cache=PATH] [device=cuda|cpu]
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..telemetry import trace as teltrace
from ..telemetry.anomaly import StallDetector
from ..transport.frames import FRAME, NO_ROWS, FrameWriter
from ..transport.lane import recv_exact_into
from ..transport.listener import Listener, accept_once
from ..utils.device import resolve_device
from ..utils.faults import fault_point
from ..utils.logging import DMLCError, check, log_info, log_warning
from ..utils.metrics import metrics
from ..utils.parameter import env_int, get_env
from ..utils.retry import RetryPolicy
from ..utils.threaded_iter import ThreadedIter
from . import autotune as autotune_mod
from . import fingerprint as fingerprint_mod
from . import tuned
from .loader import DeviceLoader, _fused_words_meta, _TransferStage

__all__ = ["serve_ingest", "stream_epoch_frames", "RemoteIngestLoader",
           "ingest_worker_main"]


def stream_epoch_frames(conn: socket.socket, loader, batch_rows: int, *,
                        stall: Optional[StallDetector] = None
                        ) -> Tuple[int, int]:
    """Send every fused item ``loader`` yields over ``conn``, one frame
    (one vectored send) each, then the end-of-stream frame.  Returns
    ``(frames, bytes)``.  (The JAX function's ``eos=`` and ``writer=``
    serve its data-service worker, which is not ported.)

    ``DMLC_INGEST_SEND_TIMEOUT`` (seconds, default 300, 0 turns it off)
    bounds each send: a peer that stops draining times out, counts in
    ``ingest.client_drops`` and frees the worker for its next
    connection.  Each frame crosses the ``ingest.send`` fault point
    first, and its time (produce and send) feeds ``stall``."""
    timeout = env_int("DMLC_INGEST_SEND_TIMEOUT", 300, minimum=0)
    conn.settimeout(timeout if timeout > 0 else None)
    w = FrameWriter(conn)
    frames = sent_bytes = 0
    t_frame = time.monotonic()
    try:
        for kind, buf, meta, rows in loader:
            check(kind == "fused", "host emit must be fused")
            fault_point("ingest.send")
            # the exact size, not len(buf): a recycled pool buffer is
            # longer than its batch, and its tail must not cross the link
            words = _fused_words_meta(batch_rows, meta)
            w.send_frame(int(meta), words,
                         NO_ROWS if rows is None else int(rows),
                         memoryview(buf[:words]).cast("B"))
            loader.recycle(buf)
            sent_bytes += words * 4
            frames += 1
            if stall is not None:
                now = time.monotonic()
                stall.observe(now - t_frame)
                t_frame = now
        w.control(0, 0, 0)                  # the end of the stream
        w.flush()
    except TimeoutError as e:
        metrics.counter("ingest.client_drops").add(1)
        log_warning("ingest: peer stopped draining (send timed out after "
                    "%ss), dropping the connection: %r", timeout, e)
        raise
    return frames, sent_bytes


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def serve_ingest(uri: str, part: int, nparts: int, fmt: str,
                 batch_rows: int, nnz_cap: int, port: int,
                 host: str = "0.0.0.0", id_mod: int = 0,
                 wire_compact="auto", max_epochs: int = 0,
                 cache="auto", autotune="auto",
                 ready_event: Optional[threading.Event] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
    """Serve fused frames of one partition, one epoch a connection;
    blocks forever, or for ``max_epochs`` connections when > 0.

    ``device`` is the trainer's device type, which only resolves
    ``wire_compact="auto"``; the worker packs on the host.  ``cache``
    passes to the worker's loader (a ``#cachefile`` URI fragment makes
    every epoch after the first a replay of the page file).
    ``autotune``: ``"auto"`` tunes only when ``DMLC_AUTOTUNE`` opts in,
    True forces it (``DMLC_AUTOTUNE=0`` still wins), False never; one
    connection is one evaluation epoch, judged by its send rate in
    MB/s.  One bad connection (a vanished trainer, a parse error) ends
    that connection only."""
    from ..data import create_parser
    backend = torch.device(device).type
    check(backend in ("cuda", "cpu"), f"unsupported device {device}")
    _, wire_compact = tuned.resolve(backend, 1, wire_compact)
    listener = Listener(host, port, backlog=4)
    if ready_event is not None:
        ready_event.set()
    log_info("ingest worker: part %d/%d of %s on :%d (wire %s)", part,
             nparts, uri, listener.port, "v3" if wire_compact else "v2")
    cores = _cores()
    # the page-cache knobs join the search only where a cache can exist
    cache_on = bool(cache) and (cache != "auto" or "#" in uri)
    tuner = autotune_mod.maybe_autotuner(
        lambda: autotune_mod.ingest_knob_space(cores=cores, cache=cache_on),
        key=fingerprint_mod.autotune_key(
            {"uri": uri, "part": [part, nparts], "fmt": fmt,
             "batch_rows": int(batch_rows), "nnz_cap": int(nnz_cap),
             "id_mod": int(id_mod)}, platform="host"),
        gate=autotune)
    # a frame covers produce (parse and pack, or a page read) and send:
    # a wedged source, a stalled disk or a blocked peer all flag here
    stall = StallDetector("ingest.frame")
    served = 0
    try:
        while not max_epochs or served < max_epochs:
            got = accept_once(listener.sock)
            if got is None:
                break
            conn, addr = got
            loader = None
            epoch_ok = False
            cfg = tuner.begin_epoch() if tuner is not None else {}
            sent_bytes = 0
            t_epoch = time.monotonic()
            try:
                # one parse thread and no parser thread on a one-core
                # host (which lets the loader take streampack), unless
                # DMLC_NUM_THREADS / OMP_NUM_THREADS pin the threads; a
                # tuner's parser_threads replaces the rule
                if tuner is not None:
                    pt = int(cfg.get("parser_threads", 1))
                    nthreads, threaded = (1, False) if pt == 1 else (pt, True)
                else:
                    pinned = (get_env("DMLC_NUM_THREADS", None)
                              or os.environ.get("OMP_NUM_THREADS"))
                    nthreads, threaded = ((1, False)
                                          if cores == 1 and not pinned
                                          else (0, True))
                # one span an epoch served (frames are too hot for one
                # each: the loader's own spans cover them)
                with teltrace.span("ingest.serve_epoch", part=part,
                                   nparts=nparts, peer=str(addr)) as sp:
                    loader = DeviceLoader(
                        create_parser(uri, part, nparts, fmt,
                                      nthreads=nthreads, threaded=threaded),
                        batch_rows=batch_rows, nnz_cap=nnz_cap,
                        id_mod=id_mod, device="cpu",
                        wire_compact=wire_compact, emit="host", cache=cache,
                        prefetch=int(cfg.get("prefetch", 2)),
                        cache_queue_pages=int(cfg.get("cache_queue", 0)),
                        cache_readahead=cfg.get("cache_readahead"))
                    frames, sent_bytes = stream_epoch_frames(
                        conn, loader, batch_rows, stall=stall)
                    sp.attrs["frames"] = frames
                    epoch_ok = frames > 0
            except Exception as e:  # noqa: BLE001 — a server: the listener
                # lives on for the next connection
                log_info("ingest worker: connection from %s ended early: "
                         "%r", addr, e)
            finally:
                if loader is not None:
                    loader.close()
                conn.close()
                if tuner is not None:
                    if epoch_ok:
                        elapsed = max(1e-9, time.monotonic() - t_epoch)
                        tuner.end_epoch(sent_bytes / 1e6 / elapsed)
                    else:
                        # a dead peer or an empty stream measures nothing
                        tuner.abort_epoch()
            served += 1
    finally:
        listener.close()


class RemoteIngestLoader(_TransferStage):
    """Batches from N ingest workers, with :class:`DeviceLoader`'s
    consumer surface (iterate, ``next_batch``, ``before_first`` to
    reconnect for the next epoch, ``close``).

    One reader thread a worker receives frames into pool buffers (pinned
    on the card) and appends them to a bounded list; one transfer thread
    copies each to the card on its own stream and decodes it there (the
    v3 wire by the decode kernel), and the consumer's stream waits on
    the batch's event, as in :class:`DeviceLoader`.  A frame whose size
    does not match ``batch_rows`` raises.  A broken stream restarts that
    worker's reader; a worker that stays gone raises in the consumer.

    ``emit="host"`` stops before the transfer and yields
    ``("fused", buf, meta, rows)`` items, the :class:`~..models.train.
    FusedTrainer` contract; hand each ``buf`` back with :meth:`recycle`.
    """

    def __init__(self, addresses: Sequence[Tuple[str, int]],
                 batch_rows: int, prefetch: int = 4,
                 connect_timeout: float = 60.0, emit: str = "device",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        check(len(addresses) > 0, "need at least one ingest worker")
        check(emit in ("device", "host"), f"bad emit {emit!r}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.addresses = list(addresses)
        self.batch_rows = int(batch_rows)
        self.connect_timeout = connect_timeout
        self.emit = emit
        depth = max(2, int(prefetch))
        self._depth = depth
        self._closed = False
        # the constructing thread's trace context: the transfer thread
        # activates it, so its spans join the consumer's trace
        self._trace = teltrace.current()
        self._words_hint = 0                # the largest frame seen
        self._init_transfer(dev, pinned=dev.type == "cuda"
                            and emit == "device",
                            pool_cap=2 * depth + 2 + len(self.addresses),
                            depth=depth)
        self._frames: ThreadedIter = ThreadedIter(
            max_capacity=max(depth, len(self.addresses)))
        self._gen_lock = threading.Lock()
        self._frames.init(self._frame_source(), self._restart_readers,
                          name="dmlc-ingest-frames")
        if emit == "host":
            self._iter = self._frames
        else:
            self._iter = ThreadedIter(max_capacity=depth)
            self._iter.init(self._transfer_next, self._reset_transfer,
                            name="dmlc-ingest-transfer")

    # -- reader side: N sockets → one list --------------------------------
    def _frame_buf(self, words: int):
        # ask for the largest frame seen, so the pool's buffers converge
        # on one size instead of being dropped for each larger frame
        self._words_hint = max(self._words_hint, words)
        return self._pool.get(self._words_hint)

    def _spawn_readers(self) -> dict:
        cv = threading.Condition()
        state = {"out": [], "cv": cv, "live": len(self.addresses),
                 "err": None, "stop": False, "socks": []}
        cap = max(self._depth, len(self.addresses))

        def stream_epoch(addr):
            """One connection, one epoch of the worker's partition;
            raises on a broken stream, returns at the end-of-stream frame
            or a stop."""
            with cv:
                if state["stop"]:
                    return
            sock = socket.create_connection(addr,
                                            timeout=self.connect_timeout)
            sock.settimeout(self.connect_timeout)
            with cv:
                if state["stop"]:
                    sock.close()
                    return
                state["socks"].append(sock)
            # one header buffer a connection, received into for every
            # frame (transport.buffer_reuse counts the frames after the
            # first)
            hdr = bytearray(FRAME.size)
            hdr_view = memoryview(hdr)
            m_reuse = metrics.counter("transport.buffer_reuse")
            first = True
            with sock:
                while True:
                    fault_point("ingest.recv")
                    try:
                        recv_exact_into(sock, hdr_view)
                    except ConnectionError:
                        raise DMLCError(
                            f"ingest worker {addr} closed mid-stream")
                    if first:
                        first = False
                    else:
                        m_reuse.add(1)
                    meta, words, rows = FRAME.unpack(hdr)
                    if words == 0:
                        return
                    buf = self._frame_buf(words)
                    try:
                        recv_exact_into(
                            sock, memoryview(buf)[:words].cast("B"))
                    except ConnectionError:
                        raise DMLCError(
                            f"ingest worker {addr} died mid-frame")
                    with cv:
                        # the list is bounded like the pool: a slow
                        # consumer must not buffer the epoch in memory
                        while len(state["out"]) >= cap and not state["stop"]:
                            cv.wait(timeout=1.0)
                        if state["stop"]:
                            return
                        state["out"].append(
                            (buf[:words], meta,
                             None if rows == NO_ROWS else rows, buf))
                        cv.notify_all()

        def read_one(addr):
            self._bind_device()         # the pool pins memory here
            restarts = max(0, int(get_env("DMLC_INGEST_READER_RETRIES", 2)))

            def on_retry(attempt, exc):
                metrics.counter("ingest.reader.restarts").add(1)
                log_warning("ingest reader %s:%d restarting after %r "
                            "(attempt %d)", addr[0], addr[1], exc, attempt)

            # a stream broken by close() is not a worker's death:
            # reconnecting would spend the worker's next epoch on a
            # stream that nobody reads
            policy = RetryPolicy(
                max_attempts=1 + restarts,
                base_delay_s=get_env("DMLC_INGEST_READER_BACKOFF", 0.05),
                max_delay_s=1.0,
                retryable=lambda e: (isinstance(e, (OSError, DMLCError))
                                     and not state["stop"]),
                name="ingest.reader")
            try:
                policy.call(stream_epoch, addr, on_retry=on_retry)
            except Exception as e:                      # noqa: BLE001
                with cv:
                    if not state["stop"]:
                        state["err"] = state["err"] or e
                    cv.notify_all()
            finally:
                with cv:
                    state["live"] -= 1
                    cv.notify_all()

        state["threads"] = [
            threading.Thread(target=read_one, args=(a,), daemon=True,
                             name=f"dmlc-ingest-reader-{i}")
            for i, a in enumerate(self.addresses)]
        for t in state["threads"]:
            t.start()
        return state

    @staticmethod
    def _cancel_readers(state: Optional[dict]) -> None:
        """Stop an epoch's readers now: flag them and close their sockets
        so that blocked receives fail at once (an orphaned reader would
        keep the worker from its next connection)."""
        if state is None:
            return
        cv = state["cv"]
        with cv:
            state["stop"] = True
            socks = list(state["socks"])
            cv.notify_all()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for t in state.get("threads", []):
            t.join(timeout=5.0)

    def _frame_source(self):
        holder: Dict[str, object] = {"state": None}

        def next_fn(_cell):
            with self._gen_lock:
                # under close()'s lock: a producer racing close() must not
                # spawn readers that take the worker's next connection
                if self._closed:
                    return None
                if holder["state"] is None:
                    holder["state"] = self._spawn_readers()
            state = holder["state"]
            cv = state["cv"]
            with cv:
                while True:
                    if state["out"]:
                        item = state["out"].pop(0)
                        cv.notify_all()
                        return item
                    if state["err"] is not None:
                        err = state["err"]
                        raise DMLCError(f"ingest reader failed: {err}") \
                            from err
                    if state["live"] == 0 or state["stop"]:
                        holder["state"] = None
                        return None
                    cv.wait(timeout=1.0)

        with self._gen_lock:
            self._frame_holder = holder
        return next_fn

    def _restart_readers(self) -> None:
        with self._gen_lock:
            self._cancel_readers(self._frame_holder["state"])
            self._frame_holder["state"] = None      # reconnect lazily

    def _check_frame(self, view, meta) -> None:
        expected = _fused_words_meta(self.batch_rows, meta)
        if expected != len(view):
            raise DMLCError(
                f"ingest frame size mismatch: the worker sent {len(view)} "
                f"words but batch_rows={self.batch_rows} implies "
                f"{expected}: trainer and worker batch_rows differ")

    def _maybe_bind(self) -> None:
        """The JAX loader's metric handles, re-fetched when the
        registry's generation moves."""
        if getattr(self, "_m_gen", None) != metrics.generation:
            self._m_gen = metrics.generation
            self._m_h2d = metrics.stage("remote_ingest.h2d")
            self._m_batches = metrics.counter("remote_ingest.batches")
            self._m_rows = metrics.throughput("remote_ingest.rows")

    def _count(self, rows: Optional[int]) -> None:
        self._maybe_bind()
        self._m_batches.add(1)
        if rows is not None:
            self._m_rows.add(rows)

    # -- transfer side: DeviceLoader's ---------------------------------------
    def _transfer_next(self, _cell):
        item = self._frames.next()
        if item is None:
            self._drain_inflight()
            return None
        view, meta, rows, buf = item
        self._check_frame(view, meta)
        self._maybe_bind()
        with teltrace.activate(self._trace), \
                teltrace.span("remote_ingest.h2d",
                              rows=(None if rows is None else int(rows))), \
                self._m_h2d.time():
            out = self._transfer_item(("fused", buf, int(meta), rows),
                                      sync=False)
        self._count(rows)
        return out

    def _reset_transfer(self) -> None:
        self._drain_inflight()
        self._frames.before_first()

    # -- consumer surface ----------------------------------------------------
    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def next_batch(self):
        """The next batch (a ``("fused", buf, meta, rows)`` item with
        ``emit="host"``), or None at the end of the epoch."""
        item = self._iter.next()
        if item is None:
            return None
        if self.emit == "device":
            return self._handoff(item)
        view, meta, rows, buf = item
        self._check_frame(view, meta)
        self._count(rows)
        return ("fused", buf, int(meta), rows)

    def recycle(self, buf) -> None:
        """Hand a consumed host frame buffer back (``emit="host"``)."""
        self._pool.put(buf)

    def before_first(self) -> None:
        """Reconnect to every worker for the next epoch."""
        self._iter.before_first()

    def close(self) -> None:
        with self._gen_lock:
            self._closed = True
            self._cancel_readers(self._frame_holder["state"])
            self._frame_holder["state"] = None
        self._frames.destroy()
        if self._iter is not self._frames:
            self._iter.destroy()
        self._drain_inflight()
        self._pool.clear()

    def __enter__(self) -> "RemoteIngestLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_STR_KEYS = ("cache", "device")


def ingest_worker_main(argv=None) -> int:
    """CLI: ``URI PART NPARTS FMT PORT [key=value ...]`` (the JAX
    ``dmlc-ingest-worker``'s arguments, plus ``device=cuda|cpu``, the
    trainer's device type, which picks the wire)."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 5:
        print("usage: python -m dmlc_core_tpu_torch.pipeline.ingest_service "
              "<uri> <part> <nparts> <fmt> <port> [batch_rows=N] "
              "[nnz_cap=N] [id_mod=N] [max_epochs=N] [cache=PATH] "
              "[device=cuda|cpu]", file=sys.stderr)
        return 2
    try:
        uri, part, nparts, fmt, port = (args[0], int(args[1]),
                                        int(args[2]), args[3], int(args[4]))
        kw = dict(batch_rows=16384, nnz_cap=512 * 1024, id_mod=0)
        for a in args[5:]:
            k, v = a.split("=", 1)
            kw[k] = v if k in _STR_KEYS else int(v)
        if kw.get("device", "cuda") not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got "
                             f"{kw['device']!r}")
    except ValueError as e:
        print(f"ingest_service: {e}", file=sys.stderr)
        return 2
    serve_ingest(uri, part, nparts, fmt, port=port, **kw)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(ingest_worker_main())
