"""Trace context propagation and in-process span recording.

Counterpart of ``dmlc_core_tpu/telemetry/trace.py``, copied so that the
port never imports the JAX package; the records are the JAX package's
field for field, so a consumer of either package's spans reads the
other's.  Cheaper per span than the JAX module (every served request
records three, one of them on the batcher's serial thread): ids are
drawn without a lock, :func:`span` and :func:`activate` are plain
context-manager classes, the ring keeps its ``telemetry.spans_dropped``
handle, and a finished span goes into the ring as it is: its record
(ids in hex, attributes made JSON-safe) is built when the ring is read.

``utils.metrics`` answers *how much / how fast*; this module answers
*where did this request go*.  A :class:`TraceContext` is a pair of ids
(``trace_id`` for the whole request tree, ``span_id`` for the current
operation) carried in a ``contextvars.ContextVar``, so it follows the
logical call chain without an argument in every signature.  Crossing a
thread or a wire is explicit: pack :func:`wire_ids` into the message
(the serving protocol carries them in the request header) and
:func:`activate` the reconstructed context on the other side.

Finished spans land in a process-global lock-protected ring buffer
(:class:`SpanRecorder`, ``DMLC_SPAN_BUFFER`` records, 4096 by default;
each eviction counts on ``telemetry.spans_dropped``).  The consumer is
:mod:`.chrome_trace` (Perfetto export).

Usage::

    with span("serving.client.predict", rows=4):        # scoped span
        ...                                             # children nest

    s = start_span("serving.server.request", parent=ctx)  # manual span
    ...                                                   # (async paths)
    s.end(status="OK")

    add_event("retry", attempt=2)   # annotate the active span, if any
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Union

from ..utils.metrics import metrics
from ..utils.parameter import get_env

__all__ = [
    "TraceContext", "Span", "SpanRecorder", "recorder", "current",
    "current_trace_id", "new_trace_id", "start_span", "span", "activate",
    "add_event", "format_id", "wire_ids", "from_wire", "set_sampler",
    "get_sampler", "record_span",
]


class TraceContext(NamedTuple):
    """Wire-portable identity of an in-progress span: 64-bit non-zero
    ``trace_id`` shared by every span of one request tree, plus the
    ``span_id`` new children must name as their parent."""

    trace_id: int
    span_id: int


def format_id(v: int) -> str:
    """Canonical hex rendering (what logs/exports show)."""
    return f"{v & 0xFFFFFFFFFFFFFFFF:016x}"


# the process id a record names, kept apart from a syscall a span
_pid = os.getpid()


def _after_fork() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_after_fork)

# one RNG for id generation; os.urandom-seeded so forked workers diverge.
# getrandbits is one C call, atomic under the interpreter lock
_id_rng = random.Random(int.from_bytes(os.urandom(8), "little"))


def new_trace_id() -> int:
    """Random non-zero 63-bit id, uniform on [1, 2^63) (zero is the
    wire's 'untraced' marker; bit 63 is reserved as the tail sampler's
    ``debug=1`` force-keep flag, so it is never minted by accident)."""
    while True:
        v = _id_rng.getrandbits(63)
        if v:
            return v


class SpanRecorder:
    """Lock-protected ring buffer of finished span/event records.

    :meth:`snapshot` returns plain JSON-ready dicts (see
    :meth:`Span.record` for the schema); a finished :class:`Span` is kept
    as it is and rendered once, when it is first read.  Bounded by
    ``capacity`` (env ``DMLC_SPAN_BUFFER``): under sustained load old
    spans fall off the back — observability must never become the
    memory leak it exists to find.
    """

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=max(1, int(capacity)))
        self._dropped = 0
        self._m_gen = -1
        self._m_dropped = None

    def record(self, rec: Any) -> None:
        """Append a record, or a finished span (anything with a
        ``record()`` method) to render when read."""
        with self._lock:
            evicted = len(self._buf) == self._buf.maxlen
            if evicted:
                self._dropped += 1
            self._buf.append(rec)
        if evicted:
            # a consumer of a lossy window must be able to see that it
            # is lossy; the handle is fetched again after a reset
            if self._m_gen != metrics.generation:
                self._m_gen = metrics.generation
                self._m_dropped = metrics.counter("telemetry.spans_dropped")
            self._m_dropped.add(1)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._buf)
        return [r if isinstance(r, dict) else r.record() for r in recs]

    @property
    def dropped(self) -> int:
        """Records evicted by the ring since construction/clear()."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


#: process-global recorder (the Chrome export reads it)
recorder = SpanRecorder(capacity=get_env("DMLC_SPAN_BUFFER", 4096))

# Optional tail sampler (telemetry.sampling.TailSampler) interposed
# between span completion and the recorder.  None (the default) keeps the
# record-everything behaviour.
_sampler: Optional[Any] = None


def set_sampler(sampler: Optional[Any]) -> None:
    """Install (or with None, remove) the tail-sampling hook.  The
    sampler must expose ``on_start(trace_id)``, ``on_end(trace_id,
    span)`` (a finished :class:`Span`, or a record dict) and
    ``on_event(trace_id_or_none, rec)``."""
    global _sampler
    _sampler = sampler


def get_sampler() -> Optional[Any]:
    return _sampler

# The active node of the logical call chain: a live Span in-process, or a
# bare TraceContext re-activated after crossing a thread/wire boundary.
_current: contextvars.ContextVar[Optional[Union["Span", TraceContext]]] = \
    contextvars.ContextVar("dmlc_trace", default=None)


def _ids_of(node: Union["Span", TraceContext, None]) -> Optional[TraceContext]:
    if node is None:
        return None
    if isinstance(node, TraceContext):
        return node
    return node.context


def current() -> Optional[TraceContext]:
    """The active trace context (ids only), or None when untraced."""
    return _ids_of(_current.get())


def current_trace_id() -> Optional[str]:
    """Hex trace id of the active context (log-correlation helper)."""
    ctx = current()
    return format_id(ctx.trace_id) if ctx is not None else None


def wire_ids() -> "tuple[int, int]":
    """``(trace_id, span_id)`` of the active context for wire injection;
    ``(0, 0)`` when untraced — zero is the wire's 'untraced' marker, so
    senders can pack unconditionally (the serving header convention,
    shared by the data-service JSON RPCs)."""
    ctx = current()
    return (ctx.trace_id, ctx.span_id) if ctx is not None else (0, 0)


def from_wire(trace_id: Any, span_id: Any) -> Optional[TraceContext]:
    """Reconstruct a remote parent from wire ids.  A zero, absent, or
    malformed trace id means the request is untraced → ``None`` (safe to
    hand straight to :func:`activate` / ``start_span(parent=...)``)."""
    try:
        tid, sid = int(trace_id or 0), int(span_id or 0)
    except (TypeError, ValueError):
        return None
    if tid == 0:
        return None
    return TraceContext(tid, sid)


class Span:
    """One timed operation.  Created via :func:`start_span` / :func:`span`;
    finished exactly once with :meth:`end` (idempotent — async completion
    paths may race a cleanup path)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "events", "_t0_wall", "_t0_mono", "_tid", "_thread",
                 "_ended", "_dur_us", "_pid", "_rec")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int], attrs: Dict[str, Any]) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        t = threading.current_thread()
        self._tid = t.ident or 0
        self._thread = t.name
        self._ended = False
        self._rec: Optional[Dict[str, Any]] = None

    @property
    def context(self) -> TraceContext:
        """What children (local or remote) name as their parent."""
        return TraceContext(self.trace_id, self.span_id)

    @property
    def dur_us(self) -> int:
        """The finished span's duration (what its record's ``dur_us``
        says)."""
        return self._dur_us

    def event(self, name: str, **attrs: Any) -> None:
        """Attach a point-in-time annotation (retry, breaker trip, ...)."""
        self.events.append({
            "name": name,
            "ts_us": int(time.time() * 1e6),
            "attrs": _jsonable(attrs),
        })

    def end(self, **attrs: Any) -> None:
        """Finish the span and push it into the ring buffer, or hand it
        to the tail sampler (its record is rendered when the ring is
        read, off the caller's path, either way)."""
        if self._ended:
            return
        self._ended = True
        self._dur_us = max(0, int((time.monotonic() - self._t0_mono) * 1e6))
        self._pid = _pid
        if attrs:
            self.attrs.update(attrs)
        s = _sampler
        if s is not None:
            s.on_end(self.trace_id, self)
        else:
            recorder.record(self)

    def record(self) -> Dict[str, Any]:
        """The finished span's record: the JAX package's schema, field
        for field (built once)."""
        rec = self._rec
        if rec is None:
            rec = self._rec = {
                "kind": "span",
                "name": self.name,
                "trace_id": format_id(self.trace_id),
                "span_id": format_id(self.span_id),
                "parent_id": (format_id(self.parent_id)
                              if self.parent_id else None),
                "ts_us": int(self._t0_wall * 1e6),
                "dur_us": self._dur_us,
                "pid": self._pid,
                "tid": self._tid,
                "thread": self._thread,
                "attrs": _jsonable(self.attrs),
                "events": self.events,
            }
        return rec


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Attrs must survive json.dumps — coerce exotic values to str."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            try:
                json.dumps(v)
                out[k] = v
            except (TypeError, ValueError):
                out[k] = str(v)
    return out


class _TimedSpan:
    """A span its caller timed and finished (:func:`record_span`): its
    ids are drawn, and its record built, when the ring is read."""

    __slots__ = ("name", "parent", "t0_wall", "dur_us", "pid", "thread",
                 "attrs", "_rec")

    def record(self) -> Dict[str, Any]:
        rec = self._rec
        if rec is None:
            p = self.parent
            trace_id = p.trace_id if p is not None else new_trace_id()
            rec = self._rec = {
                "kind": "span",
                "name": self.name,
                "trace_id": format_id(trace_id),
                "span_id": format_id(new_trace_id()),
                "parent_id": (format_id(p.span_id)
                              if p is not None and p.span_id else None),
                "ts_us": int(self.t0_wall * 1e6),
                "dur_us": self.dur_us,
                "pid": self.pid,
                "tid": self.thread.ident or 0,
                "thread": self.thread.name,
                "attrs": _jsonable(self.attrs),
                "events": [],
            }
        return rec


def record_span(name: str, t0_wall: float, t0_mono: float,
                **attrs: Any) -> None:
    """Record a span that began at ``time.time()`` ``t0_wall`` /
    ``time.monotonic()`` ``t0_mono`` and ends now, a child of the ambient
    context (or a new root), with the record :class:`span` would make.
    It is never the active context, so it can have no children: for a
    leaf on a serial hot path (the engine's forward), where it costs two
    clock reads, a context lookup and a ring append."""
    parent = current()
    if _sampler is not None:
        # the sampler sees ids at start and end: a full span
        sp = start_span(name, parent=parent, **attrs)
        sp._t0_wall, sp._t0_mono = t0_wall, t0_mono
        sp.end()
        return
    t = _TimedSpan()
    t.name, t.parent, t.t0_wall, t.attrs = name, parent, t0_wall, attrs
    t.dur_us = max(0, int((time.monotonic() - t0_mono) * 1e6))
    t.pid = _pid
    t.thread = threading.current_thread()
    t._rec = None
    recorder.record(t)


def start_span(name: str, parent: Optional[TraceContext] = None,
               **attrs: Any) -> Span:
    """Create a span WITHOUT activating it (async server paths hold the
    object and ``end()`` it from a completion callback).  ``parent``
    defaults to the ambient context; with neither, the span roots a new
    trace."""
    if parent is None:
        parent = current()
    if parent is None:
        trace_id, parent_id = new_trace_id(), None
    else:
        trace_id, parent_id = parent.trace_id, parent.span_id
    s = _sampler
    if s is not None:
        s.on_start(trace_id)
    return Span(name, trace_id, new_trace_id(), parent_id, attrs)


class span:
    """Scoped span: ``with span(name, **attrs) as s:``, a child of the
    ambient context, active for the block, ended on exit (an exception
    is recorded as ``error`` before it propagates)."""

    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, **attrs: Any) -> None:
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        self._span = start_span(self._name, **self._attrs)
        self._token = _current.set(self._span)
        return self._span

    def __exit__(self, etype, exc, tb) -> bool:
        try:
            _current.reset(self._token)
        except ValueError:
            # a span opened inside a generator dies wherever the
            # generator is finalized: GC can close an abandoned iterator
            # from another thread's context, where this token is foreign.
            # The span still ends; only the ambient-context pop is moot.
            pass
        if etype is not None:
            self._span.end(error=f"{etype.__name__}: {exc}")
        else:
            self._span.end()
        return False


class activate:
    """Re-enter a context that crossed a thread or wire boundary (ids
    only — the originating span keeps ownership of its record).  ``None``
    is a no-op so call sites need no branching."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]) -> None:
        self._ctx = ctx

    def __enter__(self) -> None:
        if self._ctx is not None:
            self._token = _current.set(self._ctx)

    def __exit__(self, etype, exc, tb) -> bool:
        if self._ctx is not None:
            _current.reset(self._token)
        return False


def add_event(name: str, **attrs: Any) -> None:
    """Annotate the active span; with only a re-activated context (or no
    trace at all) record a standalone instant event instead, so signals
    like retries are never dropped on untraced paths."""
    node = _current.get()
    if isinstance(node, Span):
        node.event(name, **attrs)
        return
    ctx = _ids_of(node)
    t = threading.current_thread()
    rec = {
        "kind": "event",
        "name": name,
        "trace_id": format_id(ctx.trace_id) if ctx else None,
        "span_id": format_id(ctx.span_id) if ctx else None,
        "ts_us": int(time.time() * 1e6),
        "pid": _pid,
        "tid": t.ident or 0,
        "thread": t.name,
        "attrs": _jsonable(attrs),
    }
    s = _sampler
    if s is not None:
        s.on_event(ctx.trace_id if ctx else None, rec)
    else:
        recorder.record(rec)
