"""Tail-based trace sampling: decide keep/drop per *trace*, after the fact.

Counterpart of ``dmlc_core_tpu/telemetry/sampling.py``, copied so that
the port never imports the JAX package: the same hash floor (``_mix``
and :func:`hash_keep` give the JAX bits, so a JAX router and a port
replica reach one verdict on one trace id), the same buffer, token
bucket, verdicts, counters and environment knobs.  One difference, for
the cost on a serial thread: a finished :class:`~.trace.Span` reaches
the buffer as it is, and its record is built when the ring is read (the
decision reads the span's fields, never its record), so a kept span
costs the batcher's thread no rendering and a dropped one is never
rendered at all.

The recorder ring (``trace.py``) keeps every span, so at production
rates the traces worth keeping — the p99 stragglers, the hedged
resubmits, the SLO-breach windows — are evicted by a flood of healthy
requests within milliseconds.  Head sampling (flip a coin at the root)
cannot fix that: the whole point of a trace is that you do not know it
will be interesting until it is over.  This module:

* finished spans buffer per ``trace_id`` in a bounded
  :class:`TraceBuffer` until every locally-open span of the trace has
  ended (or ``DMLC_TRACE_DECIDE_TIMEOUT_S`` passes);
* a :class:`TailSampler` then keeps the trace iff any span errored, the
  local root ran longer than ``DMLC_TRACE_KEEP_SLOW_MS`` (default:
  adaptive — the live p95 of that root span name, fed through the
  registry and readable back from the ``HistoryStore``), an
  SLO/burn breach was active, or the trace falls inside the consistent
  hash floor ``DMLC_TRACE_SAMPLE``;
* the hash floor is a pure function of the ``trace_id`` already carried
  in the serving request header, so every tier reaches the **same**
  verdict for the same trace without exchanging a byte;
* a token bucket (``DMLC_TRACE_KEEP_PER_S``) bounds the keep rate;
  error/debug keeps always pass but still debit the bucket, so the
  total stays near budget while nothing alarming is lost;
* bit 63 of the wire ``trace_id`` is the ``debug=1`` flag
  (:func:`mark_debug`): it rides the serving header unchanged and forces
  keep on every tier.

Kept traces flow into the :data:`~.trace.recorder` (and from there to
``/spans``, the Chrome export and flight bundles) unchanged.  Drops are
counted (``telemetry.sampling.{dropped,dropped_spans}``), never silent.

The sampler is *opt-in*: :func:`maybe_install_from_env` installs it only
when ``DMLC_TRACE_SAMPLE`` is set, so untraced deployments keep the
record-everything behaviour.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..utils.metrics import metrics
from ..utils.parameter import get_env
from . import trace as _trace
from .timeseries import history

__all__ = [
    "DEBUG_BIT", "TailSampler", "TraceBuffer", "hash_keep", "is_debug",
    "mark_debug", "debug_trace_id", "get_sampler", "install", "uninstall",
    "maybe_install_from_env", "was_kept",
]

_M64 = (1 << 64) - 1
#: bit 63 of the wire trace id: the end-to-end force-keep ("debug") flag.
#: :func:`~.trace.new_trace_id` only mints 63-bit ids, so the bit is
#: never set by accident — only by :func:`mark_debug` at the edge.
DEBUG_BIT = 1 << 63
_ID_MASK = DEBUG_BIT - 1

#: statuses that do NOT make a trace an error trace
_OK_STATUSES = {"OK", "ok", None}


def _attrs(rec: Any) -> Dict[str, Any]:
    """The attributes of a record dict or of a finished span."""
    if isinstance(rec, dict):
        return rec.get("attrs") or {}
    return rec.attrs


def _span_view(rec: Any) -> Optional[Tuple[Any, Any, int, str]]:
    """``(span_id, parent_id, dur_us, name)`` of a span record or a
    finished span, the ids in the record's hex; None for an event."""
    if isinstance(rec, dict):
        if rec.get("kind") != "span":
            return None
        return (rec.get("span_id"), rec.get("parent_id"),
                rec.get("dur_us", 0), rec.get("name"))
    return (_trace.format_id(rec.span_id),
            _trace.format_id(rec.parent_id) if rec.parent_id else None,
            rec.dur_us, rec.name)


def is_debug(trace_id: int) -> bool:
    """True when the wire id carries the force-keep bit."""
    return bool(int(trace_id) & DEBUG_BIT)


def mark_debug(ctx: "_trace.TraceContext") -> "_trace.TraceContext":
    """Stamp the debug bit onto a context; every tier the ids reach
    (the serving header) then force-keeps the trace regardless of
    sampling verdicts."""
    return _trace.TraceContext(ctx.trace_id | DEBUG_BIT, ctx.span_id)


def debug_trace_id() -> int:
    """A fresh trace id with the force-keep bit already set."""
    return _trace.new_trace_id() | DEBUG_BIT


def _mix(trace_id: int) -> int:
    """splitmix64-style finalizer: a stable, well-distributed hash of
    the id that every process computes identically (``hash()`` is
    randomized per process and would break cross-tier agreement)."""
    x = (int(trace_id) & _ID_MASK) or 1
    x = ((x ^ (x >> 33)) * 0xFF51AFD7ED558CCD) & _M64
    x = ((x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53) & _M64
    return (x ^ (x >> 33)) & _M64


def hash_keep(trace_id: int, floor: float) -> bool:
    """Consistent hash floor: the same ``trace_id`` lands on the same
    side of ``floor`` in every process, so tiers agree coordination-free."""
    if floor >= 1.0:
        return True
    if floor <= 0.0:
        return False
    return _mix(trace_id) < int(floor * float(1 << 64))


class _TokenBucket:
    """Keep-rate bound.  ``rate <= 0`` means unlimited.  ``take(force=
    True)`` (error/debug keeps) always succeeds but still debits, so
    forced keeps push the bucket into debt and healthy keeps pay it
    back — total keep rate stays near budget."""

    def __init__(self, rate: float, burst: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate)
        self._tokens = self.burst
        self._t = time.monotonic()

    def take(self, *, force: bool = False, now: Optional[float] = None
             ) -> bool:
        if self.rate <= 0:
            return True
        if now is None:
            now = time.monotonic()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= 1.0 or force:
            self._tokens -= 1.0
            return True
        return False


class _Group:
    """All buffered records of one trace on this process, plus the count
    of spans started but not yet ended locally."""

    __slots__ = ("trace_id", "t0", "open", "records")

    def __init__(self, trace_id: int, t0: float) -> None:
        self.trace_id = trace_id
        self.t0 = t0
        self.open = 0
        self.records: List[Dict[str, Any]] = []


class TraceBuffer:
    """Bounded per-trace staging area for finished span records.

    ``on_start``/``on_end`` mirror the local span lifecycle; when the
    open count of a trace returns to zero (the local root ended) the
    owner's ``decide`` callback fires with the full group.  Groups older
    than ``decide_timeout_s`` are decided on whatever is buffered, and
    when the total buffered span count would exceed ``max_spans`` the
    oldest group is force-decided — the buffer can stall a verdict, but
    it can never grow without bound or swallow spans silently.
    """

    def __init__(self, decide, *, max_spans: int = 8192,
                 decide_timeout_s: float = 5.0) -> None:
        self._decide = decide
        self.max_spans = max(1, int(max_spans))
        self.decide_timeout_s = max(0.05, float(decide_timeout_s))
        self._lock = threading.Lock()
        self._groups: "OrderedDict[int, _Group]" = OrderedDict()
        self._spans = 0
        self._last_sweep = 0.0

    def __len__(self) -> int:
        with self._lock:
            return self._spans

    def on_start(self, trace_id: int, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            g = self._groups.get(trace_id)
            if g is None:
                g = self._groups[trace_id] = _Group(trace_id, now)
            g.open += 1
        self._sweep(now)

    def on_end(self, trace_id: int, rec: Dict[str, Any],
               now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        done: List[_Group] = []
        with self._lock:
            g = self._groups.get(trace_id)
            if g is None:
                # sampler installed mid-span, or a span whose start
                # predates the buffer: a group of its own, decided now
                g = _Group(trace_id, now)
                g.records.append(rec)
                done.append(g)
            else:
                g.records.append(rec)
                self._spans += 1
                g.open -= 1
                if g.open <= 0:
                    self._groups.pop(trace_id, None)
                    self._spans -= len(g.records)
                    done.append(g)
            while self._spans > self.max_spans and self._groups:
                _tid, old = self._groups.popitem(last=False)
                self._spans -= len(old.records)
                metrics.counter("telemetry.sampling.overflow").add(1)
                done.append(old)
        for g in done:
            self._decide(g, timed_out=False)
        self._sweep(now)

    def attach(self, trace_id: int, rec: Dict[str, Any]) -> bool:
        """Buffer a standalone event record with its trace's group.
        False when no group is open (caller applies the cached verdict
        or records directly)."""
        with self._lock:
            g = self._groups.get(trace_id)
            if g is None:
                return False
            g.records.append(rec)
            self._spans += 1
        return True

    def flush_expired(self, now: Optional[float] = None) -> int:
        """Decide every group older than the timeout on whatever is
        buffered (remote-rooted traces whose parent never ends locally,
        leaked spans).  Returns the number of groups decided."""
        if now is None:
            now = time.monotonic()
        expired: List[_Group] = []
        with self._lock:
            cutoff = now - self.decide_timeout_s
            for tid in list(self._groups):
                g = self._groups[tid]
                if g.t0 > cutoff:
                    break           # insertion-ordered: the rest is newer
                del self._groups[tid]
                self._spans -= len(g.records)
                expired.append(g)
        for g in expired:
            metrics.counter("telemetry.sampling.timeouts").add(1)
            self._decide(g, timed_out=True)
        return len(expired)

    def _sweep(self, now: float) -> None:
        # cheap lazy expiry: at most one pass per second, driven by the
        # span lifecycle itself (no background thread to leak).  The
        # first check is deliberately lock-free — it runs on every span
        # end, and a stale read just defers the sweep to the next span
        if now - self._last_sweep < 1.0:
            return
        with self._lock:
            if now - self._last_sweep < 1.0:
                return
            self._last_sweep = now
        self.flush_expired(now)


class TailSampler:
    """Keep/drop verdicts over completed trace groups.

    Installed via :func:`install` it intercepts the recorder feed in
    ``trace.py``; kept groups flush into the untouched global
    :data:`~.trace.recorder`, dropped ones are counted and discarded.
    Verdicts are cached (bounded) so late spans and exemplar lookups
    (:func:`was_kept`) agree with the decision.
    """

    def __init__(self, *, floor: Optional[float] = None,
                 keep_per_s: Optional[float] = None,
                 keep_slow_ms: Optional[float] = None,
                 decide_timeout_s: Optional[float] = None,
                 max_spans: Optional[int] = None,
                 recorder: Optional["_trace.SpanRecorder"] = None) -> None:
        if floor is None:
            floor = float(get_env("DMLC_TRACE_SAMPLE", 0.01))
        if keep_per_s is None:
            keep_per_s = float(get_env("DMLC_TRACE_KEEP_PER_S", 0.0))
        if keep_slow_ms is None:
            raw = get_env("DMLC_TRACE_KEEP_SLOW_MS", None)
            keep_slow_ms = float(raw) if raw is not None else 0.0
        if decide_timeout_s is None:
            decide_timeout_s = float(get_env("DMLC_TRACE_DECIDE_TIMEOUT_S",
                                             5.0))
        if max_spans is None:
            max_spans = int(get_env("DMLC_TRACE_BUFFER_SPANS", 8192))
        self.floor = max(0.0, min(1.0, float(floor)))
        #: 0 = adaptive (live p95 of the root span name)
        self.keep_slow_ms = max(0.0, float(keep_slow_ms))
        self.recorder = recorder if recorder is not None else _trace.recorder
        self._bucket = _TokenBucket(keep_per_s)
        self.buffer = TraceBuffer(self._decide, max_spans=max_spans,
                                  decide_timeout_s=decide_timeout_s)
        self._lock = threading.Lock()
        self._verdicts: "OrderedDict[int, bool]" = OrderedDict()
        self._verdict_cap = 4096
        #: root name → (expires_at, threshold) — the adaptive slow
        #: threshold reads a histogram snapshot (a quantile sort); once
        #: per second per root is signal enough, per-decide is not
        self._thr_cache: Dict[str, Tuple[float, Optional[float]]] = {}
        self._bind()

    # -- trace.py hook surface ------------------------------------------
    def on_start(self, trace_id: int) -> None:
        # sticky verdicts: a span of an already-decided trace must not
        # reopen a group (each late tier-span would otherwise trigger a
        # fresh decision — and a fresh adaptive-p95 computation — per
        # span, tripling the sampler's cost on multi-span traces)
        if self.verdict(trace_id) is None:
            self.buffer.on_start(trace_id)

    def on_end(self, trace_id: int, rec: Dict[str, Any]) -> None:
        v = self.verdict(trace_id)
        if v is None:
            self.buffer.on_end(trace_id, rec)
        elif v:
            self.recorder.record(rec)
        else:
            if self._mgen != metrics.generation:
                self._bind()
            self._m_dropped_spans.add(1)

    def on_event(self, trace_id: Optional[int], rec: Dict[str, Any]) -> None:
        """Standalone instant events: buffered with their trace when one
        is open, else routed by the cached verdict, else recorded
        directly (untraced events — breaker trips etc. — always land)."""
        if trace_id is None:
            self.recorder.record(rec)
            return
        if self.buffer.attach(trace_id, rec):
            return
        if self.verdict(trace_id) is False:
            if self._mgen != metrics.generation:
                self._bind()
            self._m_dropped_spans.add(1)
            return
        self.recorder.record(rec)

    # -- verdicts --------------------------------------------------------
    def verdict(self, trace_id: int) -> Optional[bool]:
        """Cached keep/drop for a decided trace; None while undecided.

        Lock-free read on the span hot path: ``dict.get`` is atomic
        under the GIL and ``_cache`` is the only writer (under
        ``_lock``) — the worst race returns ``None`` for a verdict
        cached this instant, which just routes one span through the
        buffer's decided-group path."""
        return self._verdicts.get(int(trace_id) & _ID_MASK)

    def was_kept(self, trace_hex: Optional[str]) -> Optional[bool]:
        """Verdict lookup by the hex id records/exemplars carry."""
        if not trace_hex:
            return None
        try:
            return self.verdict(int(trace_hex, 16))
        except ValueError:
            return None

    def flush(self) -> None:
        """Decide every buffered group now (tests, shutdown paths)."""
        self.buffer.flush_expired(now=time.monotonic()
                                  + self.buffer.decide_timeout_s + 1.0)

    def _cache(self, trace_id: int, keep: bool) -> None:
        with self._lock:
            self._verdicts[int(trace_id) & _ID_MASK] = keep
            while len(self._verdicts) > self._verdict_cap:
                self._verdicts.popitem(last=False)

    # -- the decision ----------------------------------------------------
    @staticmethod
    def _is_error(rec: Any) -> bool:
        attrs = _attrs(rec)
        if attrs.get("error") is not None:
            return True
        return attrs.get("status") not in _OK_STATUSES

    @staticmethod
    def _root_of(records: List[Any]) -> Optional[Tuple[Any, Any, int, str]]:
        """The local root's ``(span_id, parent_id, dur_us, name)``: a span
        whose parent ended elsewhere (or nowhere).  Longest such span
        wins when several qualify."""
        spans = [v for v in map(_span_view, records) if v is not None]
        if not spans:
            return None
        local = {v[0] for v in spans}
        roots = [v for v in spans if not v[1] or v[1] not in local]
        return max(roots or spans, key=lambda v: v[2])

    def _slow_threshold_ms(self, root_name: str) -> Optional[float]:
        """Explicit knob, or adaptive: the live p95 of this root span
        name — preferring the HistoryStore series (it survives registry
        resets and powers ``/timeline``), falling back to the live
        histogram the sampler itself feeds."""
        if self.keep_slow_ms > 0:
            return self.keep_slow_ms
        now = time.monotonic()
        hit = self._thr_cache.get(root_name)
        if hit is not None and hit[0] > now:
            return hit[1]
        series = f"telemetry.trace.root_ms.{root_name}"
        pts = history.query(series + ".p95", since=300.0)
        if pts:
            thr: Optional[float] = pts[-1][1]
        else:
            snap = metrics.histogram(series).snapshot()
            thr = (float(snap["p95"]) if snap.get("count", 0) >= 50
                   else None)      # not enough signal yet — no slow keeps
        if len(self._thr_cache) >= 256:      # root names are bounded by
            self._thr_cache.clear()          # the span vocabulary anyway
        self._thr_cache[root_name] = (now + 1.0, thr)
        return thr

    def _bind(self) -> None:
        """(Re)resolve metric handles for the current registry
        generation — the decide path runs per trace, and a registry
        lookup (lock + dict) per counter per trace is measurable at
        production rates.  ``metrics.reset()`` bumps ``generation``, so
        cached handles never go stale across test resets."""
        self._mgen = metrics.generation
        self._m_slo = metrics.gauge("slo.active_breaches")
        self._m_throttled = metrics.counter("telemetry.sampling.throttled")
        self._m_kept = metrics.counter("telemetry.sampling.kept")
        self._m_dropped = metrics.counter("telemetry.sampling.dropped")
        self._m_dropped_spans = metrics.counter(
            "telemetry.sampling.dropped_spans")
        self._m_keep: Dict[str, Any] = {}
        self._m_root: Dict[str, Any] = {}

    def _decide(self, group: _Group, *, timed_out: bool) -> None:
        records = group.records
        if not records:
            return
        if self._mgen != metrics.generation:
            self._bind()
        tid = group.trace_id
        reason = None
        if is_debug(tid):
            reason = "debug"
        elif any(self._is_error(r) for r in records):
            reason = "error"
        elif self._m_slo.value > 0:
            reason = "slo"
        root = self._root_of(records)
        if root is not None and not timed_out:
            # feed the adaptive threshold with *every* root latency —
            # the p95 must reflect all traffic, not just kept traces
            dur_ms = root[2] / 1e3
            name = root[3]
            h = self._m_root.get(name)
            if h is None:
                # 512 reservoir samples give a stable-enough p95 and keep
                # the once-per-second threshold snapshot's sort cheap
                h = self._m_root[name] = metrics.histogram(
                    f"telemetry.trace.root_ms.{name}", max_samples=512)
            h.observe(dur_ms)
            if reason is None:
                thr = self._slow_threshold_ms(name)
                if thr is not None and dur_ms > thr:
                    reason = "slow"
        if reason is None and hash_keep(tid, self.floor):
            reason = "floor"
        if reason is None:
            keep = False
        elif reason in ("debug", "error"):
            keep = True
            self._bucket.take(force=True)
        else:
            keep = self._bucket.take()
            if not keep:
                self._m_throttled.add(1)
        self._cache(tid, keep)
        if keep:
            self._m_kept.add(1)
            c = self._m_keep.get(reason)
            if c is None:
                c = self._m_keep[reason] = metrics.counter(
                    f"telemetry.sampling.keep_{reason}")
            c.add(1)
            for rec in records:
                self.recorder.record(rec)
        else:
            self._m_dropped.add(1)
            self._m_dropped_spans.add(len(records))


# -- installation ---------------------------------------------------------

def get_sampler() -> Optional[TailSampler]:
    """The installed sampler (what trace.py feeds), or None."""
    return _trace.get_sampler()


def install(sampler: TailSampler) -> TailSampler:
    """Route the span feed through ``sampler`` (replacing any prior)."""
    _trace.set_sampler(sampler)
    return sampler


def uninstall() -> None:
    """Restore record-everything behaviour."""
    _trace.set_sampler(None)


def was_kept(trace_hex: Optional[str]) -> Optional[bool]:
    """Module-level verdict lookup: True/False once decided, None when
    undecided or when no sampler is installed (everything is kept)."""
    s = get_sampler()
    if s is None:
        return None
    return s.was_kept(trace_hex)


def maybe_install_from_env() -> Optional[TailSampler]:
    """Install a :class:`TailSampler` iff ``DMLC_TRACE_SAMPLE`` is set
    (the opt-in switch), idempotently — every tier's startup path calls
    this, matching the ``maybe_*_from_env`` convention of
    flight/anomaly/timeseries."""
    if get_env("DMLC_TRACE_SAMPLE", None) is None:
        return None
    existing = get_sampler()
    if existing is not None:
        return existing
    return install(TailSampler())
