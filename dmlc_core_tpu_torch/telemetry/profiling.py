"""Stdlib sampling stack profiler — the incident-time "what is every
thread doing" answer, with zero dependencies and zero cost when idle.

Counterpart of ``dmlc_core_tpu/telemetry/profiling.py``, copied so that
the port never imports the JAX package: the same sampler, collapsed
format, window bounds, baseline and diff text, byte for byte.  Frames
are labelled ``module:function``, so the port's show as
``dmlc_core_tpu_torch.<module>:<function>``.  It samples Python stacks
only: what the card runs is ``utils.metrics.profile_trace``'s.

``py-spy``/``perf`` cannot be assumed on a worker image, and cProfile
is a tracing profiler: its per-call hook is far too heavy to leave armed
in a serving or ingest hot loop.  A *sampling* profiler pays only at the
sample clock: a daemon thread wakes at ``DMLC_PROFILE_HZ`` (default 67 —
deliberately co-prime with 10 ms scheduler ticks so samples do not beat
against the interpreter's own switch interval), snapshots every thread's
stack via :func:`sys._current_frames`, and folds each stack into
collapsed form (``mod:func;mod:func <count>`` — the flamegraph.pl /
speedscope interchange format), so a profile window is a text blob small
enough to ride inside an incident bundle.

Three entry points, by audience:

* :class:`SamplingProfiler` — own the window yourself (tests, long
  experiments): ``start()`` / ``stop()`` / ``collapsed()``.
* :func:`profile_for` — one bounded window, returns the collapsed text;
  this is what a ``TelemetryServer`` mounts at ``/profile?seconds=N``
  (the HTTP thread blocks for the window; the server is threading, so
  concurrent scrapes still get /metrics).
* :func:`incident_profile` — the flight-recorder hook: a short window
  (``DMLC_FLIGHT_PROFILE_S``, default 0.25 s) captured *inside*
  ``bundle()`` so every stall/SLO incident carries the stacks that were
  running when the trigger fired, not a reconstruction after the fact.

Sampler accounting lands in ``utils.metrics`` (``profile.samples``) so a
forgotten always-on profiler is visible in any snapshot.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, Optional

from ..utils.metrics import metrics
from ..utils.parameter import get_env

__all__ = ["SamplingProfiler", "profile_for", "incident_profile",
           "diff_collapsed", "record_baseline", "baseline",
           "incident_profile_diff"]

#: default sample rate; co-prime with common 10 ms scheduler quanta
_DEFAULT_HZ = 67.0
#: hard bounds on a /profile window — a scrape must not pin an HTTP
#: thread for minutes, and a sub-10ms window cannot hold even one sample
_MIN_WINDOW_S = 0.05
_MAX_WINDOW_S = 60.0


def _frame_label(frame) -> str:
    """``module:function`` — stable across hosts (no absolute paths), the
    granularity flamegraphs aggregate well at."""
    code = frame.f_code
    mod = frame.f_globals.get("__name__", "?")
    return f"{mod}:{code.co_name}"


class SamplingProfiler:
    """Fold ``sys._current_frames`` samples into collapsed stacks.

    Thread-safe; one sampler thread per instance.  Stacks are keyed
    root-first (outermost frame leftmost), matching what flamegraph
    tooling expects.  ``max_stacks`` bounds the fold table so a pathological
    workload (e.g. generated code with unbounded distinct frames) cannot
    grow memory without bound — overflow folds into a sentinel bucket.
    """

    def __init__(self, hz: Optional[float] = None,
                 max_stacks: int = 10000) -> None:
        if hz is None:
            hz = get_env("DMLC_PROFILE_HZ", _DEFAULT_HZ)
        self.hz = max(1.0, min(1000.0, float(hz)))
        self.max_stacks = int(max_stacks)
        self._counts: Dict[str, int] = {}
        self._samples = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="dmlc-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- sampling --

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(interval):
            self.sample_once(skip_tid=me)

    def sample_once(self, skip_tid: Optional[int] = None) -> None:
        """Take one sample of every live thread (public for tests: a
        deterministic single sample without the wall-clock loop)."""
        frames = sys._current_frames()
        folded = []
        for tid, frame in frames.items():
            if tid == skip_tid:
                continue
            parts = []
            f = frame
            depth = 0
            while f is not None and depth < 128:
                parts.append(_frame_label(f))
                f = f.f_back
                depth += 1
            parts.reverse()
            folded.append(";".join(parts))
        del frames
        with self._lock:
            self._samples += len(folded)
            for stack in folded:
                if stack not in self._counts \
                        and len(self._counts) >= self.max_stacks:
                    stack = "<overflow>"
                self._counts[stack] = self._counts.get(stack, 0) + 1
        metrics.counter("profile.samples").add(len(folded))

    # -- output --

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def collapsed(self) -> str:
        """Collapsed-stack text: one ``stack count`` line per distinct
        stack, heaviest first — feed directly to flamegraph.pl or paste
        into speedscope."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{stack} {n}" for stack, n in items)


def profile_for(seconds: float, hz: Optional[float] = None) -> str:
    """Blocking bounded window → collapsed-stack text (the ``/profile``
    endpoint body).  The window is clamped to [0.05, 60] s: an HTTP
    scrape must terminate, and a shorter window cannot hold a sample."""
    seconds = max(_MIN_WINDOW_S, min(_MAX_WINDOW_S, float(seconds)))
    prof = SamplingProfiler(hz=hz)
    with prof:
        time.sleep(seconds)
    # a very short window on a quiet interpreter can miss the clock
    # entirely; one explicit sample guarantees non-empty output
    if prof.samples == 0:
        prof.sample_once()
    return prof.collapsed()


def incident_profile() -> str:
    """The flight-recorder attachment: one short window sampled at
    incident time (``DMLC_FLIGHT_PROFILE_S``, default 0.25 s — long
    enough for ~16 samples at the default rate, short enough that
    ``bundle()`` stays interactive)."""
    window = get_env("DMLC_FLIGHT_PROFILE_S", 0.25)
    if window <= 0:       # explicit opt-out: profiling disabled
        return ""
    return profile_for(window)


# ---------------------------------------------------------------------------
# profile diffing (r20): incident window vs pre-incident baseline
# ---------------------------------------------------------------------------

def _parse_collapsed(text: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, n = line.rpartition(" ")
        try:
            out[stack] = out.get(stack, 0) + int(n)
        except ValueError:
            continue              # not a collapsed line; ignore
    return out


def diff_collapsed(baseline: str, incident: str) -> str:
    """Differential flamegraph input: the incident profile's share shift
    per stack vs a baseline profile, as annotated collapsed text.

    Both inputs are normalized to *shares* (sample counts divided by the
    profile's total) so windows of different lengths compare honestly.
    One line per stack, largest share growth first::

        <stack> <incident_count> +12.3% (baseline 4.1% -> incident 16.4%)

    Stacks that shrank or vanished follow, prefixed the same way with a
    negative delta — a regression diff must show both what grew and what
    it displaced.  Empty baseline → the incident profile is returned
    annotated as ``(no baseline)`` so callers can always attach *something*.
    """
    inc = _parse_collapsed(incident)
    base = _parse_collapsed(baseline)
    if not base:
        return "\n".join(f"{s} {n} (no baseline)"
                         for s, n in sorted(inc.items(),
                                            key=lambda kv: (-kv[1], kv[0])))
    tot_i = sum(inc.values()) or 1
    tot_b = sum(base.values()) or 1
    rows = []
    for stack in set(inc) | set(base):
        si = inc.get(stack, 0) / tot_i
        sb = base.get(stack, 0) / tot_b
        rows.append((si - sb, stack, inc.get(stack, 0), sb, si))
    rows.sort(key=lambda r: (-r[0], r[1]))
    return "\n".join(
        f"{stack} {n} {d * 100:+.1f}% "
        f"(baseline {sb * 100:.1f}% -> incident {si * 100:.1f}%)"
        for d, stack, n, sb, si in rows)


#: (collapsed_text, unix_ts) of the last healthy-window profile —
#: recorded by plain ``/profile`` scrapes, consumed by ``?diff=1`` and
#: flight bundles
_baseline_lock = threading.Lock()
_baseline: Optional[tuple] = None


def record_baseline(text: str, ts: Optional[float] = None) -> None:
    """Keep ``text`` as the pre-incident baseline profile.  Every plain
    ``/profile`` scrape calls this, so any periodic profile collection
    (cron scrape, dashboard) automatically arms the diff."""
    global _baseline
    if not text:
        return
    with _baseline_lock:
        _baseline = (text, time.time() if ts is None else float(ts))


def baseline() -> Optional[tuple]:
    """The ``(collapsed_text, unix_ts)`` baseline, or None."""
    with _baseline_lock:
        return _baseline


def incident_profile_diff(incident: str) -> str:
    """``profile_diff.txt`` for a flight bundle: the incident window
    diffed against the recorded baseline; "" when no baseline exists
    (the bundle then simply omits the file)."""
    got = baseline()
    if got is None or not incident:
        return ""
    base_text, base_ts = got
    head = (f"# profile diff: baseline @ {base_ts:.0f} "
            f"({time.time() - base_ts:.0f}s ago) vs incident window\n")
    return head + diff_collapsed(base_text, incident)
