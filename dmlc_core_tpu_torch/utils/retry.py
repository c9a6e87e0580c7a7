"""Resilience primitives: retry with backoff, circuit breaker, deadlines.

Counterpart of ``dmlc_core_tpu/utils/retry.py``, copied so that the port
never imports the JAX package; the serving client retries and reconnects
through it.

* :class:`Deadline` — a wall-clock budget threaded through nested calls;
  ``clamp()`` caps every sleep and timeout below what is left of it.
* :class:`RetryPolicy` — bounded attempts with exponential backoff and
  full jitter (delay ~ U[0, min(cap, base·2^attempt)]), a retryable
  predicate and a per-call deadline.  The jitter RNG is seedable.
* :class:`CircuitBreaker` — closed → open after N consecutive failures,
  one half-open probe after a cooldown, closed again on its success.

Env knobs (read by :meth:`RetryPolicy.from_env` /
:meth:`CircuitBreaker.from_env`; each subsystem passes its prefix):
``<PREFIX>_RETRIES`` (total tries), ``<PREFIX>_BACKOFF_BASE``,
``<PREFIX>_BACKOFF_MAX`` (seconds), ``<PREFIX>_DEADLINE`` (seconds, 0 =
unbounded), ``<PREFIX>_BREAKER_THRESHOLD`` and
``<PREFIX>_BREAKER_COOLDOWN``.  Counters: ``retry.<name>.retries`` /
``.exhausted``, ``circuit.<name>.opens`` / ``.fast_fails``.  Each signal
is also an event on the active telemetry span (``retry``,
``retries_exhausted``, ``circuit_open``, ``circuit_probe``,
``circuit_fast_fail``, ``circuit_close``), or a standalone event record
where no span is active.
"""

from __future__ import annotations

import math
import random
import sys
import threading
import time
from typing import Any, Callable, Optional

from .logging import DMLCError, log_warning
from .metrics import metrics
from .parameter import get_env

__all__ = ["Deadline", "DeadlineExpired", "RetryPolicy", "RetriesExhausted",
           "CircuitBreaker", "CircuitOpen"]


def _trace_event(name: str, **attrs: Any) -> None:
    """Mirror a resilience signal onto the active telemetry span, so a
    trace of a slow request shows why it was slow.  Found through
    ``sys.modules`` (never imported here: this module sits below the
    telemetry package); a process without tracing pays one dict miss."""
    mod = sys.modules.get("dmlc_core_tpu_torch.telemetry.trace")
    if mod is None:
        return
    try:
        mod.add_event(name, **attrs)
    except Exception:   # telemetry must never break the retried call
        pass


class DeadlineExpired(DMLCError):
    """The per-call time budget ran out before the operation succeeded."""


class RetriesExhausted(DMLCError):
    """The attempt cap was reached; the last cause is ``__cause__``."""


class CircuitOpen(DMLCError):
    """The breaker is open: the dependency is presumed down; fail fast."""


class Deadline:
    """Wall-clock budget; ``Deadline(None)`` is unbounded (``remaining()``
    is ``inf``)."""

    __slots__ = ("_t_end", "_clock")

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._t_end = None if budget_s is None else clock() + float(budget_s)

    @classmethod
    def unbounded(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> float:
        if self._t_end is None:
            return math.inf
        return self._t_end - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, timeout_s: float) -> float:
        """Bound a sleep or timeout by what is left of the budget."""
        return max(0.0, min(float(timeout_s), self.remaining()))

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExpired(f"{what}: deadline budget exhausted")


def _default_retryable(exc: BaseException) -> bool:
    return isinstance(exc, (OSError, ConnectionError))


class RetryPolicy:
    """Bounded retries with exponential backoff and full jitter.

    ``max_attempts`` counts total tries (1 = no retries); ``retryable``
    decides which exceptions earn another try (default: the ``OSError``
    family); ``deadline_s`` bounds a whole :meth:`call`, sleeps included,
    unless the caller passes its own ``deadline``."""

    def __init__(self, max_attempts: int = 4, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 deadline_s: Optional[float] = None,
                 retryable: Optional[Callable[[BaseException], bool]] = None,
                 seed: Optional[int] = None, name: str = "default",
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = deadline_s
        self.name = name
        self._retryable = retryable or _default_retryable
        self._rng = random.Random(seed)
        self._sleep = sleep

    @classmethod
    def from_env(cls, prefix: str, *, name: str = "", **kw) -> "RetryPolicy":
        kw.setdefault("max_attempts", get_env(f"{prefix}_RETRIES", 4))
        kw.setdefault("base_delay_s", get_env(f"{prefix}_BACKOFF_BASE", 0.05))
        kw.setdefault("max_delay_s", get_env(f"{prefix}_BACKOFF_MAX", 2.0))
        dl = get_env(f"{prefix}_DEADLINE", 0.0)
        kw.setdefault("deadline_s", dl if dl > 0 else None)
        return cls(name=name or prefix.lower(), **kw)

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter delay before try ``attempt + 1`` (``attempt`` is
        1-based: the try that just failed)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** max(0, attempt - 1)))
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable[..., Any], *args: Any,
             deadline: Optional[Deadline] = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             **kw: Any) -> Any:
        """Run ``fn`` under this policy: its result, or the last error
        wrapped in :class:`DeadlineExpired` / :class:`RetriesExhausted`
        (the cause chained)."""
        dl = deadline or Deadline(self.deadline_s)
        m_retry = metrics.counter(f"retry.{self.name}.retries")
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kw)
            except BaseException as e:  # noqa: BLE001 — predicate decides
                if not self._retryable(e):
                    raise
                if attempt >= self.max_attempts:
                    metrics.counter(f"retry.{self.name}.exhausted").add(1)
                    _trace_event("retries_exhausted", policy=self.name,
                                 attempts=attempt, error=str(e))
                    raise RetriesExhausted(
                        f"{self.name}: gave up after {attempt} attempts: "
                        f"{e}") from e
                if dl.expired():
                    metrics.counter(f"retry.{self.name}.exhausted").add(1)
                    _trace_event("retries_exhausted", policy=self.name,
                                 attempts=attempt, error=str(e),
                                 reason="deadline")
                    raise DeadlineExpired(
                        f"{self.name}: deadline exhausted after {attempt} "
                        f"attempts: {e}") from e
                m_retry.add(1)
                _trace_event("retry", policy=self.name, attempt=attempt,
                             error=str(e))
                if on_retry is not None:
                    on_retry(attempt, e)
                delay = self.backoff_s(attempt)
                # a server-directed backoff (retry_after_s on the error)
                # raises the floor; the deadline clamp still caps it
                hint = getattr(e, "retry_after_s", None)
                if hint is not None:
                    delay = max(delay, float(hint))
                self._sleep(dl.clamp(delay))
                if dl.expired():
                    # the clamped sleep used up the budget: another try
                    # would run with a zero timeout and hide the cause
                    metrics.counter(f"retry.{self.name}.exhausted").add(1)
                    raise DeadlineExpired(
                        f"{self.name}: deadline exhausted after {attempt} "
                        f"attempts: {e}") from e


class CircuitBreaker:
    """Consecutive-failure circuit breaker (thread-safe).

    closed → ``failure_threshold`` × ``record_failure()`` → open (every
    ``allow()`` raises :class:`CircuitOpen` for ``cooldown_s``) →
    half-open (one caller gets through as the probe) → closed on its
    success, open again on its failure."""

    def __init__(self, name: str = "default", failure_threshold: int = 5,
                 cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    @classmethod
    def from_env(cls, prefix: str, *, name: str = "",
                 **kw) -> "CircuitBreaker":
        kw.setdefault("failure_threshold",
                      get_env(f"{prefix}_BREAKER_THRESHOLD", 5))
        kw.setdefault("cooldown_s", get_env(f"{prefix}_BREAKER_COOLDOWN", 5.0))
        return cls(name=name or prefix.lower(), **kw)

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._clock() - self._opened_at >= self.cooldown_s:
                return "half_open"
            return "open"

    def allow(self) -> None:
        """Gate one attempt: raises :class:`CircuitOpen` while open; in
        half-open admits exactly one probe."""
        with self._lock:
            if self._opened_at is None:
                return
            if (self._clock() - self._opened_at >= self.cooldown_s
                    and not self._probing):
                self._probing = True        # this caller is the probe
                _trace_event("circuit_probe", circuit=self.name)
                return
            metrics.counter(f"circuit.{self.name}.fast_fails").add(1)
            _trace_event("circuit_fast_fail", circuit=self.name)
            raise CircuitOpen(
                f"circuit {self.name!r} open "
                f"({self._failures} consecutive failures)")

    def record_success(self) -> None:
        with self._lock:
            recovered = self._opened_at is not None
            self._failures = 0
            self._opened_at = None
            self._probing = False
        if recovered:
            # the probe came back: a trace shows the open → closed bracket
            _trace_event("circuit_close", circuit=self.name)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._opened_at is not None:
                self._opened_at = self._clock()   # failed probe: restart
            elif self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                metrics.counter(f"circuit.{self.name}.opens").add(1)
                _trace_event("circuit_open", circuit=self.name,
                             failures=self._failures)
                log_warning("circuit %s opened after %d consecutive "
                            "failures", self.name, self._failures)

    def call(self, fn: Callable[..., Any], *args: Any, **kw: Any) -> Any:
        """``allow()``, run, record; an exception counts as a failure."""
        self.allow()
        try:
            out = fn(*args, **kw)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return out
