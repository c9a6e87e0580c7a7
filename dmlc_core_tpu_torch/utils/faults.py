"""Deterministic fault injection: named probe sites, env-configured plans.

Counterpart of ``dmlc_core_tpu/utils/faults.py``, copied so that the port
never imports the JAX package.  Hot paths declare **named probe sites**
(``fault_point("s3.request")`` around each HTTP round trip of the remote
filesystems, ``page_cache.write`` before each page the page-cache writer
stores, ``serving.server.admit`` where the server admits a request,
``ingest.send`` and ``ingest.recv`` at each frame an ingest worker sends
and a trainer's reader receives) and a *plan* decides, per site, whether to inject an error or added latency.

When no plan is active (``DMLC_FAULT_SPEC`` unset and nothing installed)
a probe is an exact no-op: one environment read and one module-global
``None`` check, no counters, no behaviour change.

Spec grammar (``DMLC_FAULT_SPEC`` or :func:`install_faults`)::

    spec    := clause (',' clause)*
    clause  := site (':' key '=' value)*
    site    := probe name, exact or prefix glob ("serving.*")

    keys:
      error=P       probability per call of raising FaultInjected
                    (an OSError subclass, so retry layers treat it
                    exactly like a dropped connection)
      latency=D     added sleep per call: "50ms", "0.2s", or seconds
      lp=P          probability the latency fires (default 1.0)
      seed=N        RNG seed for this clause (default 0): a fixed seed
                    replays the identical fault schedule every run
      times=N       stop injecting errors after N have fired
      after=N       skip the first N calls before the clause arms

Example::

    DMLC_FAULT_SPEC='s3.request:error=0.2:seed=7,page_cache.write:latency=50ms'

Each injected error bumps ``faults.<site>.errors`` and each injected
delay ``faults.<site>.delays`` on :data:`..utils.metrics.metrics`, so a
chaos test can assert both that faults fired and that the layer under
test absorbed them.  The same spec and seed give the same schedule in
both packages.
"""

from __future__ import annotations

import contextlib
import random
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional

from .logging import DMLCError
from .metrics import metrics
from .parameter import get_env

__all__ = ["FaultInjected", "FaultSpecError", "fault_point",
           "install_faults", "clear_faults", "inject_faults",
           "active_spec"]

ENV_VAR = "DMLC_FAULT_SPEC"


class FaultInjected(OSError):
    """Injected failure.  Subclasses ``OSError`` deliberately: every
    network layer in the repo already treats ``OSError`` as "connection
    trouble, maybe retry", so probes compose with real error handling
    instead of needing their own except-arms."""


class FaultSpecError(DMLCError):
    """Malformed ``DMLC_FAULT_SPEC`` — raised at parse time, loudly: a
    chaos run with a typo'd spec must not silently test nothing."""


def _parse_duration(text: str) -> float:
    t = text.strip().lower()
    try:
        if t.endswith("ms"):
            return float(t[:-2]) / 1e3
        if t.endswith("s"):
            return float(t[:-1])
        return float(t)
    except ValueError:
        raise FaultSpecError(f"bad duration {text!r}") from None


class _Rule:
    """One compiled clause; owns a seeded RNG and its fire counters."""

    __slots__ = ("site", "error_p", "latency_s", "latency_p", "times",
                 "after", "_rng", "_calls", "_fired", "_lock")

    def __init__(self, site: str, error_p: float, latency_s: float,
                 latency_p: float, times: Optional[int], after: int,
                 seed: int) -> None:
        self.site = site
        self.error_p = error_p
        self.latency_s = latency_s
        self.latency_p = latency_p
        self.times = times
        self.after = after
        self._rng = random.Random(seed)
        self._calls = 0
        self._fired = 0
        self._lock = threading.Lock()

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site

    def fire(self, site: str) -> None:
        with self._lock:
            self._calls += 1
            if self._calls <= self.after:
                return
            delay = 0.0
            if self.latency_s > 0 and (self.latency_p >= 1.0
                                       or self._rng.random() < self.latency_p):
                delay = self.latency_s
            raise_error = False
            if self.error_p > 0 and (self.times is None
                                     or self._fired < self.times):
                if self.error_p >= 1.0 or self._rng.random() < self.error_p:
                    raise_error = True
                    self._fired += 1
        if delay > 0:
            metrics.counter(f"faults.{site}.delays").add(1)
            time.sleep(delay)
        if raise_error:
            metrics.counter(f"faults.{site}.errors").add(1)
            # tell the flight recorder, where one is loaded (looked up in
            # sys.modules by the port's name: faults never imports
            # telemetry, and never reaches the JAX package's recorder)
            fl = sys.modules.get("dmlc_core_tpu_torch.telemetry.flight")
            if fl is not None:
                try:
                    fl.note_fault(site)
                except Exception:
                    pass    # the black box must never mask the fault
            raise FaultInjected(f"injected fault at {site!r}")


class _Plan:
    __slots__ = ("spec", "rules")

    def __init__(self, spec: str, rules: List[_Rule]) -> None:
        self.spec = spec
        self.rules = rules

    def fire(self, site: str) -> None:
        for rule in self.rules:
            if rule.matches(site):
                rule.fire(site)


def _compile(spec: str) -> _Plan:
    rules: List[_Rule] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        site = parts[0].strip()
        if not site:
            raise FaultSpecError(f"clause {clause!r} has no site name")
        kv: Dict[str, str] = {}
        for p in parts[1:]:
            if "=" not in p:
                raise FaultSpecError(f"bad key=value {p!r} in {clause!r}")
            k, v = p.split("=", 1)
            kv[k.strip()] = v.strip()
        unknown = set(kv) - {"error", "latency", "lp", "seed", "times",
                             "after"}
        if unknown:
            raise FaultSpecError(
                f"unknown keys {sorted(unknown)} in clause {clause!r}")
        try:
            rules.append(_Rule(
                site,
                error_p=float(kv.get("error", 0.0)),
                latency_s=_parse_duration(kv["latency"])
                if "latency" in kv else 0.0,
                latency_p=float(kv.get("lp", 1.0)),
                times=int(kv["times"]) if "times" in kv else None,
                after=int(kv.get("after", 0)),
                seed=int(kv.get("seed", 0))))
        except ValueError as e:
            raise FaultSpecError(f"bad value in clause {clause!r}: {e}") \
                from None
    if not rules:
        raise FaultSpecError(f"empty fault spec {spec!r}")
    return _Plan(spec, rules)


# -- plan lifecycle ----------------------------------------------------------
# _plan is the single hot-path global.  _env_seen tracks the last raw env
# string we compiled, so tests that flip DMLC_FAULT_SPEC (monkeypatch.setenv)
# take effect on the next probe without an explicit install call.

_plan: Optional[_Plan] = None
_env_seen: Optional[str] = None
_explicit = False           # install_faults() wins over the env var
_lifecycle_lock = threading.Lock()


def install_faults(spec: str) -> None:
    """Compile and activate a plan, overriding ``DMLC_FAULT_SPEC``."""
    global _plan, _explicit
    plan = _compile(spec)
    with _lifecycle_lock:
        _plan = plan
        _explicit = True


def clear_faults() -> None:
    """Deactivate any plan (explicit or env-derived)."""
    global _plan, _env_seen, _explicit
    with _lifecycle_lock:
        _plan = None
        _env_seen = None
        _explicit = False


def active_spec() -> Optional[str]:
    """The spec string currently armed, or None."""
    _refresh_from_env()
    p = _plan
    return p.spec if p is not None else None


@contextlib.contextmanager
def inject_faults(spec: str) -> Iterator[None]:
    """Scoped plan for tests: ``with inject_faults("x:error=1:times=1")``."""
    install_faults(spec)
    try:
        yield
    finally:
        clear_faults()


def _refresh_from_env() -> None:
    global _plan, _env_seen
    if _explicit:
        return
    raw = get_env(ENV_VAR, None) or None
    if raw == _env_seen:
        return
    with _lifecycle_lock:
        if _explicit or raw == _env_seen:
            return
        _plan = _compile(raw) if raw else None
        _env_seen = raw


def fault_point(site: str) -> None:
    """Declare a probe site.  No active plan → exact no-op (the fast path
    is one global read + one dict lookup for the env check); active plan →
    matching clauses may sleep and/or raise :class:`FaultInjected`."""
    _refresh_from_env()
    plan = _plan
    if plan is None:
        return
    plan.fire(site)
