"""Ordered control-plane endpoint lists with breaker-gated failover.

Counterpart of ``dmlc_core_tpu/transport/endpoints.py``, the same
grammar, walk and metric names.  A control-plane singleton (the serving
fleet's registry, the rabit tracker) may have a warm standby on a shared
:class:`~dmlc_core_tpu_torch.utils.durable.StateJournal`; the client half
lives here.  :class:`EndpointSet` holds the ordered
``host:port,host:port`` list (the ``DMLC_ROUTER_REGISTRY`` shape that
:class:`~dmlc_core_tpu_torch.serving.fleet.ReplicaAgent` takes), dials
the endpoints in sticky order (whoever answered last answers next) and
gates each behind its own
:class:`~dmlc_core_tpu_torch.utils.retry.CircuitBreaker`, so a dead
primary costs one breaker threshold of probes, not a retry schedule a
request.

Fencing rides the same path: control-plane replies carry a monotonic
``control_epoch``, and :meth:`EndpointSet.call` remembers the highest it
has seen.  A reply with a *lower* epoch comes from a fenced primary (dead
to the cohort, not yet aware that a standby took over): the call treats
it as a failure and walks on to the next endpoint.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, List, Tuple, Union

from ..telemetry import trace as teltrace
from ..utils.logging import DMLCError, log_warning
from ..utils.metrics import metrics
from ..utils.retry import CircuitBreaker, CircuitOpen

__all__ = ["EndpointSet", "parse_endpoints"]

EndpointsLike = Union[str, Tuple[Any, Any], Iterable[Any]]


def parse_endpoints(spec: EndpointsLike) -> List[Tuple[str, int]]:
    """Normalize an endpoint spec to ``[(host, port), ...]``.

    Takes one ``(host, port)`` pair, a ``"host:port,host:port"`` string
    (IPv6 hosts: the last colon separates the port), or any iterable
    mixing both.  Order is kept (the first endpoint is the preferred
    primary) and exact duplicates are dropped; a spec naming no endpoint,
    or a part without a port, raises :class:`DMLCError`.
    """
    out: List[Tuple[str, int]] = []

    def _add(host: Any, port: Any) -> None:
        ep = (str(host), int(port))
        if ep not in out:
            out.append(ep)

    def _one(item: Any) -> None:
        if isinstance(item, str):
            for part in item.split(","):
                part = part.strip()
                if not part:
                    continue
                host, sep, port = part.rpartition(":")
                if not sep:
                    raise DMLCError(f"endpoint {part!r} is not host:port")
                _add(host, port)
        elif (isinstance(item, (tuple, list)) and len(item) == 2
                and not isinstance(item[0], (tuple, list))):
            _add(item[0], item[1])
        else:
            for sub in item:
                _one(sub)

    _one(spec)
    if not out:
        raise DMLCError(f"endpoint spec {spec!r} names no endpoints")
    return out


class EndpointSet:
    """Sticky ordered failover over a parsed endpoint list.

    ``call(fn)`` runs ``fn(addr)`` from the endpoint that last answered,
    walking the ring on ``OSError`` / :class:`DMLCError` and skipping the
    endpoints whose breaker is open.  ``env_prefix`` names the breaker's
    knobs (``<PREFIX>_BREAKER_THRESHOLD`` / ``<PREFIX>_BREAKER_COOLDOWN``).
    """

    def __init__(self, endpoints: EndpointsLike, *,
                 env_prefix: str = "DMLC_ENDPOINTS",
                 name: str = "endpoints"):
        self.endpoints = parse_endpoints(endpoints)
        self.name = str(name)
        self._breakers = [
            CircuitBreaker.from_env(env_prefix, name=f"{name}.{h}:{p}")
            for h, p in self.endpoints]
        self._lock = threading.Lock()
        self._current = 0
        self._max_epoch = 0

    def __len__(self) -> int:
        return len(self.endpoints)

    @property
    def primary(self) -> Tuple[str, int]:
        return self.endpoints[0]

    def current(self) -> Tuple[str, int]:
        """The endpoint the next :meth:`call` dials first."""
        with self._lock:
            return self.endpoints[self._current]

    def control_epoch(self) -> int:
        """The highest ``control_epoch`` of any reply (0 before the first
        stamped one)."""
        with self._lock:
            return self._max_epoch

    def call(self, fn: Callable[[Tuple[str, int]], Any]) -> Any:
        errors: List[str] = []
        with self._lock:
            start = self._current
        n = len(self.endpoints)
        for i in range(n):
            idx = (start + i) % n
            addr = self.endpoints[idx]
            breaker = self._breakers[idx]
            try:
                breaker.allow()
            except CircuitOpen as e:
                errors.append(f"{addr[0]}:{addr[1]}: {e}")
                continue
            try:
                out = fn(addr)
            except (OSError, DMLCError) as e:
                breaker.record_failure()
                errors.append(f"{addr[0]}:{addr[1]}: "
                              f"{type(e).__name__}: {e}")
                continue
            if self._stale_reply(out):
                breaker.record_failure()
                errors.append(f"{addr[0]}:{addr[1]}: fenced (stale "
                              f"control_epoch)")
                continue
            breaker.record_success()
            failed_over = False
            with self._lock:
                if self._current != idx:
                    prev = self.endpoints[self._current]
                    self._current = idx
                    failed_over = True
                    metrics.counter("transport.endpoints.failovers").add(1)
            if failed_over:
                log_warning("endpoint set %r: failed over to %s:%d",
                            self.name, addr[0], addr[1])
                # which endpoint the walk left and which answered, on the
                # caller's trace (outside the lock)
                teltrace.add_event("failover", set=self.name,
                                   frm=f"{prev[0]}:{prev[1]}",
                                   to=f"{addr[0]}:{addr[1]}")
            return out
        raise DMLCError(f"endpoint set {self.name!r}: all "
                        f"{n} endpoint(s) failed: " + "; ".join(errors))

    def _stale_reply(self, out: Any) -> bool:
        """Client-side fencing: a reply stamped with a lower
        ``control_epoch`` than the highest seen comes from a fenced
        primary."""
        if not isinstance(out, dict):
            return False
        epoch = out.get("control_epoch")
        if epoch is None:
            return False
        epoch = int(epoch)
        with self._lock:
            if epoch < self._max_epoch:
                return True
            self._max_epoch = epoch
        return False
