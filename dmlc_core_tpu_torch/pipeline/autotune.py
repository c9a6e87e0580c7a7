"""Closed-loop autotuner: an online hill climb over bounded knobs.

Counterpart of ``dmlc_core_tpu/pipeline/autotune.py``, copied so that
the port never imports the JAX package.

* a declared knob space: each :class:`Knob` is a bounded ladder of
  values (parser threads, prefetch depth, put_threads, page-cache writer
  queue and readahead, the micro-batcher's max delay and batch budget)
  with a baseline and optionally a live ``apply`` callback;
* one bounded mutation per evaluation epoch: ``begin_epoch()`` returns
  the config to run, ``end_epoch(objective)`` judges it against the best
  seen (kept only on a relative gain of ``min_gain``, reverted
  otherwise); ``abort_epoch()`` reverts an epoch that ended for reasons
  other than performance, unjudged;
* freeze: an epoch during which any ``anomaly.stalls.*`` counter moved
  (:class:`..telemetry.anomaly.StallDetector`), or with the
  ``slo.active_breaches`` gauge above 0, is never judged: the candidate
  rolls back to the last-good config and the search backs off for
  ``backoff_epochs``;
* convergence and persistence: a sweep of the move set with no accepted
  mutation converges; the winner is saved per (dataset fingerprint, host
  shape, platform) by :func:`.tuned.save_autotuned`, and a tuner built
  at the same key warm-starts converged at it.

Every decision moves the ``autotune.*`` counters and gauges, under the
JAX package's names, and is traced as the JAX tuner traces it: one
``autotune.decide`` span each :meth:`Autotuner.end_epoch` (``epoch``,
``objective`` and the decision's keys), and the events
``autotune.warm_start``, ``.abort``, ``.mutate`` and ``.converged``.

``DMLC_AUTOTUNE`` gates the ambient wiring (``serve_ingest`` and the
server's ``serve_forever``): unset or ``0`` means no controller is ever
built.  Direct construction is always allowed.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..telemetry import trace as teltrace
from ..utils.logging import check, log_info
from ..utils.metrics import metrics
from ..utils.parameter import get_env
from . import fingerprint as fingerprint_mod
from . import tuned

__all__ = ["Knob", "Autotuner", "enabled", "maybe_autotuner",
           "ingest_knob_space", "serving_knob_space"]


def enabled() -> bool:
    """True iff the *ambient* autotuner wiring is opted in:
    ``DMLC_AUTOTUNE`` set to anything but ``0``.  Unset means off — the
    controller changes pipeline behavior over time, so it must never be
    a silent default; ``DMLC_AUTOTUNE=0`` is the hard kill switch."""
    v = get_env("DMLC_AUTOTUNE", "").strip()
    return bool(v) and v != "0"


class Knob:
    """One tunable: a named, bounded ladder of candidate values.

    ``values`` is the whole legal domain — the controller can never
    propose anything outside it, which is what makes an online mutation
    safe (a prefetch of 10**6 is not a search direction, it is an OOM).
    ``apply`` (optional) pushes a value onto a live object (the
    micro-batcher path); epoch-scoped knobs (loader/parser constructor
    args) are instead read out of ``begin_epoch()``'s config dict by the
    consumer that rebuilds those objects each epoch.
    """

    def __init__(self, name: str, values: Sequence, baseline=None,
                 apply: Optional[Callable] = None):
        check(len(values) > 0, f"knob {name!r} has an empty domain")
        self.name = name
        self.values = tuple(values)
        self.apply = apply
        b = values[0] if baseline is None else baseline
        self.index = self._closest(b)
        self.best_index = self.index

    def _closest(self, v) -> int:
        """Index of the domain value closest to ``v`` (exact for ints,
        nearest for floats — persisted JSON may round-trip floats)."""
        best, best_d = 0, None
        for i, cand in enumerate(self.values):
            try:
                d = abs(float(cand) - float(v))
            except (TypeError, ValueError):
                d = 0.0 if cand == v else float("inf")
            if best_d is None or d < best_d:
                best, best_d = i, d
        return best

    @property
    def value(self):
        return self.values[self.index]


class Autotuner:
    """Hill-climbing controller over a list of :class:`Knob`.

    Protocol (one evaluation epoch = one measured pass of the workload,
    e.g. one served ingest epoch)::

        cfg = tuner.begin_epoch()      # {knob: value} to run with
        ...run the epoch using cfg...
        tuner.end_epoch(mb_s)          # judge; propose next mutation

    ``abort_epoch()`` discards an epoch that failed for non-performance
    reasons (peer hung up mid-stream): the pending mutation reverts
    un-judged.

    ``key`` (a :func:`~.fingerprint.autotune_key` string) enables
    persistence: convergence writes the winner through
    :func:`~.tuned.save_autotuned`, and construction warm-starts from an
    existing entry — the controller comes up already converged at the
    persisted config and proposes nothing.
    """

    def __init__(self, knobs: Sequence[Knob], *, key: Optional[str] = None,
                 min_gain: float = 0.03, backoff_epochs: int = 2,
                 persist: bool = True, warm_start: bool = True,
                 stall_prefix: str = "anomaly.stalls."):
        names = [k.name for k in knobs]
        check(len(set(names)) == len(names), "duplicate knob names")
        self.knobs: Dict[str, Knob] = {k.name: k for k in knobs}
        self.key = key
        self.min_gain = float(min_gain)
        self.backoff_epochs = max(1, int(backoff_epochs))
        self.persist = bool(persist)
        self._stall_prefix = stall_prefix
        # the move set: ±1 ladder step per knob with room to move
        self._moves: List[Tuple[str, int]] = []
        for k in knobs:
            if len(k.values) > 1:
                self._moves.append((k.name, +1))
                self._moves.append((k.name, -1))
        self._move_i = 0
        self._no_improve = 0
        self._pending: Optional[Tuple[str, int, int]] = None  # name, old, new
        self._best_obj: Optional[float] = None
        self._epoch = 0
        self._open = False
        self._skip = 0                  # backoff epochs left un-mutated
        self._converged = not self._moves
        self._stall_base = 0
        self._m_gen = None
        self._bind()
        if warm_start and key is not None:
            self._warm_start()
        self._export_state()

    # -- metrics / persistence ----------------------------------------
    def _bind(self) -> None:
        m = metrics
        self._m_gen = m.generation
        self._m_epochs = m.counter("autotune.epochs")
        self._m_mut = m.counter("autotune.mutations")
        self._m_acc = m.counter("autotune.accepted")
        self._m_rej = m.counter("autotune.rejected")
        self._m_freeze = m.counter("autotune.freezes")
        self._m_roll = m.counter("autotune.rollbacks")
        self._m_abort = m.counter("autotune.aborted")
        self._m_conv = m.gauge("autotune.converged")
        self._m_obj = m.gauge("autotune.objective")
        self._m_best = m.gauge("autotune.best_objective")

    def _maybe_rebind(self) -> None:
        if self._m_gen != metrics.generation:
            self._bind()

    def _export_state(self) -> None:
        self._maybe_rebind()
        self._m_conv.set(1.0 if self._converged else 0.0)
        if self._best_obj is not None:
            self._m_best.set(self._best_obj)
        for k in self.knobs.values():
            try:
                metrics.gauge(f"autotune.knob.{k.name}").set(float(k.value))
            except (TypeError, ValueError):
                pass

    def _warm_start(self) -> None:
        saved = tuned.load_autotuned(self.key)
        if not saved or not isinstance(saved.get("knobs"), dict):
            return
        for name, v in saved["knobs"].items():
            k = self.knobs.get(name)
            if k is not None:
                k.index = k.best_index = k._closest(v)
        obj = saved.get("objective")
        self._best_obj = float(obj) if isinstance(obj, (int, float)) else None
        self._converged = True
        log_info("autotune: warm start from persisted config %s (%s)",
                 self.key, self.config())
        teltrace.add_event("autotune.warm_start", key=self.key)

    def _persist(self) -> None:
        if not (self.persist and self.key):
            return
        cfg = {"knobs": {k.name: k.values[k.best_index]
                         for k in self.knobs.values()},
               "objective": self._best_obj,
               "epochs": self._epoch,
               "host": fingerprint_mod.host_shape(),
               "saved": time.time()}
        try:
            tuned.save_autotuned(self.key, cfg)
            log_info("autotune: converged after %d epochs, persisted %s "
                     "-> %s", self._epoch, self.key, cfg["knobs"])
        except OSError as e:
            log_info("autotune: could not persist winner: %r", e)

    # -- freeze signals ------------------------------------------------
    def _stall_count(self) -> int:
        snap = metrics.snapshot()
        return int(sum(v.get("value", 0) for name, v in snap.items()
                       if name.startswith(self._stall_prefix)
                       and v.get("type") == "counter"))

    def _under_pressure(self) -> bool:
        if metrics.gauge("slo.active_breaches").value > 0:
            return True
        return self._stall_count() > self._stall_base

    # -- epoch protocol ------------------------------------------------
    def config(self) -> Dict[str, object]:
        """The current candidate config (pending mutation included)."""
        return {k.name: k.value for k in self.knobs.values()}

    def best_config(self) -> Dict[str, object]:
        return {k.name: k.values[k.best_index] for k in self.knobs.values()}

    def begin_epoch(self) -> Dict[str, object]:
        """Arm one evaluation epoch and return the config to run it
        with.  Live knobs (``apply`` callbacks) are pushed here."""
        check(not self._open, "begin_epoch() with an epoch already open")
        self._open = True
        self._epoch += 1
        self._maybe_rebind()
        self._stall_base = self._stall_count()
        cfg = self.config()
        for k in self.knobs.values():
            if k.apply is not None:
                k.apply(k.value)
        self._export_state()
        return cfg

    def abort_epoch(self) -> None:
        """Discard an epoch that ended for non-performance reasons: the
        pending mutation reverts without being judged."""
        if not self._open:
            return
        self._open = False
        self._m_abort.add(1)
        if self._pending is not None:
            name, old, _new = self._pending
            self.knobs[name].index = old
            self._pending = None
        teltrace.add_event("autotune.abort", epoch=self._epoch)

    def end_epoch(self, objective: float) -> Dict[str, object]:
        """Judge the epoch just run (``objective``: higher is better,
        e.g. MB/s) and stage the next mutation.  Returns the action
        taken, for logs/tests: ``{"action": ..., ...}``."""
        check(self._open, "end_epoch() without begin_epoch()")
        self._open = False
        self._maybe_rebind()
        self._m_epochs.add(1)
        obj = float(objective)
        self._m_obj.set(obj)
        with teltrace.span("autotune.decide", epoch=self._epoch) as sp:
            out = self._decide(obj)
            sp.attrs.update(out)
            sp.attrs["objective"] = obj
        self._export_state()
        return out

    def _decide(self, obj: float) -> Dict[str, object]:
        if self._under_pressure():
            # never tune during a flagged stall / standing SLO breach:
            # judging this epoch would optimize for the pathology, and
            # a candidate mutation may even be its cause — roll back to
            # the last-good config and freeze the search
            self._m_freeze.add(1)
            rolled = self._rollback()
            self._skip = self.backoff_epochs
            return {"action": "freeze", "rolled_back": rolled}
        if self._skip > 0:
            # backing off: run the last-good config, judge nothing
            self._skip -= 1
            return {"action": "backoff", "left": self._skip}
        if self._converged:
            return {"action": "steady"}
        if self._best_obj is None:
            # warmup: first clean epoch is the baseline measurement
            self._best_obj = obj
            return self._propose("baseline")
        if self._pending is not None:
            name, old, new = self._pending
            self._pending = None
            if obj > self._best_obj * (1.0 + self.min_gain):
                self._best_obj = obj
                k = self.knobs[name]
                k.best_index = k.index
                self._m_acc.add(1)
                self._no_improve = 0
                # greedy: a direction that paid keeps being tried first
                self._move_i = (self._move_i - 1) % len(self._moves)
                return self._propose("accept", knob=name,
                                     value=k.value)
            self.knobs[name].index = old
            self._m_rej.add(1)
            self._no_improve += 1
            if self._no_improve >= len(self._moves):
                return self._converge()
            return self._propose("reject", knob=name)
        # no mutation was pending (post-freeze/backoff epoch): resume
        return self._propose("resume")

    def _propose(self, action: str, **extra) -> Dict[str, object]:
        """Stage the next ±1 ladder move with room to travel; converge
        if a full cycle of the move set is out of room."""
        for _ in range(len(self._moves)):
            name, step = self._moves[self._move_i]
            self._move_i = (self._move_i + 1) % len(self._moves)
            k = self.knobs[name]
            j = k.index + step
            if 0 <= j < len(k.values):
                self._pending = (name, k.index, j)
                k.index = j
                self._m_mut.add(1)
                teltrace.add_event("autotune.mutate", knob=name,
                                   value=str(k.value))
                return {"action": action, "next_knob": name,
                        "next_value": k.value, **extra}
        return self._converge()

    def _converge(self) -> Dict[str, object]:
        self._converged = True
        self._rollback()
        self._persist()
        teltrace.add_event("autotune.converged", epochs=self._epoch)
        return {"action": "converge", "epochs": self._epoch,
                "best": self.best_config()}

    def _rollback(self) -> bool:
        """Force the candidate back to the last-good config; True if
        anything actually moved."""
        self._pending = None
        moved = False
        for k in self.knobs.values():
            if k.index != k.best_index:
                k.index = k.best_index
                moved = True
        if moved:
            self._m_roll.add(1)
        return moved

    @property
    def converged(self) -> bool:
        return self._converged

    @property
    def epoch(self) -> int:
        return self._epoch


# -- standard knob spaces ----------------------------------------------


def _ladder(*vals) -> Tuple:
    return tuple(sorted(set(vals)))


def ingest_knob_space(*, cores: Optional[int] = None, cache: bool = False,
                      device: bool = False,
                      degraded: bool = False) -> List[Knob]:
    """The declared ingest-side knob space.

    ``cores`` bounds the thread ladders (default: the affinity mask);
    ``cache=True`` adds the page-cache writer-queue/readahead knobs;
    ``device=True`` adds ``put_threads`` (transfer-pool width — host-emit
    loaders have no transfer stage).  ``degraded=True`` pins every
    baseline to the worst rung, so that a cold-start climb is
    measurable."""
    if cores is None:
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 1
    tmax = max(8, cores)
    threads = tuple(v for v in _ladder(1, 2, 4, 8, 16, cores)
                    if v <= tmax)
    base_threads = 1 if (degraded or cores == 1) else min(cores, 8)
    knobs = [
        Knob("parser_threads", threads, baseline=base_threads),
        Knob("prefetch", _ladder(1, 2, 4, 8),
             baseline=1 if degraded else 2),
    ]
    if device:
        knobs.append(Knob("put_threads", _ladder(1, 2, 4),
                          baseline=1))
    if cache:
        knobs.append(Knob("cache_queue", _ladder(4, 8, 16, 32),
                          baseline=4 if degraded else 8))
        knobs.append(Knob("cache_readahead", _ladder(0, 1, 2, 4, 8),
                          baseline=0 if degraded else 2))
    return knobs


def serving_knob_space(batcher) -> List[Knob]:
    """Live knob space over a :class:`~..serving.batcher.MicroBatcher`:
    cut triggers move through ``apply_knobs`` (bounded by the engine
    ladder inside it), so mutations land between batches with no
    restart."""
    ladder = batcher.engine.ladder
    delays = _ladder(0.0005, 0.001, 0.002, 0.004, 0.008)
    rows = _ladder(*(max(1, ladder.max_rows // d) for d in (4, 2, 1)))
    nnz = _ladder(*(max(1, ladder.max_nnz // d) for d in (4, 2, 1)))
    return [
        Knob("max_delay_s", delays, baseline=batcher.max_delay_s,
             apply=lambda v: batcher.apply_knobs(max_delay_s=v)),
        Knob("max_batch_rows", rows, baseline=batcher.max_batch_rows,
             apply=lambda v: batcher.apply_knobs(max_batch_rows=v)),
        Knob("max_batch_nnz", nnz, baseline=batcher.max_batch_nnz,
             apply=lambda v: batcher.apply_knobs(max_batch_nnz=v)),
    ]


def maybe_autotuner(knobs_factory: Callable[[], Sequence[Knob]],
                    key: Optional[str] = None,
                    gate="auto") -> Optional[Autotuner]:
    """Ambient construction helper: returns an :class:`Autotuner` iff
    the wiring is opted in, else None (the caller's no-tuner path must
    be byte-identical to the pre-autotune code).

    ``gate``: "auto" consults :func:`enabled` (``DMLC_AUTOTUNE``);
    True forces on unless the env kill switch (``DMLC_AUTOTUNE=0``)
    stands; False is always off."""
    if gate is False:
        return None
    if get_env("DMLC_AUTOTUNE", "").strip() == "0":
        return None
    if gate == "auto" and not enabled():
        return None
    return Autotuner(list(knobs_factory()), key=key)
