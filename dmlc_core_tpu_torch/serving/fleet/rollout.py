"""Canary checkpoint rollout over the replica fleet.

Counterpart of ``dmlc_core_tpu/serving/fleet/rollout.py``, the same
decisions, ledger events, journal records and knobs.  A rollout moves
one model's stable checkpoint pointer in three acts:

1. **stage**: pick a canary subset (``DMLC_CANARY_FRACTION`` of the
   alive replicas, ``ceil`` of it, at least one, never all when the
   fleet has more than one) and queue a hot-reload directive for each;
   the rest keep serving the stable checkpoint as the control group.
2. **bake**: for ``DMLC_CANARY_BAKE_S`` the watch loop compares the
   canaries with the control group on every pass.  A canary's SLO
   breach (``slo.active_breaches`` in its report), a failed reload ack,
   a canary declared dead, or a canary mean p99 above
   ``DMLC_CANARY_P99_RATIO`` times the stable mean (both above a 1 ms
   noise floor) is a **breach**; canaries that have not all acked after
   four bakes plus 10 s are one too.
3. **promote or roll back**: a clean bake (every canary acked, no
   breach) moves the stable pointer and queues reloads for the rest of
   the fleet; a breach queues reloads of the stable pointer for the
   canaries and leaves the pointer where it was.

Every transition lands in a bounded ledger (``DMLC_CANARY_LEDGER_CAP``
events) served at ``/rollouts`` and attached to flight bundles by the
``rollout_ledger`` contributor.

Directives ride heartbeat replies (see :mod:`.registry`), so a rollout
advances at heartbeat cadence: a bake shorter than a couple of beats
cannot see the canary.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ...utils.logging import log_info, log_warning
from ...utils.metrics import metrics
from ...utils.parameter import get_env

__all__ = ["RolloutManager"]

#: ignore p99 ratios when both sides are under this floor — loopback
#: noise, not a regression
_P99_NOISE_FLOOR_MS = 1.0


class RolloutManager:
    """Owns canary rollouts for a :class:`~.registry.ReplicaRegistry`.

    One active rollout per ``model_id``; staging a second for the same
    model while one is in flight is an error (roll it back or let it
    bake out first).  All decisions run in a single watch thread, so
    state transitions are serialized per manager.

    Rollout state is durable: every transition forwards a journal
    record through the owning registry's ``_jlog`` (a no-op without a
    journal), so a SIGKILLed registry replays its active canaries,
    pending acks, and ledger, and the bake resumes — the bake window
    restarts from the replay (conservative), and the atomic
    ``rollout_finished`` record guarantees a promote is applied exactly
    once across restarts.
    """

    _DURABLE_STATE = ("_active", "_ledger", "_seq")

    def __init__(self, registry: Any, *,
                 bake_s: Optional[float] = None,
                 p99_ratio: Optional[float] = None,
                 fraction: Optional[float] = None,
                 ledger_cap: Optional[int] = None):
        self.registry = registry
        if bake_s is None:
            bake_s = get_env("DMLC_CANARY_BAKE_S", 30.0)
        if p99_ratio is None:
            p99_ratio = get_env("DMLC_CANARY_P99_RATIO", 1.5)
        if fraction is None:
            fraction = get_env("DMLC_CANARY_FRACTION", 0.25)
        if ledger_cap is None:
            ledger_cap = get_env("DMLC_CANARY_LEDGER_CAP", 256)
        self.bake_s = float(bake_s)
        self.p99_ratio = float(p99_ratio)
        self.fraction = min(1.0, max(0.0, float(fraction)))
        self._lock = threading.Lock()
        #: model_id → active rollout record
        self._active: Dict[str, Dict[str, Any]] = {}
        self._ledger: deque = deque(maxlen=max(16, int(ledger_cap)))
        self._seq = 0
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- durability ------------------------------------------------------
    def _jlog(self, op: str, **fields: Any) -> None:
        """Forward a journal record to the owning registry's journal;
        called with no locks held (the registry's compaction path takes
        its journal mutex before the rollout lock)."""
        reg_jlog = getattr(self.registry, "_jlog", None)
        if reg_jlog is not None:
            reg_jlog(op, **fields)

    def durable_snapshot(self) -> Dict[str, Any]:
        """The rollout slice of the registry's journal snapshot —
        JSON-form active rollouts (sets as sorted lists, no monotonic
        clocks) + ledger + the rollout-id sequence."""
        with self._lock:
            return {
                "active": {
                    m: {"id": r["id"], "model_id": r["model_id"],
                        "ckpt_dir": r["ckpt_dir"], "step": r["step"],
                        "canaries": list(r["canaries"]),
                        "bake_s": r["bake_s"],
                        "acked": sorted(r["acked"]),
                        "failed": sorted(r["failed"])}
                    for m, r in self._active.items()},
                "ledger": list(self._ledger),
                "seq": self._seq,
            }

    def _restore_state(self, state: Dict[str, Any]) -> None:
        """Rebuild from a replayed journal state.  ``staged_at`` is a
        monotonic clock that did not survive the crash, so the bake
        window restarts now — a restored canary bakes a full window
        before promoting, never a truncated one."""
        if not state:
            return
        now = time.monotonic()
        with self._lock:
            self._active = {
                str(m): {"id": r.get("id"), "model_id": str(m),
                         "ckpt_dir": r.get("ckpt_dir"),
                         "step": r.get("step"),
                         "canaries": list(r.get("canaries") or []),
                         "bake_s": float(r.get("bake_s") or self.bake_s),
                         "staged_at": now,
                         "acked": set(r.get("acked") or []),
                         "failed": set(r.get("failed") or [])}
                for m, r in (state.get("active") or {}).items()}
            self._ledger.clear()
            self._ledger.extend(state.get("ledger") or [])
            self._seq = max(self._seq, int(state.get("seq") or 0))
        if self._active:
            log_info("rollout manager: restored %d active rollout(s) "
                     "from journal — bake window restarted",
                     len(self._active))

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._watch_loop,
                                        name="fleet-rollout-watch",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- staging ---------------------------------------------------------
    def stage(self, model_id: str, ckpt_dir: str, *,
              step: Optional[int] = None,
              fraction: Optional[float] = None,
              bake_s: Optional[float] = None) -> Dict[str, Any]:
        """Stage ``ckpt_dir`` on a canary subset of ``model_id``'s
        replicas; returns ``{"rollout_id", "canaries"}``."""
        frac = self.fraction if fraction is None else float(fraction)
        bake = self.bake_s if bake_s is None else float(bake_s)
        records = self.registry.replica_records(model_id)
        alive = sorted(j for j, r in records.items() if r.get("alive"))
        if not alive:
            return {"error": f"no live replicas serve model {model_id!r}"}
        n = max(1, math.ceil(frac * len(alive)))
        if len(alive) > 1:
            n = min(n, len(alive) - 1)   # keep a control group
        canaries = alive[:n]
        with self._lock:
            if model_id in self._active:
                return {"error": f"rollout {self._active[model_id]['id']}"
                                 f" already in flight for {model_id!r}"}
            self._seq += 1
            rid = f"ro-{self._seq}"
            seq = self._seq
            self._active[model_id] = {
                "id": rid, "model_id": model_id, "ckpt_dir": ckpt_dir,
                "step": step, "canaries": canaries, "bake_s": bake,
                "staged_at": time.monotonic(), "acked": set(),
                "failed": set(),
            }
        self._jlog("rollout_staged", seq=seq, rollout={
            "id": rid, "model_id": model_id, "ckpt_dir": ckpt_dir,
            "step": step, "canaries": canaries, "bake_s": bake})
        for jobid in canaries:
            self.registry.push_directive(jobid, {
                "kind": "reload", "rollout_id": rid,
                "ckpt_dir": ckpt_dir, "step": step})
        metrics.counter("fleet.rollouts.staged").add(1)
        self._record("staged", rid, model_id, ckpt_dir=ckpt_dir,
                     step=step, canaries=canaries, bake_s=bake)
        log_info("rollout %s: staged %s (step=%s) on canaries %s "
                 "(bake %.1fs)", rid, ckpt_dir, step, canaries, bake)
        return {"rollout_id": rid, "canaries": canaries}

    # -- heartbeat hooks (called by the registry) ------------------------
    def on_ack(self, jobid: str, ack: dict) -> None:
        """A replica acked a reload directive on its heartbeat."""
        rid = ack.get("rollout_id")
        with self._lock:
            ro = next((r for r in self._active.values()
                       if r["id"] == rid), None)
            if ro is None:
                return          # promote/rollback ack, or stale
            if ack.get("ok"):
                ro["acked"].add(jobid)
            else:
                ro["failed"].add(jobid)
                ro["fail_reason"] = ack.get("error")
        self._jlog("rollout_ack", jobid=jobid, rollout_id=rid,
                   ok=bool(ack.get("ok")), error=ack.get("error"))

    def on_replica_gone(self, jobid: str) -> None:
        """A canary that deregisters mid-bake stops counting toward the
        all-acked promotion condition."""
        touched = False
        with self._lock:
            for ro in self._active.values():
                if jobid in ro["canaries"]:
                    ro["canaries"] = [j for j in ro["canaries"]
                                      if j != jobid]
                    ro["acked"].discard(jobid)
                    touched = True
        if touched:
            self._jlog("rollout_gone", jobid=jobid)

    # -- bake evaluation -------------------------------------------------
    def _watch_loop(self) -> None:
        while not self._stop_ev.is_set():
            with self._lock:
                bakes = [r["bake_s"] for r in self._active.values()]
            shortest = min(bakes) if bakes else 1.0
            if self._stop_ev.wait(max(0.05, min(1.0, shortest / 8.0))):
                return
            self.evaluate_once()

    def evaluate_once(self) -> None:
        """One bake-evaluation pass (the watch thread's body; tests call
        it directly for determinism)."""
        with self._lock:
            active = list(self._active.values())
        for ro in active:
            try:
                self._evaluate(ro)
            except Exception as e:  # noqa: BLE001 — one broken rollout
                # must not stall the watch loop for every model
                log_warning("rollout %s: evaluation error: %s",
                            ro["id"], e)

    def _evaluate(self, ro: Dict[str, Any]) -> None:
        model_id = ro["model_id"]
        records = self.registry.replica_records(model_id)
        canaries = {j: r for j, r in records.items()
                    if j in ro["canaries"]}
        stable = {j: r for j, r in records.items()
                  if j not in ro["canaries"] and r.get("alive")}
        breach = self._breach_reason(ro, canaries, stable)
        if breach:
            self._finish(ro, promoted=False, reason=breach)
            return
        elapsed = time.monotonic() - ro["staged_at"]
        all_acked = (bool(ro["canaries"])
                     and ro["acked"] >= set(ro["canaries"]))
        if all_acked and elapsed >= ro["bake_s"]:
            self._finish(ro, promoted=True,
                         reason=f"baked {elapsed:.1f}s clean")
        elif not all_acked and elapsed > 4.0 * ro["bake_s"] + 10.0:
            # stale guard: canaries never picked the directive up
            # (heartbeats stopped, reload hung) — treat as a breach
            self._finish(ro, promoted=False,
                         reason="canaries never acked reload")

    def _breach_reason(self, ro: Dict[str, Any],
                       canaries: Dict[str, dict],
                       stable: Dict[str, dict]) -> Optional[str]:
        if ro["failed"]:
            return (f"reload failed on {sorted(ro['failed'])}: "
                    f"{ro.get('fail_reason')}")
        breached = [j for j, r in canaries.items()
                    if int(r.get("slo_breaches") or 0) > 0]
        if breached:
            return f"SLO breach on canaries {breached}"
        dead = [j for j in ro["canaries"]
                if j in canaries and not canaries[j].get("alive")]
        if dead:
            return f"canaries died mid-bake: {dead}"
        # p99 delta vs the control group — only meaningful once the
        # canaries acked (pre-reload latency describes the old ckpt)
        if stable and ro["acked"]:
            c_p99 = [float(r.get("p99_ms") or 0.0)
                     for j, r in canaries.items() if j in ro["acked"]]
            s_p99 = [float(r.get("p99_ms") or 0.0)
                     for r in stable.values()]
            c = sum(c_p99) / len(c_p99) if c_p99 else 0.0
            s = sum(s_p99) / len(s_p99) if s_p99 else 0.0
            if (c > _P99_NOISE_FLOOR_MS
                    and c > self.p99_ratio * max(s, _P99_NOISE_FLOOR_MS)):
                return (f"canary p99 {c:.2f}ms > {self.p99_ratio:g}x "
                        f"stable {s:.2f}ms")
        return None

    def _finish(self, ro: Dict[str, Any], *, promoted: bool,
                reason: str) -> None:
        model_id = ro["model_id"]
        with self._lock:
            if self._active.get(model_id) is not ro:
                return          # already finished by another path
            del self._active[model_id]
        # one atomic journal record closes the rollout AND (on promote)
        # moves the stable pointer: replay can never re-promote a closed
        # rollout, which is what makes promotion exactly-once across
        # registry crashes
        self._jlog("rollout_finished", model_id=model_id,
                   rollout_id=ro["id"], promoted=promoted,
                   ckpt_dir=ro["ckpt_dir"], step=ro["step"],
                   reason=reason)
        if promoted:
            self.registry.set_stable_pointer(model_id, ro["ckpt_dir"],
                                             ro["step"])
            # fleet-wide reload: every non-canary replica follows
            records = self.registry.replica_records(model_id)
            rest = [j for j, r in records.items()
                    if j not in ro["canaries"] and r.get("alive")]
            for jobid in rest:
                self.registry.push_directive(jobid, {
                    "kind": "reload", "rollout_id": f"{ro['id']}-promote",
                    "ckpt_dir": ro["ckpt_dir"], "step": ro["step"]})
            metrics.counter("fleet.rollouts.promoted").add(1)
            self._record("promoted", ro["id"], model_id,
                         ckpt_dir=ro["ckpt_dir"], step=ro["step"],
                         reason=reason, reloaded=rest)
            log_info("rollout %s: PROMOTED %s for model %s (%s)",
                     ro["id"], ro["ckpt_dir"], model_id, reason)
        else:
            stable = self.registry.stable_pointer(model_id)
            rollback_dir = stable.get("ckpt_dir")
            for jobid in ro["canaries"]:
                if rollback_dir is not None:
                    self.registry.push_directive(jobid, {
                        "kind": "reload",
                        "rollout_id": f"{ro['id']}-rollback",
                        "ckpt_dir": rollback_dir,
                        "step": stable.get("step")})
            metrics.counter("fleet.rollouts.rolled_back").add(1)
            self._record("rolled_back", ro["id"], model_id,
                         ckpt_dir=ro["ckpt_dir"], reason=reason,
                         rollback_to=rollback_dir)
            log_warning("rollout %s: ROLLED BACK for model %s — %s",
                        ro["id"], model_id, reason)

    # -- ledger ----------------------------------------------------------
    def _record(self, event: str, rid: str, model_id: str,
                **attrs: Any) -> None:
        ev = {"ts": time.time(), "event": event, "rollout_id": rid,
              "model_id": model_id, **attrs}
        self._jlog("rollout_event", event=ev)
        with self._lock:
            self._ledger.append(ev)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/rollouts`` body and the ``rollout_ledger`` flight
        contributor: active rollouts + the bounded event ledger."""
        with self._lock:
            active = {
                m: {"id": r["id"], "ckpt_dir": r["ckpt_dir"],
                    "step": r["step"], "canaries": list(r["canaries"]),
                    "acked": sorted(r["acked"]),
                    "failed": sorted(r["failed"]),
                    "bake_s": r["bake_s"],
                    "elapsed_s": round(time.monotonic() - r["staged_at"],
                                       3)}
                for m, r in self._active.items()}
            events = list(self._ledger)
        return {"schema": "dmlc.serving.rollouts/1", "ts": time.time(),
                "active": active, "events": events}
