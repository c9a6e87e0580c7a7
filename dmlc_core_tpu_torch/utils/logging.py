"""Error type, checks and info logging for the PyTorch port.

Counterpart of ``dmlc_core_tpu/utils/logging.py``, reduced to what the
port uses: :class:`DMLCError`, :class:`IdOverflowError`, :func:`check`,
:func:`log_info`, :func:`log_warning`, :func:`set_log_context` and
:func:`get_log_tail`.  The port keeps its own copy so that it never
imports the JAX package.

Every record carries the process's log context (:func:`set_log_context`:
``rank`` once the tracker assigned one, seeded from ``DMLC_RANK`` at
import) and, while a trace is live on its thread, the trace id: `` [k=v
... trace_id=<hex>]`` after the text, the trace id last, or the fields
as keys with ``DMLC_LOG_FORMAT=json``, where each record is one JSON
line (``ts``, ``level``, ``msg``, the context, ``trace_id``).

Every emitted line also lands in an in-process tail ring of the last
``DMLC_LOG_TAIL`` lines (256 by default), as the JAX module keeps one:
``HH:MM:SS LEVEL text``, or the JSON line itself.  The flight recorder's
incident bundle writes it as ``log_tail.txt``.
"""

from __future__ import annotations

import json
import logging as _pylogging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["DMLCError", "IdOverflowError", "check", "log_info",
           "log_warning", "set_log_context", "get_log_tail"]


class DMLCError(RuntimeError):
    """Base error type of the port (the JAX package's ``DMLCError``)."""


class IdOverflowError(DMLCError, ValueError):
    """A feature id exceeds int32 range and no feature hashing
    (``id_mod``) is configured: the batch layout is int32, so wide ids
    must be hashed, never silently wrapped."""


class _Formatter(_pylogging.Formatter):
    """The text prefix, except on a JSON record, which is the line."""

    def format(self, record: _pylogging.LogRecord) -> str:
        if getattr(record, "dmlc_json", False):
            return record.getMessage()
        return super().format(record)


_logger = _pylogging.getLogger("dmlc_core_tpu_torch")
if not _logger.handlers:
    _h = _pylogging.StreamHandler(sys.stderr)
    _h.setFormatter(_Formatter(
        "[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(_pylogging.INFO)
    _logger.propagate = False


# the tail ring the flight recorder snapshots: every emitted line, bounded
# by DMLC_LOG_TAIL (a deque's append, and its copy by list(), are each
# atomic under the interpreter lock)
_log_tail: deque = deque(
    maxlen=max(1, int(os.environ.get("DMLC_LOG_TAIL", "256") or 256)))


# the process's correlation fields: swapped whole under the lock by
# set_log_context, read by one reference per record, so a record never
# sees half an update
_log_ctx: Dict[str, Any] = {}
_log_ctx_lock = threading.Lock()
_r = os.environ.get("DMLC_RANK")
if _r is not None and _r.lstrip("-").isdigit():
    _log_ctx["rank"] = int(_r)
del _r


def set_log_context(**fields: Any) -> None:
    """Attach correlation fields (``rank=...``) to every later record;
    ``None`` removes a field.  The context is replaced wholesale, never
    mutated in place, so concurrent threads are safe."""
    global _log_ctx
    with _log_ctx_lock:
        ctx = dict(_log_ctx)
        for k, v in fields.items():
            if v is None:
                ctx.pop(k, None)
            else:
                ctx[k] = v
        _log_ctx = ctx


def get_log_tail() -> List[str]:
    """The last N emitted log lines (N = ``DMLC_LOG_TAIL``, default 256),
    oldest first: what the flight recorder writes into a bundle."""
    return list(_log_tail)


def check(cond: Any, msg: str = "") -> None:
    """Raise :class:`DMLCError` when ``cond`` is falsy."""
    if not cond:
        raise DMLCError(f"Check failed: {msg}" if msg else "Check failed")


def _live_trace_id() -> Optional[str]:
    """The active trace id, if the telemetry package is loaded and a
    trace is live on this logical thread.  Found through ``sys.modules``,
    so logging (imported by everything) never imports telemetry (which
    imports utils back)."""
    mod = sys.modules.get("dmlc_core_tpu_torch.telemetry.trace")
    if mod is None:
        return None
    try:
        return mod.current_trace_id()
    except Exception:
        return None


def _record_fields(name: str, msg: str) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"ts": time.time(), "level": name, "msg": msg}
    rec.update(_log_ctx)           # one read: the dict is swapped whole
    trace_id = _live_trace_id()
    if trace_id is not None:
        rec["trace_id"] = trace_id
    return rec


def _emit(level: int, msg: str) -> None:
    name = _pylogging.getLevelName(level)
    rec = _record_fields(name, msg)
    if os.environ.get("DMLC_LOG_FORMAT", "").lower() == "json":
        line = json.dumps(rec, default=str)
        _log_tail.append(line)
        _logger.log(level, line, extra={"dmlc_json": True})
        return
    suffix = " ".join(f"{k}={v}" for k, v in rec.items()
                      if k not in ("ts", "level", "msg"))
    if suffix:
        msg = f"{msg} [{suffix}]"
    _log_tail.append(time.strftime("%H:%M:%S", time.localtime(rec["ts"]))
                     + f" {name} {msg}")
    _logger.log(level, msg)


def log_info(msg: str, *args: Any) -> None:
    _emit(_pylogging.INFO, msg % args if args else msg)


def log_warning(msg: str, *args: Any) -> None:
    _emit(_pylogging.WARNING, msg % args if args else msg)
