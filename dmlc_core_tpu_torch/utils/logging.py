"""Error type, checks and info logging for the PyTorch port.

Counterpart of ``dmlc_core_tpu/utils/logging.py``, reduced to what the
port uses: :class:`DMLCError`, :class:`IdOverflowError`, :func:`check`,
:func:`log_info`, :func:`log_warning` and :func:`get_log_tail`.  The
port keeps its own copy so that it never imports the JAX package.

A record logged while a trace is live on its thread carries the trace
id: ``[trace_id=<hex>]`` after the text, or a ``trace_id`` key with
``DMLC_LOG_FORMAT=json``, where each record is one JSON line (``ts``,
``level``, ``msg``).

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
import time
from collections import deque
from typing import Any, List, Optional

__all__ = ["DMLCError", "IdOverflowError", "check", "log_info",
           "log_warning", "get_log_tail"]


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


def _emit(level: int, msg: str) -> None:
    trace_id = _live_trace_id()
    ts = time.time()
    name = _pylogging.getLevelName(level)
    if os.environ.get("DMLC_LOG_FORMAT", "").lower() == "json":
        rec = {"ts": ts, "level": name, "msg": msg}
        if trace_id is not None:
            rec["trace_id"] = trace_id
        line = json.dumps(rec, default=str)
        _log_tail.append(line)
        _logger.log(level, line, extra={"dmlc_json": True})
        return
    if trace_id is not None:
        msg = f"{msg} [trace_id={trace_id}]"
    _log_tail.append(time.strftime("%H:%M:%S", time.localtime(ts))
                     + f" {name} {msg}")
    _logger.log(level, msg)


def log_info(msg: str, *args: Any) -> None:
    _emit(_pylogging.INFO, msg % args if args else msg)


def log_warning(msg: str, *args: Any) -> None:
    _emit(_pylogging.WARNING, msg % args if args else msg)
