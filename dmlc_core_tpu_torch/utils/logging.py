"""Error type, checks and info logging for the PyTorch port.

Counterpart of ``dmlc_core_tpu/utils/logging.py``, reduced to what the
port uses: :class:`DMLCError`, :class:`IdOverflowError`, :func:`check`,
:func:`log_info` and :func:`log_warning`.  The
port keeps its own copy so that it never imports the JAX package.

A record logged while a trace is live on its thread carries the trace
id: ``[trace_id=<hex>]`` after the text, or a ``trace_id`` key with
``DMLC_LOG_FORMAT=json``, where each record is one JSON line (``ts``,
``level``, ``msg``).
"""

from __future__ import annotations

import json
import logging as _pylogging
import os
import sys
import time
from typing import Any, Optional

__all__ = ["DMLCError", "IdOverflowError", "check", "log_info",
           "log_warning"]


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
    if os.environ.get("DMLC_LOG_FORMAT", "").lower() == "json":
        rec = {"ts": time.time(), "level": _pylogging.getLevelName(level),
               "msg": msg}
        if trace_id is not None:
            rec["trace_id"] = trace_id
        _logger.log(level, json.dumps(rec, default=str),
                    extra={"dmlc_json": True})
        return
    if trace_id is not None:
        msg = f"{msg} [trace_id={trace_id}]"
    _logger.log(level, msg)


def log_info(msg: str, *args: Any) -> None:
    _emit(_pylogging.INFO, msg % args if args else msg)


def log_warning(msg: str, *args: Any) -> None:
    _emit(_pylogging.WARNING, msg % args if args else msg)
