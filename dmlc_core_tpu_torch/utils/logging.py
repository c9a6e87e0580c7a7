"""Error type, checks and info logging for the PyTorch port.

Counterpart of ``dmlc_core_tpu/utils/logging.py``, reduced to what the
port uses: :class:`DMLCError`, :class:`IdOverflowError`, :func:`check`,
:func:`log_info` and :func:`log_warning`.  The
port keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import logging as _pylogging
import sys
from typing import Any

__all__ = ["DMLCError", "IdOverflowError", "check", "log_info",
           "log_warning"]


class DMLCError(RuntimeError):
    """Base error type of the port (the JAX package's ``DMLCError``)."""


class IdOverflowError(DMLCError, ValueError):
    """A feature id exceeds int32 range and no feature hashing
    (``id_mod``) is configured: the batch layout is int32, so wide ids
    must be hashed, never silently wrapped."""


_logger = _pylogging.getLogger("dmlc_core_tpu_torch")
if not _logger.handlers:
    _h = _pylogging.StreamHandler(sys.stderr)
    _h.setFormatter(_pylogging.Formatter(
        "[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(_pylogging.INFO)
    _logger.propagate = False


def check(cond: Any, msg: str = "") -> None:
    """Raise :class:`DMLCError` when ``cond`` is falsy."""
    if not cond:
        raise DMLCError(f"Check failed: {msg}" if msg else "Check failed")


def log_info(msg: str, *args: Any) -> None:
    _logger.info(msg % args if args else msg)


def log_warning(msg: str, *args: Any) -> None:
    _logger.warning(msg % args if args else msg)
