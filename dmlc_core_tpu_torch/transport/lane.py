"""Exact receives for the frame wire.

Counterpart of ``recv_exact_into`` in ``dmlc_core_tpu/transport/lane.py``,
without descriptors: the fd-passing lane (``SCM_RIGHTS``) and the rest of
that module are ROADMAP queue A.11.b.
"""

from __future__ import annotations

import socket

__all__ = ["recv_exact_into"]


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` exactly; raises ConnectionError on EOF mid-buffer."""
    off, n = 0, len(view)
    while off < n:
        got = sock.recv_into(view[off:])
        if got == 0:
            raise ConnectionError("connection closed mid-frame")
        off += got
